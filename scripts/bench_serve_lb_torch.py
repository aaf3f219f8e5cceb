#!/usr/bin/env python3
"""Serve-plane benchmark of the PyTorch port: the twin of
``scripts/bench_serve_lb.py`` with port replicas
(``skypilot_tpu_torch``) behind the serve plane's unchanged load
balancer.

The sweep (the default) measures serving the way a user meets it:
Poisson arrivals POSTed to an endpoint with stream=True, client-side TTFT
at the first SSE token event, TPOT over the rest, 429 sheds counted --
prompts of 219 tokens, 188 new tokens each.  With ``--endpoint URL`` it
drives an endpoint that is already up (a port replica or a service's LB);
without one it brings a service up on the local cloud (the serve plane's
controller, prober and LB), whose replica command is the reference's with
the module changed: ``python -m skypilot_tpu_torch.cli infer serve
--model llama2-7b --weight-dtype int8 --cache-dtype fp8 ...``.

The in-process fleet sections put port replicas (``infer/chaos.py``'s
``KillableReplica``) behind the serve plane's ``SkyTpuLoadBalancer``,
built through ``ChaosFleet``'s LB factory (``scripts/chaos_smoke_torch.py``
``lb_factory``):

  --failover  clean vs killed-and-resumed stream latency, and a drain's
              hot-prefix handoff to the survivor;
  --affinity  shared-system-prompt TTFT, prefix_affinity vs least_load vs
              one replica (greedy outputs byte-identical across arms);
  --gray      one replica behind a latency-injecting proxy, probation +
              hedging on vs off;
  --qos       2x-overload interactive TTFT, FIFO vs WFQ + preemption;
  --batch     the batch plane's goodput against online rows.

The serve plane and its LB import ``yaml``, ``psutil`` and ``filelock``;
the fleet sections and the serve-up path import it (the JAX package's
JAX-free planes) inside themselves, so they run where those are
installed.  ``--endpoint`` mode imports nothing of it and runs anywhere,
the card's host included.  ``--device`` picks the in-process replicas'
device (default cuda).  Nothing is written unless --out is given.

  python scripts/bench_serve_lb_torch.py --endpoint http://127.0.0.1:8100 \\
      --qps 2
  python scripts/bench_serve_lb_torch.py --failover --device cpu
"""
import argparse
import importlib.util
import json
import os
import statistics
import sys
import threading
import time
import urllib.request
from http.client import HTTPConnection

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

PROMPT_LEN = 219      # the reference's JetStream workload shape
NEW_TOKENS = 188
DEVICE = 'cuda'       # the in-process replicas' device, set by main()


def _post_stream(endpoint: str, tokens, max_new: int):
    """POST /generate stream=True; returns (ttft_s, latency_s, n_out)."""
    body = json.dumps({'tokens': tokens, 'max_new_tokens': max_new,
                       'stream': True}).encode()
    req = urllib.request.Request(
        endpoint + '/generate', data=body,
        headers={'Content-Type': 'application/json'})
    t0 = time.time()
    ttft = None
    n_out = 0
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f'HTTP {resp.status}')
        for raw in resp:
            line = raw.decode('utf-8', 'replace').strip()
            if not line.startswith('data: '):
                continue
            msg = json.loads(line[len('data: '):])
            if msg.get('done'):
                if msg.get('finish_reason') == 'error':
                    raise RuntimeError(msg.get('error', 'stream error'))
                n_out = len(msg.get('output_tokens', []))
                break
            if ttft is None and msg.get('tokens'):
                ttft = time.time() - t0
            n_out += len(msg.get('tokens', []))
    return (ttft if ttft is not None else time.time() - t0,
            time.time() - t0, n_out)


def run_sweep_row(endpoint: str, qps: float, num_requests: int,
                  vocab: int = 32000, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=num_requests)
    prompts = [rng.integers(4, vocab, size=PROMPT_LEN).tolist()
               for _ in range(num_requests)]
    results = [None] * num_requests
    errors = []
    sheds = []
    threads = []

    def one(i):
        import urllib.error
        try:
            results[i] = _post_stream(endpoint, prompts[i], NEW_TOKENS)
        except urllib.error.HTTPError as e:
            if e.code == 429:
                sheds.append((i, e.headers.get('Retry-After')))
            else:
                errors.append((i, f'HTTP {e.code}'))
        except Exception as e:  # noqa: BLE001 -- counted, not raised
            errors.append((i, str(e)[:200]))

    t_start = time.time()
    for i in range(num_requests):
        time.sleep(float(gaps[i]))
        t = threading.Thread(target=one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=900)
    elapsed = time.time() - t_start
    done = [r for r in results if r is not None]
    if not done:
        raise RuntimeError(f'no request completed; errors: {errors[:3]}')
    ttfts = sorted(r[0] for r in done)
    lats = [r[1] for r in done]
    outs = sum(r[2] for r in done)
    tpots = sorted((r[1] - r[0]) / max(r[2] - 1, 1) for r in done)

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(len(xs) * p))]

    return {
        'offered_qps': qps,
        'completed': len(done),
        'shed_429': len(sheds),
        'shed_rate': len(sheds) / num_requests,
        'errors': len(errors),
        'output_tokens': outs,
        'requests_per_second': len(done) / elapsed,
        'output_tokens_per_second': outs / elapsed,
        'ttft_median_s': statistics.median(ttfts),
        'ttft_p99_s': pct(ttfts, 0.99),
        'tpot_median_s': statistics.median(tpots),
        'tpot_p99_s': pct(tpots, 0.99),
        'latency_median_s': statistics.median(sorted(lats)),
        'elapsed_s': elapsed,
        'measured_at': 'load_balancer_endpoint',
    }


def _merge_out(out, key, value, append=False) -> None:
    """Merge one section into the --out JSON document (none: print
    only)."""
    if not out:
        return
    try:
        with open(out) as f:
            doc = json.load(f)
    except (FileNotFoundError, ValueError):
        doc = {}
    if append:
        doc.setdefault(key, [])
        doc[key] += value
    else:
        doc[key] = value
    with open(out, 'w') as f:
        json.dump(doc, f, indent=2)
    print(f'wrote {out}')


# --------------------------------------------------- the in-process fleet


def lb_factory(policy_name: str = 'least_load'):
    """The serve plane's load balancer for ChaosFleet, as the chaos twin
    builds it (``scripts/chaos_smoke_torch.py`` ``lb_factory``)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'chaos_smoke_torch.py')
    spec = importlib.util.spec_from_file_location('chaos_smoke_torch', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lb_factory(policy_name)


def _fleet(make_engine, n: int, policy: str = 'least_load'):
    from skypilot_tpu_torch.infer.chaos import ChaosFleet
    return ChaosFleet(make_engine, n, lb_factory(policy))


def _tiny_engine_factory(geometry: dict, infer: dict, faults=None):
    """A factory of seeded port engines (weights from seed 0 on DEVICE),
    warmed up, with an optional fault plan armed after the warm-up."""
    from skypilot_tpu_torch.infer import InferConfig, InferenceEngine
    from skypilot_tpu_torch.models.llama import LlamaConfig
    mc = LlamaConfig(**geometry, tie_embeddings=True, dtype=torch.float32)

    def make_engine():
        eng = InferenceEngine(mc, InferConfig(cache_dtype=torch.float32,
                                              **infer),
                              device=DEVICE, generator=torch.Generator(
                                  device=DEVICE).manual_seed(0))
        eng.warmup()
        if faults is not None:
            eng.arm_faults(faults())
        return eng

    return make_engine


def _sse_lines(resp, on_first_chunk=None):
    """The SSE messages of a streaming response; calls on_first_chunk once
    the first chunk has arrived."""
    buf, fired = b'', False
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            raise RuntimeError('stream ended without done event')
        buf += chunk
        while b'\n\n' in buf:
            ev, buf = buf.split(b'\n\n', 1)
            for line in ev.split(b'\n'):
                if line.startswith(b'data: '):
                    msg = json.loads(line[6:])
                    yield msg
                    if msg.get('done'):
                        return
        if not fired and on_first_chunk is not None:
            fired = True
            on_first_chunk()


def _failover_stream(port: int, payload: dict, on_first_chunk=None):
    """Stream /generate via the LB; returns (latency_s, done message).
    Calls on_first_chunk after the first chunk arrives."""
    conn = HTTPConnection('127.0.0.1', port, timeout=120)
    t0 = time.time()
    try:
        conn.request('POST', '/generate',
                     body=json.dumps(payload).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f'HTTP {resp.status}')
        done = None
        for msg in _sse_lines(resp, on_first_chunk):
            if msg.get('done'):
                done = msg
        return time.time() - t0, done
    finally:
        conn.close()


def _ttft_stream(port: int, tokens, max_new: int = 8, **fields):
    """(ttft_s, output_tokens) for one stream through the LB; extra fields
    (priority, tenant_id) go into the request body."""
    conn = HTTPConnection('127.0.0.1', port, timeout=300)
    t0 = time.time()
    try:
        conn.request('POST', '/generate',
                     body=json.dumps({'tokens': tokens,
                                      'max_new_tokens': max_new,
                                      'stream': True, **fields}).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f'HTTP {resp.status}')
        ttft, done = None, None
        for msg in _sse_lines(resp):
            if msg.get('done'):
                done = msg
            elif ttft is None and msg.get('tokens'):
                ttft = time.time() - t0
        if done.get('finish_reason') not in ('length', 'eos'):
            raise RuntimeError(f'finish_reason={done.get("finish_reason")}'
                               f' error={done.get("error")!r}')
        return ttft if ttft is not None else time.time() - t0, \
            done['output_tokens']
    finally:
        conn.close()


def _qos_stream(port: int, tokens, max_new: int, priority: str,
                tenant: str):
    return _ttft_stream(port, tokens, max_new, priority=priority,
                        tenant_id=tenant)


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


# ------------------------------------------------- failover section

FAILOVER_GEOMETRY = dict(name='lbbench-t', vocab_size=101, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_seq_len=128)
FAILOVER_INFER = dict(num_slots=4, max_cache_len=64,
                      prefill_buckets=(8, 16, 32), max_new_tokens=32,
                      decode_steps=4, kv_block_size=8,
                      auto_prefix_cache=True, host_kv_bytes=32 << 20)


def _failover_faults():
    from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
    # Stretch the stream across loop passes so the mid-stream kill has a
    # mid-stream to land in (sleep only; both arms pay it alike).
    return FaultPlan(seed=0, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=0.04)])


def run_failover_bench(iters: int, out=None, make_engine=None) -> dict:
    """Clean vs killed-and-resumed stream latency through the LB, then
    the warm-drain handoff.  make_engine: the replicas' factory (default:
    the section's tiny model, warmed up, with a stall fault armed)."""
    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    make_engine = make_engine or _tiny_engine_factory(
        FAILOVER_GEOMETRY, FAILOVER_INFER, _failover_faults)
    payload = {'tokens': [3, 14, 15, 9, 2, 6], 'max_new_tokens': 24,
               'stream': True}
    fleet = _fleet(make_engine, 2)
    fleet.start()
    try:
        def settle():
            deadline = time.time() + 60
            while time.time() < deadline:
                if len(fleet.live_replicas()) == 2 and not \
                        fleet.lb_stats()['breaker_open_now']:
                    return
                time.sleep(0.05)
            raise TimeoutError('fleet never settled')

        _, ref_done = _failover_stream(fleet.lb.port, payload)
        reference = ref_done['output_tokens']

        clean, resumed = [], []
        for _ in range(iters):
            lat, done = _failover_stream(fleet.lb.port, payload)
            assert done['output_tokens'] == reference
            clean.append(lat)
        for i in range(iters):
            settle()
            lat, done = _failover_stream(
                fleet.lb.port, payload,
                on_first_chunk=lambda: fleet.kill_one())
            if not done.get('resumed'):
                raise RuntimeError(
                    f'iteration {i}: stream was not resumed ({done})')
            if done['output_tokens'] != reference:
                raise RuntimeError(f'iteration {i}: tokens diverged')
            resumed.append(lat)
            fleet.respawn_dead()
        # Warm-drain handoff: cache a hot prefix DIRECTLY on one replica,
        # drain it, wait for the LB's hot-set handoff to land on the
        # survivor, then compare the survivor's TTFT for the handed-off
        # prefix against cold same-shape prefixes.  The reference's hot
        # prefix is [5] * 24, which the port's warm-up has already put in
        # every replica's tree (its largest-bucket prompt is [5] * 62):
        # this one no warm-up prompt seeds.
        settle()
        hot = [61] * 24
        src, dst = fleet.replicas[0], fleet.replicas[1]
        for k in range(3):
            _ttft_stream(src.port, hot + [9 + k], max_new=4)
        urllib.request.urlopen(urllib.request.Request(
            f'http://127.0.0.1:{src.port}/drain', data=b'{}',
            headers={'Content-Type': 'application/json'}), timeout=10)
        deadline = time.time() + 30
        while time.time() < deadline and \
                dst.server.engine.handoff_stats['adopted'] == 0:
            time.sleep(0.1)
        adopted = dst.server.engine.handoff_stats['adopted']
        radix0 = dict(dst.server.engine.radix_stats)
        hot_ttfts = [_ttft_stream(fleet.lb.port, hot + [40 + k],
                                           max_new=4)[0]
                     for k in range(4)]
        radix1 = dict(dst.server.engine.radix_stats)
        cold_ttfts = [_ttft_stream(fleet.lb.port,
                                            [50 + k] * 24 + [9],
                                            max_new=4)[0]
                      for k in range(4)]
        drain = {
            'adopted_blocks': adopted,
            'survivor_hot_radix_hits': radix1['hits'] - radix0['hits'],
            'prefill_tokens_avoided':
                radix1['tokens_reused'] - radix0['tokens_reused'],
            'survivor_hot_ttft_p50_s': statistics.median(hot_ttfts),
            'survivor_cold_ttft_p50_s': statistics.median(cold_ttfts),
        }
        stats = fleet.lb_stats()
    finally:
        fleet.stop()

    row = {
        'iters': iters,
        'clean_p50_s': statistics.median(clean),
        'clean_p99_s': _pct(clean, 0.99),
        'failover_p50_s': statistics.median(resumed),
        'failover_p99_s': _pct(resumed, 0.99),
        'added_p50_s': statistics.median(resumed) -
                       statistics.median(clean),
        'added_p99_s': _pct(resumed, 0.99) - _pct(clean, 0.99),
        'streams_resumed': stats['streams_resumed'],
        'failovers': stats['failovers'],
        'warm_boot': True,
        'hot_handoffs': stats['hot_handoffs'],
        'handoff_prefixes': stats['handoff_prefixes'],
        'drain_handoff': drain,
        'output_tokens': reference,
        'model': f'tiny ({torch.device(DEVICE).type})',
        'measured_at': 'load_balancer_endpoint',
    }
    print(json.dumps(row, indent=2), flush=True)
    _merge_out(out, 'failover', [row], append=True)
    return row


# ------------------------------------------------- affinity section

AFFINITY_GEOMETRY = dict(name='affinity-bench', vocab_size=101,
                         hidden_size=128, intermediate_size=256,
                         num_layers=4, num_heads=4, num_kv_heads=2,
                         max_seq_len=512)
# The 192 bucket matters: a 50%-overlap match leaves a 192-token suffix,
# and without a bucket that fits beside the match (start + bucket <=
# max_cache_len) the engine abandons the match and prefills it all.
AFFINITY_INFER = dict(num_slots=4, max_cache_len=448,
                      prefill_buckets=(64, 192, 448), max_new_tokens=8,
                      decode_steps=4, kv_block_size=16, kv_blocks=384,
                      auto_prefix_cache=True)


def _affinity_prompts(groups: int, per_group: int, overlap: float,
                      prompt_len: int = 384, block: int = 16):
    """`groups` families of prompts sharing a block-aligned head of
    ~overlap * prompt_len tokens, each with a distinct tail."""
    shared = max(block, int(prompt_len * overlap) // block * block)
    specs = []
    for g in range(groups):
        head = [(g * 131 + 7 * j) % 97 + 1 for j in range(shared)]
        for r in range(per_group):
            tail = [(g * 17 + r * 29 + 3 * j) % 97 + 1
                    for j in range(prompt_len - shared)]
            specs.append({'group': g, 'req': r, 'tokens': head + tail})
    return specs


def _run_affinity_arm(make_engine, n_replicas: int, policy: str,
                      specs, width: int):
    """One fleet arm: fresh replicas (cold radix trees), `width`
    concurrent client lanes draining the spec list in order.  Returns
    (ttfts_by_spec, outputs_by_spec, fleet_radix, policy_stats)."""
    import queue as queue_mod

    fleet = _fleet(make_engine, n_replicas, policy)
    fleet.start()
    try:
        ttfts, outputs = {}, {}
        q = queue_mod.Queue()
        for spec in specs:
            q.put(spec)
        errors = []

        def lane():
            while True:
                try:
                    spec = q.get_nowait()
                except queue_mod.Empty:
                    return
                key = (spec['group'], spec['req'])
                try:
                    ttfts[key], outputs[key] = _ttft_stream(
                        fleet.lb.port, spec['tokens'])
                except Exception as e:  # noqa: BLE001 -- raised below
                    errors.append(f'{key}: {e}')

        lanes = [threading.Thread(target=lane, daemon=True)
                 for _ in range(width)]
        for t in lanes:
            t.start()
        for t in lanes:
            t.join(timeout=600)
        if errors:
            raise RuntimeError(f'affinity arm failed: {errors[:3]}')
        hits = lookups = 0
        for rep in fleet.replicas:
            radix = rep.server.engine.kv_health()['radix']
            hits += radix['hits']
            lookups += radix['lookups']
        return ttfts, outputs, \
            {'hits': hits, 'lookups': lookups,
             'hit_rate': hits / lookups if lookups else 0.0}, \
            fleet.lb.policy.stats()
    finally:
        fleet.stop()


def run_affinity_bench(out=None, n_replicas: int = 3, groups: int = 8,
                       per_group: int = 6, overlaps=(0.5, 0.9),
                       make_engine=None) -> dict:
    """Shared-system-prompt TTFT sweep: prefix_affinity vs least_load
    through N replicas, with a single-replica arm as the radix-cache
    ceiling.  Greedy outputs must be byte-identical across every arm
    (routing may never change tokens).  Returns the section, with each
    overlap's outputs by (group, req)."""
    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    make_engine = make_engine or _tiny_engine_factory(AFFINITY_GEOMETRY,
                                                      AFFINITY_INFER)
    # Every arm sees the same offered load (one lane per fleet replica).
    width = n_replicas
    arms = [('single_replica', 1, 'least_load', width),
            ('least_load', n_replicas, 'least_load', width),
            ('prefix_affinity', n_replicas, 'prefix_affinity', width)]
    rows, summary, outputs_by_overlap = [], [], {}
    for overlap in overlaps:
        specs = _affinity_prompts(groups, per_group, overlap)
        # Interleave groups so concurrent lanes carry different families.
        specs.sort(key=lambda s: (s['req'], s['group']))
        arm_ttfts, arm_outputs = {}, {}
        for name, n, policy, width in arms:
            print(f'-- overlap={overlap} arm={name} ({n} replicas, '
                  f'{len(specs)} requests)', flush=True)
            ttfts, outputs, radix, pstats = _run_affinity_arm(
                make_engine, n, policy, specs, width)
            arm_ttfts[name], arm_outputs[name] = ttfts, outputs
            vals = sorted(ttfts.values())
            row = {
                'overlap': overlap,
                'arm': name,
                'n_replicas': n,
                'client_width': width,
                'groups': groups,
                'requests': len(specs),
                'ttft_p50_s': statistics.median(vals),
                'ttft_mean_s': statistics.mean(vals),
                'ttft_p99_s': _pct(vals, 0.99),
                'fleet_radix_hit_rate': radix['hit_rate'],
                'fleet_radix_hits': radix['hits'],
                'fleet_radix_lookups': radix['lookups'],
            }
            if policy == 'prefix_affinity':
                row['affinity_hits'] = pstats['affinity_hits']
                row['affinity_spills'] = pstats['affinity_spills']
            print(json.dumps(row), flush=True)
            rows.append(row)
        # Routing must never change tokens: every arm byte-identical.
        for name in ('least_load', 'prefix_affinity'):
            if arm_outputs[name] != arm_outputs['single_replica']:
                raise RuntimeError(
                    f'greedy outputs diverged between single_replica '
                    f'and {name} at overlap {overlap}')
        outputs_by_overlap[overlap] = arm_outputs['single_replica']
        p50 = {name: statistics.median(sorted(arm_ttfts[name].values()))
               for name, *_ in arms}
        summary.append({
            'overlap': overlap,
            'speedup_vs_least_load':
                p50['least_load'] / p50['prefix_affinity'],
            'vs_single_replica':
                p50['prefix_affinity'] / p50['single_replica'],
            'outputs_byte_identical': True,
        })
        print(json.dumps(summary[-1]), flush=True)
    section = {'rows': rows, 'summary': summary,
               'model': f'tiny ({torch.device(DEVICE).type})',
               'measured_at': 'load_balancer_endpoint'}
    _merge_out(out, 'affinity', section)
    return {**section, 'outputs': outputs_by_overlap}


# --------------------------------------------- gray-failure section

GRAY_INFER = dict(num_slots=4, max_cache_len=64,
                  prefill_buckets=(8, 16, 32), max_new_tokens=16,
                  decode_steps=4, kv_block_size=8, auto_prefix_cache=True)


def _gray_env(overrides: dict):
    """Apply SKYTPU_LB_* knob overrides for one arm; returns a restore
    callable.  The LB reads these at construction (hedge deadline) and at
    breaker materialisation (probation knobs), so they must be in place
    before the fleet is built."""
    saved = {k: os.environ.get(k) for k in overrides}
    for k, v in overrides.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)

    def restore():
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
    return restore


def run_gray_bench(out=None, n_replicas: int = 3,
                   requests_per_arm: int = 90, lanes: int = 3,
                   delay_s: float = 0.35, make_engine=None) -> dict:
    """Gray-failure TTFT: one replica of a 3-replica fleet rots (every
    response chunk delayed ~delay_s by a seeded network proxy -- alive,
    never failing, just slow) while client lanes stream through the LB.
    Arms: ``no_ejection`` (probation off, no hedging) and
    ``ejection_hedge`` (default probation + TTFT hedging at 250 ms).
    Rescue may never change tokens."""
    from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    make_engine = make_engine or _tiny_engine_factory(FAILOVER_GEOMETRY,
                                                      GRAY_INFER)
    prompts = [[(11 * i + 5 * j) % 97 + 1 for j in range(10)]
               for i in range(6)]

    def run_arm(name: str, env: dict):
        restore = _gray_env(env)
        fleet = None
        try:
            fleet = _fleet(make_engine, n_replicas)
            fleet.start()
            plan = FaultPlan(seed=1, specs=[
                FaultSpec(site='net_degrade', prob=1.0,
                          delay_s=delay_s, jitter_s=0.05)])
            proxy = fleet.degrade_one(0, plan, seed=1)
            ttfts, outputs, errors = [], {}, []
            lock = threading.Lock()
            pending = list(range(requests_per_arm))

            def lane():
                while True:
                    with lock:
                        if not pending or errors:
                            return
                        i = pending.pop()
                    key = i % len(prompts)
                    try:
                        ttft, toks = _ttft_stream(
                            fleet.lb.port, prompts[key], max_new=8)
                    except Exception as e:  # noqa: BLE001 -- raised below
                        with lock:
                            errors.append(f'req {i}: {e}')
                        return
                    with lock:
                        ttfts.append(ttft)
                        if outputs.setdefault(key, toks) != toks:
                            errors.append(f'divergence at prompt {key}')

            threads = [threading.Thread(target=lane, daemon=True)
                       for _ in range(lanes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if errors:
                raise RuntimeError(f'gray arm {name}: {errors[:3]}')
            stats = fleet.lb_stats()
            vals = sorted(ttfts)
            row = {
                'arm': name,
                'requests': len(vals),
                'degraded_replicas': 1,
                'chunk_delay_s': delay_s,
                'ttft_p50_s': statistics.median(vals),
                'ttft_p95_s': _pct(vals, 0.95),
                'ttft_p99_s': _pct(vals, 0.99),
                'hedges': stats['hedges'],
                'hedge_wins': stats['hedge_wins'],
                'hedge_cancelled': stats['hedge_cancelled'],
                'probation_replicas': stats['probation_replicas'],
                'degraded_in_probation':
                    proxy.url in stats['probation_replicas'],
                'chunks_delayed': proxy.chunks_delayed,
            }
            print(json.dumps(row), flush=True)
            return row, outputs
        finally:
            if fleet is not None:
                fleet.stop()
            restore()

    arms = [
        ('no_ejection', {'SKYTPU_LB_PROBATION_K': '1e9',
                         'SKYTPU_LB_HEDGE_MS': None}),
        ('ejection_hedge', {'SKYTPU_LB_PROBATION_K': None,
                            'SKYTPU_LB_HEDGE_MS': '250'}),
    ]
    rows, outs = {}, {}
    for name, env in arms:
        print(f'-- gray arm={name}', flush=True)
        rows[name], outs[name] = run_arm(name, env)
    if outs['ejection_hedge'] != outs['no_ejection']:
        raise RuntimeError('greedy outputs diverged between gray arms')
    summary = {
        'p99_no_ejection_s': rows['no_ejection']['ttft_p99_s'],
        'p99_ejection_hedge_s': rows['ejection_hedge']['ttft_p99_s'],
        'p99_speedup':
            rows['no_ejection']['ttft_p99_s'] /
            rows['ejection_hedge']['ttft_p99_s'],
        'p99_improved':
            rows['ejection_hedge']['ttft_p99_s'] <
            rows['no_ejection']['ttft_p99_s'],
        'outputs_byte_identical': True,
    }
    print(json.dumps(summary), flush=True)
    section = {'rows': list(rows.values()), 'summary': summary,
               'model': f'tiny ({torch.device(DEVICE).type})',
               'measured_at': 'load_balancer_endpoint'}
    _merge_out(out, 'gray_failure', section)
    return {**section, 'outputs': outs['no_ejection']}


# ------------------------------------------------------ qos section

QOS_GEOMETRY = dict(name='qos-bench', vocab_size=101, hidden_size=64,
                    intermediate_size=128, num_layers=2, num_heads=4,
                    num_kv_heads=2, max_seq_len=256)


def _qos_infer(qos: bool) -> dict:
    # Largest bucket 32 so the 96-token batch prompts take the chunked
    # path -- that is what makes them preemptible.
    return dict(num_slots=2, max_cache_len=192, prefill_buckets=(16, 32),
                max_new_tokens=16, decode_steps=4, kv_block_size=16,
                kv_blocks=160, prefill_chunk=16, auto_prefix_cache=True,
                qos=qos)


def _batch_prompt(lane: int, seq: int, n: int = 96):
    return [(lane * 131 + seq * 37 + 5 * j) % 97 + 1 for j in range(n)]


def _interactive_prompt(i: int, n: int = 12):
    return [(i * 41 + 7 * j) % 97 + 1 for j in range(n)]


def run_qos_bench(out=None, interactive_n: int = 128,
                  batch_lanes: int = 4, make_engine=None) -> dict:
    """2x-overload QoS protection: one replica (2 decode slots, chunked
    prefill + radix), `batch_lanes` closed-loop batch lanes keeping 2x
    the slot count outstanding, and an open-loop interactive tenant
    measuring TTFT through the LB.  Arms: uncontended (the SLO floor),
    fifo (QoS off) and qos (WFQ + priority + chunk-boundary preemption).
    QoS only reorders: completed greedy streams are byte-identical across
    arms.  make_engine(qos) builds a replica's engine."""
    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')

    def factory(qos: bool):
        if make_engine is not None:
            return lambda: make_engine(qos)
        return _tiny_engine_factory(QOS_GEOMETRY, _qos_infer(qos))

    def run_arm(name: str, qos: bool, flood: bool):
        fleet = _fleet(factory(qos), 1)
        fleet.start()
        try:
            port = fleet.lb.port
            # Warm the qos-only resume path: a parked job resumes as a
            # radix suffix-only prefill of each residual class.
            warm = [89] * 96
            _qos_stream(port, warm, 16, 'batch', 'warm')
            _qos_stream(port, warm[:80] + [23] * 16, 4, 'batch', 'warm')
            _qos_stream(port, warm[:64] + [29] * 32, 4, 'batch', 'warm')
            _qos_stream(port, warm[:32] + [31] * 64, 4, 'batch', 'warm')
            stop = threading.Event()
            batch_out, batch_err = {}, []

            def lane(lane_id: int):
                seq = 0
                while not stop.is_set():
                    key = (lane_id, seq)
                    try:
                        _, toks = _qos_stream(
                            port, _batch_prompt(lane_id, seq), 8,
                            'batch', 'bulk')
                        batch_out[key] = toks
                    except Exception as e:  # noqa: BLE001 -- raised below
                        batch_err.append(f'{key}: {e}')
                        return
                    seq += 1

            lanes = []
            if flood:
                lanes = [threading.Thread(target=lane, args=(i,),
                                          daemon=True)
                         for i in range(batch_lanes)]
                for t in lanes:
                    t.start()
                time.sleep(0.5)       # the flood reaches steady overload
            ttfts, inter_out = [], {}
            for i in range(interactive_n):
                ttft, toks = _qos_stream(port, _interactive_prompt(i),
                                         4, 'interactive', 'live')
                ttfts.append(ttft)
                inter_out[i] = toks
                time.sleep(0.05)
            stop.set()
            for t in lanes:
                t.join(timeout=120)
            if batch_err:
                raise RuntimeError(f'batch lane failed: {batch_err[:3]}')
            eng = fleet.replicas[0].server.engine
            vals = sorted(ttfts)
            row = {
                'arm': name,
                'interactive_requests': interactive_n,
                'batch_completed': len(batch_out),
                'ttft_p50_s': statistics.median(vals),
                'ttft_p95_s': _pct(vals, 0.95),
                'ttft_p99_s': _pct(vals, 0.99),
                'preemptions': eng.qos_stats['preemptions'],
                'sheds': eng.qos_stats['sheds'],
            }
            print(json.dumps(row), flush=True)
            return row, inter_out, batch_out
        finally:
            fleet.stop()

    rows, inter_outs, batch_outs = {}, {}, {}
    for name, qos, flood in [('uncontended', True, False),
                             ('fifo', False, True),
                             ('qos', True, True)]:
        print(f'-- qos arm={name}', flush=True)
        rows[name], inter_outs[name], batch_outs[name] = run_arm(
            name, qos, flood)
    for name in ('fifo', 'qos'):
        if inter_outs[name] != inter_outs['uncontended']:
            raise RuntimeError(
                f'interactive outputs diverged: {name} vs uncontended')
    common = set(batch_outs['fifo']) & set(batch_outs['qos'])
    for key in common:
        if batch_outs['fifo'][key] != batch_outs['qos'][key]:
            raise RuntimeError(f'batch outputs diverged at {key}')
    summary = {
        'overload': f'{2}x (closed-loop batch lanes = 2x decode slots)',
        'interactive_p99_vs_uncontended_fifo':
            rows['fifo']['ttft_p99_s'] / rows['uncontended']['ttft_p99_s'],
        'interactive_p99_vs_uncontended_qos':
            rows['qos']['ttft_p99_s'] / rows['uncontended']['ttft_p99_s'],
        'within_1_5x':
            rows['qos']['ttft_p99_s'] <=
            1.5 * rows['uncontended']['ttft_p99_s'],
        'batch_absorbed_queueing':
            rows['qos']['batch_completed'] > 0,
        'outputs_byte_identical': True,
        'batch_keys_compared': len(common),
    }
    print(json.dumps(summary), flush=True)
    section = {'rows': list(rows.values()), 'summary': summary,
               'model': f'tiny ({torch.device(DEVICE).type})',
               'measured_at': 'load_balancer_endpoint'}
    _merge_out(out, 'qos', section)
    return {**section, 'outputs': inter_outs['uncontended']}


# ---------------------------------------------------- batch section

BATCH_INFER = dict(num_slots=4, max_cache_len=128, prefill_buckets=(16, 32),
                   max_new_tokens=16, decode_steps=4, kv_block_size=16,
                   kv_blocks=160, auto_prefix_cache=True, qos=True)


def run_batch_bench(out=None, n_replicas: int = 2, n_rows: int = 48,
                    row_workers: int = 4, interactive_slo_s: float = 2.0,
                    make_engine=None) -> dict:
    """Bulk-inference goodput: the same `n_rows` greedy rows pushed
    through the fleet as online interactive streams from `row_workers`
    lanes, and as one ``/v1/batches`` job (journaled rows dispatched as
    QoS batch-class requests by the BatchCoordinator), with an open-loop
    interactive tenant probing TTFT throughout.  Greedy outputs must be
    byte-identical between arms."""
    import tempfile

    from skypilot_tpu.serve.batch import BatchCoordinator

    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    make_engine = make_engine or _tiny_engine_factory(QOS_GEOMETRY,
                                                      BATCH_INFER)
    rows = [_batch_prompt(0, i, n=24) for i in range(n_rows)]
    max_new = 16

    def run_arm(name, drive):
        """drive(port) -> (outputs_by_idx, n_output_tokens); a fresh fleet
        per arm keeps the radix state equal."""
        fleet = _fleet(make_engine, n_replicas)
        fleet.start()
        try:
            port = fleet.lb.port
            _qos_stream(port, _interactive_prompt(0), 4,
                        'interactive', 'live')
            stop = threading.Event()
            ttfts, probe_err = [], []

            def prober():
                i = 0
                while not stop.is_set():
                    try:
                        ttft, _ = _qos_stream(
                            port, _interactive_prompt(i), 4,
                            'interactive', 'live')
                        ttfts.append(ttft)
                    except Exception as e:  # noqa: BLE001 -- raised below
                        probe_err.append(str(e))
                        return
                    i += 1
                    time.sleep(0.05)

            pt = threading.Thread(target=prober, daemon=True)
            pt.start()
            t0 = time.time()
            outputs, out_tokens = drive(port)
            elapsed = time.time() - t0
            stop.set()
            pt.join(timeout=60)
            if probe_err:
                raise RuntimeError(f'{name} prober died: {probe_err[:1]}')
            vals = sorted(ttfts)
            row = {
                'arm': name,
                'rows': n_rows,
                'row_workers': row_workers,
                'elapsed_s': elapsed,
                'rows_per_s': n_rows / elapsed,
                'goodput_tokens_per_s': out_tokens / elapsed,
                'interactive_probes': len(vals),
                'interactive_ttft_p50_s': statistics.median(vals),
                'interactive_ttft_p99_s': _pct(vals, 0.99),
            }
            print(json.dumps(row), flush=True)
            return row, outputs
        finally:
            fleet.stop()

    def drive_online(port):
        outputs, errors = {}, []
        lock = threading.Lock()
        pending = list(range(n_rows))

        def lane():
            while True:
                with lock:
                    if not pending or errors:
                        return
                    i = pending.pop()
                try:
                    _, toks = _qos_stream(port, rows[i], max_new,
                                          'interactive', 'bulk')
                except Exception as e:  # noqa: BLE001 -- raised below
                    with lock:
                        errors.append(f'row {i}: {e}')
                    return
                with lock:
                    outputs[i] = toks

        lanes = [threading.Thread(target=lane, daemon=True)
                 for _ in range(row_workers)]
        for t in lanes:
            t.start()
        for t in lanes:
            t.join(timeout=600)
        if errors:
            raise RuntimeError(f'online arm failed: {errors[:3]}')
        return outputs, sum(len(t) for t in outputs.values())

    def drive_batch(port):
        with tempfile.TemporaryDirectory() as tmp:
            coord = BatchCoordinator(
                os.path.join(tmp, 'batch_journal.jsonl'), port,
                spool_dir=os.path.join(tmp, 'spool'),
                row_workers=row_workers)
            try:
                jid = coord.submit(rows, max_new,
                                   completion_window_s=600.0,
                                   job_id='bench')
                if not coord.join(jid, timeout=600):
                    raise RuntimeError(
                        f'batch job never finished: {coord.status(jid)}')
                st = coord.status(jid)
                if st['state'] != 'done':
                    raise RuntimeError(f'batch job failed: {st}')
                outputs = {}
                with open(coord.result_path(jid)) as fh:
                    for line in fh:
                        rec = json.loads(line)
                        outputs[rec['row']] = rec['output_tokens']
                return outputs, sum(len(t) for t in outputs.values())
            finally:
                coord.stop()

    results = {}
    for name, drive in [('online', drive_online),
                        ('batch_plane', drive_batch)]:
        print(f'-- batch arm={name}', flush=True)
        results[name] = run_arm(name, drive)
    if results['batch_plane'][1] != results['online'][1]:
        raise RuntimeError('greedy outputs diverged between the online '
                           'and batch-plane arms')
    on, bp = results['online'][0], results['batch_plane'][0]
    summary = {
        'interactive_slo_s': interactive_slo_s,
        'goodput_ratio_batch_vs_online':
            bp['goodput_tokens_per_s'] / on['goodput_tokens_per_s'],
        'interactive_p99_online_s': on['interactive_ttft_p99_s'],
        'interactive_p99_batch_s': bp['interactive_ttft_p99_s'],
        'interactive_p99_within_slo':
            bp['interactive_ttft_p99_s'] <= interactive_slo_s,
        'outputs_byte_identical': True,
    }
    print(json.dumps(summary), flush=True)
    section = {'rows': [on, bp], 'summary': summary,
               'model': f'tiny ({torch.device(DEVICE).type})',
               'measured_at': 'load_balancer_endpoint'}
    _merge_out(out, 'batch_plane', section)
    return {**section, 'outputs': results['online'][1]}


# ------------------------------------------------------- the sweep


def replica_command(args) -> str:
    """The serve-up replica's command: the reference's flags, the port's
    command line."""
    num_slots = args.num_slots if args.num_slots is not None else \
        (None if args.profile else 48)
    return (
        'python -m skypilot_tpu_torch.cli infer serve '
        '--model llama2-7b --weight-dtype int8 --cache-dtype fp8 '
        + (f'--profile {args.profile} ' if args.profile else '')
        + (f'--num-slots {num_slots} '
           if num_slots is not None else '')
        + (f'--decode-steps {args.decode_steps} '
           if args.decode_steps is not None else '')
        + '--max-cache-len 512 '
        + (f'--max-ttft {args.max_ttft} '
           if args.max_ttft is not None else '')
        + (f'--max-queue {args.max_queue} '
           if args.max_queue is not None else '')
        + '--port $SKYTPU_SERVE_REPLICA_PORT')


def serve_up(args):
    """Bring the service up on the local cloud (controller, prober, LB;
    one replica running replica_command) and wait for READY.  Returns
    (service name, endpoint)."""
    from skypilot_tpu import Resources, Task, state
    from skypilot_tpu.serve import core as serve_core
    from skypilot_tpu.serve.service_spec import SkyTpuServiceSpec

    state.set_enabled_clouds(['local'])
    task = Task('llama-serve-bench', run=replica_command(args))
    task.set_resources(Resources(cloud='local'))
    task.set_service(SkyTpuServiceSpec.from_yaml_config({
        'readiness_probe': {'path': '/health',
                            'initial_delay_seconds': 1800},
        'replica_policy': {'min_replicas': 1, 'max_replicas': 1},
        'port': 8100,
    }))
    name, endpoint = serve_core.up(task, service_name=args.service_name)
    print(f'service {name} at {endpoint}; waiting for READY...',
          flush=True)
    deadline = time.time() + 1800
    while time.time() < deadline:
        svcs = serve_core.status([name])
        if svcs and svcs[0]['status'] == 'READY':
            return name, endpoint
        time.sleep(5)
    raise TimeoutError('replica never became READY')


def run_sweep(args) -> list:
    """The Poisson sweep at each --qps through --endpoint (else a service
    brought up here, and down at the end unless --keep-up)."""
    qps_list = args.qps or [2.0, 3.5]
    endpoint, name = args.endpoint, args.service_name
    if endpoint is None:
        name, endpoint = serve_up(args)
    print(f'driving load at {endpoint}', flush=True)
    # Warm the serving path.  The LB's replica list syncs on an interval,
    # so READY can precede routability: retry until the path is live.
    deadline = time.time() + 300
    while True:
        try:
            _post_stream(endpoint, list(range(4, 4 + PROMPT_LEN)), 4)
            break
        except Exception as e:  # noqa: BLE001 -- retried until deadline
            if time.time() > deadline:
                raise
            print(f'warm request not routable yet ({e}); retrying',
                  flush=True)
            time.sleep(5)

    rows = []
    for qps in qps_list:
        n = max(int(qps * args.requests_per_qps), 16)
        print(f'-- qps {qps} ({n} requests)', flush=True)
        row = run_sweep_row(endpoint, qps, n)
        if args.profile:
            row['profile'] = args.profile
        print(json.dumps(row), flush=True)
        rows.append(row)
    _merge_out(args.out, 'serve_plane_sweep', rows, append=True)
    if not args.keep_up and args.endpoint is None:
        from skypilot_tpu.serve import core as serve_core
        serve_core.down([name])
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--qps', action='append', type=float, default=[])
    p.add_argument('--requests-per-qps', type=int, default=48,
                   help='num_requests = qps * this (at least 16)')
    p.add_argument('--num-slots', type=int, default=None)
    p.add_argument('--decode-steps', type=int, default=None)
    p.add_argument('--profile', default=None,
                   choices=['latency', 'throughput'],
                   help='replica operating point (infer serve --profile); '
                        'explicit --num-slots/--decode-steps still win')
    p.add_argument('--max-ttft', type=float, default=None,
                   help='replica admission bound (s); sheds count in the '
                        'sweep rows')
    p.add_argument('--max-queue', type=int, default=None,
                   help='replica hard backlog cap (requests)')
    p.add_argument('--service-name', default='lbbench')
    p.add_argument('--out', default=None)
    p.add_argument('--keep-up', action='store_true',
                   help='leave the service running afterwards')
    p.add_argument('--endpoint', default=None,
                   help='reuse an existing endpoint (skip serve up)')
    p.add_argument('--failover', action='store_true',
                   help='the replica-failover latency section '
                        '(in-process fleet)')
    p.add_argument('--failover-iters', type=int, default=6)
    p.add_argument('--affinity', action='store_true',
                   help='the prefix-affinity routing TTFT sweep '
                        '(in-process fleet)')
    p.add_argument('--affinity-replicas', type=int, default=3)
    p.add_argument('--affinity-groups', type=int, default=8)
    p.add_argument('--affinity-per-group', type=int, default=6)
    p.add_argument('--gray', action='store_true',
                   help='the gray-failure ejection/hedging TTFT section '
                        '(in-process fleet)')
    p.add_argument('--gray-requests', type=int, default=90,
                   help='requests per gray arm (p99 needs enough draws)')
    p.add_argument('--qos', action='store_true',
                   help='the 2x-overload QoS protection section '
                        '(in-process fleet)')
    p.add_argument('--qos-interactive', type=int, default=128,
                   help='interactive sample count (p99 needs enough '
                        'draws to not be the single max)')
    p.add_argument('--qos-batch-lanes', type=int, default=4)
    p.add_argument('--batch', action='store_true',
                   help='the batch-plane vs online goodput section '
                        '(in-process fleet)')
    p.add_argument('--batch-rows', type=int, default=48)
    p.add_argument('--device', default='cuda',
                   help="the in-process replicas' device: cuda or cpu")
    return p


def main(argv=None) -> int:
    global DEVICE
    args = parser().parse_args(argv)
    fleet = args.batch or args.failover or args.gray or args.qos or \
        args.affinity
    if fleet:
        if args.device != 'cpu' and not torch.cuda.is_available():
            print('bench_serve_lb_torch: no CUDA device is visible (pass '
                  '--device cpu to run on the CPU)', file=sys.stderr)
            return 1
        DEVICE = args.device
    if args.batch:
        run_batch_bench(args.out, n_rows=args.batch_rows)
    elif args.failover:
        run_failover_bench(args.failover_iters, args.out)
    elif args.gray:
        run_gray_bench(args.out, requests_per_arm=args.gray_requests)
    elif args.qos:
        run_qos_bench(args.out, interactive_n=args.qos_interactive,
                      batch_lanes=args.qos_batch_lanes)
    elif args.affinity:
        run_affinity_bench(args.out, n_replicas=args.affinity_replicas,
                           groups=args.affinity_groups,
                           per_group=args.affinity_per_group)
    else:
        run_sweep(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
