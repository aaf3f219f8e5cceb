#!/usr/bin/env python3
"""Microbenchmarks of the serving features on the PyTorch port: the twin
of ``scripts/bench_features.py`` over ``skypilot_tpu_torch``.

Measures, with the reference's 7B-config int8 + fp8-KV engine (llama2-7b,
int8 weights drawn at random from seed 0, the fp8 e4m3 cache):

1. **Prefix KV caching** -- TTFT for a 1088-token prompt with and without
   its 1024-token prefix registered (the reuse path forwards the suffix).
2. **Chunked prefill** -- lone-stream TTFT of a 1100-token prompt chunked
   against the monolithic bucket.
3. **Speculative decoding** -- offline throughput and acceptance with
   prompt-lookup drafting against the windowed decode (random weights:
   greedy output collapses to repetition, so this is the grounded
   regime's upper bound, not open-ended traffic), and
4. **the dispatch cost** of the two decode shapes (a full window against
   one [B, 1+D] verify) with the break-even acceptance it implies.
5. **KV occupancy** of the paged pool through one episode (stats()).
6. **Fault containment** -- armed-but-unfired overhead and an attributed
   mid-batch fault that fails one request while the rest finish.
7. **Radix prefix caching** at the shared-system-prompt shape.
8. **LB affinity** -- a policy-level fleet-cache replay through the serve
   plane's load-balancing policies (the only section that imports the JAX
   package's JAX-free serve plane; it runs where that plane's
   dependencies are installed, and ``--no-lb`` skips it).
9. **TP capacity** -- the head-sharded pool's slot budget (arithmetic).
10. **The QoS scheduler** -- the port's FifoScheduler and WfqScheduler
    replaying a 2x-overload trace.

``--num-layers N`` cuts the engine's depth (the widths stay the
reference's); ``--device cpu`` runs without a card.  Nothing is written
unless --out is given.

  python scripts/bench_features_torch.py [--reps 5] [--out features.json]
"""
import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from skypilot_tpu_torch.infer import engine as engine_mod  # noqa: E402
from skypilot_tpu_torch.infer.engine import (InferConfig,  # noqa: E402
                                             InferenceEngine, Request)
from skypilot_tpu_torch.infer.faults import FaultPlan, FaultSpec  # noqa: E402
from skypilot_tpu_torch.infer.qos import WfqScheduler  # noqa: E402
from skypilot_tpu_torch.infer.scheduler import FifoScheduler  # noqa: E402
from skypilot_tpu_torch.models.llama import FP8  # noqa: E402
from skypilot_tpu_torch.models.registry import \
    get_model_config  # noqa: E402

# The engines' device and depth (None: the model's), set by main().
DEVICE = 'cuda'
NUM_LAYERS = None


def _model_config():
    mc = dataclasses.replace(get_model_config('llama2-7b'),
                             weight_dtype='int8')
    if NUM_LAYERS is not None:
        mc = dataclasses.replace(mc, num_layers=NUM_LAYERS)
    return mc


def _engine(draft_len=0, num_slots=16, max_cache_len=512,
            prefill_lanes=4, prefill_chunk=0, kv_block_size=0,
            kv_blocks=None, max_prefixes=16, auto_prefix_cache=False):
    """The 7B int8 + fp8-KV engine; slots x cache_len is the memory knob
    (48 x 512 is the serve bench's shape)."""
    cfg = InferConfig(model='llama2-7b', num_slots=num_slots,
                      max_cache_len=max_cache_len, decode_steps=8,
                      cache_dtype=FP8, draft_len=draft_len,
                      prefill_lanes=prefill_lanes,
                      prefill_chunk=prefill_chunk,
                      kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                      max_prefixes=max_prefixes,
                      auto_prefix_cache=auto_prefix_cache)
    return InferenceEngine(_model_config(), cfg, device=DEVICE)


def _collect() -> None:
    """Return a dropped engine's memory (its cache holds gigabytes)."""
    gc.collect()
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.empty_cache()


def bench_prefix(reps: int = 5):
    # Long-prompt shape: 4 slots x 1152 cache, single-lane prefill
    # (single-request TTFT; pad lanes would only burn memory).
    eng = _engine(num_slots=4, max_cache_len=1152, prefill_lanes=1)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 32000, size=1024).tolist()
    suffix = rng.integers(0, 32000, size=64).tolist()

    def ttft_ms(tokens):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            [res] = eng.generate([Request(tokens=list(tokens),
                                          max_new_tokens=1)])
            times.append((time.perf_counter() - t0) * 1000.0)
            assert res.finish_reason == 'length'
        return statistics.median(times)

    # Warm both paths outside the measurement.
    eng.generate([Request(tokens=prefix + suffix, max_new_tokens=1)])
    cold = ttft_ms(prefix + suffix)
    eng.register_prefix(prefix)
    eng.generate([Request(tokens=prefix + suffix, max_new_tokens=1)])
    hot = ttft_ms(prefix + suffix)
    stats = dict(eng.prefix_stats)
    del eng
    _collect()
    return {
        'prompt_len': len(prefix) + len(suffix),
        'prefix_len': len(prefix),
        'prefill_ms_full': round(cold, 1),
        'prefill_ms_prefix_reuse': round(hot, 1),
        'ttft_reduction': round(1.0 - hot / cold, 3),
        'prefix_hits': stats['hits'],
        'prefix_stats': stats,
    }


def bench_chunked_prefill(prefill_chunk: int = 64, reps: int = 3):
    """Chunked-prefill cost at the long-prompt shape: offline TTFT for a
    prompt no bucket holds (chunked engine) against the same prompt
    through the monolithic bucket -- the chunked path trades a little
    lone-stream TTFT (per-chunk dispatches) for a bounded decode stall
    (bench_decode_micro_torch.py's chunk_stall measures that side)."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 32000, size=1100).tolist()

    def ttft_ms(eng):
        eng.generate([Request(tokens=list(prompt), max_new_tokens=1)])
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            [res] = eng.generate([Request(tokens=list(prompt),
                                          max_new_tokens=1)])
            times.append((time.perf_counter() - t0) * 1000.0)
            assert res.finish_reason == 'length'
        return statistics.median(times)

    eng = _engine(num_slots=4, max_cache_len=1152, prefill_lanes=1,
                  prefill_chunk=prefill_chunk)
    chunked = ttft_ms(eng)
    stats = dict(eng.chunk_stats)
    del eng
    _collect()
    eng = _engine(num_slots=4, max_cache_len=1152, prefill_lanes=1)
    mono = ttft_ms(eng)
    del eng
    _collect()
    return {
        'prefill_chunk': prefill_chunk,
        'prompt_len': len(prompt),
        'ttft_ms_chunked': round(chunked, 1),
        'ttft_ms_monolithic': round(mono, 1),
        'ttft_overhead': round(chunked / mono - 1.0, 3),
        'chunk_stats': stats,
    }


def bench_spec(num_requests: int = 32, prompt_len: int = 219,
               new_tokens: int = 188, dispatch_iters: int = 20):
    def run(eng, reqs, label, out):
        # The measurement shape of engine.benchmark, custom prompts.
        eng.generate([Request(tokens=list(reqs[0].tokens),
                              max_new_tokens=2)])
        eng._warm_spec(len(reqs[0].tokens))
        for k in eng.spec_stats:
            eng.spec_stats[k] = 0
        t0 = time.perf_counter()
        results = eng.generate([Request(tokens=list(r.tokens),
                                        max_new_tokens=r.max_new_tokens)
                                for r in reqs])
        elapsed = time.perf_counter() - t0
        st = eng.spec_stats
        row = {
            'output_tokens_per_second': round(
                sum(len(r.output_tokens) for r in results) / elapsed, 1),
            'requests_per_second': round(len(results) / elapsed, 2),
            'spec': dict(st),
        }
        if st['drafted']:
            row['accept_rate'] = round(st['accepted'] / st['drafted'], 3)
        if st['dispatches']:
            row['tokens_per_dispatch'] = round(
                1 + st['accepted'] / st['dispatches'], 2)
        out[label] = row

    rng = np.random.default_rng(0)
    random_reqs = [
        Request(tokens=rng.integers(0, 32000, size=prompt_len).tolist(),
                max_new_tokens=new_tokens) for _ in range(num_requests)
    ]
    out = {}
    eng = _engine(draft_len=0)
    run(eng, random_reqs, 'draft_len_0_random', out)
    del eng
    _collect()
    eng = _engine(draft_len=4)
    run(eng, random_reqs, 'draft_len_4_random', out)
    out['dispatch_cost'] = bench_dispatch_cost(eng, prompt_len,
                                               iters=dispatch_iters)
    del eng
    _collect()
    return out


def bench_dispatch_cost(eng, prompt_len, iters: int = 20):
    """Costs of the two decode dispatch shapes at the full batch: windowed
    = decode_steps sequential [B, 1] forwards in one dispatch; verify =
    one [B, 1+D] forward.  Speculation wins once the accepted tokens per
    slot exceed the break-even this derives."""
    rng = np.random.default_rng(1)
    # Fill every slot with a long-budget request (host-side start only).
    items = []
    for slot in range(eng.cfg.num_slots):
        req = Request(tokens=rng.integers(
            0, 32000, size=prompt_len).tolist(), max_new_tokens=280)
        items.append((req, slot, 0.0, *eng._validate_request(req)))
    eng._start_batch(items)

    def timeit(fn, warm=3):
        for _ in range(warm):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        # The host reads each dispatch's tokens back, so the wall time
        # is already synchronous.
        return (time.perf_counter() - t0) * 1000.0 / iters

    win_ms = timeit(eng._decode_step)
    plain = engine_mod.prompt_lookup_draft
    engine_mod.prompt_lookup_draft = \
        lambda hist, k, nmax: [1, 2, 3, 4][:k]

    def spec():
        eng._accept_ema = 1.0     # keep the policy gate open
        eng._spec_step()

    try:
        spec_ms = timeit(spec)
    finally:
        engine_mod.prompt_lookup_draft = plain
    k = eng.cfg.decode_steps
    return {
        'windowed_ms_per_dispatch': round(win_ms, 2),
        'windowed_tokens_per_dispatch': k,
        'verify_ms_per_dispatch': round(spec_ms, 2),
        'windowed_ms_per_token': round(win_ms / k, 3),
        # Verify yields 1+accepted tokens: the accepted tokens per slot at
        # which speculation matches windowed throughput.
        'break_even_accepted_per_slot': round(spec_ms / (win_ms / k) - 1,
                                              2),
    }


def bench_kv_occupancy(block_size: int = 16):
    """Paged KV pool occupancy through one serving episode (stats()):
    after a 1024-token prefix registers, mid-flight with every slot
    decoding a prefix-sharing prompt (shared blocks carry one copy for N
    readers), and after the batch drains (everything back on the free
    list)."""
    eng = _engine(num_slots=4, max_cache_len=1152, prefill_lanes=1,
                  kv_block_size=block_size)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 32000, size=1024).tolist()
    out = {'idle': eng.stats()}
    eng.register_prefix(prefix)
    out['prefix_registered'] = eng.stats()
    # Host-side start only: every slot takes a prefix-sharing prompt,
    # then the mid-flight occupancy.
    items = []
    for slot in range(eng.cfg.num_slots):
        req = Request(tokens=prefix + rng.integers(
            0, 32000, size=32).tolist(), max_new_tokens=64)
        items.append((req, slot, 0.0, *eng._validate_request(req)))
    eng._start_batch(items)
    eng._decode_step()
    out['mid_flight_4_slots_sharing'] = eng.stats()
    for i in range(eng.cfg.num_slots):
        eng._finish_slot(i, 'cancelled')
    out['drained'] = eng.stats()
    del eng
    _collect()
    return out


def bench_fault_containment(num_requests: int = 16,
                            prompt_len: int = 128,
                            new_tokens: int = 64):
    """Cost of the fault-tolerance surface: the armed-but-unfired decode
    overhead (one attribute check per site consult), and containment --
    an attributed decode-step fault mid-batch fails one request while
    the survivors run to completion, at about the clean batch's cost."""
    eng = _engine(num_slots=8, max_cache_len=256)
    rng = np.random.default_rng(0)

    def reqs():
        return [Request(tokens=rng.integers(
            0, 32000, size=prompt_len).tolist(),
                        max_new_tokens=new_tokens, request_id=str(i))
                for i in range(num_requests)]

    eng.warmup_decode(reqs()[0].tokens)

    t0 = time.perf_counter()
    clean = eng.generate(reqs())
    wall_clean = time.perf_counter() - t0
    assert all(r.finish_reason == 'length' for r in clean)

    # Armed but never firing: the consult overhead alone.
    eng.arm_faults(FaultPlan(seed=0, specs=[
        FaultSpec(site='decode_step', hits=(10 ** 9,))]))
    t0 = time.perf_counter()
    armed = eng.generate(reqs())
    wall_armed = time.perf_counter() - t0
    eng.disarm_faults()
    assert all(r.finish_reason == 'length' for r in armed)

    # Attributed mid-batch fault: one request dies, survivors finish.
    eng.arm_faults(FaultPlan(seed=0, specs=[
        FaultSpec(site='decode_step', hits=(3,), slot=1)]))
    t0 = time.perf_counter()
    faulted = eng.generate(reqs())
    wall_faulted = time.perf_counter() - t0
    eng.disarm_faults()
    failed = [r for r in faulted if r.finish_reason == 'error']
    assert len(failed) == 1 and failed[0].error_class == 'internal'
    counters = dict(eng.fault_stats)
    del eng
    _collect()
    return {
        'wall_clean_s': round(wall_clean, 3),
        'wall_armed_unfired_s': round(wall_armed, 3),
        'armed_overhead_pct': round(
            100.0 * (wall_armed - wall_clean) / wall_clean, 2),
        'wall_faulted_s': round(wall_faulted, 3),
        'failed_requests': len(failed),
        'survivors_completed': sum(
            1 for r in faulted if r.finish_reason == 'length'),
        'counters': counters,
    }


def bench_radix(reps: int = 5):
    """Automatic radix prefix caching at the shared-system-prompt shape:
    every request carries the same 512-token system prompt plus a
    distinct 64-token turn.  TTFT of unrelated prompts (the full-prefill
    baseline, lookups included) against system-prompt prompts once
    earlier traffic has warmed the tree, and the tree's hit rate."""
    eng = _engine(num_slots=4, max_cache_len=1152, prefill_lanes=1,
                  kv_block_size=16, auto_prefix_cache=True)
    rng = np.random.default_rng(0)
    system = rng.integers(0, 32000, size=512).tolist()

    def fresh():
        return rng.integers(0, 32000, size=576).tolist()

    def turn():
        return system + rng.integers(0, 32000, size=64).tolist()

    def ttft_ms(make):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            [res] = eng.generate([Request(tokens=make(),
                                          max_new_tokens=1)])
            times.append((time.perf_counter() - t0) * 1000.0)
            assert res.finish_reason == 'length'
        return statistics.median(times)

    eng.generate([Request(tokens=fresh(), max_new_tokens=1)])  # warm
    cold = ttft_ms(fresh)          # no shared prefix: full prefill
    eng.generate([Request(tokens=turn(), max_new_tokens=1)])   # insert
    eng.generate([Request(tokens=turn(), max_new_tokens=1)])   # sb warm
    hot = ttft_ms(turn)            # 512/576 tokens reused by refcount
    st = eng.stats()['kv']['radix']
    del eng
    _collect()
    return {
        'prompt_len': 576,
        'system_prompt_len': 512,
        'ttft_ms_no_overlap': round(cold, 1),
        'ttft_ms_shared_system_prompt': round(hot, 1),
        'ttft_reduction': round(1.0 - hot / cold, 3),
        'radix_hit_rate': round(st['hit_rate'], 3),
        'radix_hits': st['hits'],
        'radix_tokens_reused': st['tokens_reused'],
        'radix_nodes': st['nodes'],
        'radix_evictions': st['evictions'],
    }


def bench_lb_affinity(n_replicas_sweep=(1, 2, 4, 8), groups: int = 31,
                      per_group: int = 16, prompt_blocks: int = 24,
                      shared_blocks: int = 12):
    """Policy-level fleet-cache replay (no engines): a grouped-prompt
    trace through the serve plane's LB policy objects, each replica's
    radix tree modelled as an LRU set of block-aligned prefixes with a
    FIXED capacity (~40% of the fleet working set).  Under load-only
    routing every replica sees every group and thrashes; prefix_affinity
    partitions the key space, so the fleet hit rate grows with N.  groups
    is odd on purpose: groups % n == 0 would hand round_robin accidental
    affinity.  The policies are the serve plane's (skypilot_tpu.serve),
    imported here and nowhere else in this script."""
    import random

    from skypilot_tpu.serve.load_balancing_policies import (
        LoadBalancingPolicy, RequestContext)
    block = 16
    # Symbolic prefix keys: cache identity only needs (group, depth) for
    # the shared head and (group, rep, depth) past it.
    contexts, keys = {}, {}
    for g in range(groups):
        head = [(g * 131 + 7 * j) % 97 + 1
                for j in range(shared_blocks * block)]
        for r in range(per_group):
            tail = [(g * 17 + r * 29 + 3 * j) % 97 + 1
                    for j in range((prompt_blocks - shared_blocks) * block)]
            contexts[g, r] = RequestContext(tokens=head + tail,
                                            adapter=None)
            keys[g, r] = ([('s', g, d) for d in range(1, shared_blocks + 1)]
                          + [('t', g, r, d)
                             for d in range(shared_blocks + 1,
                                            prompt_blocks + 1)])
    order = [(g, r) for r in range(per_group) for g in range(groups)]
    random.Random(0).shuffle(order)
    cap = int(0.4 * groups * prompt_blocks)
    rows = []
    for n in n_replicas_sweep:
        urls = [f'http://10.0.0.{i + 1}:8000' for i in range(n)]
        row = {'n_replicas': n}
        for name in ('round_robin', 'least_load', 'prefix_affinity'):
            policy = LoadBalancingPolicy.make(name)
            policy.set_ready_replicas(urls)
            caches = {u: {} for u in urls}   # prefix-key -> lru tick
            tick = 0
            hit_tokens = total_tokens = 0
            for g, r in order:
                pick = policy.select_replica(context=contexts[g, r])
                cache = caches[pick]
                depth = 0
                for key in keys[g, r]:
                    if key not in cache:
                        break
                    depth += 1
                hit_tokens += depth * block
                total_tokens += prompt_blocks * block
                for key in keys[g, r]:
                    tick += 1
                    cache[key] = tick
                while len(cache) > cap:
                    victim = min(cache, key=cache.get)
                    del cache[victim]
                policy.request_done(pick)
            row[name] = round(hit_tokens / total_tokens, 3)
        ll = row['least_load']
        row['affinity_vs_least_load'] = (round(row['prefix_affinity'] / ll, 2)
                                         if ll > 1e-3 else None)
        rows.append(row)
    return {'groups': groups, 'per_group': per_group,
            'prompt_blocks': prompt_blocks, 'shared_blocks': shared_blocks,
            'replica_cache_capacity_blocks': cap,
            'metric': 'fleet_prefix_hit_rate (cached tokens / prompt '
                      'tokens, LRU-capped replica caches)',
            'rows': rows}


def bench_tp_capacity(tp_sweep=(1, 2, 4, 8), hbm_gb=16.0,
                      weights_gb=7.0, block_size=16, typical_len=256,
                      max_cache_len=512):
    """The head-sharded paged pool's fleet economics at 7B geometry
    (arithmetic, no engines).  A tp replica owns tp devices; the pool
    pages shard on kv heads, so its KV budget is the whole group's memory
    minus ONE (sharded) weight copy, while per-device KV read bytes per
    decode step fall as 1/tp: tp devices spent on one tp replica buy more
    concurrent slots than the same devices as tp single-device replicas,
    each carrying its own weights."""
    # 7B fp8-KV geometry: Hkv=32, D=128, 32 layers, 1-byte cache rows.
    hkv, d, layers, itemsize = 32, 128, 32, 1
    row_bytes = 2 * hkv * d * itemsize * layers
    blocks_per_slot = -(-typical_len // block_size)
    nb = 1
    while nb < blocks_per_slot and nb < max_cache_len // block_size:
        nb *= 2
    full_read = nb * block_size * row_bytes
    rows = []
    base = None
    for tp in tp_sweep:
        if hkv % tp:
            rows.append({'tp': tp, 'supported': False})
            continue
        kv_budget = int(tp * hbm_gb * (1 << 30)) - \
            int(weights_gb * (1 << 30))
        slots_tp = int(kv_budget // (block_size * row_bytes)
                       // blocks_per_slot)
        if base is None:
            base = max(slots_tp, 1)
        # The same tp devices as independent single-device replicas: each
        # carries its own full weight copy.
        dp_budget = int(hbm_gb * (1 << 30)) - int(weights_gb * (1 << 30))
        slots_dp = tp * int(dp_budget // (block_size * row_bytes)
                            // blocks_per_slot)
        rows.append({
            'tp': tp,
            'per_chip_kv_read_bytes_per_step': full_read // tp,
            'slots_one_tp_replica': slots_tp,
            'slots_tp_single_chip_dp_replicas': slots_dp,
            'tp_vs_dp_slot_gain': round(slots_tp / max(slots_dp, 1), 2),
            'capacity_gain_vs_tp1': round(slots_tp / base, 2),
        })
    return {'hbm_gb_per_chip': hbm_gb, 'weights_gb': weights_gb,
            'block_size': block_size, 'typical_resident_len': typical_len,
            'kv_row_bytes': row_bytes,
            'metric': 'max concurrent slots from the paged-pool block '
                      'budget (typical resident length per slot)',
            'rows': rows}


def bench_qos_scheduler(backlog: int = 2000, reps: int = 3):
    """Scheduler-level QoS replay (no engines) of a 2x-overload trace
    through the port's FifoScheduler and WfqScheduler: (a) interactive
    jump-ahead -- queue positions an interactive arrival waits behind a
    full batch backlog (FIFO: all of it; WFQ strict priority: 0); (b) the
    admission share under saturation for tenants weighted 3:1:1; (c) raw
    push+pop throughput."""

    def req(tenant, priority='batch', cost=128):
        return SimpleNamespace(tokens=[1] * (cost - 1), max_new_tokens=1,
                               priority=priority, tenant_id=tenant)

    def make_wfq():
        return WfqScheduler(weights={'gold': 3.0, 'silver': 1.0,
                                     'bronze': 1.0})

    # (a) jump-ahead: a backlog of batch requests, then 1 interactive.
    jump = {}
    for name, sched in (('fifo', FifoScheduler()), ('wfq', make_wfq())):
        for i in range(backlog):
            sched.push(req('bronze'))
        sched.push(req('gold', priority='interactive'))
        pos = 0
        while True:
            r = sched.pop()
            if r.priority == 'interactive':
                break
            pos += 1
        jump[name] = pos
    # (b) saturation fairness: bronze floods at 2x the arrival rate of
    # gold and silver; the scheduler drains a fixed admission window.
    share = {}
    for name, sched in (('fifo', FifoScheduler()), ('wfq', make_wfq())):
        order = []
        for i in range(backlog):
            order.append(req('gold'))
            order.append(req('silver'))
            order.append(req('bronze'))
            order.append(req('bronze'))
        for r in order:
            sched.push(r)
        admitted = {}
        for _ in range(backlog):          # drain 1/4 of the backlog
            r = sched.pop()
            admitted[r.tenant_id] = admitted.get(r.tenant_id, 0) + 1
        total = sum(admitted.values())
        share[name] = {t: round(n / total, 3)
                       for t, n in sorted(admitted.items())}
    # (c) push+pop throughput.
    thr = {}
    for name, make in (('fifo', FifoScheduler), ('wfq', make_wfq)):
        best = 0.0
        for _ in range(reps):
            sched = make()
            t0 = time.perf_counter()
            for i in range(backlog):
                sched.push(req(('gold', 'silver', 'bronze')[i % 3]))
            while sched.pop() is not None:
                pass
            dt = time.perf_counter() - t0
            best = max(best, 2 * backlog / dt)
        thr[name] = round(best)
    return {
        'backlog': backlog,
        'weights': {'gold': 3.0, 'silver': 1.0, 'bronze': 1.0},
        'interactive_waits_behind': jump,
        'admission_share_bronze_floods_2x': share,
        'push_pop_ops_per_s': thr,
    }


def main(argv=None) -> int:
    global DEVICE, NUM_LAYERS
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=None)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--prefill-chunk', type=int, default=64,
                    help='chunk size for the chunked-prefill TTFT '
                         'comparison (0 skips it)')
    ap.add_argument('--qos-only', action='store_true',
                    help='run only the model-free qos scheduler section '
                         'and merge it into --out')
    ap.add_argument('--no-lb', action='store_true',
                    help='skip the LB affinity section (the one that '
                         'imports the serve plane)')
    ap.add_argument('--spec-requests', type=int, default=32,
                    help='requests of the speculative section')
    ap.add_argument('--spec-new-tokens', type=int, default=188,
                    help='tokens each speculative-section request makes')
    ap.add_argument('--num-layers', type=int, default=None,
                    help="the engine's depth (default: llama2-7b's 32)")
    ap.add_argument('--device', default='cuda',
                    help="the engines' device: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.qos_only:
        qos = bench_qos_scheduler()
        print(json.dumps(qos))
        if args.out:
            try:
                with open(args.out) as f:
                    doc = json.load(f)
            except (FileNotFoundError, ValueError):
                doc = {}
            doc['qos_scheduler'] = qos
            with open(args.out, 'w') as f:
                json.dump(doc, f, indent=2)
            print(f'wrote {args.out}')
        return 0
    if args.device != 'cpu' and not torch.cuda.is_available():
        print('bench_features_torch: no CUDA device is visible (pass '
              '--device cpu to run on the CPU)', file=sys.stderr)
        return 1
    DEVICE, NUM_LAYERS = args.device, args.num_layers
    layers = _model_config().num_layers
    result = {
        'description':
            'serving-feature microbenchmarks of the PyTorch port on one '
            f'device ({torch.device(DEVICE).type}; llama2-7b config at '
            f'{layers} layers, int8 weights, fp8 KV). prefix_cache: '
            'prefill wall time for a 1088-token prompt, full vs '
            'suffix-only over a 1024-token registered prefix. '
            'speculative: offline throughput, draft_len 4 vs windowed '
            'decode; random-init greedy output is repetitive, so the '
            'acceptance here is the grounded-regime UPPER BOUND, not '
            'open-ended traffic.',
        'num_layers': layers,
        'prefix_cache': bench_prefix(reps=args.reps),
    }
    print(json.dumps(result['prefix_cache']), flush=True)
    result['speculative'] = bench_spec(num_requests=args.spec_requests,
                                       new_tokens=args.spec_new_tokens,
                                       dispatch_iters=max(args.reps, 5))
    print(json.dumps(result['speculative']), flush=True)
    if args.prefill_chunk:
        result['chunked_prefill'] = bench_chunked_prefill(
            prefill_chunk=args.prefill_chunk, reps=max(3, args.reps // 2))
        print(json.dumps(result['chunked_prefill']), flush=True)
    result['kv_occupancy'] = bench_kv_occupancy()
    print(json.dumps(result['kv_occupancy']), flush=True)
    result['fault_containment'] = bench_fault_containment()
    print(json.dumps(result['fault_containment']), flush=True)
    result['radix_prefix_cache'] = bench_radix(reps=args.reps)
    print(json.dumps(result['radix_prefix_cache']), flush=True)
    if not args.no_lb:
        result['lb_affinity'] = bench_lb_affinity()
        print(json.dumps(result['lb_affinity']), flush=True)
    result['tp_capacity'] = bench_tp_capacity()
    print(json.dumps(result['tp_capacity']), flush=True)
    result['qos_scheduler'] = bench_qos_scheduler()
    print(json.dumps(result['qos_scheduler']), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=2)
        print(f'wrote {args.out}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
