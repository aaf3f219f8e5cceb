#!/usr/bin/env python
"""Chaos smoke of the PyTorch port: the twin of ``scripts/chaos_smoke.py``
over the port's engine (``skypilot_tpu_torch``).

A seeded fault sweep over the small model arms a *mixture* of
probabilistic faults across every injection site and checks the two
properties that must hold under ANY fault sequence:

  1. **No hang** -- every serving episode drains within its wall bound
     (nothing waits on a dead loop or a stuck allocator).
  2. **Full request accounting** -- every submitted request gets exactly
     one terminal result (ok / error / deadline), and the paged block
     pool balances at drain (all blocks free, refcounts zero).

Probabilistic specs draw from per-spec seeded streams (FaultPlan), so
a failing seed reproduces exactly:
    python scripts/chaos_smoke_torch.py --device cpu --seeds 3

``--multi-replica N`` switches to the replica-plane sweep: N killable
in-process port replicas behind the serve plane's load balancer, with a
seeded killer thread consulting the plan's ``replica_kill`` site and
preempting replicas mid-decode.  The property there: **every greedy
request completes byte-identical to the fault-free run** -- zero failed
requests under replica preemption -- plus a drain exercise asserting a
draining replica finishes its in-flight stream while the LB answers
zero 5xx.  The sweep ends with two control-plane legs:

  3. **LB kill + warm restart** -- the load balancer itself is killed
     mid-traffic and restarted on the same port with its journal
     re-adopted; clients retry connection errors, and every request
     must still land byte-identical (zero lost through the outage).
  4. **Gray-failure probation** -- one replica is wrapped in a seeded
     latency-injection proxy (``net_degrade`` site); the LB's TTFT
     outlier track must put it in probation within the detection
     window while traffic through it stays byte-identical.

``--batch`` runs the durable-batch leg instead: one journaled batch job
submitted through a BatchCoordinator, with a replica, the LB, and the
coordinator itself each killed mid-job.  The resumed job's final output
file must be byte-identical to the fault-free run's -- zero lost rows,
zero duplicated spool writes (exactly-once), zero determinism
violations -- and the restarted LB must show it re-adopted the orphaned
row leases from its journal.

The replica and batch legs compose the two packages: the port's replicas
(``skypilot_tpu_torch.infer.chaos``) stand behind the serve plane's
unchanged load balancer, policy, journal and batch coordinator
(``skypilot_tpu.serve``), which this script imports inside those legs and
hands to ``ChaosFleet`` through its LB factory.  Nothing here loads JAX.
As in the reference, the fleet's last replica is tensor-parallel (tp=2)
when the device can give two ranks (``tp_last`` in the banner): a
``ProcessReplica`` whose two ranks are processes of their own.

``--device`` picks the engines' device (default ``cuda``; ``cpu`` for a
run without a card).  Run from anywhere:
    python scripts/chaos_smoke_torch.py --device cpu [--multi-replica 3 | --batch]

Exit code: 0 = all episodes passed, 1 = any property violated.
"""
import argparse
import copy
import functools
import json
import os
import queue
import sys
import threading
import time
from http.client import HTTPConnection

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from skypilot_tpu_torch.analysis import sanitizers  # noqa: E402
from skypilot_tpu_torch.infer import (FaultPlan, FaultSpec,  # noqa: E402
                                      InferConfig, InferenceEngine,
                                      Request)
from skypilot_tpu_torch.models.llama import LlamaConfig  # noqa: E402

EPISODE_WALL_S = 120.0


def build_engine(device: str) -> InferenceEngine:
    mc = LlamaConfig(name='chaos-smoke', vocab_size=101, hidden_size=32,
                     intermediate_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, max_seq_len=128,
                     tie_embeddings=True, dtype=torch.float32)
    cfg = InferConfig(num_slots=4, max_cache_len=64,
                      prefill_buckets=(8, 16, 32), max_new_tokens=8,
                      cache_dtype=torch.float32, kv_block_size=8)
    return InferenceEngine(mc, cfg, device=device,
                           generator=_generator(device))


def _generator(device: str) -> torch.Generator:
    """The weights' seed: every engine built here draws the same ones."""
    return torch.Generator(device=device).manual_seed(0)


def make_plan(seed: int) -> FaultPlan:
    """A bit of everything: attributed and unattributed dispatch
    faults, allocator pressure, NaN lanes, stalls, and loop death."""
    return FaultPlan(seed=seed, specs=[
        FaultSpec(site='decode_step', prob=0.10, slot=1, max_fires=2),
        FaultSpec(site='decode_step', prob=0.04, max_fires=1),
        FaultSpec(site='prefill', prob=0.10, max_fires=2),
        FaultSpec(site='chunk_round', prob=0.10, max_fires=1),
        FaultSpec(site='block_alloc', prob=0.15, max_fires=4),
        FaultSpec(site='nonfinite_logits', prob=0.08, slot=0,
                  max_fires=2),
        FaultSpec(site='stall', prob=0.10, stall_s=0.05),
        FaultSpec(site='serve_loop', prob=0.05, max_fires=2),
    ])


def make_requests(n: int):
    reqs = []
    for i in range(n):
        toks = [(5 * i + j) % 97 + 1 for j in range(3 + i % 5)]
        reqs.append(Request(
            request_id=f'r{i}', tokens=toks,
            max_new_tokens=4 + i % 12,
            # Every 5th request carries a (generous) deadline so the
            # eviction path runs inside the sweep too.
            deadline_s=30.0 if i % 5 == 0 else None))
    return reqs


def episode(eng: InferenceEngine, seed: int, n: int,
            reference: dict = None) -> list:
    """One serving episode under an armed plan; returns violations.
    reference: request_id -> the fault-free run's tokens; each request
    that finishes cleanly (length or eos) must have them."""
    plan = make_plan(seed)
    reqs = make_requests(n)
    results, q, stop = {}, queue.Queue(), threading.Event()
    for r in reqs:
        q.put(copy.deepcopy(r))
    eng.arm_faults(plan)
    loop_exc = []

    def run():
        try:
            eng.generate_stream(
                q, lambda res: results.setdefault(res.request_id, res),
                stop)
        except Exception as e:  # supervisor gave up: legal iff every
            loop_exc.append(e)  # request was still accounted for
    t = threading.Thread(target=run, daemon=True)
    t0 = time.time()  # det-ok: episode wall bound (harness)
    t.start()
    try:
        while len(results) < n and time.time() - t0 < EPISODE_WALL_S:  # det-ok: episode wall bound (harness)
            if loop_exc and len(results) >= n:
                break
            time.sleep(0.02)
    finally:
        stop.set()
        t.join(timeout=30)
        eng.disarm_faults()

    bad = []
    if t.is_alive():
        bad.append('HANG: serving loop did not stop')
    if len(results) != n:
        missing = sorted(set(r.request_id for r in reqs) - set(results))
        bad.append(f'ACCOUNTING: {len(results)}/{n} results; '
                   f'missing {missing}')
    reasons = {}
    for res in results.values():
        reasons[res.finish_reason] = reasons.get(res.finish_reason,
                                                 0) + 1
        if res.finish_reason not in ('length', 'eos', 'error',
                                     'deadline'):
            bad.append(f'BAD finish_reason {res.finish_reason!r} '
                       f'for {res.request_id}')
        elif (reference is not None and
              res.finish_reason in ('length', 'eos') and
              res.output_tokens != reference[res.request_id]):
            bad.append(f'DIVERGED: {res.request_id} gave '
                       f'{res.output_tokens}, the fault-free run '
                       f'{reference[res.request_id]}')
    if eng._paged:
        # Full conservation law (refcounts == slot tables + radix +
        # prefixes, free list == zero-ref blocks), then the stricter
        # drained-pool expectation: nothing in flight may hold blocks.
        try:
            sanitizers.check_block_conservation(eng)
        except sanitizers.BlockLeakError as e:
            bad.append(f'BLOCK LEAK: {e}')
        held = eng._num_blocks - 1 - len(eng._free_blocks)
        radix_held = eng._radix.blocks_held if eng._radix else 0
        prefix_held = sum(len(e.get('blocks', ()))
                          for e in eng._prefixes.values())
        if held != radix_held + prefix_held:
            bad.append(
                f'BLOCK LEAK: {held} blocks held at drain but only '
                f'{radix_held} radix + {prefix_held} prefix expected; '
                f'refs={eng._block_refs.tolist()}')
    if sanitizers.shard_sanitizer_enabled():
        # Fault storms must not re-commit root inputs off their
        # declared layouts (no-op for mesh-less engines).
        try:
            sanitizers.check_shard_layout(eng)
        except sanitizers.ShardLayoutError as e:
            bad.append(f'SHARD DRIFT: {e}')
    print(f'  seed={seed}: {reasons} wall={time.time() - t0:.1f}s '  # det-ok: wall time printed
          f'fired={plan.stats()["fired"]} '
          f'counters={eng.fault_stats} '
          f'{"terminal-giveup " if loop_exc else ""}'
          f'{"FAIL" if bad else "ok"}')
    return bad


# ------------------------------------------------ multi-replica sweep


def _replica_engine(device: str, stall_s: float = 0.04, mesh=None,
                    params=None) -> InferenceEngine:
    """One replica's engine; over `mesh` (a tensor-parallel replica's,
    built on every rank of a ProcessReplica), and on the given `params`
    (a state dict) instead of seed-0 draws."""
    mc = LlamaConfig(name='chaos-replica', vocab_size=101,
                     hidden_size=32, intermediate_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_seq_len=128,
                     tie_embeddings=True, dtype=torch.float32)
    cfg = InferConfig(num_slots=4, max_cache_len=64,
                      prefill_buckets=(8, 16, 32), max_new_tokens=32,
                      cache_dtype=torch.float32, decode_steps=4,
                      kv_block_size=8, auto_prefix_cache=True,
                      host_kv_bytes=32 << 20)
    eng = InferenceEngine(mc, cfg, params=params, device=device,
                          generator=_generator(device), mesh=mesh)
    # Stretch generations across loop iterations so kills land while
    # streams are genuinely in flight (sleep only; tokens unaffected).
    eng.arm_faults(FaultPlan(seed=0, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=stall_s)]))
    return eng


def _request_spec(i: int) -> dict:
    return {'tokens': [(3 * i + j) % 97 + 1 for j in range(4 + i % 4)],
            'max_new_tokens': 12 + i % 5, 'stream': True}


def _stream_generate(port: int, payload: dict, timeout: float = 60.0):
    """POST /generate via the LB; returns the parsed SSE event list."""
    conn = HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request('POST', '/generate',
                     body=json.dumps(payload).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f'LB answered {resp.status}')
        buf, events = b'', []
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b'\n\n' in buf:
                ev, buf = buf.split(b'\n\n', 1)
                for line in ev.split(b'\n'):
                    if line.startswith(b'data: '):
                        events.append(json.loads(line[6:]))
        return events
    finally:
        conn.close()


def _finish_of(events):
    done = [e for e in events if e.get('done')]
    if len(done) != 1:
        raise RuntimeError(f'{len(done)} terminal events')
    return done[0]


def _health(replica) -> dict:
    """A replica's /healthz document, whatever its status (the same for
    an in-process and a process replica)."""
    conn = HTTPConnection(replica.host, replica.port, timeout=10)
    try:
        conn.request('GET', '/healthz')
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _kv(replica) -> dict:
    return _health(replica)['kv']


def _wait_health(replica, pred, timeout_s: float) -> bool:
    deadline = time.time() + timeout_s  # det-ok: harness wait
    while time.time() < deadline:  # det-ok: harness wait
        if pred(_health(replica)):
            return True
        time.sleep(0.05)
    return False


def _drain_exercise(fleet, references) -> list:
    """Drain the replica serving an in-flight stream: the stream must
    complete (byte-identical) and the LB must answer zero 5xx."""
    bad = []
    result, exc = {}, []

    def client():
        try:
            result['events'] = _stream_generate(
                fleet.lb.port, _request_spec(0))
        except Exception as e:  # noqa: BLE001
            exc.append(e)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    deadline = time.time() + 30  # det-ok: harness wait
    busy = None
    while time.time() < deadline and busy is None:  # det-ok: harness wait
        busy = next((r for r in fleet.replicas if r.busy()), None)
        time.sleep(0.01)
    if busy is None:
        return ['DRAIN: stream never reached a replica']
    # Seed a hot radix prefix on the soon-to-drain replica: the LB
    # must ship it to a survivor (warm failover) once it observes the
    # drain, and the adopter must answer the matching prompt off the
    # adopted blocks — byte-identical, suffix-only prefill.
    hot = [7] * 24   # three full blocks at kv_block_size=8
    hot_ref = None
    try:
        hot_ref = _finish_of(_stream_generate(
            busy.port, {'tokens': hot + [90], 'max_new_tokens': 3,
                        'stream': True}))['output_tokens']
    except RuntimeError as e:
        bad.append(f'DRAIN: hot seed request failed: {e}')
    conn = HTTPConnection('127.0.0.1', busy.port, timeout=10)
    conn.request('POST', '/drain', body=b'{"deadline_s": 60}')
    if conn.getresponse().status != 200:
        bad.append('DRAIN: /drain rejected')
    conn.close()
    for i in range(1, 5):
        try:
            done = _finish_of(_stream_generate(fleet.lb.port,
                                               _request_spec(i)))
            if done.get('output_tokens') != references[i]:
                bad.append(f'DRAIN: request {i} diverged')
        except RuntimeError as e:
            bad.append(f'DRAIN: request {i} during drain: {e}')
    t.join(60)
    if t.is_alive() or exc:
        bad.append(f'DRAIN: in-flight stream failed: {exc}')
    elif _finish_of(result['events']).get('output_tokens') != \
            references[0]:
        bad.append('DRAIN: in-flight stream diverged')
    if not _wait_health(busy, lambda doc: doc['drained'], 30):
        bad.append('DRAIN: replica never reported drained')
    # Warm failover: the drained replica's hot set ships to the
    # affinity-ring owner of EACH prefix, so with several survivors
    # the prefixes can split across them (ring order follows the
    # randomized ports).  Wait for the handoff to finish shipping
    # every group (hot_handoffs bumps once, at the end), then replay
    # the hot prompt on every adopter: byte-identity must hold on all
    # of them, and the prefix's owner must answer it off the adopted
    # blocks (radix hit) on at least one.
    wait_until = time.time() + 30  # det-ok: harness wait
    while (time.time() < wait_until and  # det-ok: harness wait
           fleet.lb.lb_stats().get('hot_handoffs', 0) < 1):
        time.sleep(0.05)
    survivors = [r for r in fleet.replicas if r is not busy]
    adopters = [r for r in survivors
                if _kv(r)['host_tier'].get('adopted', 0) > 0]
    if not adopters:
        bad.append('DRAIN: no survivor adopted the hot set')
    elif hot_ref is not None:
        radix_hits = 0
        for adopter in adopters:
            hits0 = _kv(adopter)['radix']['hits']
            try:
                done = _finish_of(_stream_generate(
                    adopter.port, {'tokens': hot + [90],
                                   'max_new_tokens': 3, 'stream': True}))
                if done['output_tokens'] != hot_ref:
                    bad.append('DRAIN: hot replay diverged on the adopter')
                if _kv(adopter)['radix']['hits'] > hits0:
                    radix_hits += 1
            except RuntimeError as e:
                bad.append(f'DRAIN: hot replay failed: {e}')
        if radix_hits == 0:
            bad.append('DRAIN: hot replay missed the adopted radix')
    conn = HTTPConnection('127.0.0.1', busy.port, timeout=10)
    conn.request('POST', '/drain', body=b'{"cancel": true}')
    conn.getresponse()
    conn.close()
    return bad


def _stream_with_retry(port: int, payload: dict, wall_s: float = 90.0):
    """Stream through an LB that may be mid-restart: connection-level
    errors and severed streams retry (greedy decode is deterministic,
    so a from-scratch reissue yields identical tokens).  Returns
    (terminal_event, attempts)."""
    deadline = time.time() + wall_s  # det-ok: leg wall bound (harness)
    attempts, last = 0, None
    while time.time() < deadline:  # det-ok: leg wall bound (harness)
        attempts += 1
        try:
            events = _stream_generate(port, payload, timeout=30)
            done = [e for e in events if e.get('done')]
            if len(done) == 1 and \
                    done[0].get('finish_reason') in ('length', 'eos'):
                return done[0], attempts
            last = RuntimeError(
                f'incomplete stream ({len(done)} terminal events, '
                f'finish={done[0].get("finish_reason") if done else None})')
        except (OSError, RuntimeError) as e:
            last = e
        time.sleep(0.2)
    raise RuntimeError(f'never completed after {attempts} attempts: {last}')


def _lb_restart_exercise(fleet, references, n_requests: int) -> list:
    """Kill the LB mid-traffic, restart it on the same port with the
    journal re-adopted: zero requests lost, every answer
    byte-identical."""
    bad, results = [], {}
    lock = threading.Lock()

    def worker(idx):
        try:
            done, attempts = _stream_with_retry(fleet.lb_port,
                                                _request_spec(idx))
            with lock:
                results[idx] = (done['output_tokens'], attempts)
        except Exception as e:  # noqa: BLE001
            with lock:
                bad.append(f'LB-restart request {idx}: {e}')

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_requests)]
    for th in threads:
        th.start()
    time.sleep(0.4)   # let streams get genuinely in flight
    fleet.kill_lb()
    time.sleep(0.3)   # clients live through the dead window
    fleet.restart_lb()
    for th in threads:
        th.join(120)
        if th.is_alive():
            bad.append('LB-restart: client hung')
    retried = sum(1 for _, n in results.values() if n > 1)
    for idx, (tokens, _) in sorted(results.items()):
        if tokens != references[idx]:
            bad.append(f'LB-restart: request {idx} diverged')
    if len(results) + len(bad) < n_requests:
        bad.append(f'LB-restart: only {len(results)}/{n_requests} '
                   'requests accounted for')
    stats = fleet.lb.lb_stats()
    if stats.get('adopted_unverified'):
        bad.append('LB-restart: journal-adopted replicas never '
                   f're-verified: {stats["adopted_unverified"]}')
    print(f'  lb-restart: kills={fleet.lb_kills} '
          f'restarts={fleet.lb_restarts} retried_clients={retried} '
          f'journal_age_s={stats.get("journal_age_s")} '
          f'{"FAIL" if bad else "ok"}')
    return bad


def _probation_exercise(fleet, references, window_s: float = 45.0) -> list:
    """Degrade one replica's network path (alive, answering probes,
    crawling responses) and require the LB's gray-failure track to put
    it in probation within the detection window — with every request
    routed through the rot still byte-identical."""
    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site='net_degrade', prob=1.0, delay_s=0.4,
                  jitter_s=0.1),
    ])
    proxy = fleet.degrade_one(0, plan, seed=0)
    bad, stop = [], threading.Event()
    lock = threading.Lock()

    def lane(lane_id):
        i = lane_id
        while not stop.is_set():
            idx = i % 5
            i += 3
            try:
                done, _ = _stream_with_retry(fleet.lb_port,
                                             _request_spec(idx),
                                             wall_s=30)
                if done['output_tokens'] != references[idx]:
                    with lock:
                        bad.append(f'probation: request {idx} diverged '
                                   'through the degraded path')
            except RuntimeError as e:
                with lock:
                    bad.append(f'probation traffic: {e}')
                return

    # Three concurrent lanes so least-load routing spreads TTFT samples
    # across the fleet (probation compares against the fleet median —
    # it needs at least two replicas with an EWMA).
    lanes = [threading.Thread(target=lane, args=(k,), daemon=True)
             for k in range(3)]
    for th in lanes:
        th.start()
    deadline = time.time() + window_s  # det-ok: detection window (harness)
    probation = []
    while time.time() < deadline and not bad:  # det-ok: detection window (harness)
        probation = fleet.lb.lb_stats()['probation_replicas']
        # Wait for the DEGRADED replica specifically: another replica
        # entering probation (e.g. TTFT inflated by queuing behind the
        # rot) is not detection.
        if proxy.url in probation:
            break
        time.sleep(0.2)
    detect_wall = window_s - max(0.0, deadline - time.time())  # det-ok: detection wall (recorded)
    stop.set()
    for th in lanes:
        th.join(60)
    if proxy.url not in probation:
        bad.append(f'probation: degraded replica not ejected within '
                   f'{window_s}s (probation={probation}, '
                   f'delayed_chunks={proxy.chunks_delayed})')
    if proxy.chunks_delayed == 0:
        bad.append('probation: degrade proxy never fired')
    print(f'  probation: detected_in={detect_wall:.1f}s '
          f'delayed_chunks={proxy.chunks_delayed} '
          f'{"FAIL" if bad else "ok"}')
    return bad


def lb_factory(policy_name: str = 'least_load'):
    """The serve plane's load balancer for ``ChaosFleet``: a fresh policy
    seeded with the replica URLs, the journal at journal_path (when
    given), the fleet's severable HTTP server."""
    from skypilot_tpu.serve.lb_journal import LBJournal
    from skypilot_tpu.serve.load_balancer import SkyTpuLoadBalancer
    from skypilot_tpu.serve.load_balancing_policies import \
        LoadBalancingPolicy

    def make_lb(port, urls, journal_path, server_cls):
        policy = LoadBalancingPolicy.make(policy_name)
        policy.set_ready_replicas(urls)
        journal = (LBJournal(journal_path, clock=time.monotonic)
                   if journal_path else None)
        return SkyTpuLoadBalancer(None, port, policy, journal=journal,
                                  server_cls=server_cls)

    return make_lb


def kill_episode(fleet, seed: int, n_requests: int, references) -> list:
    """One replica-kill episode: n_requests greedy streams through the LB
    in lanes of two while a SeededKiller (seed) preempts replicas, then
    the dead ones respawn.  Every stream must finish (length or eos)
    with its reference tokens; returns the violations."""
    from skypilot_tpu_torch.infer.chaos import SeededKiller

    t0 = time.time()  # det-ok: wall time printed
    killer = SeededKiller(fleet, FaultPlan(seed=seed, specs=[
        FaultSpec(site='replica_kill', prob=0.02, max_fires=2),
    ]))
    killer.start()
    bad, done_stats = [], {'resumed': 0}
    lock = threading.Lock()

    def worker(idx):
        try:
            events = _stream_generate(fleet.lb.port, _request_spec(idx))
            done = _finish_of(events)
            if done.get('finish_reason') not in ('length', 'eos'):
                raise RuntimeError(
                    f'finish_reason={done.get("finish_reason")} '
                    f'error={done.get("error")!r}')
            if done['output_tokens'] != references[idx]:
                raise RuntimeError(
                    f'tokens diverged: {done["output_tokens"]} '
                    f'!= {references[idx]}')
            with lock:
                done_stats['resumed'] += bool(done.get('resumed'))
        except Exception as e:  # noqa: BLE001
            with lock:
                bad.append(f'seed={seed} request {idx}: {e}')

    # Two client lanes keep replicas busy so kills land mid-stream, not
    # between requests.
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_requests)]
    for lane in range(0, n_requests, 2):
        batch = threads[lane:lane + 2]
        for th in batch:
            th.start()
        for th in batch:
            th.join(90)
            if th.is_alive():
                bad.append(f'seed={seed}: client hung')
    killer.stop()
    fleet.respawn_dead()
    stats = fleet.lb.lb_stats()
    print(f'  seed={seed}: kills={killer.kills} '
          f'resumed={done_stats["resumed"]} '
          f'failovers={stats["failovers"]} '
          f'wall={time.time() - t0:.1f}s '  # det-ok: wall time printed
          f'{"FAIL" if bad else "ok"}')
    # Let probes re-admit the respawned replicas.
    settle = time.time() + 15  # det-ok: harness wait
    while time.time() < settle:  # det-ok: harness wait
        if not fleet.lb.lb_stats()['breaker_open_now']:
            break
        time.sleep(0.05)
    return bad


def tp_last_degree(n_replicas: int, device: str) -> int:
    """The last replica's tensor degree: 2 when the fleet has peers and
    the device can give two ranks (on the CPU two cores in this process's
    affinity, counted as server.run() counts its shards; on the card two
    gloo ranks sharing card 0), else 1."""
    from skypilot_tpu_torch.infer import server
    if n_replicas < 2:
        return 1
    if device == 'cpu':
        return 2 if server._visible_devices('cpu') >= 2 else 1
    return 2 if torch.cuda.is_available() else 1


def multi_replica_sweep(n_replicas: int, seeds, n_requests: int,
                        policy_name: str = 'least_load',
                        device: str = 'cuda') -> int:
    import tempfile

    from skypilot_tpu_torch.infer.chaos import (ChaosFleet, EngineRecipe,
                                                ProcessReplica, free_port)

    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    # Mixed fleet: the last replica runs tensor-parallel (tp=2) when the
    # device can give two ranks -- the LB, breaker, failover and the
    # sanitizers must treat a head-sharded replica exactly like its
    # single-device peers (byte-identical streams, same wire surface).
    # Its ranks are processes of their own, so it is a ProcessReplica.
    tp_last = tp_last_degree(n_replicas, device)
    factories = [functools.partial(_replica_engine, device)] * n_replicas
    if tp_last > 1:
        # One torch thread a rank on the CPU: the ranks and the in-process
        # replicas share the cores.
        factories[-1] = ProcessReplica(
            EngineRecipe(_replica_engine, device), free_port(), tp=tp_last,
            device=device, threads=1 if device == 'cpu' else None)
    print(f'replica chaos: {n_replicas} replicas seeds={seeds} '
          f'requests/episode={n_requests} policy={policy_name} '
          f'tp_last={tp_last}')
    journal = os.path.join(tempfile.mkdtemp(prefix='chaos-lb-'),
                           'lb_journal.jsonl')
    fleet = ChaosFleet(factories, n_replicas, lb_factory(policy_name),
                       journal_path=journal)
    fleet.start()
    failures = []
    try:
        # Fault-free pass = the byte-exact reference per request spec.
        references = {}
        for i in range(max(n_requests, 5)):
            done = _finish_of(_stream_generate(fleet.lb.port,
                                               _request_spec(i)))
            references[i] = done['output_tokens']

        for seed in seeds:
            failures += kill_episode(fleet, seed, n_requests, references)

        # Each leg tests ONE mechanism.  The kill episodes leave gray-
        # failure evidence behind (TTFT EWMAs spiked by mid-stream
        # failovers can hold a survivor in probation indefinitely once
        # it stops drawing traffic), and a survivor stuck in probation
        # diverts the drain leg's hot replay away from the replica that
        # adopted the radix — so the evidence is explicitly reset at
        # each leg boundary, exactly like an operator closing out a
        # maintenance window.
        fleet.lb.reset_gray_state()
        failures += _drain_exercise(fleet, references)
        fleet.lb.reset_gray_state()
        failures += _lb_restart_exercise(fleet, references,
                                         n_requests=min(6, n_requests))
        fleet.lb.reset_gray_state()
        failures += _probation_exercise(fleet, references)
        print(f'  lb stats: {fleet.lb.lb_stats()}')
    finally:
        fleet.stop()
    if failures:
        print('REPLICA CHAOS FAILED:')
        for f in failures:
            print(f'  {f}')
        return 1
    print('replica chaos: PASS')
    return 0


# ------------------------------------------------------- batch sweep


def _wait_for(pred, timeout_s: float, what: str):
    deadline = time.time() + timeout_s  # det-ok: harness wait
    while time.time() < deadline:  # det-ok: harness wait
        if pred():
            return None
        time.sleep(0.05)
    return f'batch: timed out waiting for {what}'


def batch_sweep(n_replicas: int, n_rows: int, device: str = 'cuda') -> int:
    """Durable-batch chaos leg: one journaled batch job run
    twice — fault-free, then with every actor killed mid-flight
    (replica kill, LB kill + warm restart, coordinator crash-stop +
    resume on the same journal) — and the final output file must be
    byte-identical with zero lost rows and zero determinism
    violations.  Duplicates are allowed to OCCUR (that is the crash
    replay) but must dedup against the spooled digest instead of
    double-writing."""
    import tempfile

    from skypilot_tpu.serve.batch import BatchCoordinator
    from skypilot_tpu_torch.infer.chaos import ChaosFleet

    os.environ.setdefault('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    prompts = [[(5 * i + j) % 97 + 1 for j in range(3 + i % 5)]
               for i in range(n_rows)]
    print(f'batch chaos: {n_replicas} replicas rows={n_rows}')

    def fresh_fleet() -> ChaosFleet:
        journal = os.path.join(
            tempfile.mkdtemp(prefix='chaos-batch-lb-'),
            'lb_journal.jsonl')
        # Slower decode (bigger stall) + a single row worker below:
        # each kill must land while the job is genuinely mid-flight,
        # not in the gap between an instant job and the choreography.
        fleet = ChaosFleet(functools.partial(_replica_engine, device,
                                             stall_s=0.08),
                           n_replicas, lb_factory(), journal_path=journal)
        fleet.start()
        return fleet

    failures = []

    # ---- fault-free pass: the byte-exact reference ------------------
    fleet = fresh_fleet()
    ref_bytes = None
    try:
        d = tempfile.mkdtemp(prefix='chaos-batch-ref-')
        coord = BatchCoordinator(os.path.join(d, 'batch.jsonl'),
                                 fleet.lb_port,
                                 spool_dir=os.path.join(d, 'spool'),
                                 row_workers=2)
        jid = coord.submit(prompts, 10,
                           completion_window_s=EPISODE_WALL_S,
                           job_id='chaosjob')
        if not coord.join(jid, EPISODE_WALL_S):
            failures.append('batch: fault-free job never finished: '
                            f'{coord.status(jid)}')
        else:
            st = coord.status(jid)
            if st['state'] != 'done':
                failures.append(f'batch: fault-free run ended {st}')
            with open(coord.result_path(jid), 'rb') as fh:
                ref_bytes = fh.read()
        coord.stop()
    finally:
        fleet.stop()
    if failures:
        print('BATCH CHAOS FAILED (reference pass):')
        for f in failures:
            print(f'  {f}')
        return 1

    # ---- chaos pass: same job, every actor dies mid-flight ----------
    fleet = fresh_fleet()
    try:
        d = tempfile.mkdtemp(prefix='chaos-batch-run-')
        jpath = os.path.join(d, 'batch.jsonl')
        spool = os.path.join(d, 'spool')
        # ONE row worker: rows dispatch strictly serially, so the
        # choreography below (each wait is a row-count threshold)
        # always finds the job mid-flight.
        coord = BatchCoordinator(jpath, fleet.lb_port, spool_dir=spool,
                                 row_workers=1)
        jid = coord.submit(prompts, 10,
                           completion_window_s=3 * EPISODE_WALL_S,
                           job_id='chaosjob')

        def done_rows():
            return coord.status(jid)['completed']

        # 1. Replica killed mid-job: the LB fails the stream over;
        #    only unfinished rows are ever (re)dispatched.  The dead
        #    replica stays down until the successor coordinator is up
        #    (respawn compiles a fresh engine, which takes long enough
        #    for a small job to finish — the later kills must still
        #    land mid-flight).
        err = _wait_for(lambda: done_rows() >= 2, 60, 'first rows')
        if err:
            failures.append(err)
        if fleet.kill_one() is None:
            failures.append('batch: no replica available to kill')
        marker = done_rows()
        err = _wait_for(lambda: done_rows() > marker, 60,
                        'progress past the replica kill')
        if err:
            failures.append(err)

        # 2. LB killed mid-row, restarted on the same port: the row
        #    transport retries through the outage and the restarted LB
        #    re-adopts the orphaned row leases from its journal
        #    (adoption runs in the constructor, so the counter is
        #    valid the moment restart_lb returns).
        err = _wait_for(
            lambda: fleet.lb_stats()['batch_rows_inflight'] >= 1,
            60, 'a batch row in flight at the LB')
        if err:
            failures.append(err)
        fleet.kill_lb()
        time.sleep(0.3)
        fleet.restart_lb(wait_adopted=False)
        lb_stats = fleet.lb_stats()
        if lb_stats.get('batch_leases_adopted', 0) < 1:
            failures.append('batch: restarted LB adopted no row '
                            f'leases (stats={lb_stats})')

        # 3. Coordinator (the controller-side actor) crash-stopped
        #    mid-job: a successor on the same journal path RESUMES —
        #    completed rows are recognised by digest and never re-run.
        before = coord.status(jid)
        coord.stop()
        if before['state'] != 'running':
            failures.append('batch: job finished before the '
                            f'coordinator crash ({before}) — '
                            'resume leg proved nothing')
        coord2 = BatchCoordinator(jpath, fleet.lb_port,
                                  spool_dir=spool, row_workers=2)
        fleet.respawn_dead()   # capacity back while the successor runs
        resumed = coord2.status(jid)
        if resumed['completed'] < before['completed']:
            failures.append(
                'batch: resume lost completed rows '
                f'({resumed["completed"]} < {before["completed"]})')
        if not coord2.join(jid, 2 * EPISODE_WALL_S):
            failures.append('batch: resumed job never finished: '
                            f'{coord2.status(jid)}')
        final = coord2.status(jid)
        if final['state'] != 'done' or final['completed'] != n_rows:
            failures.append(f'batch: final status {final}')
        if final['determinism_violations']:
            failures.append('batch: determinism violations: '
                            f'{final["determinism_violations"]}')
        chaos_bytes = None
        try:
            with open(coord2.result_path(jid), 'rb') as fh:
                chaos_bytes = fh.read()
        except OSError as e:
            failures.append(f'batch: no output file: {e}')
        if ref_bytes is not None and chaos_bytes != ref_bytes:
            failures.append('batch: chaos output is not '
                            'byte-identical to the fault-free run')
        print(f'  batch: rows={final["completed"]}/{n_rows} '
              f'retries={final["retries"]} dups={final["duplicates"]} '
              f'resumed_from={before["completed"]} '
              f'leases_adopted='
              f'{lb_stats.get("batch_leases_adopted")} '
              f'{"FAIL" if failures else "ok"}')
        coord2.stop()
    finally:
        fleet.stop()
    if failures:
        print('BATCH CHAOS FAILED:')
        for f in failures:
            print(f'  {f}')
        return 1
    print('batch chaos: PASS')
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2],
                    help='fault-plan seeds to sweep')
    ap.add_argument('--requests', type=int, default=12)
    ap.add_argument('--multi-replica', type=int, default=0,
                    metavar='N',
                    help='replica-plane sweep with N killable replicas '
                         'behind the load balancer (0 = engine sweep)')
    ap.add_argument('--policy', default='least_load',
                    help='LB policy for --multi-replica (byte-identity '
                         'must hold under ANY routing policy)')
    ap.add_argument('--batch', action='store_true',
                    help='durable batch-job chaos leg: kill a replica, '
                         'the LB, and the coordinator mid-job; the '
                         'final output must be byte-identical to the '
                         'fault-free run with zero lost/duplicated '
                         'rows')
    ap.add_argument('--device', default='cuda',
                    help="the engines' device: cuda (the card) or cpu")
    args = ap.parse_args()
    if args.device != 'cpu' and not torch.cuda.is_available():
        print('chaos smoke: no CUDA device is visible (pass --device '
              'cpu to run on the CPU)', file=sys.stderr)
        return 1
    if args.batch:
        return batch_sweep(args.multi_replica or 3,
                           n_rows=2 * args.requests, device=args.device)
    if args.multi_replica:
        return multi_replica_sweep(args.multi_replica, args.seeds,
                                   args.requests, args.policy,
                                   device=args.device)
    print(f'chaos smoke: seeds={args.seeds} '
          f'requests/episode={args.requests}')
    eng = build_engine(args.device)
    failures = []
    for seed in args.seeds:
        failures += episode(eng, seed, args.requests)
    if failures:
        print('CHAOS SMOKE FAILED:')
        for f in failures:
            print(f'  {f}')
        return 1
    print('chaos smoke: PASS')
    return 0


if __name__ == '__main__':
    sys.exit(main())
