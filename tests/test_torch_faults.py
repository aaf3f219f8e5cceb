"""The port's serving loop and step-level fault containment, held against
the JAX engine on the same tiny f32 model and weights: the dense cases of
tests/test_faults.py (plan firing, attributed and unattributed decode
faults, non-finite lanes, supervisor restart and give-up, deadlines,
stall detection, submit timeout), the window policy and decode
lookahead of tests/test_infer.py (greedy tokens identical to the JAX
engine with each flag on), and streaming."""
import copy
import queue
import threading
import time

import pytest
import torch

from helpers_torch import (WindowAudit, assert_same_qos, conservation_errors,
                           jax_engine, key_sets, make_params, port_engine)
from skypilot_tpu.infer import FaultPlan as JaxFaultPlan
from skypilot_tpu.infer import FaultSpec as JaxFaultSpec
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.infer import (FaultPlan, FaultSpec, InjectedFault,
                                      Request)
from skypilot_tpu_torch.infer.server import InferenceServer


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def dense(params):
    return port_engine(params)


@pytest.fixture(scope='module')
def jax_dense(params):
    return jax_engine(params)


def _prompts(n):
    return [[(3 * i + j) % 97 + 1 for j in range(4 + i % 3)]
            for i in range(n)]


def _reqs(n, max_new=8):
    return [Request(request_id=str(i), tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(_prompts(n))]


@pytest.fixture(scope='module')
def jax_tokens(jax_dense):
    """The JAX engine's greedy tokens for _prompts, by (n, max_new)."""
    memo = {}

    def get(n, max_new=8):
        if (n, max_new) not in memo:
            res = jax_dense.generate([
                JaxRequest(request_id=str(i), tokens=p,
                           max_new_tokens=max_new)
                for i, p in enumerate(_prompts(n))])
            memo[n, max_new] = {r.request_id: r.output_tokens for r in res}
        return memo[n, max_new]

    return get


def _serve(eng, jobs, timeout=60):
    """Run jobs through generate_stream; returns {request_id: result}."""
    results, q, stop = {}, queue.Queue(), threading.Event()
    # Enqueued before the loop starts: the first dequeue sees the whole
    # burst, so which consult finds which slots active is deterministic.
    for job in jobs:
        q.put(copy.deepcopy(job))
    t = threading.Thread(
        target=eng.generate_stream,
        args=(q, lambda res: results.__setitem__(res.request_id, res),
              stop), daemon=True)
    t.start()
    try:
        deadline = time.time() + timeout
        while len(results) < len(jobs) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(results) == len(jobs), (
        f'only {len(results)}/{len(jobs)} requests got a result')
    return results


# ---------------------------------------------------------------- plan

def test_faultspec_validation():
    with pytest.raises(ValueError, match='unknown fault site'):
        FaultSpec(site='warp_core', hits=(1,))
    with pytest.raises(ValueError, match='1-based'):
        FaultSpec(site='prefill', hits=(0,))
    with pytest.raises(ValueError, match='prob'):
        FaultSpec(site='prefill', prob=1.5)
    with pytest.raises(ValueError, match='never fire'):
        FaultSpec(site='prefill')


def test_faultplan_hits_fire_on_exact_consults():
    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site='decode_step', hits=(2, 4))])
    fired = [plan.check('decode_step') is not None for _ in range(5)]
    assert fired == [False, True, False, True, False]
    assert plan.stats() == {'consults': {'decode_step': 5},
                            'fired': {'decode_step': 2}}


@pytest.mark.parametrize('seed', [7, 8])
def test_faultplan_fires_as_the_jax_plan_does(seed):
    """Same seed and specs: the port's plan fires on exactly the consults
    the JAX package's does (per-spec numpy streams), max_fires included."""
    def specs(spec_cls):
        return [spec_cls(site='prefill', prob=0.3),
                spec_cls(site='decode_step', prob=1.0, max_fires=2)]

    mine = FaultPlan(seed=seed, specs=specs(FaultSpec))
    ref = JaxFaultPlan(seed=seed, specs=specs(JaxFaultSpec))
    for site in ['prefill'] * 64 + ['decode_step'] * 10:
        assert (mine.check(site) is None) == (ref.check(site) is None)
    assert mine.stats() == ref.stats()
    assert 0 < mine.stats()['fired']['prefill'] < 64
    assert mine.stats()['fired']['decode_step'] == 2


def test_sites_of_other_layouts_are_accepted_and_never_fire(dense,
                                                           jax_tokens):
    """chunk_round and block_alloc belong to chunked prefill and the paged
    pool: a dense engine takes the plan and never consults them."""
    plan = FaultPlan(seed=1, specs=[
        FaultSpec(site='chunk_round', prob=1.0),
        FaultSpec(site='block_alloc', prob=1.0)])
    dense.arm_faults(plan)
    try:
        out = dense.generate(_reqs(3))
    finally:
        dense.disarm_faults()
    assert {r.request_id: r.output_tokens for r in out} == jax_tokens(3)
    stats = plan.stats()
    assert stats['fired'] == {}
    assert not {'chunk_round', 'block_alloc'} & set(stats['consults'])
    assert stats['consults']['decode_step'] >= 1


# -------------------------------------------------------- containment

def test_decode_fault_fails_only_injured_slot_offline(dense, jax_tokens):
    baseline = jax_tokens(3)
    before = dict(dense.fault_stats)
    dense.arm_faults(FaultPlan(seed=1, specs=[
        FaultSpec(site='decode_step', hits=(1,), slot=1)]))
    try:
        out = dense.generate(_reqs(3))
    finally:
        dense.disarm_faults()
    errs = [r for r in out if r.finish_reason == 'error']
    assert len(errs) == 1
    assert errs[0].error_class == 'internal'
    assert 'injected' in errs[0].error
    for r in out:
        if r.finish_reason != 'error':
            assert r.output_tokens == baseline[r.request_id]
            assert r.finish_reason == 'length'
    assert dense.fault_stats['internal_errors'] == \
        before['internal_errors'] + 1
    assert dense.fault_stats['quarantined_batches'] == \
        before['quarantined_batches']


def test_unattributed_fault_quarantines_batch_then_recovers(dense,
                                                          jax_tokens):
    before = dict(dense.fault_stats)
    cache = [k for k, _ in dense.cache]
    dense.arm_faults(FaultPlan(seed=1, specs=[
        FaultSpec(site='decode_step', hits=(1,))]))  # no slot: no blame
    try:
        out = dense.generate(_reqs(3))
    finally:
        dense.disarm_faults()
    assert all(r.finish_reason == 'error' and r.error_class == 'internal'
               for r in out)
    assert dense.fault_stats['quarantined_batches'] == \
        before['quarantined_batches'] + 1
    # The quarantine zeroed the cache in place: the model still holds
    # the same tensors, and the engine answers as before.
    assert all(a is b for a, (b, _) in zip(cache, dense.cache))
    assert all(not k.any() and not v.any() for k, v in dense.cache)
    again = dense.generate(_reqs(3))
    assert {r.request_id: r.output_tokens for r in again} == jax_tokens(3)


def test_nonfinite_logits_kill_lane_not_batch(dense, jax_tokens):
    before = dict(dense.fault_stats)
    dense.arm_faults(FaultPlan(seed=1, specs=[
        FaultSpec(site='nonfinite_logits', hits=(1,), slot=2)]))
    try:
        out = dense.generate(_reqs(3))
    finally:
        dense.disarm_faults()
    errs = [r for r in out if r.finish_reason == 'error']
    assert len(errs) == 1 and errs[0].error_class == 'internal'
    assert errs[0].request_id == '2' and 'non-finite' in errs[0].error
    for r in out:
        if r.finish_reason != 'error':
            assert r.output_tokens == jax_tokens(3)[r.request_id]
    assert dense.fault_stats['nonfinite_lanes'] == \
        before['nonfinite_lanes'] + 1


def test_serving_decode_fault_survivors_byte_identical(dense, jax_tokens):
    """A seeded decode-step failure mid-serving fails only the injured
    request; every other greedy stream equals the JAX engine's."""
    dense.arm_faults(FaultPlan(seed=2, specs=[
        FaultSpec(site='decode_step', hits=(2,), slot=1)]))
    try:
        results = _serve(dense, _reqs(6))
    finally:
        dense.disarm_faults()
    errs = [r for r in results.values() if r.finish_reason == 'error']
    assert len(errs) == 1 and errs[0].error_class == 'internal'
    for rid, res in results.items():
        if res.finish_reason != 'error':
            assert res.output_tokens == jax_tokens(6)[rid], rid


def test_prefill_fault_fails_batch_not_loop(dense):
    """A prefill-dispatch fault fails the batch it hit; the loop keeps
    serving and the next prefill succeeds."""
    before = dict(dense.fault_stats)
    dense.arm_faults(FaultPlan(seed=3, specs=[
        FaultSpec(site='prefill', hits=(1,))]))
    try:
        results = _serve(dense, _reqs(6))
    finally:
        dense.disarm_faults()
    errs = [r for r in results.values() if r.finish_reason == 'error']
    ok = [r for r in results.values() if r.finish_reason == 'length']
    assert errs and ok and len(errs) + len(ok) == 6
    assert all(r.error_class == 'internal' for r in errs)
    assert dense.fault_stats['loop_restarts'] == before['loop_restarts']
    assert all(s is None for s in dense._slots)


# --------------------------------------------------------- supervisor

def test_loop_death_fails_inflight_promptly_and_restarts(dense):
    before = dict(dense.fault_stats)
    dense.arm_faults(FaultPlan(seed=4, specs=[
        FaultSpec(site='serve_loop', hits=(1,))]))
    t0 = time.time()
    try:
        # max_new=24 spans several windows, so the requests are still in
        # their slots at the next iteration top, where the serve_loop
        # site kills the loop.
        results = _serve(dense, _reqs(2, max_new=24), timeout=30)
    finally:
        dense.disarm_faults()
    assert time.time() - t0 < 20
    assert all(r.finish_reason == 'error' and r.error_class == 'internal'
               for r in results.values())
    assert all('loop died' in r.error for r in results.values())
    assert dense.fault_stats['loop_restarts'] == \
        before['loop_restarts'] + 1
    # The restarted loop still serves.
    after = _serve(dense, _reqs(2))
    assert all(r.finish_reason == 'length' for r in after.values())


def test_crash_loop_gives_up_and_drains_queue(dense):
    """A loop that dies on every pass gives up after the restart budget,
    fails the queued requests too and re-raises to the caller."""
    jobs = _reqs(10, max_new=24)
    results, q, stop = {}, queue.Queue(), threading.Event()
    for job in jobs:
        q.put(job)
    dense._MAX_LOOP_RESTARTS = 1  # instance override; deleted below
    dense.arm_faults(FaultPlan(seed=5, specs=[
        FaultSpec(site='serve_loop', prob=1.0)]))
    raised = []

    def run():
        try:
            dense.generate_stream(
                q, lambda res: results.__setitem__(res.request_id, res),
                stop)
        except Exception as e:  # noqa: BLE001
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    try:
        assert not t.is_alive()
        assert raised and isinstance(raised[0], InjectedFault)
        assert len(results) == len(jobs)  # full request accounting
        assert all(r.finish_reason == 'error' and
                   r.error_class == 'internal'
                   for r in results.values())
        assert dense.fault_stats['loop_restarts'] >= 2
        assert not dense.serving
    finally:
        stop.set()
        del dense._MAX_LOOP_RESTARTS
        dense.disarm_faults()


# ----------------------------------------------------------- deadlines

def test_deadline_validation_fails_request_alone(dense):
    out = dense.generate([Request(tokens=[1, 2, 3], max_new_tokens=2,
                                  deadline_s=-1.0),
                          Request(tokens=[1, 2, 3], max_new_tokens=2)])
    assert out[0].finish_reason == 'error'
    assert out[0].error_class == 'client'
    assert 'deadline' in out[0].error
    assert out[1].finish_reason == 'length'


def test_deadline_eviction_offline(dense):
    before = dict(dense.fault_stats)
    out = dense.generate([
        Request(request_id='dl', tokens=[5, 6, 7], max_new_tokens=8,
                deadline_s=1e-6),
        Request(request_id='ok', tokens=[8, 9, 10], max_new_tokens=8)])
    by = {r.request_id: r for r in out}
    assert by['dl'].finish_reason == 'deadline'
    assert by['ok'].finish_reason == 'length'
    assert dense.fault_stats['deadline_evictions'] == \
        before['deadline_evictions'] + 1


def test_deadline_expired_at_dequeue(dense):
    """A request that waited out its deadline in the queue is shed at
    dequeue, typed as the JAX engine types it, without a prefill."""
    before = dict(dense.qos_stats)
    req = Request(request_id='late', tokens=[1, 2, 3], max_new_tokens=8,
                  deadline_s=1.0, arrival_time=time.time() - 10)
    res = _serve(dense, [req])['late']
    assert res.finish_reason == 'deadline' and res.error_class == 'shed'
    assert res.output_tokens == []
    assert dense.qos_stats['sheds'] == before['sheds'] + 1


def test_stall_detection_raises_with_stats(dense):
    """generate_served's watchdog trips after run_stall_timeout_s without
    progress, and the error carries stats()."""
    orig = dense.cfg.run_stall_timeout_s
    dense.cfg.run_stall_timeout_s = 0.4
    dense.arm_faults(FaultPlan(seed=7, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=1.0)]))
    try:
        with pytest.raises(RuntimeError, match='serving stalled') as ei:
            dense.generate_served(_reqs(2, max_new=4))
        assert 'run_stall_timeout_s' in str(ei.value)
        assert 'faults' in str(ei.value)  # stats() in the message
    finally:
        dense.cfg.run_stall_timeout_s = orig
        dense.disarm_faults()
    # Unarmed, the same call serves every request.
    out = dense.generate_served(_reqs(2, max_new=4))
    assert [r.finish_reason for r in out] == ['length', 'length']


def test_submit_timeout_cancels_into_engine(dense):
    """A timed-out submit() cancels into the engine: the abandoned
    request stops decoding and its slot frees."""
    dense.arm_faults(FaultPlan(seed=8, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=0.25)]))
    srv = InferenceServer(dense)
    srv.start()
    try:
        assert srv.ready.wait(60)
        res = srv.submit(Request(tokens=[1, 2, 3], max_new_tokens=40),
                         timeout=0.3)
        assert res is None        # timed out, client gone
        dense.disarm_faults()     # let the loop spin normally again
        deadline = time.time() + 20
        while time.time() < deadline:
            with dense._lock:
                drained = all(s is None for s in dense._slots)
            if drained:
                break
            time.sleep(0.05)
        assert drained, 'abandoned request kept its slot'
    finally:
        dense.disarm_faults()
        srv.stop()


def test_stats_key_sets_match_the_jax_dense_engine(params, dense,
                                                  jax_dense):
    """stats() and kv_health() carry the JAX dense engine's keys, at
    every depth (the server and the LB's prober read them)."""
    dense.generate(_reqs(1))
    assert set(dense.stats()['faults']) == {
        'internal_errors', 'deadline_evictions', 'loop_restarts',
        'quarantined_batches', 'nonfinite_lanes'}
    # The module's dense engine has served through the loop (tenant rows,
    # sheds) and the JAX one offline only: the sections are compared
    # whole between a fresh engine and the JAX one after the same
    # offline request.
    fresh = port_engine(params)
    fresh.generate(_reqs(1))
    jax_dense.generate([JaxRequest(request_id='0', tokens=_prompts(1)[0],
                                   max_new_tokens=8)])
    mine, ref = fresh.stats(), jax_dense.stats()
    assert_same_qos(mine['qos'], ref['qos'])
    assert key_sets(mine) == key_sets(ref)
    # The module's engine after its loop history: every key at every
    # depth, but for the per-tenant rows, which exist once the loop has
    # admitted a tenant.
    served = dense.stats()
    served['qos']['tenants'] = ref['qos']['tenants'] = {}
    assert key_sets(served) == key_sets(ref)
    assert key_sets(dense.kv_health()) == key_sets(jax_dense.kv_health())
    assert dense.stats()['kv_bytes_total'] == \
        jax_dense.stats()['kv_bytes_total']


# ------------------------------------------- window policy, lookahead

def test_adaptive_decode_window_token_identity(params):
    """Queue-aware windows (2 steps while an arrival waits with a slot
    free) change the dispatch schedule, never the tokens: greedy output
    equals the JAX engine's with the flag on, in both regimes."""
    cfg = dict(num_slots=8, prefill_buckets=(8,), max_new_tokens=12,
               decode_steps=8, adaptive_decode_window=True)
    ref = jax_engine(params, **cfg)
    ref._arrivals_hint = 1
    [want] = ref.generate([JaxRequest(tokens=[7, 8, 9],
                                      max_new_tokens=12)])
    adaptive = port_engine(params, **cfg)
    calls = []
    orig = adaptive._decode

    def spy(*args):
        calls.append(args[-1])          # `steps`
        return orig(*args)

    adaptive._decode = spy
    # Backlog signalled + 7 free slots -> short windows throughout.
    adaptive._arrivals_hint = 1
    [got] = adaptive.generate([Request(tokens=[7, 8, 9],
                                       max_new_tokens=12)])
    assert got.output_tokens == want.output_tokens
    assert calls and all(k == 2 for k in calls), calls
    # No backlog (offline generate): full windows at occupancy 1.
    adaptive._arrivals_hint = 0
    calls.clear()
    [got2] = adaptive.generate([Request(tokens=[7, 8, 9],
                                        max_new_tokens=12)])
    assert got2.output_tokens == want.output_tokens
    assert calls and all(k == 8 for k in calls), calls


def test_decode_lookahead_token_identity(params):
    """Decode lookahead changes the dispatch schedule, never the tokens:
    lone greedy streams through the serving loop equal the JAX engine's
    serving loop with lookahead on; every window after a stream's first
    is queued ahead, and no wasted tail window is dispatched."""
    cfg = dict(num_slots=2, prefill_buckets=(8,), max_new_tokens=24,
               decode_steps=4, decode_lookahead=True)
    prompts = [[4, 5, 6], [7, 8], [5, 5, 5, 5], [9, 3, 1]]
    jax_ref = jax_engine(params, **cfg)
    want = []
    for p in prompts:
        out = _jax_serve(jax_ref, [JaxRequest(request_id='x', tokens=p,
                                              max_new_tokens=24)])
        want.append(out['x'].output_tokens)
    eng = port_engine(params, **cfg)
    srv = InferenceServer(eng)
    srv.start()
    assert srv.ready.wait(60)
    dispatches = {'n': 0}
    ahead = {'n': 0}
    orig = eng._decode
    orig_ahead = eng._maybe_dispatch_ahead

    def spy(*args):
        dispatches['n'] += 1
        return orig(*args)

    def spy_ahead(*args, **kw):
        orig_ahead(*args, **kw)
        if eng._ahead is not None:
            ahead['n'] += 1

    eng._decode = spy
    eng._maybe_dispatch_ahead = spy_ahead
    try:
        for p, w in zip(prompts, want):
            res = srv.submit(Request(tokens=list(p), max_new_tokens=24),
                             timeout=60)
            assert res is not None and res.finish_reason == 'length', res
            assert res.output_tokens == w, (p, res.output_tokens, w)
    finally:
        srv.stop()
    # A lone 24-token stream at window 4 consumes 6 windows; windows 2..6
    # were each queued while the previous one was in flight, and a 7th
    # (all past max_new) never was.
    assert ahead['n'] >= len(prompts) * 5, (ahead, dispatches)
    assert dispatches['n'] == len(prompts) * (24 // 4), dispatches


def _jax_serve(eng, jobs, timeout=60):
    results, q, stop = {}, queue.Queue(), threading.Event()
    for job in jobs:
        q.put(job)
    t = threading.Thread(
        target=eng.generate_stream,
        args=(q, lambda res: results.__setitem__(res.request_id, res),
              stop), daemon=True)
    t.start()
    deadline = time.time() + timeout
    while len(results) < len(jobs) and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=30)
    assert len(results) == len(jobs)
    return results


def test_decode_lookahead_prefill_during_flight(params):
    """A request arriving while another stream's lookahead window is in
    flight prefills without waiting for it: both outputs stay identical
    to the JAX engine's."""
    cfg = dict(num_slots=2, max_cache_len=96, prefill_buckets=(8,),
               max_new_tokens=48, decode_steps=4)
    pa, pb = [4, 5, 6], [9, 8, 7, 6]
    want = {r.request_id: r.output_tokens for r in jax_engine(
        params, **cfg).generate([
            JaxRequest(request_id='a', tokens=pa, max_new_tokens=48),
            JaxRequest(request_id='b', tokens=pb, max_new_tokens=48)])}
    eng = port_engine(params, decode_lookahead=True, **cfg)
    # Slow each loop pass so B lands while A's ahead window is queued.
    eng.arm_faults(FaultPlan(seed=9, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=0.01)]))
    srv = InferenceServer(eng)
    srv.start()
    assert srv.ready.wait(60)
    in_flight = []
    orig_start = eng._start_batch
    eng._start_batch = lambda items: (in_flight.append(
        eng._ahead is not None), orig_start(items))[1]
    results = {}

    def run_a():
        results['a'] = srv.submit(Request(tokens=pa, max_new_tokens=48),
                                  timeout=60)

    ta = threading.Thread(target=run_a)
    ta.start()
    try:
        deadline = time.time() + 30
        while eng._ahead is None and time.time() < deadline:
            time.sleep(0.001)
        results['b'] = srv.submit(Request(tokens=pb, max_new_tokens=48),
                                  timeout=60)
        ta.join(timeout=60)
    finally:
        srv.stop()
    assert not ta.is_alive()
    assert in_flight == [False, True], in_flight   # B met A's ahead window
    assert results['a'].output_tokens == want['a']
    assert results['b'].output_tokens == want['b']


# ---------------------------------------------------------- streaming

def test_streaming_chunks_concatenate_to_result(params):
    """Streamed chunks concatenate exactly to the final result's
    output_tokens and equal the non-streamed greedy output."""
    eng = port_engine(params, num_slots=2, prefill_buckets=(8,),
                      max_new_tokens=12, decode_steps=3)
    srv = InferenceServer(eng)
    srv.start()
    try:
        assert srv.ready.wait(60)
        want = srv.submit(Request(tokens=[4, 5, 6], max_new_tokens=12))
        chunks, final = [], None
        for kind, value in srv.submit_stream(
                Request(tokens=[4, 5, 6], max_new_tokens=12)):
            if kind == 'tokens':
                chunks.append(value)
            elif kind == 'done':
                final = value
        assert final is not None and final.finish_reason == 'length'
        streamed = [t for c in chunks for t in c]
        assert streamed == final.output_tokens == want.output_tokens
        # Incremental: more than one chunk for 12 tokens at window 3.
        assert len(chunks) >= 3
    finally:
        srv.stop()


def test_generate_stream_burst_with_prefill_cap(params):
    """The serving loop drains a burst larger than the slot count, with
    prefills capped per decode gap while slots are busy, and delivers
    every result exactly once."""
    eng = port_engine(params, num_slots=3, prefill_buckets=(8,),
                      max_new_tokens=20, decode_steps=2,
                      prefills_per_gap=1)
    admissions = []
    orig_start = eng._start_batch
    eng._start_batch = lambda items: (admissions.append(
        (len(items), any(s is not None for s in eng._slots))),
        orig_start(items))[1]
    lengths = [4, 12, 20, 4, 12, 20]
    results = _serve(eng, [Request(tokens=[1, 2, i + 1], request_id=str(i),
                                   max_new_tokens=lengths[i])
                           for i in range(6)])
    assert sorted(results) == [str(i) for i in range(6)]
    for rid, res in results.items():
        assert res.finish_reason == 'length'
        assert len(res.output_tokens) == lengths[int(rid)]
    busy = [n for n, was_busy in admissions if was_busy]
    assert busy, f'cap branch never exercised: {admissions}'
    assert max(busy) <= eng.cfg.prefills_per_gap, admissions


def test_inference_mode_on_the_serving_thread(dense):
    """The serving thread decodes in inference mode (a thread-local
    switch): no window it runs builds autograd state."""
    seen = []
    orig = dense._decode

    def spy(*args):
        seen.append(torch.is_inference_mode_enabled())
        return orig(*args)

    dense._decode = spy
    try:
        _serve(dense, _reqs(1))
    finally:
        del dense._decode
    assert seen and all(seen)


# ------------------------------------------- out-of-range ids (ROADMAP C1)

def test_out_of_range_ids_do_not_fail_their_prefill_batch(dense,
                                                          jax_dense):
    """A valid request co-batched (one prefill dispatch) with an id of V
    and one of -V-1 (V = 101): all three are served with the JAX
    engine's tokens and finish reasons, the valid one 'length'."""
    prompts = [[1, 2, 3], [101, 5, 6], [-102, 8, 9]]
    ref = jax_dense.generate([JaxRequest(request_id=str(i), tokens=p,
                                         max_new_tokens=6)
                              for i, p in enumerate(prompts)])
    before = dense.fault_stats['internal_errors']
    results = _serve(dense, [Request(request_id=str(i), tokens=p,
                                     max_new_tokens=6)
                             for i, p in enumerate(prompts)])
    for r in ref:
        assert results[r.request_id].output_tokens == r.output_tokens
        assert results[r.request_id].finish_reason == r.finish_reason
    assert results['0'].finish_reason == 'length'
    assert dense.fault_stats['internal_errors'] == before


# ---------------------------------------- the paged pool with the tree

@pytest.fixture(scope='module')
def paged(params):
    """A paged engine with the radix cache and the host tier on a pool of
    20 blocks (radix eviction, so spills, under the traffic below)."""
    return port_engine(params, kv_block_size=8, kv_blocks=20,
                       auto_prefix_cache=True, host_kv_bytes=1 << 20)


def _long_reqs(n, max_new=8):
    """_prompts behind a shared 16-token head (two full blocks), so the
    tree has prefixes to match."""
    head = [(7 * j) % 97 + 1 for j in range(16)]
    return [Request(request_id=str(i), tokens=head + p,
                    max_new_tokens=max_new)
            for i, p in enumerate(_prompts(n))]


@pytest.fixture(scope='module')
def jax_long_tokens(jax_dense):
    res = jax_dense.generate([JaxRequest(request_id=r.request_id,
                                         tokens=r.tokens, max_new_tokens=8)
                              for r in _long_reqs(6)])
    return {r.request_id: r.output_tokens for r in res}


def test_paged_prefill_fault_fails_batch_then_serves(paged,
                                                     jax_long_tokens):
    """A prefill fault on the paged engine fails its batch; the loop and
    the pool survive, the next burst (radix hits included) gives the JAX
    engine's tokens, and the conservation law holds after every window
    and after the fault."""
    with WindowAudit(paged) as audit:
        paged.arm_faults(FaultPlan(seed=3, specs=[
            FaultSpec(site='prefill', hits=(1,))]))
        try:
            first = _serve(paged, _long_reqs(6))
        finally:
            paged.disarm_faults()
        errs = [r for r in first.values() if r.finish_reason == 'error']
        assert errs and all(r.error_class == 'internal' for r in errs)
        assert conservation_errors(paged) == []
        hits = paged.radix_stats['hits']
        again = _serve(paged, _long_reqs(6))
    assert {k: r.output_tokens for k, r in again.items()} == jax_long_tokens
    assert paged.radix_stats['hits'] > hits
    assert audit.windows > 0 and audit.errors == []


@pytest.mark.parametrize('slot', [1, None], ids=['attributed',
                                                 'unattributed'])
def test_paged_decode_fault_contained_then_serves(paged, jax_long_tokens,
                                                  slot):
    """A decode fault on the paged engine: attributed, only the injured
    request fails; unattributed, the active batch fails, the pool is
    zeroed in place, the allocator reset and the tree dropped while the
    host tier stays.  Either way the next requests give the JAX engine's
    tokens, and no block leaks."""
    with WindowAudit(paged) as audit:
        _serve(paged, _long_reqs(6))             # the tree holds prefixes
        tier_entries = paged._host_tier.entries
        gen = paged._radix.generation
        quarantined = paged.fault_stats['quarantined_batches']
        pool = [k for k, _ in paged.cache]
        paged.arm_faults(FaultPlan(seed=2, specs=[
            FaultSpec(site='decode_step', hits=(2,), slot=slot)]))
        try:
            hit = _serve(paged, _long_reqs(6))
        finally:
            paged.disarm_faults()
        errs = [r for r in hit.values() if r.finish_reason == 'error']
        if slot is not None:
            assert len(errs) == 1
            for rid, res in hit.items():
                if res.finish_reason != 'error':
                    assert res.output_tokens == jax_long_tokens[rid]
        else:
            assert errs and all(r.error_class == 'internal' for r in errs)
            assert paged.fault_stats['quarantined_batches'] == \
                quarantined + 1
            assert paged._radix.generation == gen + 1    # tree dropped
            assert all(a is b for a, (b, _) in zip(pool, paged.cache))
            assert paged._host_tier.entries >= tier_entries
        assert conservation_errors(paged) == []
        again = _serve(paged, _long_reqs(6))
    assert {k: r.output_tokens for k, r in again.items()} == jax_long_tokens
    assert audit.errors == []
