"""QoS in the port (skypilot_tpu_torch/infer/qos.py and the engine's
hooks) held against the JAX package's on the tiny f32 model of
helpers_torch (CPU): the scheduler's pop order, requeue and shed victims
on the same pushes; QoS reorders and sheds but never changes a stream's
tokens; the typed shed shapes; preemption at a chunk boundary with the
JAX paged engine's count, tokens and radix counters; a parked job whose
adapter is re-registered adopts nothing stale (ROADMAP.md C3); and the
service-rate estimate that stats() reports with QoS off (C5)."""
import copy
import queue
import threading
import time

import numpy as np
import pytest

from helpers_torch import (WindowAudit, assert_same_qos, jax_engine,
                           make_params, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import qos as jqos
from skypilot_tpu.infer.faults import FaultPlan as JaxFaultPlan
from skypilot_tpu.infer.faults import FaultSpec as JaxFaultSpec
from skypilot_tpu.train import lora as jlora
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec, Request
from skypilot_tpu_torch.infer import qos
from skypilot_tpu_torch.train import lora
from test_torch_lora_serving import LORA, _tree

# Paged, radix, chunked: the configuration preemption needs.  One slot,
# so an interactive arrival finds every slot taken by the batch prompt,
# which no bucket holds (so it chunks); parked after 4 chunks, its 28-token
# suffix fits the 32 bucket beside the 4 matched blocks.
PREEMPT = dict(num_slots=1, max_cache_len=128, prefill_buckets=(8, 16, 32),
               kv_block_size=8, prefill_chunk=8, auto_prefix_cache=True)
BATCH_PROMPT = [(7 * j) % 97 + 1 for j in range(60)]
INTERACTIVE_PROMPT = [9, 4, 2, 8]


@pytest.fixture(scope='module')
def params():
    return make_params()


def _jobs(cls):
    """Ten requests over two tenants and both classes (tests/test_qos.py's
    mix)."""
    return [cls(request_id=str(i),
                tokens=[(5 * i + j) % 97 + 1 for j in range(3 + i % 5)],
                max_new_tokens=6,
                priority='batch' if i % 3 else 'interactive',
                tenant_id='teamA' if i % 2 else 'teamB')
            for i in range(10)]


def _serve(eng, jobs, expect=None, timeout=120):
    """Serve `jobs` through generate_stream until `expect` results (one a
    job by default) are in; {request_id: result}."""
    expect = len(jobs) if expect is None else expect
    results, q, stop = {}, queue.Queue(), threading.Event()
    for job in jobs:
        q.put(copy.deepcopy(job))
    t = threading.Thread(
        target=eng.generate_stream,
        args=(q, lambda res: results.__setitem__(res.request_id, res), stop),
        daemon=True)
    t.start()
    try:
        deadline = time.time() + timeout
        while len(results) < expect and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(timeout=30)
    assert len(results) == expect, sorted(results)
    return results


# ------------------------------------------------------------ scheduler


def test_scheduler_matches_jax_on_the_same_pushes():
    """Random pushes (tenants with weights, both classes, costs), pops,
    requeues and shed_victim calls, with and without prefer_over and a
    doomed filter: the same request ids, depths and stats() as the JAX
    WfqScheduler's, and the same estimator readings."""
    rng = np.random.default_rng(0)
    weights = {'a': 3.0, 'b': 1.0, 'c': 0.5}
    mine, ref = qos.WfqScheduler(weights), jqos.WfqScheduler(weights)
    seen = []
    for step in range(300):
        op = rng.choice(['push', 'push', 'pop', 'requeue', 'shed'])
        if op == 'push':
            kw = dict(request_id=str(step),
                      tokens=[1] * int(rng.integers(1, 20)),
                      max_new_tokens=int(rng.integers(1, 30)),
                      priority=[None, 'batch', 'interactive',
                                'other'][rng.integers(4)],
                      tenant_id=[None, 'a', 'b', 'c'][rng.integers(4)],
                      deadline_s=(None if rng.random() < 0.4
                                  else float(rng.integers(1, 9))))
            mine.push(Request(**kw))
            ref.push(JaxRequest(**kw))
        elif op == 'pop':
            got, want = mine.pop(), ref.pop()
            assert (got and got.request_id) == (want and want.request_id)
            if got is not None:
                seen.append((got, want))
        elif op == 'requeue' and seen:
            got, want = seen.pop(int(rng.integers(len(seen))))
            mine.requeue(got)
            ref.requeue(want)
        elif op == 'shed':
            prefer = [None, 'a', 'b', 'c', '_default'][rng.integers(5)]
            cut = float(rng.integers(1, 9))
            got = mine.shed_victim(prefer_over=prefer,
                                   doomed=lambda r: r.deadline_s < cut)
            want = ref.shed_victim(prefer_over=prefer,
                                   doomed=lambda r: r.deadline_s < cut)
            assert (got and got.request_id) == (want and want.request_id)
        assert mine.backlog() == ref.backlog()
        for cls in ('interactive', 'batch'):
            assert mine.waiting(cls) == ref.waiting(cls)
        assert mine.stats() == ref.stats()
    assert mine.served == ref.served and len(mine.served) == 4
    assert qos.PRIORITY_CLASSES == jqos.PRIORITY_CLASSES
    assert qos.DEFAULT_TENANT == jqos.DEFAULT_TENANT
    est, jest = qos.ServiceEstimator(alpha=0.5), jqos.ServiceEstimator(
        alpha=0.5)
    for tokens, seconds in ((100, 1.0), (200, 1.0), (0, 1.0), (10, 0.0),
                            (33, 0.7)):
        est.observe(tokens, seconds)
        jest.observe(tokens, seconds)
        assert est.rate() == jest.rate()
        assert est.projected_s(300) == jest.projected_s(300)
    for bad in ((dict(alpha=0.0), 'alpha'), ):
        with pytest.raises(ValueError, match=bad[1]):
            qos.ServiceEstimator(**bad[0])
    with pytest.raises(ValueError, match='tenant weight must be > 0'):
        qos.WfqScheduler({'a': 0})


# ---------------------------------------------------------------- engine


def test_qos_reorders_but_never_changes_tokens(params):
    """Mixed tenants and classes through a qos engine: every stream is
    the qos-off engine's, and stats()['qos'] (WFQ policy, per-tenant
    admissions) is the JAX qos engine's."""
    off = port_engine(params)
    on = port_engine(params, qos=True, qos_tenant_weights={'teamA': 2.0})
    jon = jax_engine(params, qos=True, qos_tenant_weights={'teamA': 2.0})
    ref = _serve(off, _jobs(Request))
    got = _serve(on, _jobs(Request))
    jgot = _serve(jon, _jobs(JaxRequest))
    for rid, r in got.items():
        assert r.finish_reason == ref[rid].finish_reason
        assert r.output_tokens == ref[rid].output_tokens, rid
        assert r.output_tokens == jgot[rid].output_tokens, rid
    st = on.stats()['qos']
    assert st['enabled'] is True and st['scheduler']['policy'] == 'wfq'
    assert st['tenants']['teamA']['admitted'] == 5
    assert off.stats()['qos']['enabled'] is False
    assert_same_qos(st, jon.stats()['qos'])


def test_unknown_priority_is_a_client_error(params):
    """The same error text and class as the JAX qos engine's."""
    [mine] = _serve(port_engine(params, qos=True),
                    [Request(request_id='bad', tokens=[1, 2, 3],
                             max_new_tokens=4,
                             priority='ultra')]).values()
    [ref] = _serve(jax_engine(params, qos=True),
                   [JaxRequest(request_id='bad', tokens=[1, 2, 3],
                               max_new_tokens=4,
                               priority='ultra')]).values()
    assert mine.finish_reason == ref.finish_reason == 'error'
    assert mine.error_class == ref.error_class == 'client'
    assert mine.error == ref.error and 'priority' in mine.error


def test_shed_shapes_match_jax(params):
    """A projection miss (the estimator seeded at 1 token/s) and a request
    expired in the queue are shed at dequeue with the JAX engine's typed
    shape and counters; a request without a deadline is never shed.  Then
    the over-fair-share victim: with tenant 'a' far over its share, a
    doomed 'b' head sheds a doomed queued 'a' row in its place."""
    outs = []
    for eng, cls in ((port_engine(params, qos=True), Request),
                     (jax_engine(params, qos=True), JaxRequest)):
        eng._svc_estimator.observe(10, 10.0)
        late = cls(request_id='late', tokens=[1, 2, 3], max_new_tokens=8,
                   deadline_s=1.0)
        late.arrival_time = time.time() - 10
        got = _serve(eng, [
            cls(request_id='doomed', tokens=[1, 2, 3], max_new_tokens=8,
                deadline_s=2.0),
            late,
            cls(request_id='fine', tokens=[1, 2, 3], max_new_tokens=8)])
        outs.append((eng, got))
    (mine, got), (ref, want) = outs
    assert got['doomed'].error_class == 'shed'
    assert 'projected' in got['doomed'].error
    assert 'expired in queue' in got['late'].error
    assert got['fine'].finish_reason == 'length'
    for rid in got:
        for f in ('finish_reason', 'error_class', 'output_tokens'):
            assert getattr(got[rid], f) == getattr(want[rid], f), (rid, f)
    assert got['doomed'].error.split(' cannot')[1] == \
        want['doomed'].error.split(' cannot')[1]
    assert mine.fault_stats == ref.fault_stats
    assert_same_qos(mine.stats()['qos'], ref.stats()['qos'])
    assert mine.stats()['qos']['sheds'] == 2

    # Over-share victim: 'a' was served 40 cost units, 'b' none.
    victims = []
    for eng, cls in ((port_engine(params, qos=True), Request),
                     (jax_engine(params, qos=True), JaxRequest)):
        eng._sched.served['a'] = 40.0
        eng._svc_estimator.observe(10, 10.0)
        with eng._lock:
            for i in range(2):
                eng._sched.push(cls(request_id=f'a{i}', tokens=[1, 2, 3],
                                    max_new_tokens=8, tenant_id='a',
                                    deadline_s=2.0))
        got = _serve(eng, [cls(request_id='b0', tokens=[1, 2, 3],
                               max_new_tokens=8, tenant_id='b',
                               deadline_s=2.0)], expect=3)
        victims.append((eng, got, eng.stats()['qos']))
    (_, got, st), (_, want, jst) = victims
    assert 'over-fair-share victim' in got['a1'].error
    for rid, r in want.items():
        assert (got[rid].finish_reason, got[rid].error_class) == \
            (r.finish_reason, r.error_class)
        assert got[rid].error.split(':')[0] == r.error.split(':')[0]
    assert_same_qos(st, jst)


def _preempting_run(eng, cls, arrive_after, tenant=None, adapter=None,
                    before_park=None):
    """The batch prompt, then the interactive one queued right after the
    engine's `arrive_after`-th chunk round, served with the loop stalled
    10 ms a pass; `before_park` runs on the serving thread, outside the
    engine lock, just before the first preemption check."""
    q, results, stop = queue.Queue(), {}, threading.Event()
    orig, calls = eng._chunk_round, [0]

    def chunk_round():
        out = orig()
        calls[0] += 1
        if calls[0] == arrive_after:
            q.put(cls(request_id='inter', tokens=list(INTERACTIVE_PROMPT),
                      max_new_tokens=8, priority='interactive'))
        return out

    eng._chunk_round = chunk_round
    if before_park is not None:
        preempt = eng._maybe_preempt_for

        def maybe_preempt_for(exclude):
            if eng._sched.waiting('interactive'):
                before_park()
                del eng._maybe_preempt_for
            return preempt(exclude)

        eng._maybe_preempt_for = maybe_preempt_for
    plan = (FaultPlan if cls is Request else JaxFaultPlan)(seed=0, specs=[
        (FaultSpec if cls is Request else JaxFaultSpec)(
            site='stall', prob=1.0, stall_s=0.01)])
    eng.arm_faults(plan)
    q.put(cls(request_id='batch', tokens=list(BATCH_PROMPT),
              max_new_tokens=8, priority='batch', tenant_id=tenant,
              adapter=adapter))
    t = threading.Thread(target=eng.generate_stream,
                         args=(q, lambda r: results.__setitem__(
                             r.request_id, r), stop), daemon=True)
    t.start()
    try:
        deadline = time.time() + 90
        while len(results) < 2 and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(timeout=30)
        eng.disarm_faults()
        del eng._chunk_round
    assert len(results) == 2, sorted(results)
    return results


def test_interactive_preempts_batch_at_a_chunk_boundary(params):
    """A 60-token batch prompt (8-token chunks) parks after its fourth
    chunk round for an interactive arrival and resumes from its own radix
    blocks (a suffix-only prefill of 28 tokens): both streams equal an uncontended
    qos-off run, and the preemption count, tokens and radix counters
    equal the JAX paged engine's on the same arrival.  The pool is
    conserved after every window."""
    ref = jax_engine(params, **PREEMPT)
    uncontended = {**_serve(ref, [JaxRequest(
        request_id='batch', tokens=list(BATCH_PROMPT), max_new_tokens=8)]),
        **_serve(ref, [JaxRequest(request_id='inter',
                                  tokens=list(INTERACTIVE_PROMPT),
                                  max_new_tokens=8)])}
    mine = port_engine(params, qos=True, **PREEMPT)
    jax_qos = jax_engine(params, qos=True, **PREEMPT)
    with WindowAudit(mine) as audit:
        got = _preempting_run(mine, Request, arrive_after=4)
    want = _preempting_run(jax_qos, JaxRequest, arrive_after=4)
    assert mine.qos_stats['preemptions'] == 1
    assert mine.qos_stats == jax_qos.qos_stats
    assert mine.radix_stats == jax_qos.radix_stats
    assert mine.radix_stats['hits'] == 1
    assert mine.radix_stats['tokens_reused'] == 32
    for rid in ('batch', 'inter'):
        assert got[rid].output_tokens == uncontended[rid].output_tokens
        assert got[rid].output_tokens == want[rid].output_tokens
        assert got[rid].finish_reason == want[rid].finish_reason
    assert audit.errors == []
    assert_same_qos(mine.stats()['qos'], jax_qos.stats()['qos'])


def test_parked_job_of_a_reregistered_adapter_adopts_nothing_stale(
        params, tmp_path):
    """ROADMAP.md C3 under preemption: the batch prompt chunks under
    adapter 't' (a.npz), 't' is re-registered with b.npz's weights, and
    the job is parked: its rows, written under the old weights, join no
    radix node, so it resumes from scratch and its tokens are those of an
    engine that only ever had b.npz's weights."""
    jlora.save_adapter_npz(_tree(1), str(tmp_path / 'a.npz'))
    jlora.save_adapter_npz(_tree(2), str(tmp_path / 'b.npz'))
    old = lora.load_adapter_npz(str(tmp_path / 'a.npz'))
    new = lora.load_adapter_npz(str(tmp_path / 'b.npz'))
    fresh = port_engine(params, **LORA, **PREEMPT)
    fresh.register_adapter('t', new)
    [want] = fresh.generate([Request(tokens=list(BATCH_PROMPT),
                                     max_new_tokens=8, adapter='t')])
    eng = port_engine(params, qos=True, **LORA, **PREEMPT)
    eng.register_adapter('t', old)
    with WindowAudit(eng) as audit:
        got = _preempting_run(
            eng, Request, arrive_after=4, adapter='t',
            before_park=lambda: eng.register_adapter('t', new))
    assert eng.qos_stats['preemptions'] == 1
    assert eng.radix_stats['hits'] == 0
    assert got['batch'].output_tokens == want.output_tokens
    assert audit.errors == []


def test_c5_service_rate_follows_clean_finishes(params):
    """ROADMAP.md C5, with QoS off on both engines: the rate is None
    before any clean finish, a positive float after one, and an error
    finish (an attributed decode fault) or a cancelled one leaves it
    unchanged."""
    for eng, cls, plan, spec in (
            (port_engine(params), Request, FaultPlan, FaultSpec),
            (jax_engine(params), JaxRequest, JaxFaultPlan, JaxFaultSpec)):
        def rate():
            return eng.stats()['qos']['service_rate_tokens_per_s']

        def failed_run():
            eng.arm_faults(plan(seed=0, specs=[
                spec(site='decode_step', hits=(1,), slot=0)]))
            [res] = eng.generate([cls(tokens=[1, 2, 3], max_new_tokens=4)])
            eng.disarm_faults()
            assert res.finish_reason == 'error'

        assert eng.stats()['qos']['enabled'] is False
        failed_run()
        assert rate() is None
        [res] = eng.generate([cls(tokens=[1, 2, 3], max_new_tokens=4)])
        assert res.finish_reason == 'length'
        first = rate()
        assert isinstance(first, float) and first > 0
        failed_run()
        assert rate() == first
        # Cancelled in its slot, from the client's side (cancel() frees
        # the slot through _finish_slot; no result is delivered).
        started, q, stop = threading.Event(), queue.Queue(), threading.Event()
        q.put(cls(request_id='c', tokens=[1, 2, 3], max_new_tokens=56,
                  stream_cb=lambda toks: started.set()))
        # Seven windows at 0.2 s a loop pass: the cancel lands mid-stream.
        eng.arm_faults(plan(seed=0, specs=[
            spec(site='stall', prob=1.0, stall_s=0.2)]))
        t = threading.Thread(target=eng.generate_stream,
                             args=(q, lambda r: None, stop), daemon=True)
        t.start()
        try:
            assert started.wait(60)
            assert eng.cancel('c')
        finally:
            stop.set()
            t.join(timeout=30)
            eng.disarm_faults()
        assert rate() == first


def test_qos_server_matches_the_jax_server(params):
    """A qos server pair (tenant weights a=3, b=1): /generate with tenants
    and classes gives the JAX server's tokens, an unknown priority the
    JAX server's 400 and error text, and /stats the JAX server's qos
    section."""
    from test_torch_server import _call, _Live
    from skypilot_tpu.infer import server as jax_server
    from skypilot_tpu_torch.infer import server as port_server
    weights = {'a': 3.0, 'b': 1.0}
    lives = [_Live(jax_server, jax_engine(params, qos=True,
                                          qos_tenant_weights=weights)),
             _Live(port_server, port_engine(params, qos=True,
                                            qos_tenant_weights=weights))]
    try:
        answers = []
        for live in lives:
            got = [_call(live.port, 'POST', '/generate', {
                'tokens': [3 + i, 9, 27], 'max_new_tokens': 4,
                'tenant_id': 'ab'[i % 2],
                'priority': ('batch', 'interactive')[i % 2]})
                for i in range(4)]
            bad = _call(live.port, 'POST', '/generate',
                        {'tokens': [1, 2], 'priority': 'vip'})
            stats = _call(live.port, 'GET', '/stats')
            answers.append((got, bad, stats))
        (jgot, jbad, jstats), (pgot, pbad, pstats) = answers
        for j, p in zip(jgot, pgot):
            assert p[0] == j[0] == 200
            assert p[2]['output_tokens'] == j[2]['output_tokens']
        assert pbad[0] == jbad[0] == 400
        assert pbad[2]['error'] == jbad[2]['error']
        assert pstats[2]['qos']['enabled'] is True
        assert_same_qos(pstats[2]['qos'], jstats[2]['qos'])
    finally:
        for live in lives:
            live.close()
