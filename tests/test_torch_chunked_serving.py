"""Chunked prefill in the port's serving loop: long prompts arriving at
random phases while other streams decode (adaptive window and decode
lookahead on) give the JAX engine's greedy tokens; a prompt arriving
while another is still being chunked reuses that prompt's chunk-boundary
radix blocks; a chunk_round fault, a deadline and a cancel on a chunking
slot end it with its typed finish and free its blocks while the other
requests are served unchanged -- the fault and the deadline exactly as
the JAX engine under the same plan.  The block-conservation law is
checked after every decode window.  f32, on the CPU."""
import contextlib
import random
import threading
import time

import numpy as np
import pytest

from helpers_torch import (WindowAudit, conservation_errors, jax_engine,
                           make_params, port_engine)
from skypilot_tpu.infer import FaultPlan as JaxFaultPlan
from skypilot_tpu.infer import FaultSpec as JaxFaultSpec
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.infer import server as port_server

CHUNK = dict(prefill_buckets=(8, 16), prefill_chunk=8)
PAGED = dict(kv_block_size=8, auto_prefix_cache=True)
# Each serving-loop pass sleeps this long (the stall fault site), so a
# test can act between two chunk rounds.
SLOW_LOOP = dict(site='stall', prob=1.0, stall_s=0.02)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def solo(params):
    """Greedy output of each prompt served alone by the JAX engine with
    monolithic prefill (its buckets then reach the cache), memoized."""
    eng = jax_engine(params, prefill_buckets=(8, 16))
    memo = {}

    def run(tokens, max_new):
        key = (tuple(tokens), max_new)
        if key not in memo:
            [res] = eng.generate([JaxRequest(tokens=list(tokens),
                                             max_new_tokens=max_new)])
            memo[key] = res.output_tokens
        return memo[key]

    return run


def _wait(cond, timeout=60.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, 'condition never held'
        time.sleep(0.001)


@pytest.mark.parametrize('layout', ['dense', 'paged_radix'])
def test_serving_randomized_identity(params, solo, layout):
    """Twelve requests, up to 48 prompt tokens (past the largest bucket
    16), one in three sharing a 16-token prefix, at random phases into a
    live server: every output is the JAX engine's solo greedy output."""
    eng = port_engine(params, adaptive_decode_window=True,
                      decode_lookahead=True, decode_steps=4, **CHUNK,
                      **(PAGED if layout == 'paged_radix' else {}))
    r = random.Random(11)
    prefix = [r.randrange(1, 100) for _ in range(16)]
    jobs = []
    for i in range(12):
        toks = [r.randrange(1, 100) for _ in range(r.randrange(1, 49))]
        if i % 3 == 0:
            toks = (prefix + toks)[:48]
        jobs.append((toks, r.randrange(1, 16)))
    want = [solo(t, k) for t, k in jobs]
    audit = WindowAudit(eng) if eng._paged else contextlib.nullcontext()
    srv = port_server.InferenceServer(eng)
    got = {}
    with audit:
        srv.start()
        assert srv.ready.wait(timeout=120)

        def one(i, toks, k):
            got[i] = srv.submit(port.Request(tokens=list(toks),
                                             max_new_tokens=k), timeout=120)

        threads = []
        for i, (toks, k) in enumerate(jobs):
            time.sleep(r.random() * 0.06)
            t = threading.Thread(target=one, args=(i, toks, k), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=120)
        srv.stop()
    assert eng.chunk_stats['requests'] > 0
    for i, (toks, k) in enumerate(jobs):
        assert got[i].finish_reason == 'length', (i, got[i])
        assert got[i].output_tokens == want[i], (i, len(toks), k)
    if eng._paged:
        assert not audit.errors, audit.errors[:5]
        assert eng.radix_stats['hits'] > 0


def _serve(eng):
    """A serving loop on its own thread: (queue, results, stop)."""
    import queue
    q, results, stop = queue.Queue(), {}, threading.Event()
    threading.Thread(target=eng.generate_stream,
                     args=(q, lambda res: results.__setitem__(
                         res.request_id, res), stop), daemon=True).start()
    return q, results, stop


def test_radix_hits_on_chunk_boundary_blocks(params, solo):
    """A 48-token prompt chunks 8 rows a round; each round's full blocks
    join the radix tree at once, so a prompt sharing its first 40 tokens
    that arrives after four rounds reuses them mid-prefill (its suffix
    then fits the largest bucket)."""
    eng = port_engine(params, **CHUNK, **PAGED)
    eng.arm_faults(FaultPlan(seed=0, specs=[FaultSpec(**SLOW_LOOP)]))
    rng = np.random.default_rng(2)
    a = rng.integers(1, 101, 48).tolist()
    b = a[:40] + rng.integers(1, 101, 5).tolist()
    q, results, stop = _serve(eng)
    with WindowAudit(eng) as audit:
        q.put(port.Request(tokens=a, max_new_tokens=8, request_id='a'))
        _wait(lambda: eng.chunk_stats['chunks'] >= 4)
        with eng._lock:
            assert 'a' in [j.req.request_id for j in eng._chunking.values()]
            q.put(port.Request(tokens=b, max_new_tokens=8, request_id='b'))
        _wait(lambda: len(results) == 2)
        stop.set()
    assert results['a'].output_tokens == solo(a, 8)
    assert results['b'].output_tokens == solo(b, 8)
    assert eng.radix_stats['hits'] >= 1
    assert eng.radix_stats['tokens_reused'] >= 32
    assert not audit.errors, audit.errors[:5]


@pytest.fixture(scope='module')
def fault_pair(params):
    """(JAX engine, port engine), paged with the radix cache, chunking."""
    return (jax_engine(params, **CHUNK, **PAGED),
            port_engine(params, **CHUNK, **PAGED))


def _requests(mod, deadline_s=None):
    """A chunked prompt in slot 0 (with `deadline_s`) and two survivors."""
    rng = np.random.default_rng(4)
    lens_new = [(40, 6), (12, 10), (5, 12)]
    return [mod(tokens=rng.integers(0, 101, n).tolist(), max_new_tokens=m,
                deadline_s=deadline_s if i == 0 else None)
            for i, (n, m) in enumerate(lens_new)]


def test_chunk_round_fault_fails_only_the_chunking_slot(fault_pair):
    """A chunk_round fault attributed to the chunking slot (the second
    round) fails that request alone, typed 'error'/'internal', its blocks
    freed; the survivors' tokens are unchanged and equal the JAX
    engine's under the same plan."""
    jax_eng, eng = fault_pair
    spec = dict(site='chunk_round', hits=(2,), slot=0)
    jax_eng.arm_faults(JaxFaultPlan(seed=0, specs=[JaxFaultSpec(**spec)]))
    eng.arm_faults(FaultPlan(seed=0, specs=[FaultSpec(**spec)]))
    try:
        ref = jax_eng.generate(_requests(JaxRequest))
        with WindowAudit(eng) as audit:
            got = eng.generate(_requests(port.Request))
    finally:
        jax_eng.disarm_faults()
        eng.disarm_faults()
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in ref] == ['error', 'length', 'length']
    assert got[0].error_class == ref[0].error_class == 'internal'
    assert 'chunk round' in got[0].error and got[0].output_tokens == []
    for a, b in zip(ref, got):
        assert b.output_tokens == a.output_tokens
    assert eng.fault_stats == jax_eng.fault_stats
    assert not audit.errors, audit.errors[:5]
    assert not eng._chunking and int(eng._slot_nblocks.sum()) == 0


def test_deadline_on_a_chunking_slot(fault_pair):
    """A chunking prompt past its deadline ends 'deadline' with no tokens
    after its first chunk, its blocks freed, as in the JAX engine."""
    jax_eng, eng = fault_pair
    ref = jax_eng.generate(_requests(JaxRequest, deadline_s=1e-9))
    with WindowAudit(eng) as audit:
        got = eng.generate(_requests(port.Request, deadline_s=1e-9))
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in ref] == ['deadline', 'length', 'length']
    assert got[0].output_tokens == [] and got[0].error_class is None
    for a, b in zip(ref, got):
        assert b.output_tokens == a.output_tokens
    assert eng.fault_stats == jax_eng.fault_stats
    assert eng.chunk_stats == jax_eng.chunk_stats
    assert not audit.errors, audit.errors[:5]
    assert not conservation_errors(eng)


def test_cancel_on_a_chunking_slot(params, solo):
    """cancel() of a request mid-chunked-prefill returns True, frees its
    slot and blocks at once, and delivers nothing; a stream decoding
    beside it is unchanged."""
    eng = port_engine(params, **CHUNK, **PAGED)
    eng.arm_faults(FaultPlan(seed=0, specs=[FaultSpec(**SLOW_LOOP)]))
    rng = np.random.default_rng(6)
    long_ = rng.integers(1, 101, 48).tolist()
    short = rng.integers(1, 101, 6).tolist()
    q, results, stop = _serve(eng)
    with WindowAudit(eng) as audit:
        q.put(port.Request(tokens=short, max_new_tokens=15,
                           request_id='short'))
        _wait(lambda: eng._slots[0] is not None)
        q.put(port.Request(tokens=long_, max_new_tokens=8,
                           request_id='long'))
        _wait(lambda: eng.chunk_stats['chunks'] >= 2)
        assert eng.cancel('long')
        with eng._lock:
            assert not eng._chunking
            assert not conservation_errors(eng)
        _wait(lambda: 'short' in results)
        stop.set()
    assert 'long' not in results
    assert results['short'].output_tokens == solo(short, 15)
    assert not audit.errors, audit.errors[:5]
