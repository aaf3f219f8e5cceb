"""The port's block-paged KV engine held against the port's dense engine
and the JAX paged engine (InferConfig(kv_block_size=8)) on the same tiny
f32 model and weights: greedy tokens and finish reasons identical,
logprobs within TOL, offline and in serving interleavings, with and
without the radix prefix cache and the host tier.  Also the paged cache
write itself against the JAX function (including a position past the
table, which clamps), admission deferral under a tight pool, the
allocator's units, config validation and the block-conservation law
after every decode window."""
import copy
import queue
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import (WindowAudit, assert_same_qos, conservation_errors,
                           jax_engine, key_sets, make_params, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.models import llama as port_llama

# f32 on both sides: logprobs differ by summation order only.
TOL = 1e-5
PAGED = dict(kv_block_size=8)
RADIX = dict(kv_block_size=8, auto_prefix_cache=True)
TIER = dict(kv_block_size=8, auto_prefix_cache=True, kv_blocks=20,
            host_kv_bytes=1 << 20)


@pytest.fixture(scope='module')
def params():
    return make_params()


def _prompts(seed, n):
    """n prompts of 3-30 tokens; every other one opens with a shared
    17-token system prompt (two full blocks and a token), so the radix
    cache has prefixes to match across waves."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 101, 17).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(1, 101, int(rng.integers(3, 14))).tolist()
        out.append(system + tail if i % 2 else tail)
    return out


def _reqs(prompts, cls=Request, max_new=8):
    return [cls(request_id=str(i), tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _assert_same(ref, out):
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert b.output_tokens == a.output_tokens, b.request_id
        assert b.finish_reason == a.finish_reason
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=TOL)


def _serve(eng, jobs, timeout=60):
    """generate_stream over a queue holding every job before the loop
    starts; returns the results in job order."""
    results, q, stop = {}, queue.Queue(), threading.Event()
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
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(timeout=30)
    assert len(results) == len(jobs)
    return [results[j.request_id] for j in jobs]


# ------------------------------------------------------ the cache write

def _write_inputs(positions):
    rng = np.random.default_rng(0)
    b, hq, hkv, d, bs, n = 2, 4, 2, 8, 8, 9
    pos = np.asarray(positions, np.int64)
    t = pos.shape[1]
    return dict(
        q=rng.normal(size=(b, hq, t, d)).astype(np.float32),
        k=rng.normal(size=(b, hkv, t, d)).astype(np.float32),
        v=rng.normal(size=(b, hkv, t, d)).astype(np.float32),
        pool_k=rng.normal(size=(n, hkv, bs, d)).astype(np.float32),
        pool_v=rng.normal(size=(n, hkv, bs, d)).astype(np.float32),
        # Block 0 is the dump block: a table names it only past a
        # lane's allocation.
        tables=np.array([[3, 1, 7, 0], [2, 5, 4, 8]], np.int64),
        pos=pos, bs=bs)


def _port_write(x):
    pk = torch.from_numpy(x['pool_k'].copy())
    pv = torch.from_numpy(x['pool_v'].copy())
    out, (pk2, pv2) = port_llama.paged_write_kv_and_attend(
        (pk, pv), torch.from_numpy(x['k']), torch.from_numpy(x['v']),
        torch.from_numpy(x['q']), torch.from_numpy(x['pos']),
        torch.from_numpy(x['tables']), x['bs'])
    assert pk2 is pk and pv2 is pv          # written in place
    return out.numpy(), pk.numpy(), pv.numpy()


def test_paged_write_and_attend_matches_the_jax_function():
    """Scatter + gather + attention over a [N, Hkv, bs, D] pool against
    the JAX function on the same numpy inputs, positions across a block
    boundary: outputs, and the whole pools after the write."""
    x = _write_inputs([[0, 1, 2], [13, 14, 15]])
    ref_out, (ref_k, ref_v) = jax_llama.paged_write_kv_and_attend(
        (jnp.asarray(x['pool_k']), jnp.asarray(x['pool_v'])),
        jnp.asarray(x['k']), jnp.asarray(x['v']), jnp.asarray(x['q']),
        jnp.asarray(x['pos'], jnp.int32),
        jnp.asarray(x['tables'], jnp.int32), x['bs'])
    out, pk, pv = _port_write(x)
    np.testing.assert_array_equal(pk, np.asarray(ref_k))
    np.testing.assert_array_equal(pv, np.asarray(ref_v))
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=0, atol=1e-5)


def test_paged_write_past_the_table_clamps_to_its_last_entry():
    """A position past the table's NB*bs rows (a dead lane's overrun)
    writes into the last table entry's block at pos % bs -- it neither
    raises (torch's gather would) nor touches a block outside the lane's
    table.  (The JAX function documents the same clamp; JAX 0.9's
    take_along_axis fills instead and its scatter drops the row: either
    way only a dead row changes.)"""
    x = _write_inputs([[30, 31, 32], [45, 46, 47]])
    out, pk, pv = _port_write(x)
    want_k, want_v = x['pool_k'].copy(), x['pool_v'].copy()
    for b in range(2):
        for t, p in enumerate(x['pos'][b]):
            blk = x['tables'][b, min(p // x['bs'], 3)]
            want_k[blk, :, p % x['bs']] = x['k'][b, :, t]
            want_v[blk, :, p % x['bs']] = x['v'][b, :, t]
    np.testing.assert_array_equal(pk, want_k)
    np.testing.assert_array_equal(pv, want_v)
    view_k = torch.from_numpy(want_k)[torch.from_numpy(x['tables'])]
    view_v = torch.from_numpy(want_v)[torch.from_numpy(x['tables'])]
    ref = port_llama.decode_attention(
        torch.from_numpy(x['q']),
        view_k.transpose(1, 2).reshape(2, 2, 32, 8),
        view_v.transpose(1, 2).reshape(2, 2, 32, 8),
        torch.from_numpy(x['pos']))
    np.testing.assert_allclose(out, ref.numpy(), rtol=0, atol=1e-6)
    assert np.isfinite(out).all()


def test_paged_forward_matches_the_dense_forward(params):
    """Llama.forward over a scrambled block pool equals the forward over
    the dense cache: prefill then two decode steps."""
    eng = port_engine(params)
    model, cfg = eng.model, eng.model_config
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, 101, (2, 12)))
    dense = port_llama.init_cache(cfg, 2, 32, torch.float32, 'cpu')
    pool = port_llama.init_paged_cache(cfg, 9, 8, torch.float32, 'cpu')
    tables = torch.tensor([[5, 2, 8, 1], [3, 7, 4, 6]])
    with torch.inference_mode():
        pos = torch.arange(12).expand(2, 12)
        ld, _ = model(tokens, pos, dense)
        lp, _ = model(tokens, pos, pool, paged_tables=tables,
                      paged_block_size=8)
        torch.testing.assert_close(lp, ld, rtol=0, atol=1e-5)
        nxt = ld[:, -1].argmax(-1)
        for step in range(2):
            p = torch.full((2, 1), 12 + step)
            ld, _ = model(nxt[:, None], p, dense)
            lp, _ = model(nxt[:, None], p, pool, paged_tables=tables,
                          paged_block_size=8)
            torch.testing.assert_close(lp, ld, rtol=0, atol=1e-5)
            nxt = ld[:, 0].argmax(-1)


# ---------------------------------------------------- engine identity

@pytest.fixture(scope='module')
def jax_ref(params):
    """Greedy results of one JAX paged engine, memoized by (prompts,
    max_new): the reference every scheduling variant must reproduce
    (greedy tokens do not depend on the schedule or the pool size)."""
    eng, memo = jax_engine(params, **PAGED), {}

    def run(prompts, max_new=8):
        key = (tuple(map(tuple, prompts)), max_new)
        if key not in memo:
            memo[key] = eng.generate(_reqs(prompts, JaxRequest, max_new))
        return memo[key]

    return run


@pytest.mark.parametrize('flags', [PAGED, RADIX, TIER],
                         ids=['paged', 'radix', 'tier'])
def test_offline_identical_to_dense_and_jax_paged(params, jax_ref, flags):
    """Two waves of the same traffic (the second finds the first's
    prompts in the radix tree; the tier's small pool spills and
    restores) through the port's paged engine, the port's dense engine
    and the JAX paged engine: tokens.  With the tree and the tier, a JAX
    engine with the same flags and history also gives the same radix,
    tier and pool counters, and stats() and kv_health() carry its keys
    at every depth and its KV values."""
    waves = [_prompts(2, 8), _prompts(2, 8)[::-1]]
    dense, paged = port_engine(params), port_engine(params, **flags)
    ref = (jax_engine(params, **flags) if flags.get('host_kv_bytes')
           else None)
    with WindowAudit(paged) as audit:
        for w in waves:
            mine = paged.generate(_reqs(w))
            _assert_same(dense.generate(_reqs(w)), mine)
            _assert_same(jax_ref(w), mine)
            if ref is not None:
                _assert_same(ref.generate(_reqs(w, JaxRequest)), mine)
    assert audit.windows > 0 and audit.errors == []
    if flags.get('auto_prefix_cache'):
        assert paged.radix_stats['hits'] > 0
    if ref is None:
        return
    assert paged.radix_stats == ref.radix_stats
    assert paged._host_tier.stats['spills'] > 0
    a, b = paged.stats(), ref.stats()
    assert_same_qos(a['qos'], b['qos'])
    assert key_sets(a) == key_sets(b)
    assert a['kv'] == b['kv']
    assert paged.kv_health() == ref.kv_health()


@pytest.mark.parametrize('flags', [
    PAGED, RADIX, {**RADIX, 'decode_lookahead': True,
                   'adaptive_decode_window': True}, TIER],
    ids=['paged', 'radix', 'radix-lookahead', 'tier'])
def test_serving_identical_to_jax_paged(params, jax_ref, flags):
    """A burst through the serving loop (prefills interleaved with
    decode windows, the prefill cap, lookahead), twice, gives the JAX
    paged engine's greedy tokens; the conservation law holds after
    every window."""
    prompts = _prompts(3, 12)
    ref = jax_ref(prompts, 12)
    eng = port_engine(params, prefills_per_gap=2, **flags)
    with WindowAudit(eng) as audit:
        out = _serve(eng, _reqs(prompts, max_new=12))
        again = _serve(eng, _reqs(prompts, max_new=12))
    _assert_same(ref, out)
    _assert_same(ref, again)
    assert audit.windows > 0 and audit.errors == []
    if flags.get('auto_prefix_cache'):
        assert eng.radix_stats['hits'] >= 6


def test_tight_pool_defers_then_completes(params, jax_ref):
    """A pool that holds two worst-case requests (plus the dump block)
    defers the head of the queue until blocks free up; every request
    still finishes with the JAX engine's tokens, and no block leaks."""
    prompts = [[(5 * i + j) % 97 + 1 for j in range(20 + i)]
               for i in range(6)]
    ref = jax_ref(prompts)
    eng = port_engine(params, kv_block_size=8, kv_blocks=9)
    with WindowAudit(eng) as audit:
        out = _serve(eng, _reqs(prompts))
    _assert_same(ref, out)
    assert eng.stats()['admission_deferred'] > 0
    assert audit.errors == []
    assert len(eng._free_blocks) == 8
    offline = port_engine(params, kv_block_size=8, kv_blocks=9)
    _assert_same(ref, offline.generate(_reqs(prompts)))
    assert offline.paged_stats['deferred'] > 0
    assert conservation_errors(offline) == []


def test_request_filling_the_pool_is_served_alone(params, jax_ref):
    """A request whose worst-case demand is the whole pool (59 prompt
    tokens + 5 new = 8 blocks of 8) waits until nothing runs, runs
    alone, and the requests around it are served."""
    prompts = [[1, 2, 3], list(range(1, 60)), [4, 5, 6]]
    ref = jax_ref(prompts, 5)
    eng = port_engine(params, kv_block_size=8, kv_blocks=9)   # 8 usable
    with WindowAudit(eng) as audit:
        out = _serve(eng, _reqs(prompts, max_new=5))
    _assert_same(ref, out)
    assert eng.paged_stats['deferred'] > 0 and audit.errors == []


# ------------------------------------------------------- allocator

def test_allocator_units(params):
    eng = port_engine(params, kv_block_size=8)    # 64 / 8 = 8 blocks
    assert eng._num_blocks == 4 * 8 + 1 and eng._max_blocks == 8
    assert [eng._nb_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9)] == \
        [1, 1, 2, 4, 8, 8, 8]
    assert eng._slot_cap_rows(10, 8) == 17
    assert eng._slot_cap_rows(60, 8) == 64
    assert eng._blocks_demand(10, 8) == 3 and eng._blocks_demand(1, 1) == 1
    eng._ensure_blocks(0, 9)
    assert list(eng._tables_np[0, :2]) == [1, 2]
    assert eng._slot_nblocks[0] == 2
    eng._ensure_blocks(0, 16)                     # already covered
    assert eng._slot_nblocks[0] == 2
    eng._append_shared_blocks(1, [1, 2])
    assert list(eng._block_refs[:3]) == [1, 2, 2]
    eng._free_slot_blocks(0)
    assert list(eng._block_refs[:3]) == [1, 1, 1]
    eng._free_slot_blocks(1)
    assert list(eng._block_refs[:3]) == [1, 0, 0]
    assert sorted(eng._free_blocks) == list(range(1, 33))
    tables = eng._lane_tables([0, 1], 4)
    assert tables.dtype == torch.int64 and tables.shape == (2, 4)
    with pytest.raises(RuntimeError, match='exhausted'):
        eng._alloc_blocks(33)


@pytest.mark.parametrize('bad,match', [
    ({'kv_block_size': -1}, 'kv_block_size'),
    ({'kv_block_size': 24}, 'multiple of kv_block_size'),
    ({'kv_block_size': 16, 'prefill_buckets': (8, 16, 32)},
     'every prefill bucket'),
    ({'kv_block_size': 8, 'kv_blocks': 8}, 'kv_blocks'),
    ({'auto_prefix_cache': True}, 'requires the block-paged'),
    ({'kv_block_size': 8, 'host_kv_bytes': -1}, 'host_kv_bytes'),
])
def test_config_validation_as_the_jax_engine(params, bad, match):
    with pytest.raises(ValueError, match=match):
        port_engine(params, **bad)
    with pytest.raises(ValueError, match=match):
        jax_engine(params, **bad)
