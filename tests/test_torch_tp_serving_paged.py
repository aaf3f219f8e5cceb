"""Tensor-parallel serving over the block-paged pool, held against the JAX
package's TP engine on the CPU (the tiny f32 llama of
tests/test_tp_paged.py on 2 gloo ranks against ``tp_mesh(2)`` on the
conftest's virtual devices): the radix cache with chunked prefill and the
host tier's spill and restore through the serving loop with lookahead and
the adaptive window, conservation after every window, the shard-layout
sanitizer at the quiesce point, the per-chip accounting, QoS preemption's
park and resume, and the drain-time handoff between a tp=2 replica and
tp=1 ones (JAX and port) in both directions."""
import base64
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from helpers_torch import (COMMON, GEOMETRY, JAX_CFG, PORT_CFG, jax_engine,
                           make_params, port_engine)
from skypilot_tpu.analysis import sanitizers as jax_sanitizers
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert

TOL = 1e-5
# A small pool (12 usable blocks + dump) so radix eviction, and with it
# the host tier, fires under a few requests; chunked prefill for prompts
# past the largest bucket; lookahead and the adaptive window in the loop.
PAGED = dict(num_slots=2, kv_block_size=8, kv_blocks=13,
             auto_prefix_cache=True, host_kv_bytes=1 << 20, prefill_chunk=8,
             decode_lookahead=True, adaptive_decode_window=True,
             decode_steps=4)
RADIX = dict(kv_block_size=8, auto_prefix_cache=True)
QOS = dict(num_slots=1, max_cache_len=128, prefill_buckets=(8, 16),
           max_new_tokens=8, kv_block_size=8, prefill_chunk=8,
           auto_prefix_cache=True)
HOT = [(5 * j) % 97 + 1 for j in range(24)]
HOT2 = [(3 * j + 7) % 97 + 1 for j in range(24)]
SEED = [dict(tokens=HOT + [1 + i], max_new_tokens=5) for i in range(2)]
CHURN = [dict(request_id=f'c{i}',
              tokens=[(7 * j + 11 * i) % 97 + 1 for j in range(25)],
              max_new_tokens=4) for i in range(5)]
RESTORE = [dict(tokens=HOT + [50], max_new_tokens=6)]
# Prompts past the largest bucket (32): chunked in 8-token rounds.
LONG = [dict(request_id=f'l{i}',
             tokens=[(13 * j + 5 * i) % 97 + 1 for j in range(33 + 4 * i)],
             max_new_tokens=6) for i in range(3)]
BATCH = dict(request_id='batch', tokens=[(7 * j) % 97 + 1 for j in range(60)],
             max_new_tokens=8, priority='batch')
INTER = dict(request_id='inter', tokens=[9, 4, 2, 8], max_new_tokens=8,
             priority='interactive')
AFTER_ADOPT = [dict(tokens=HOT2 + [60], max_new_tokens=6)]


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax(params, mesh=True, **overrides):
    kw = {**COMMON, 'cache_dtype': jnp.float32, **overrides}
    return JaxEngine(JAX_CFG, JaxInferConfig(**kw),
                     params={'params': params}, rng=jax.random.PRNGKey(7),
                     mesh=tp_mesh(2) if mesh else None)


def _jreqs(reqs):
    return [JaxRequest(**r) for r in reqs]


def _served(eng, reqs, timeout=120):
    """The JAX engine's serving loop over `reqs` (queued before it
    starts, as the port's generate_served does); results in order."""
    results, q, stop = {}, queue.Queue(), threading.Event()
    for r in _jreqs(reqs):
        q.put(r)
    loop = threading.Thread(
        target=eng.generate_stream,
        args=(q, lambda res: results.__setitem__(res.request_id, res),
              stop), daemon=True)
    loop.start()
    deadline = time.time() + timeout
    try:
        while len(results) < len(reqs) and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        loop.join(timeout=30)
    return [results[r['request_id']] for r in reqs]


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def jax_payload(params):
    """A tp=1 JAX replica's hot-prefix payload (HOT2, 3 blocks), and that
    replica's tokens for AFTER_ADOPT served from its own cache."""
    eng = jax_engine(params, **RADIX)
    eng.generate(_jreqs([dict(tokens=HOT2 + [2], max_new_tokens=3)]))
    payload = eng.export_hot_prefixes()
    return payload, eng.generate(_jreqs(AFTER_ADOPT))


@pytest.fixture(scope='module')
def runs(params, jax_payload, tmp_path_factory):
    """The port's TP runs on 2 ranks, started first; the JAX TP engines
    through the same sequence meanwhile."""
    sd = _np(convert.state_dict_from_jax(params, PORT_CFG))
    f32 = {**COMMON, 'cache_dtype': torch.float32}
    serve_runs = [
        hd.ServeRun('paged', 'llama', GEOMETRY, {**f32, **PAGED}, sd, [
            ('generate', SEED), ('shard_sanitizer', True),
            ('served', CHURN), ('generate', RESTORE), ('served', LONG),
            ('shard_sanitizer', False),
            ('attr', 'radix_stats'), ('attr', 'chunk_stats'), ('tier',),
            ('stats',), ('kv_health',), ('shard',), ('export', 4, 16),
            ('attr', '_shard_checks')],
                    audit=True),
        hd.ServeRun('qos', 'llama', GEOMETRY,
                    {**QOS, 'qos': True, 'cache_dtype': torch.float32}, sd,
                    [('qos_park', BATCH, INTER), ('attr', 'qos_stats')],
                    audit=True),
        hd.ServeRun('adopt', 'llama', GEOMETRY, {**f32, **RADIX}, sd, [
            ('adopt', jax_payload[0]), ('generate', AFTER_ADOPT),
            ('attr', 'radix_stats'), ('export',)], audit=True),
    ]
    workers = hd.Workers(hd.tp_serving, 2,
                         tmp_path_factory.mktemp('tp_paged'), serve_runs)
    jax_out = {}
    eng = _jax(params, **PAGED)
    jax_out['seed'] = eng.generate(_jreqs(SEED))
    jax_out['churn'] = _served(eng, CHURN)
    jax_out['restore'] = eng.generate(_jreqs(RESTORE))
    jax_out['long'] = _served(eng, LONG)
    jax_out['radix_stats'] = dict(eng.radix_stats)
    jax_out['chunk_stats'] = dict(eng.chunk_stats)
    jax_out['tier'] = eng._host_tier_section()
    jax_out['stats'] = eng.stats()
    jax_out['kv_health'] = eng.kv_health()
    jax_out['shard'] = jax_sanitizers.check_shard_layout(eng)
    jax_out['export'] = eng.export_hot_prefixes(4, 16)
    ref = _jax(params, mesh=False, **QOS)
    jax_out['qos'] = {r['request_id']: ref.generate(_jreqs([r]))[0]
                      for r in (BATCH, INTER)}
    out = workers.join()
    return {'port': {r.name: [rank[i] for rank in out]
                     for i, r in enumerate(serve_runs)},
            'jax': jax_out}


def _same(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['tokens'] == list(w.output_tokens)
        assert g['finish'] == w.finish_reason
        np.testing.assert_allclose(g['logprobs'], w.logprobs, rtol=0,
                                   atol=tol)


def _rows(payload):
    """Each exported block's (tokens, k, v) as f32 arrays."""
    out = []
    for pref in payload['prefixes']:
        for i, rec in enumerate(pref['blocks']):
            out.append((tuple(pref['tokens'][:(i + 1) * 8]),) + tuple(
                np.frombuffer(base64.b64decode(rec[part]), np.float32)
                for part in ('k', 'v')))
    return out


def test_paged_radix_tier_and_chunked_serving_match_the_jax_tp_engine(runs):
    """Through the serving loop with lookahead and the adaptive window:
    the radix seed, a churn that evicts the hot prefix into the host
    tier, the restore that brings it back and chunked prompts give the
    JAX TP engine's tokens, finish reasons and logprobs, and the same
    radix, chunk and tier counters; the block-conservation law holds
    after every window, and the shard sanitizer ran at the serving loop's
    quiesce point (SKYTPU_SHARD_SANITIZER=1) without a fault."""
    rank0 = runs['port']['paged'][0]
    v, jx = rank0['values'], runs['jax']
    _same(v[0], jx['seed'])
    _same(v[2], jx['churn'])
    _same(v[3], jx['restore'])
    _same(v[4], jx['long'])
    assert v[6] == jx['radix_stats'] and v[6]['hits'] > 0
    assert v[7] == jx['chunk_stats'] and v[7]['chunks'] > 0
    assert v[8] == jx['tier']
    assert v[8]['spills'] > 0 and v[8]['restores'] > 0
    # the serving loop's quiesce hook ran the check (the 'shard' op once)
    assert v[13][0] > 1
    assert rank0['conservation'] == []
    assert [r['cache_heads'] for r in runs['port']['paged']] == [1, 1]


def test_paged_accounting_and_shard_report(runs):
    """kv_health and stats at tp=2 equal the JAX TP engine's (the pool's
    per-chip bytes are total // 2), and check_shard_layout reports every
    pool leaf as a paged one."""
    v, jx = runs['port']['paged'][0]['values'], runs['jax']
    stats, health, report = v[9], v[10], v[11]
    assert health == jx['kv_health']
    assert stats['kv']['bytes'] == jx['stats']['kv']['bytes']
    assert stats['kv']['blocks'] == jx['stats']['kv']['blocks']
    b = stats['kv']['bytes']
    assert b['per_chip_total'] == b['total'] // 2
    assert b['per_chip_resident'] == b['resident'] // 2
    assert report.keys() == jx['shard'].keys()
    assert report['paged_pool_leaves'] == jx['shard']['paged_pool_leaves']
    assert report['tensor_degree'] == 2


def test_export_gathers_every_ranks_heads(runs):
    """A tp=2 replica's export is the topology-neutral [L, Hkv, bs, D]
    form: the same prefixes as the JAX TP engine's, rows within 1e-5."""
    got = _rows(runs['port']['paged'][0]['values'][12])
    want = _rows(runs['jax']['export'])
    assert [g[0] for g in got] == [w[0] for w in want] and got
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_qos_preemption_parks_and_resumes_under_tp(runs):
    """A part-prefilled batch prompt on the tp=2 engine parks at its
    chunk boundary for an interactive arrival and resumes from its radix
    blocks: both streams equal an uncontended JAX run's."""
    rank0 = runs['port']['qos'][0]
    got, qos_stats = rank0['values']
    assert qos_stats['preemptions'] >= 1
    for rid, want in runs['jax']['qos'].items():
        _same([got[rid]], [want])
    assert rank0['conservation'] == []


def test_handoff_from_a_tp1_jax_replica_to_a_tp2_port_replica(
        runs, jax_payload):
    """A tp=1 JAX replica's payload is adopted by the tp=2 port replica
    (scattered by heads): the next hot request is a radix hit and gives
    the exporter's tokens; re-exported, the rows are the exported bytes."""
    rank0 = runs['port']['adopt'][0]
    adopted, got, radix, payload = rank0['values']
    assert adopted['adopted_blocks'] == 3
    _same(got, jax_payload[1])
    assert radix['hits'] == 1 and radix['tokens_reused'] == 24
    mine = {r[0]: r[1:] for r in _rows(payload)}
    for toks, k, v in _rows(jax_payload[0]):
        assert np.array_equal(mine[toks][0], k)
        assert np.array_equal(mine[toks][1], v)
    assert rank0['conservation'] == []


def test_handoff_from_a_tp2_port_replica_to_tp1_replicas(runs, params):
    """The tp=2 replica's export, adopted by a tp=1 port engine and a tp=1
    JAX engine: both serve the hot request from the adopted blocks with
    the tp=2 replica's tokens."""
    payload = runs['port']['adopt'][0]['values'][3]
    want = runs['port']['adopt'][0]['values'][1]
    mine = port_engine(params, **RADIX)
    theirs = jax_engine(params, **RADIX)
    assert mine.adopt_prefixes(payload)['adopted_blocks'] == \
        theirs.adopt_prefixes(payload)['adopted_blocks'] > 0
    got = mine.generate([port.Request(**r) for r in AFTER_ADOPT])
    ref = theirs.generate(_jreqs(AFTER_ADOPT))
    for g, r, w in zip(got, ref, want):
        assert g.output_tokens == r.output_tokens == w['tokens']
    assert mine.radix_stats['hits'] == theirs.radix_stats['hits'] == 1
