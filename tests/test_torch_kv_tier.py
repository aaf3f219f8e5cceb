"""The port's host-RAM KV tier and the drain-time hot-prefix handoff, on
the tiny f32 model of helpers_torch (CPU):

- spill/restore identity, including the recycle race: the eviction
  that spills a block hands its id to the very next prefill, which
  overwrites it in place, and the restore still brings back the rows
  the block held;
- the tier's LRU budget and an oversized entry, against the JAX tier;
- a mismatched or malformed payload (a 400 over HTTP);
- export -> adopt in both directions between a JAX engine and a port
  engine: the adopted pool rows are the exported bytes, and the next
  hot request is a radix hit with the exporter's greedy tokens;
- a mixed fleet behind the unchanged LB: drain the replica holding the
  hot prefix, the LB ships it to the survivor, which serves the next hot
  request from the adopted blocks -- port to JAX, then JAX to port, with
  zero 5xx and identical greedy output."""
import base64
import json
import queue
import threading
import time
from http.client import HTTPConnection

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import (WindowAudit, conservation_errors, jax_engine,
                           make_params, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer.block_pool import HostKVTier as JaxHostKVTier
from skypilot_tpu.infer.chaos import (KillableReplica, _TrackingHTTPServer,
                                      free_port)
from skypilot_tpu.serve.load_balancer import SkyTpuLoadBalancer
from skypilot_tpu.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.infer.chaos import KillableReplica as PortReplica
from skypilot_tpu_torch.infer.block_pool import HostKVTier

# A small pool (12 usable blocks + dump) so radix eviction -- the tier's
# feed -- fires under a handful of requests, while admission still holds
# one worst-case request (8 blocks).
TIGHT = dict(num_slots=2, kv_block_size=8, kv_blocks=13,
             auto_prefix_cache=True)
RADIX = dict(kv_block_size=8, auto_prefix_cache=True)
TIER_BYTES = 1 << 20
# Hot prefixes: 3 full blocks each.
HOT = [(5 * j) % 97 + 1 for j in range(24)]
HOT2 = [(3 * j + 7) % 97 + 1 for j in range(24)]


def _churn(i):
    """One distinct 25-token prompt: 3 radix inserts per completion, so a
    few of these evict the hot prefix out of the 12-block pool."""
    return Request(tokens=[(7 * j + 11 * i) % 97 + 1 for j in range(25)],
                   max_new_tokens=4)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def jax_radix(params):
    """One JAX radix engine for the engine-level handoff tests."""
    return jax_engine(params, **RADIX)


def _rows(eng, blocks):
    return [(torch.stack([kp[b] for kp, _ in eng.cache]).clone(),
             torch.stack([vp[b] for _, vp in eng.cache]).clone())
            for b in blocks]


# ------------------------------------------------------ tier identity

def test_spill_recycle_restore_identity(params):
    """Seed the hot prefix, churn it out of the pool: its blocks spill,
    and the churn prefill that triggered the eviction takes the freed
    ids at once (the free list is LIFO) and overwrites them.  Re-sending
    the hot prefix restores it into fresh blocks with the rows it had
    before, bit for bit, and the greedy tokens equal a tierless
    engine's, which prefills it again."""
    base = port_engine(params, **TIGHT)
    tier = port_engine(params, host_kv_bytes=TIER_BYTES, **TIGHT)
    seed = [Request(tokens=HOT + [50], max_new_tokens=4)]
    assert [r.output_tokens for r in tier.generate(seed)] == \
        [r.output_tokens for r in base.generate(seed)]
    hot_blocks = tier._radix.peek(None, HOT, len(HOT))
    assert len(hot_blocks) == 3
    before = _rows(tier, hot_blocks)
    with WindowAudit(tier) as audit:
        for i in range(4):
            assert tier.generate([_churn(i)])[0].output_tokens == \
                base.generate([_churn(i)])[0].output_tokens
        assert tier._radix.peek(None, HOT, len(HOT)) == []
        assert tier._host_tier.stats['spills'] >= 3
        # The recycled ids now hold churn rows.
        assert any(not torch.equal(a[0], b[0]) for a, b in
                   zip(before, _rows(tier, hot_blocks)))
        probe = [Request(tokens=HOT + [60, 61], max_new_tokens=4)]
        got = tier.generate(probe)[0]
        want = base.generate(probe)[0]
    assert got.output_tokens == want.output_tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-5)
    assert tier._host_tier.stats['restores'] == 3
    assert tier.radix_stats['hits'] >= 1
    restored = tier._radix.peek(None, HOT, len(HOT))
    for (k0, v0), (k1, v1) in zip(before, _rows(tier, restored)):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert audit.errors == []


def test_tier_serving_identity(params):
    """The same spill/restore traffic through the serving loop: tokens
    equal the tierless engine's, restores happen, nothing leaks."""
    jobs = ([Request(request_id='h0', tokens=HOT + [50], max_new_tokens=4)]
            + [Request(request_id=f'c{i}', tokens=_churn(i).tokens,
                       max_new_tokens=4) for i in range(4)]
            + [Request(request_id='h1', tokens=HOT + [61, 62],
                       max_new_tokens=4)])
    base = port_engine(params, **TIGHT)
    want = {j.request_id: base.generate([j])[0].output_tokens for j in jobs}
    tier = port_engine(params, host_kv_bytes=TIER_BYTES, **TIGHT)
    results, q, stop = {}, queue.Queue(), threading.Event()
    loop = threading.Thread(
        target=tier.generate_stream,
        args=(q, lambda res: results.__setitem__(res.request_id, res), stop),
        daemon=True)
    with WindowAudit(tier) as audit:
        loop.start()
        for j in jobs:          # one at a time: eviction order is fixed
            q.put(j)
            deadline = time.time() + 30
            while j.request_id not in results and time.time() < deadline:
                time.sleep(0.005)
        stop.set()
        loop.join(timeout=30)
    assert {k: r.output_tokens for k, r in results.items()} == want
    assert tier._host_tier.stats['restores'] >= 1
    assert audit.errors == []


# ------------------------------------------------- tier LRU mechanics

def _fake_block(fill, layers=2, hkv=2, bs=8, d=4):
    ks = [np.full((hkv, bs, d), float(fill), np.float32)
          for _ in range(layers)]
    return ks, [x + 1 for x in ks]


def test_host_tier_budget_lru_eviction_as_the_jax_tier():
    """Entries are 2 layers x [2, 8, 4] f32 k+v = 1 KiB; a 2 KiB budget
    holds two, the third spill evicts the LRU entry, and the byte ledger
    audits clean through spill, eviction and take -- with the JAX tier's
    counters at every step."""
    mine, ref = HostKVTier(2048, 8), JaxHostKVTier(2048, 8)
    for i in range(3):
        ks, vs = _fake_block(i)
        mine.spill((None, (i,)), [torch.from_numpy(x) for x in ks],
                   [torch.from_numpy(x) for x in vs])
        ref.spill((None, (i,)), [jnp.asarray(x) for x in ks],
                  [jnp.asarray(x) for x in vs])
    assert mine.in_flight == ref.in_flight == 3
    hits = [mine.contains((None, (i,))) for i in range(3)]
    assert hits == [ref.contains((None, (i,))) for i in range(3)] == \
        [False, True, True]
    assert mine.entries == 2 and mine.bytes_used == 2048
    assert mine.stats == ref.stats and mine.audit() == ref.audit() == []
    k_rows, v_rows = mine.take((None, (1,)))
    ref_k, ref_v = ref.take((None, (1,)))
    assert tuple(k_rows.shape) == (2, 2, 8, 4)
    np.testing.assert_array_equal(k_rows.numpy(), ref_k)
    np.testing.assert_array_equal(v_rows.numpy(), ref_v)
    assert mine.entries == 1 and mine.bytes_used == 1024
    assert mine.stats_section() == ref.stats_section()
    assert mine.audit() == []


def test_host_tier_drops_oversized_entry():
    tier = HostKVTier(512, 8)           # smaller than one entry
    ks, vs = _fake_block(3)
    tier.spill((None, (3,)), [torch.from_numpy(x) for x in ks],
               [torch.from_numpy(x) for x in vs])
    tier.finalize()
    assert tier.entries == 0 and tier.stats['dropped'] == 1
    assert tier.audit() == []


def test_spill_snapshots_the_rows_not_a_view():
    """The tier copies at spill time: writing the source rows afterwards
    (the recycled block's next prefill) does not reach the entry."""
    tier = HostKVTier(1 << 20, 8)
    ks = [torch.ones(2, 8, 4) for _ in range(2)]
    vs = [torch.ones(2, 8, 4) for _ in range(2)]
    tier.spill((None, (1,)), ks, vs)
    for x in ks + vs:
        x.fill_(7.0)
    k_rows, v_rows = tier.take((None, (1,)))
    assert (k_rows == 1).all() and (v_rows == 1).all()


# --------------------------------------------------------- handoff

def _good_header(eng):
    return {'version': 1, 'model': eng.cfg.model, 'block_size': 8,
            'cache_dtype': 'float32', 'num_layers': 2, 'prefixes': []}


def test_adopt_rejects_mismatched_payload(params):
    eng = port_engine(params, **RADIX)
    good = _good_header(eng)
    assert eng.adopt_prefixes(dict(good)) == {
        'adopted_prefixes': 0, 'adopted_blocks': 0, 'skipped': 0}
    for bad in ({'version': 2}, {'block_size': 16},
                {'cache_dtype': 'bfloat16'}, {'num_layers': 3},
                {'model': 'other-model'}):
        with pytest.raises(ValueError):
            eng.adopt_prefixes({**good, **bad})
    # A malformed prefix is skipped, the payload still answers.
    row = base64.b64encode(b'\0' * 10).decode()
    res = eng.adopt_prefixes({**good, 'prefixes': [
        {'adapter': None, 'tokens': HOT, 'blocks': [{'k': row, 'v': row}]},
        {'adapter': None, 'tokens': HOT, 'blocks': [{'k': '!!'}]}]})
    assert res == {'adopted_prefixes': 0, 'adopted_blocks': 0,
                   'skipped': 2}
    assert conservation_errors(eng) == []
    with pytest.raises(ValueError, match='no radix cache'):
        port_engine(params).adopt_prefixes(good)


def _decoded(payload, shape=(2, 2, 8, 8)):
    out = []
    for p in payload['prefixes']:
        for rec in p['blocks']:
            out.append(tuple(np.frombuffer(base64.b64decode(rec[x]),
                                           np.float32).reshape(shape)
                             for x in ('k', 'v')))
    return out


def test_export_matches_the_jax_engines_form(params, jax_radix):
    """After the same traffic (the JAX engine's first), the port's
    payload has the JAX engine's header, prefixes, tokens and row shapes
    (rows within f32 rounding: the two prefill with different summation
    orders)."""
    port = port_engine(params, **RADIX)
    reqs = [[11, 12] * 9 + [5], [(j * 13) % 97 + 1 for j in range(17)]]
    ref_eng = jax_radix
    port.generate([Request(tokens=t, max_new_tokens=2) for t in reqs])
    ref_eng.generate([JaxRequest(tokens=t, max_new_tokens=2) for t in reqs])
    mine, ref = port.export_hot_prefixes(), ref_eng.export_hot_prefixes()
    strip = lambda d: {**d, 'prefixes': [
        {**p, 'blocks': len(p['blocks'])} for p in d['prefixes']]}
    assert strip(mine) == strip(ref)
    for (k0, v0), (k1, v1) in zip(_decoded(mine), _decoded(ref)):
        np.testing.assert_allclose(k0, k1, atol=1e-5)
        np.testing.assert_allclose(v0, v1, atol=1e-5)
    assert port.handoff_stats == ref_eng.handoff_stats


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_handoff_between_a_jax_and_a_port_engine(params, jax_radix,
                                                 direction):
    """The exporter serves a hot prefix, its /hot_prefixes payload (through
    JSON) adopts into the other package's engine: the adopted pool rows
    are the payload's bytes, and the next hot request there is a radix
    hit with the exporter's greedy tokens."""
    port = port_engine(params, **RADIX)
    hot = HOT if direction == 'jax_to_port' else HOT2
    src, dst = ((jax_radix, port) if direction == 'jax_to_port'
                else (port, jax_radix))
    req_cls = {id(jax_radix): JaxRequest, id(port): Request}
    src.generate([req_cls[id(src)](tokens=hot + [50], max_new_tokens=4)])
    payload = json.loads(json.dumps(src.export_hot_prefixes()))
    assert payload['cache_dtype'] == 'float32'
    [pref] = [p for p in payload['prefixes'] if p['tokens'] == hot]
    want = src.generate([req_cls[id(src)](tokens=hot + [70],
                                          max_new_tokens=6)])[0]
    res = dst.adopt_prefixes({**payload, 'prefixes': [pref]})
    assert res == {'adopted_prefixes': 1, 'adopted_blocks': 3,
                   'skipped': 0}
    blocks = dst._radix.peek(None, hot, len(hot))
    for (k, v), blk in zip(_decoded({'prefixes': [pref]}), blocks):
        got_k = np.stack([np.asarray(kp[blk]) for kp, _ in dst.cache])
        got_v = np.stack([np.asarray(vp[blk]) for _, vp in dst.cache])
        assert got_k.tobytes() == k.tobytes()
        assert got_v.tobytes() == v.tobytes()
    hits = dst.radix_stats['hits']
    got = dst.generate([req_cls[id(dst)](tokens=hot + [70],
                                         max_new_tokens=6)])[0]
    assert dst.radix_stats['hits'] == hits + 1
    assert got.output_tokens == want.output_tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-5)
    if dst is port:
        assert conservation_errors(port) == []
        assert port.kv_health()['host_tier']['adopted'] == 3


# -------------------------------------------------------- mixed fleet

def _post(port, path, payload, want=200):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        conn.request('POST', path, body=json.dumps(payload).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == want, (resp.status, body)
        return json.loads(body)
    finally:
        conn.close()


def _wait(cond, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def test_mixed_fleet_drain_hands_the_hot_set_to_the_survivor(params,
                                                            monkeypatch):
    """A JAX and a port replica behind the unchanged LB.  The port replica
    serves a hot prefix and drains: the LB ships its hot set to the JAX
    survivor, which serves the next hot request from the adopted blocks.
    The port replica comes back, the JAX replica serves a second hot
    prefix and drains: the port replica adopts it and serves the next
    hot request as a radix hit.  Every answer a 200, every greedy output
    the fleet's own, and the handoff counters agree."""
    monkeypatch.setenv('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    jax_rep = KillableReplica(lambda: jax_engine(params, **RADIX),
                              free_port())
    port_rep = PortReplica(lambda: port_engine(params, **RADIX),
                            free_port())
    jax_rep.start()
    port_rep.start()
    policy = LoadBalancingPolicy.make('round_robin')
    policy.set_ready_replicas([jax_rep.url, port_rep.url])
    lb = SkyTpuLoadBalancer(None, free_port(), policy,
                            server_cls=_TrackingHTTPServer)
    threading.Thread(target=lb.run, daemon=True).start()
    try:
        assert _wait(lambda: _lb_up(lb.port), 10)
        # A mismatched payload is a client error on the port replica.
        code = _raw_post(port_rep.port, '/adopt_blocks',
                         {**_good_header(port_rep.server.engine),
                          'block_size': 16})
        assert code == 400
        for src, dst, hot in ((port_rep, jax_rep, HOT),
                              (jax_rep, port_rep, HOT2)):
            body = {'tokens': hot + [50], 'max_new_tokens': 4}
            warm = _post(src.port, '/generate', body)['output_tokens']
            eng = dst.server.engine
            adopted, hits = eng.handoff_stats['adopted'], \
                eng.radix_stats['hits']
            assert _post(src.port, '/drain', {'deadline_s': 30})['draining']
            assert _wait(lambda: eng.handoff_stats['adopted'] > adopted), \
                lb.lb_stats()
            assert eng.handoff_stats['adopted'] - adopted == 3
            doc = _post(lb.port, '/generate', body)   # 200: zero 5xx
            assert doc['output_tokens'] == warm
            assert eng.radix_stats['hits'] > hits
            _post(src.port, '/drain', {'cancel': True})
            assert _wait(lambda: src.url not in lb.lb_stats().get(
                'replica_draining', []))
        st = lb.lb_stats()
        assert st['hot_handoffs'] >= 2 and st['handoff_failures'] == 0
        assert port_rep.server.engine.handoff_stats['exported'] >= 3
        assert conservation_errors(port_rep.server.engine) == []
    finally:
        lb.stop()
        for rep in (jax_rep, port_rep):
            rep.kill()


def _lb_up(port):
    try:
        HTTPConnection('127.0.0.1', port, timeout=1).connect()
        return True
    except OSError:
        return False


def _raw_post(port, path, payload):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        conn.request('POST', path, body=json.dumps(payload).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()
