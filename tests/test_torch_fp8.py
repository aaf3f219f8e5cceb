"""The port's fp8 (e4m3) KV cache held against the JAX engine's, on the
tiny f32 model of helpers_torch (CPU):

- the cast (models.llama.to_fp8) gives jnp.astype(float8_e4m3fn)'s byte
  for every input of a sweep that holds the overflow band (|x| > 464,
  NaN in the reference, where torch's own cast saturates to 448), +-inf,
  NaN of both signs and subnormals, from f32 and from bf16;
- the dense and the paged fp8 engines against the JAX fp8 engines:
  tokens, finish reasons, logprobs within TOL, and the caches byte for
  byte after the run;
- the host tier under fp8 and the hot-prefix handoff both ways between a
  JAX and a port engine, with the bf16 <-> fp8 mismatch refused;
- a planted K overflow (layer 0's K projection scaled up in both models):
  both engines store the same NaN rows and end the lane the same way."""
import copy

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from helpers_torch import (WindowAudit, jax_engine, make_params,
                           port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.models.llama import as_bytes, to_fp8

# f32 model on both sides, fp8 rows byte-identical: logprobs differ by
# summation order only.
TOL = 1e-5
FP8 = dict(cache_dtype=torch.float8_e4m3fn)
JFP8 = dict(cache_dtype=jnp.float8_e4m3fn)
PAGED = dict(kv_block_size=8)
RADIX_TIER = dict(num_slots=2, kv_block_size=8, kv_blocks=13,
                  auto_prefix_cache=True, host_kv_bytes=1 << 20)
HOT = [(5 * j) % 97 + 1 for j in range(24)]


@pytest.fixture(scope='module')
def params():
    return make_params()


def _sweep() -> np.ndarray:
    """Normal values at scales 1e-3 .. 300, the band around the largest
    finite value and past it, the rounding ties there, the specials and
    the subnormal range, each with both signs."""
    rng = np.random.default_rng(0)
    normal = np.concatenate([rng.normal(0, s, 20000)
                             for s in (1e-3, 1e-2, 0.1, 1, 10, 100, 300)])
    band = np.concatenate([np.linspace(440, 470, 3001),
                           np.linspace(465, 1000, 2000),
                           [448, 456, 464, np.nextafter(464, 0, dtype=np.float32),
                            np.nextafter(464, 1e9, dtype=np.float32), 480,
                            1e6, 3e38, np.inf, np.nan]])
    sub = np.concatenate([np.linspace(0, 2 ** -6, 2001),
                          [2 ** -9, 2 ** -10, 2 ** -11, 3 * 2 ** -11, 1e-30]])
    x = np.concatenate([normal, band, sub]).astype(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize('src', ['float32', 'bfloat16'])
def test_cast_gives_the_jax_bytes(src):
    x = _sweep()
    if src == 'bfloat16':
        # The same bf16 bits on both sides.
        xj = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(xj.view(np.int16).copy()).view(torch.bfloat16)
    else:
        xj, xt = x, torch.from_numpy(x)
    want = np.asarray(jnp.asarray(xj).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = to_fp8(xt).view(torch.uint8).numpy()
    x = np.asarray(xj, np.float32)          # the values cast
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (x[bad[:8]], got[bad[:8]], want[bad[:8]])
    over = ~(np.abs(x) <= 464)
    assert over.sum() > 4000
    # The overflow band is NaN with the input's sign, where torch's own
    # cast saturates (the fault the helper repairs).
    assert set(got[over & ~np.signbit(x)].tolist()) == {0x7F}
    assert set(got[over & np.signbit(x)].tolist()) == {0xFF}
    plain = xt.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (plain[over & np.isfinite(x)] != want[over & np.isfinite(x)]).all()


def _prompts(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 101, int(rng.integers(3, 30))).tolist()
            for _ in range(n)]


def _assert_same(ref, out):
    for a, b in zip(ref, out):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason == a.finish_reason
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=TOL)


def _cache_bytes(eng, jax_side):
    if jax_side:
        return [(np.asarray(k).view(np.uint8), np.asarray(v).view(np.uint8))
                for k, v in eng.cache]
    return [(as_bytes(k).numpy(), as_bytes(v).numpy()) for k, v in eng.cache]


@pytest.mark.parametrize('layout', ['dense', 'paged'])
def test_fp8_engine_matches_the_jax_fp8_engine(params, layout):
    """Six prompts over three buckets on four slots (dense) or the block
    pool (paged): tokens, finish reasons and logprobs as the JAX fp8
    engine gives them, the caches equal byte for byte after the run, and
    one byte a cached value (a quarter of the f32 cache's bytes, half a
    bf16 cache's)."""
    kw = PAGED if layout == 'paged' else {}
    ref = jax_engine(params, **JFP8, **kw)
    eng = port_engine(params, **FP8, **kw)
    prompts = _prompts()
    _assert_same(
        ref.generate([JaxRequest(tokens=p, max_new_tokens=8)
                      for p in prompts]),
        eng.generate([Request(tokens=p, max_new_tokens=8) for p in prompts]))
    for (jk, jv), (pk, pv) in zip(_cache_bytes(ref, True),
                                  _cache_bytes(eng, False)):
        assert np.array_equal(jk, pk) and np.array_equal(jv, pv)
    assert eng.stats()['kv']['bytes'] == ref.stats()['kv']['bytes']
    f32 = port_engine(params, **kw).stats()['kv']['bytes']['total']
    assert eng.stats()['kv']['bytes']['total'] * 4 == f32


def test_fp8_host_tier_and_handoff_both_ways(params):
    """fp8 rows through the host tier (spill on eviction, restore on the
    next match) give the JAX tier engine's tokens, and the hot-prefix
    export of each engine adopts into the other: the adopted pool rows
    are the exported bytes and the next hot request is a radix hit with
    the exporter's tokens.  A bf16 payload into an fp8 engine is
    refused, as in the reference."""
    ref = jax_engine(params, **JFP8, **RADIX_TIER)
    eng = port_engine(params, **FP8, **RADIX_TIER)
    churn = [[(7 * j + 11 * i) % 97 + 1 for j in range(25)]
             for i in range(4)]
    waves = [[HOT + [50]], *[[c] for c in churn], [HOT + [60, 61]]]
    with WindowAudit(eng) as audit:
        for wave in waves:
            _assert_same(
                ref.generate([JaxRequest(tokens=p, max_new_tokens=4)
                              for p in wave]),
                eng.generate([Request(tokens=p, max_new_tokens=4)
                              for p in wave]))
    assert audit.errors == []
    assert eng._host_tier.stats['restores'] == \
        ref._host_tier.stats['restores'] == 3
    assert eng.radix_stats == ref.radix_stats
    # The exports hold the same bytes.
    pay_p = eng.export_hot_prefixes()
    pay_j = ref.export_hot_prefixes()
    assert pay_p['cache_dtype'] == pay_j['cache_dtype'] == 'float8_e4m3fn'
    assert pay_p['prefixes'] == pay_j['prefixes']
    probe = HOT + [70, 71]
    want = eng.generate([Request(tokens=probe, max_new_tokens=4)])[0]
    # Port -> JAX and JAX -> port.
    j2 = jax_engine(params, **JFP8, **RADIX_TIER)
    p2 = port_engine(params, **FP8, **RADIX_TIER)
    assert j2.adopt_prefixes(copy.deepcopy(pay_p))['adopted_blocks'] > 0
    assert p2.adopt_prefixes(copy.deepcopy(pay_j))['adopted_blocks'] > 0
    blocks = p2._radix.peek(None, HOT, len(HOT))
    assert len(blocks) == 3
    [rec] = [p for p in pay_j['prefixes'] if p['tokens'][:24] == HOT]
    for i, blk in enumerate(blocks):
        for part, pool in (('k', 0), ('v', 1)):
            rows = torch.stack([as_bytes(kv[pool])[blk] for kv in p2.cache])
            assert p2._wire_rows(rows) == rec['blocks'][i][part]
    for adopter, cls in ((j2, JaxRequest), (p2, Request)):
        hits = adopter.radix_stats['hits']
        got = adopter.generate([cls(tokens=probe, max_new_tokens=4)])[0]
        assert got.output_tokens == want.output_tokens
        assert adopter.radix_stats['hits'] == hits + 1
    bf16 = port_engine(params, kv_block_size=8, auto_prefix_cache=True,
                       cache_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='cache_dtype mismatch'):
        bf16.adopt_prefixes(copy.deepcopy(pay_j))
    with pytest.raises(ValueError, match='cache_dtype mismatch'):
        p2.adopt_prefixes(bf16.export_hot_prefixes())


@pytest.mark.parametrize('layout', ['dense', 'paged'])
def test_planted_k_overflow_ends_the_lane_as_jax_does(params, layout):
    """Layer 0's K projection scaled by 1000 in both models puts K rows
    past e4m3's range: both caches hold the same NaN bytes there (the
    port's plain torch cast would have stored +-448 and served on), and
    both engines end the lane the same way."""
    planted = copy.deepcopy(params)
    k = planted['layer_0']['attn']['k_proj']['kernel']
    planted['layer_0']['attn']['k_proj']['kernel'] = k * 1000.0
    kw = PAGED if layout == 'paged' else {}
    ref = jax_engine(planted, **JFP8, **kw)
    eng = port_engine(planted, **FP8, **kw)
    prompts = _prompts(seed=4, n=2)
    r_j = ref.generate([JaxRequest(tokens=p, max_new_tokens=6)
                        for p in prompts])
    r_p = eng.generate([Request(tokens=p, max_new_tokens=6)
                        for p in prompts])
    for a, b in zip(r_j, r_p):
        assert b.finish_reason == a.finish_reason == 'error'
        assert b.output_tokens == a.output_tokens
    assert eng.fault_stats == ref.fault_stats
    assert eng.fault_stats['nonfinite_lanes'] == 2
    jk = _cache_bytes(ref, True)[0][0]
    pk = _cache_bytes(eng, False)[0][0]
    assert np.isin(pk, (0x7F, 0xFF)).sum() > 100
    assert np.array_equal(jk, pk)
