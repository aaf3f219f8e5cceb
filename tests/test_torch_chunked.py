"""Chunked prefill in the port's engine (skypilot_tpu_torch.infer.engine,
``prefill_chunk``) held against the JAX engine offline: the same f32
weights and requests -- prompts past the largest bucket, which always
chunk -- give the same greedy tokens, finish reasons, chunk_stats and
radix/admission counters, logprobs within TOL, over the dense cache and
the block-paged pool with the radix cache off and on and with the host
tier; the block-conservation law holds after every decode window.  Then
the config errors and the window policy.  Serving, radix hits on
chunk-boundary blocks and failures of chunking slots are in
test_torch_chunked_serving.py."""
import contextlib

import numpy as np
import pytest

from helpers_torch import WindowAudit, jax_engine, make_params, port_engine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.infer import engine as port

# f32 on both sides: logprobs differ by summation order only.
TOL = 1e-5
# Largest bucket 16 in a 64-row cache: prompts of 17..48 tokens chunk,
# 8 rows per chunk.
CHUNK = dict(prefill_buckets=(8, 16), prefill_chunk=8)
LAYOUTS = {
    'dense': {},
    'paged': dict(kv_block_size=8),
    'paged_radix': dict(kv_block_size=8, auto_prefix_cache=True),
    # 19 usable blocks: admission defers, radix leaves spill to the tier.
    'paged_tier': dict(kv_block_size=8, auto_prefix_cache=True,
                       kv_blocks=20, host_kv_bytes=1 << 20),
}
# Requests 0, 2, 3, 4 and 6 are past the largest bucket; request 6
# repeats request 0's first 32 tokens (a radix hit once 0 finished).
LENS = (40, 12, 48, 17, 33, 5)
NEW = (8, 8, 16, 6, 8, 8, 12)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 101, n).tolist() for n in LENS]
    return out + [out[0][:32] + rng.integers(0, 101, 4).tolist()]


def assert_same(ref, got):
    """Token ids and finish reasons exactly, logprobs within TOL."""
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.output_tokens == a.output_tokens, (i, a, b)
        assert b.finish_reason == a.finish_reason, (i, a, b)
        np.testing.assert_allclose(b.logprobs or [], a.logprobs or [],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_offline_chunked_identical_to_jax_engine(params, prompts, layout):
    kw = {**CHUNK, **LAYOUTS[layout]}
    jax_eng = jax_engine(params, **kw)
    eng = port_engine(params, **kw)
    # The max_cache_len bucket is not appended: prompts past 16 chunk.
    assert eng.cfg.prefill_buckets == tuple(jax_eng.cfg.prefill_buckets) \
        == (8, 16)
    ref = jax_eng.generate([JaxRequest(tokens=p, max_new_tokens=m)
                            for p, m in zip(prompts, NEW)])
    audit = WindowAudit(eng) if eng._paged else contextlib.nullcontext()
    with audit:
        got = eng.generate([port.Request(tokens=p, max_new_tokens=m)
                            for p, m in zip(prompts, NEW)])
    assert_same(ref, got)
    assert [r.finish_reason for r in got] == ['length'] * len(prompts)
    assert eng.chunk_stats == jax_eng.chunk_stats
    assert eng.chunk_stats['requests'] >= 4   # 6 may start by radix
    assert not eng._chunking and eng.has_free_slot()
    if eng._paged:
        assert not audit.errors, audit.errors[:5]
        assert audit.windows > 0
        assert eng.radix_stats == jax_eng.radix_stats
        assert eng.paged_stats == jax_eng.paged_stats
        if eng._radix is not None:
            assert eng.radix_stats['hits'] >= 1
        if eng._host_tier is not None:
            assert eng.paged_stats['deferred'] > 0
            assert (eng.stats()['kv']['host_tier']['spills'] ==
                    jax_eng.stats()['kv']['host_tier']['spills'])


def test_past_the_cache_is_still_a_client_error(params):
    """Chunking lifts the bucket cap, not the cache's: prompt + max_new
    past max_cache_len fails alone, as in the JAX engine."""
    eng = port_engine(params, **CHUNK)
    bad, ok = eng.generate([port.Request(tokens=[1] * 49, max_new_tokens=16),
                            port.Request(tokens=[2] * 48, max_new_tokens=16)])
    assert bad.finish_reason == 'error' and bad.error_class == 'client'
    assert 'exceeds cache' in bad.error
    assert ok.finish_reason == 'length' and len(ok.output_tokens) == 16


@pytest.mark.parametrize('overrides,match', [
    (dict(prefill_chunk=-4), 'prefill_chunk'),
    (dict(prefill_chunk=24), 'multiple of prefill_chunk'),
    (dict(prefill_chunk=4, kv_block_size=8), 'multiple of kv_block_size'),
])
def test_config_errors_match_the_jax_engine(params, overrides, match):
    """The JAX engine's config errors, message for message."""
    with pytest.raises(ValueError, match=match) as ref:
        jax_engine(params, **overrides)
    with pytest.raises(ValueError, match=match) as got:
        port_engine(params, **overrides)
    assert str(got.value) == str(ref.value)


def test_chunking_slot_counts_as_a_pending_arrival(params):
    """The queue-aware window treats a part-prefilled slot like a queued
    arrival: short windows while its chunks ride the gaps, full ones for
    a stream alone; the slot is not free."""
    eng = port_engine(params, adaptive_decode_window=True, decode_steps=8,
                      **CHUNK)
    eng._slots[0] = object()
    assert eng._select_window() == 8
    eng._chunking[1] = object()
    assert eng._select_window() == 2
    assert eng._free_slot() == 2
    eng._slots[2] = eng._slots[3] = object()
    assert not eng.has_free_slot()
