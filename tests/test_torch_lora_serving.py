"""Multi-LoRA serving of the port (skypilot_tpu_torch.infer) held against
the JAX engine and server, on the tiny f32 model of helpers_torch (CPU):
the same base weights (state_dict_from_jax) and the same adapter files
(each engine loads the other package's .npz), and mixed batches of base
and adapter requests give identical greedy tokens, finish reasons and
registered adapters, logprobs within TOL -- dense and paged, with the
radix cache and host tier, registered prefixes under an adapter (the
reference's review fixes), chunked prefill, speculation and prompt
scoring under adapters, and the hot-prefix handoff naming an adapter,
both ways.  The two reference faults the port does not copy (C3, C4) are
tests/test_torch_lora_faults.py; the HTTP side is
tests/test_torch_lora_server.py."""
import dataclasses
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers_torch import (JAX_CFG, WindowAudit, conservation_errors,
                           jax_engine, make_params, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.train import lora as jlora
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.train import lora

# f32 on both sides, summation order only.  Adapters with B at std 0.5
# (large enough to move greedy tokens) give logprobs of a few nats whose
# f32 round-off reaches 2e-5: held to 1e-5 of their size.
TOL = dict(rtol=1e-5, atol=1e-6)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_max_adapters=3)
RADIX = dict(kv_block_size=8, auto_prefix_cache=True)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [1, 2, 3],
           [9] * 17, [21, 3, 44, 7, 19, 2, 60, 33, 12]]


def _tree(seed):
    """An adapter tree for the helpers' geometry at rank 4 with every
    leaf drawn with numpy: A at 0.02, B at 0.5."""
    cfg = dataclasses.replace(JAX_CFG, lora_rank=4, lora_alpha=8.0)
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    full = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.normal(
            0, 0.5 if 'lora_b' in jax.tree_util.keystr(p) else 0.02,
            x.shape).astype(np.float32), shapes)
    return jlora.extract_adapter_tree(full)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Adapters 'a' and 'b' written by the JAX package, 'c' by the port
    (from the same kind of tree), all in one adapter directory."""
    root = tmp_path_factory.mktemp('adapters')
    jlora.save_adapter_npz(_tree(1), str(root / 'a.npz'))
    jlora.save_adapter_npz(_tree(2), str(root / 'b.npz'))
    lora.save_adapter_npz(_tree(3), str(root / 'c.npz'))
    return root


def _pair(params, files, names=('a', 'b'), **kw):
    """A JAX and a port engine over the same base weights, each with the
    named adapters registered (name 'x' from x.npz, 't' from a.npz),
    the JAX engine reading the files with jlora.load_adapter_npz, the
    port with lora.load_adapter_npz."""
    je = jax_engine(params, **LORA, **kw)
    pe = port_engine(params, **LORA, **kw)
    for i, name in enumerate(names):
        path = str(files / f"{'a' if name == 't' else name}.npz")
        assert je.register_adapter(name, jlora.load_adapter_npz(path)) == i
        assert pe.register_adapter(name, lora.load_adapter_npz(path)) == i
    assert je.adapters == pe.adapters
    return je, pe


class _NoAudit:
    """WindowAudit's shape for a dense engine (no pool to conserve)."""
    errors, windows = [], 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _audit(eng):
    return WindowAudit(eng) if eng._paged else _NoAudit()


def _mixed(cls, adapters=(None, 'a', 'b'), max_new=8, **kw):
    return [cls(tokens=list(p), max_new_tokens=max_new, adapter=a,
                request_id=f'{i}-{a}', **kw)
            for i, p in enumerate(PROMPTS) for a in adapters]


def _same(jres, pres):
    assert len(jres) == len(pres)
    for j, p in zip(jres, pres):
        assert p.output_tokens == j.output_tokens, (p.request_id, j, p)
        assert p.finish_reason == j.finish_reason
        np.testing.assert_allclose(p.logprobs, j.logprobs, **TOL)
        if j.prompt_logprobs is not None:
            np.testing.assert_allclose(
                np.asarray(p.prompt_logprobs[1:], np.float64),
                np.asarray(j.prompt_logprobs[1:], np.float64), **TOL)


@pytest.mark.parametrize('layout', ['dense', 'paged-radix'])
def test_mixed_batch_and_adapter_prefixes_match_jax(params, files, layout):
    """Base and two adapters in one batch, twice (paged: the second wave
    reuses radix blocks per adapter), then a prefix registered under 'a'
    (the reference's review fix (c): it hits only requests naming 'a'),
    prompt scoring under 'b', and re-registering 'a' with 'b''s weights
    (review fix (b): its prefix entries go and its requests decode as
    'b').  Both engines were built from a base state, which grafts it
    under zero adapters (review fix (a))."""
    je, pe = _pair(params, files, **(RADIX if layout != 'dense' else {}))
    with _audit(pe) as audit:
        jres = je.generate(_mixed(JaxRequest))
        pres = pe.generate(_mixed(Request))
        _same(jres, pres)
        base = [r.output_tokens for r in pres[0::3]]
        assert base != [r.output_tokens for r in pres[1::3]]
        assert base != [r.output_tokens for r in pres[2::3]]
        _same(je.generate(_mixed(JaxRequest)), pe.generate(_mixed(Request)))
        assert pe.radix_stats == je.radix_stats
        n = 8 if layout != 'dense' else 5
        assert je.register_prefix(PROMPTS[0][:n], adapter='a') == \
            pe.register_prefix(PROMPTS[0][:n], adapter='a')
        hits = pe.prefix_stats['hits'], pe.radix_stats['hits']
        _same(je.generate(_mixed(JaxRequest)), pe.generate(_mixed(Request)))
        assert pe.prefix_stats == je.prefix_stats
        assert pe.radix_stats == je.radix_stats
        if layout == 'dense':
            # One hit: prompt 0 under 'a'; base and 'b' do not match.
            assert pe.prefix_stats['hits'] == hits[0] + 1
        scored = [JaxRequest(tokens=PROMPTS[3], max_new_tokens=3,
                             adapter='b', want_prompt_logprobs=True)]
        _same(je.generate(scored), pe.generate([Request(
            tokens=PROMPTS[3], max_new_tokens=3, adapter='b',
            want_prompt_logprobs=True)]))
        tree_b = str(files / 'b.npz')
        je.register_adapter('a', jlora.load_adapter_npz(tree_b))
        pe.register_adapter('a', lora.load_adapter_npz(tree_b))
        assert not any(k[0] == 'a' for k in pe._prefixes)
        assert not any(k[0] == 'a' for k in je._prefixes)
        again = pe.generate(_mixed(Request, adapters=('a', 'b')))
        for ra, rb in zip(again[0::2], again[1::2]):
            assert ra.output_tokens == rb.output_tokens
        if layout == 'dense':
            _same(je.generate(_mixed(JaxRequest, adapters=('a', 'b'))),
                  again)
    assert audit.errors == []
    bad = pe.generate([Request(tokens=[1, 2], adapter='nope')])[0]
    jbad = je.generate([JaxRequest(tokens=[1, 2], adapter='nope')])[0]
    assert bad.finish_reason == jbad.finish_reason == 'error'
    assert bad.error == jbad.error and bad.error_class == 'client'


def test_chunked_and_speculative_under_adapters_match_jax(params, files):
    """Chunked prefill (a 24-token prompt past the largest bucket) and
    prompt-lookup speculation (repetitive prompts) under adapters,
    beside base requests: the JAX engine's tokens and counters."""
    kw = dict(draft_len=3, prefill_chunk=8, prefill_buckets=(8, 16))
    je, pe = _pair(params, files, **kw)
    # Prompts over tokens 1..4, as the speculation tests draw them: the
    # n-gram drafts fire often.
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 5, 24).tolist()] + [
        rng.integers(1, 5, n).tolist() for n in (9, 14)]
    mk = lambda cls: [cls(tokens=p, max_new_tokens=12, adapter=a)  # noqa
                      for p in prompts for a in (None, 'a', 'b')]
    _same(je.generate(mk(JaxRequest)), pe.generate(mk(Request)))
    assert pe.spec_stats == je.spec_stats
    assert pe.spec_stats['dispatches'] > 0
    assert pe.chunk_stats == je.chunk_stats
    assert pe.chunk_stats['requests'] == 3


# A pool of 12 usable blocks (+ dump): a few 25-token prompts evict.
TIGHT = dict(num_slots=2, kv_block_size=8, kv_blocks=13,
             auto_prefix_cache=True, host_kv_bytes=1 << 20)
HOT = [(5 * j) % 97 + 1 for j in range(24)]


def _churn(cls, i, adapter=None):
    return cls(tokens=[(7 * j + 11 * i) % 97 + 1 for j in range(25)],
               max_new_tokens=4, adapter=adapter)


def test_host_tier_and_handoff_under_adapters_match_jax(params, files):
    """A hot prefix under 'a' churned out of a tight pool spills to the
    host tier keyed by 'a' and restores for the next 'a' request, not
    for a base one; then the hot set, exported by each engine, adopts
    into the other package's fresh engine only when it registered 'a',
    and serves the exporter's tokens from the adopted blocks."""
    je, pe = _pair(params, files, **TIGHT)
    with WindowAudit(pe) as audit:
        for eng, cls in ((je, JaxRequest), (pe, Request)):
            eng.generate([cls(tokens=HOT + [50], max_new_tokens=4,
                              adapter='a')])
            for i in range(4):
                eng.generate([_churn(cls, i, 'b' if i % 2 else None)])
        assert pe._radix.peek('a', HOT, len(HOT)) == []
        assert ('a', tuple(HOT[:8])) in pe._host_tier._entries
        reqs = lambda cls: [  # noqa: E731
            cls(tokens=HOT + [60], max_new_tokens=4),
            cls(tokens=HOT + [61], max_new_tokens=4, adapter='a')]
        for r in reqs(JaxRequest):
            [jr] = je.generate([r])
            [pr] = pe.generate([Request(tokens=r.tokens, max_new_tokens=4,
                                        adapter=r.adapter)])
            _same([jr], [pr])
        assert pe._host_tier.stats['restores'] == \
            je._host_tier.stats['restores'] == 3
        assert pe.radix_stats == je.radix_stats
    assert audit.errors == []
    for src, dst_cls in ((je, 'port'), (pe, 'jax')):
        payload = json.loads(json.dumps(src.export_hot_prefixes()))
        assert any(p['adapter'] == 'a' for p in payload['prefixes'])
        make = port_engine if dst_cls == 'port' else jax_engine
        bare = make(params, **LORA, **RADIX)
        res = bare.adopt_prefixes(payload)
        assert res['adopted_prefixes'] == sum(
            p['adapter'] is None for p in payload['prefixes'])
        dst = make(params, **LORA, **RADIX)
        path = str(files / 'a.npz')
        dst.register_adapter('a', (lora if dst_cls == 'port' else jlora)
                             .load_adapter_npz(path))
        res = dst.adopt_prefixes(payload)
        assert res['skipped'] == sum(p['adapter'] == 'b'
                                     for p in payload['prefixes'])
        cls = Request if dst_cls == 'port' else JaxRequest
        hits = dst.radix_stats['hits']
        got = dst.generate([cls(tokens=HOT + [70], max_new_tokens=6,
                                adapter='a')])
        assert dst.radix_stats['hits'] == hits + 1
        want = src.generate([(JaxRequest if src is je else Request)(
            tokens=HOT + [70], max_new_tokens=6, adapter='a')])
        _same(want, got)
        if dst_cls == 'port':
            assert conservation_errors(dst) == []


def test_registration_errors_match_jax(params, files):
    """register_adapter's refusals are the JAX engine's, message for
    message: a leaf with no target (wrong targets), a rank mismatch,
    the slots full, an engine built without lora_rank; a request naming
    an adapter on such an engine is a client error with the JAX text.
    The {'params': ...} wrapper is tolerated and re-registering keeps
    the slot."""
    je, pe = _pair(params, files, names=('a',))
    tree = jlora.load_adapter_npz(str(files / 'b.npz'))
    mlp = {'layer_0': {'mlp': {'up_proj_lora': tree['layer_0']['attn'][
        'q_proj_lora']}}}
    wide = jax.tree.map(lambda x: np.concatenate([x, x], axis=-1), tree)
    for bad, err in ((mlp, KeyError), (wide, ValueError)):
        msgs = []
        for eng in (je, pe):
            with pytest.raises(err) as info:
                eng.register_adapter('x', bad)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1], msgs
    assert 'rank mismatch' in msgs[1]
    for eng in (je, pe):
        assert eng.register_adapter('b', {'params': tree}) == 1
        assert eng.register_adapter('c', tree) == 2
        assert eng.register_adapter('a', tree) == 0
    msgs = []
    for eng in (je, pe):
        with pytest.raises(ValueError) as info:
            eng.register_adapter('d', tree)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and 'slots full' in msgs[1]
    plain_j, plain_p = jax_engine(params), port_engine(params)
    msgs = []
    for eng in (plain_j, plain_p):
        with pytest.raises(ValueError) as info:
            eng.register_adapter('a', tree)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    [j] = plain_j.generate([JaxRequest(tokens=[1, 2], adapter='a')])
    [p] = plain_p.generate([Request(tokens=[1, 2], adapter='a')])
    assert (p.finish_reason, p.error, p.error_class) == \
        (j.finish_reason, j.error, j.error_class) == \
        ('error', "request names adapter 'a' but the engine was built "
         'without lora_rank', 'client')
