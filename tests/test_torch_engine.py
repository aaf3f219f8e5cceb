"""The port's dense-cache engine (skypilot_tpu_torch.infer.engine) held
against the JAX InferenceEngine: the same params (carried across with
state_dict_from_jax), an f32 model and cache, and the same requests give
identical greedy tokens.  Everything on the CPU at llama-debug size."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import jax_engine, make_params, port_engine
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert, registry

# f32 on both sides: logprobs differ only by summation order.
TOL_LOGPROB = 1e-4
# Random init at std 0.02 makes a 2-layer model repeat one token; weights
# scaled by this factor give greedy paths that change token every step.
WEIGHT_SCALE = 10.0

JAX_CFG = dataclasses.replace(jax_model_config('llama-debug'),
                              dtype=jnp.float32)
PORT_CFG = dataclasses.replace(registry.get_model_config('llama-debug'),
                               dtype=torch.float32)
# Six prompts over the two buckets (16, 48); request 4 wants one token.
PROMPT_LENS = (5, 9, 17, 30, 3, 40)
MAX_NEW = (8, 8, 8, 8, 1, 8)


def _engine_kwargs(**overrides):
    kw = dict(num_slots=2, max_cache_len=96, prefill_buckets=(16, 48),
              max_new_tokens=8, decode_steps=4)
    kw.update(overrides)
    return kw


@pytest.fixture(scope='module')
def params():
    """numpy params['params'] in the flax tree's layout (from an abstract
    init), drawn at std 0.02 * WEIGHT_SCALE."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(JAX_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda x: rng.normal(
        0, 0.02 * WEIGHT_SCALE, x.shape).astype(np.float32), shapes)


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope='module')
def jax_greedy(params, prompts):
    """JAX engine greedy results, memoized by engine settings."""
    memo = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in memo:
            eng = JaxEngine(JAX_CFG, JaxInferConfig(
                **_engine_kwargs(**{'cache_dtype': jnp.float32, **kw})),
                            params={'params': params})
            memo[key] = eng.generate([
                JaxRequest(tokens=p, max_new_tokens=m)
                for p, m in zip(prompts, MAX_NEW)])
        return memo[key]

    return run


def _port_engine(params, **kw):
    return port.InferenceEngine(
        PORT_CFG, port.InferConfig(**_engine_kwargs(
            **{'cache_dtype': torch.float32, **kw})),
        params=convert.state_dict_from_jax(params, PORT_CFG), device='cpu',
        generator=torch.Generator().manual_seed(0))


def _port_run(params, prompts, temps=None, **kw):
    temps = temps or [0.0] * len(prompts)
    return _port_engine(params, **kw).generate(
        [port.Request(tokens=p, max_new_tokens=m, temperature=t)
         for p, m, t in zip(prompts, MAX_NEW, temps)])


def _assert_same(jax_results, port_results):
    assert len(jax_results) == len(port_results)
    for j, t in zip(jax_results, port_results):
        assert t.output_tokens == j.output_tokens
        assert t.finish_reason == j.finish_reason
        np.testing.assert_allclose(t.logprobs, j.logprobs, rtol=0,
                                   atol=TOL_LOGPROB)
        for jt, tt in zip(j.top_logprobs, t.top_logprobs):
            jv = np.array([lp for _, lp in jt])
            np.testing.assert_allclose([lp for _, lp in tt], jv, rtol=0,
                                       atol=TOL_LOGPROB)
            # Ids only where values are distinct: tie order differs
            # between lax.top_k and torch.topk.
            gaps = np.diff(jv)
            for r, (ji, ti) in enumerate(zip(jt, tt)):
                distinct = ((r == 0 or -gaps[r - 1] > TOL_LOGPROB) and
                            (r == len(jv) - 1 or -gaps[r] > TOL_LOGPROB))
                if distinct:
                    assert ji[0] == ti[0]


@pytest.mark.parametrize('decode_steps', [1, 4])
def test_greedy_tokens_identical_to_jax_engine(params, prompts, jax_greedy,
                                              decode_steps):
    """Two buckets, two slots recycled over six requests, one request
    with max_new_tokens=1."""
    j = jax_greedy(decode_steps=decode_steps)
    t = _port_run(params, prompts, decode_steps=decode_steps)
    _assert_same(j, t)
    assert [len(r.output_tokens) for r in t] == list(MAX_NEW)
    assert len({tok for r in t for tok in r.output_tokens}) > 8


@pytest.mark.parametrize('decode_steps', [1, 4])
def test_eos_finish_identical_to_jax_engine(params, prompts, jax_greedy,
                                           decode_steps):
    """eos_id set to a token request 0 produces mid-stream: it ends there
    ('eos') in both engines, and every other request matches too."""
    plain = _port_run(params, prompts, decode_steps=decode_steps)
    eos = plain[0].output_tokens[3]
    j = jax_greedy(decode_steps=decode_steps, eos_id=eos)
    t = _port_run(params, prompts, decode_steps=decode_steps, eos_id=eos)
    _assert_same(j, t)
    assert t[0].finish_reason == 'eos'
    assert t[0].output_tokens[-1] == eos


def test_temperature_lane_leaves_greedy_lanes_identical(params, prompts,
                                                        jax_greedy):
    """One lane samples at temperature 0.8; the greedy lanes still give
    the JAX engine's greedy tokens."""
    temps = [0.0, 0.0, 0.8, 0.0, 0.0, 0.0]
    j = jax_greedy(decode_steps=4)
    t = _port_run(params, prompts, temps=temps)
    greedy = [i for i, x in enumerate(temps) if x == 0.0]
    _assert_same([j[i] for i in greedy], [t[i] for i in greedy])
    assert t[2].finish_reason == 'length' and len(t[2].output_tokens) == 8


def test_bad_request_fails_alone(params, prompts):
    eng = _port_engine(params)
    res = eng.generate([port.Request(tokens=[]),
                        port.Request(tokens=prompts[0], max_new_tokens=2),
                        port.Request(tokens=[1] * 90, max_new_tokens=10)])
    assert [r.finish_reason for r in res] == ['error', 'length', 'error']
    assert res[0].error_class == 'client' and 'empty' in res[0].error
    assert 'exceeds cache' in res[2].error


def test_deadline_finish(params, prompts):
    eng = _port_engine(params)
    res = eng.generate([port.Request(tokens=prompts[1], deadline_s=1e-9,
                                     max_new_tokens=8)])
    assert res[0].finish_reason == 'deadline'


def test_buckets_cover_the_cache(params):
    eng = _port_engine(params, prefill_buckets=(16, 48))
    assert eng.cfg.prefill_buckets == (16, 48, 96)
    assert eng._bucket(17) == 48 and eng._bucket(60) == 96
    with pytest.raises(ValueError, match='bucket'):
        eng._bucket(97)


def _matches_jax_with(params, prompts, field, value, **layout):
    """A field ported since it was refused: the engine builds and serves
    the six prompts as the JAX engine with the same setting does (with
    max_prefixes, a 32-token prefix of prompt 5 registered on both)."""
    jax_value = jnp.float8_e4m3fn if value is torch.float8_e4m3fn else value
    ref = JaxEngine(JAX_CFG, JaxInferConfig(**_engine_kwargs(
        **{'cache_dtype': jnp.float32, **layout, field: jax_value})),
                    params={'params': params})
    eng = _port_engine(params, **layout, **{field: value})
    if field == 'max_prefixes':
        assert (eng.register_prefix(prompts[5][:32]) ==
                ref.register_prefix(prompts[5][:32]) == 32)
    reqs = [(p, m) for p, m in zip(prompts, MAX_NEW)]
    _assert_same(
        ref.generate([JaxRequest(tokens=p, max_new_tokens=m)
                      for p, m in reqs]),
        eng.generate([port.Request(tokens=p, max_new_tokens=m)
                      for p, m in reqs]))
    assert eng.spec_stats == ref.spec_stats
    assert eng.prefix_stats == ref.prefix_stats


@pytest.mark.parametrize('field,value', [
    ('draft_len', 2),
    ('lora_rank', 4), ('qos', True),
    ('max_prefixes', 4), ('qos_tenant_weights', {'a': 2.0}),
    ('cache_dtype', torch.float8_e4m3fn),
])
def test_unported_features_raise(params, prompts, field, value):
    """Every InferConfig field is ported now (QoS last): speculation,
    multi-LoRA with no adapter registered, QoS and its tenant weights,
    registered prefixes and the fp8 cache each serve as the JAX engine
    with the same setting does, and the engine keeps no table of
    refused fields."""
    assert not hasattr(port, '_UNPORTED')
    _matches_jax_with(params, prompts, field, value)


@pytest.mark.parametrize('field,value', [
    ('draft_len', 2), ('max_prefixes', 4),
    ('cache_dtype', torch.float8_e4m3fn),
])
def test_unported_features_raise_on_the_paged_engine(params, prompts, field,
                                                     value):
    """Speculation, registered prefixes (pinned in the radix tree) and
    the fp8 cache on the block-paged engine with the radix cache: as the
    JAX paged engine serves them."""
    assert not hasattr(port, '_UNPORTED')
    _matches_jax_with(params, prompts, field, value, kv_block_size=16,
                      auto_prefix_cache=True)


def test_out_of_range_token_id_served_as_the_jax_engine_does():
    """ROADMAP C1: a prompt id of V maps as the JAX model's gather maps it
    (clamped to V - 1), so the request is served -- 'length' and three
    tokens, the reference's -- instead of failing its prefill batch."""
    p = make_params()
    [ref] = jax_engine(p).generate([JaxRequest(tokens=[101, 3],
                                               max_new_tokens=3)])
    [out] = port_engine(p).generate([port.Request(tokens=[101, 3],
                                                  max_new_tokens=3)])
    assert ref.finish_reason == out.finish_reason == 'length'
    assert out.output_tokens == ref.output_tokens
    assert len(out.output_tokens) == 3
    np.testing.assert_allclose(out.logprobs, ref.logprobs, atol=1e-5)


# ---------------------------------------------------------- benchmarks

BENCH = dict(num_requests=4, prompt_len=10, new_tokens=5)


def test_benchmark_keys_match_the_jax_engine():
    """benchmark(): the JAX engine's keys, every request generated."""
    p = make_params()
    ref = jax_engine(p).benchmark(**BENCH)
    out = port_engine(p).benchmark(**BENCH)
    assert set(out) == set(ref)
    assert all(np.isfinite(v) and v > 0 for v in out.values())


@pytest.mark.parametrize('qps', [None, 200.0])
def test_benchmark_serving_keys_match_the_jax_engine(qps):
    """benchmark_serving(): the JAX engine's keys, all requests completed,
    all at once and with Poisson arrivals."""
    p = make_params()
    ref = jax_engine(p).benchmark_serving(qps=qps, **BENCH)
    out = port_engine(p).benchmark_serving(qps=qps, **BENCH)
    assert set(out) == set(ref)
    assert out['completed'] == ref['completed'] == BENCH['num_requests']
    assert out['offered_qps'] == qps
    assert out['output_tokens_per_second'] > 0


def test_benchmark_serving_stall_raises():
    """A wedged serving loop (the stall fault site sleeps every pass)
    trips the progress-aware stall detection: RuntimeError with the
    engine's stats in the message."""
    from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
    eng = port_engine(make_params(), run_stall_timeout_s=0.3)
    eng.arm_faults(FaultPlan(seed=0, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=1.0)]))
    with pytest.raises(RuntimeError, match='serving stalled.*engine stats'):
        eng.benchmark_serving(**BENCH)
    assert not eng.serving
