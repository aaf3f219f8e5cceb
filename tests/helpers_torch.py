"""Shared pieces of the port's serving tests (test_torch_faults.py,
test_torch_server.py): one tiny f32 Llama built on both sides from the
same numpy weights, and engine factories for the JAX engine and the
port's."""
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import LlamaConfig as PortLlamaConfig
# The conservation law lives in the JAX-free helper, which spawned workers
# import; the serving tests take it from here as before.
from helpers_torch_dist import WindowAudit, conservation_errors  # noqa: F401

# The geometry of tests/test_faults.py's tiny model.
GEOMETRY = dict(name='serve-test', vocab_size=101, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=128, tie_embeddings=True)
JAX_CFG = JaxLlamaConfig(**GEOMETRY, dtype='float32')
PORT_CFG = PortLlamaConfig(**GEOMETRY, dtype=torch.float32)

# The engine settings of tests/test_faults.py (COMMON).
COMMON = dict(num_slots=4, max_cache_len=64, prefill_buckets=(8, 16, 32),
              max_new_tokens=8)

# Weights at std 0.02 * WEIGHT_SCALE: at the init's 0.02 a 2-layer model's
# logits are nearly flat, and near-ties could order differently under two
# summation orders; scaled, greedy paths change token every few steps.
WEIGHT_SCALE = 10.0


def make_params(seed: int = 3):
    """numpy params['params'] in the flax tree's layout."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(JAX_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.normal(
        0, 0.02 * WEIGHT_SCALE, x.shape).astype(np.float32), shapes)


def jax_engine(params, **overrides) -> JaxEngine:
    kw = {**COMMON, 'cache_dtype': jnp.float32, **overrides}
    return JaxEngine(JAX_CFG, JaxInferConfig(**kw),
                     params={'params': params},
                     rng=jax.random.PRNGKey(7))


def port_engine(params, **overrides) -> port.InferenceEngine:
    kw = {**COMMON, 'cache_dtype': torch.float32, **overrides}
    return port.InferenceEngine(
        PORT_CFG, port.InferConfig(**kw),
        params=convert.state_dict_from_jax(params, PORT_CFG),
        generator=torch.Generator().manual_seed(0), device='cpu')


def key_sets(doc):
    """The nested key structure of a JSON document: dicts by their keys,
    lists element-wise, every leaf one mark (timings and ids differ
    between replicas; their keys must not)."""
    if isinstance(doc, dict):
        return {k: key_sets(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [key_sets(v) for v in doc]
    return 'leaf'


def assert_same_qos(mine, ref):
    """stats()['qos'] sections equal whole, but for the wall-clock service
    rate, whose None-ness must match."""
    mine, ref = dict(mine), dict(ref)
    rates = (mine.pop('service_rate_tokens_per_s'),
             ref.pop('service_rate_tokens_per_s'))
    assert (rates[0] is None) == (rates[1] is None), rates
    assert mine == ref


def features_match(jax_eng, port_eng, prompts, prefix, max_new=6,
                   tol=1e-4):
    """Registered-prefix, prompt-logprob and (with the engines' own
    draft_len / qos settings) speculative and QoS serving of `prompts` on
    a JAX and a port engine over the same weights: `prefix` registered on
    both, every other prompt starting with it, the first asking for
    prompt logprobs.  Asserts the same tokens, finish reasons and
    prefix hits, and logprobs and prompt logprobs within `tol`."""
    from skypilot_tpu.infer import Request as JaxRequest
    assert jax_eng.register_prefix(prefix) == port_eng.register_prefix(prefix)
    seqs = [list(prefix) + p if i % 2 else p for i, p in enumerate(prompts)]
    want = jax_eng.generate([
        JaxRequest(tokens=s, max_new_tokens=max_new,
                   want_prompt_logprobs=i == 0) for i, s in enumerate(seqs)])
    got = port_eng.generate([
        port.Request(tokens=s, max_new_tokens=max_new,
                     want_prompt_logprobs=i == 0)
        for i, s in enumerate(seqs)])
    assert port_eng.prefix_stats == jax_eng.prefix_stats
    assert port_eng.prefix_stats['hits'] > 0
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=tol)
    np.testing.assert_allclose(
        np.asarray(got[0].prompt_logprobs[1:], np.float64),
        np.asarray(want[0].prompt_logprobs[1:], np.float64), rtol=0,
        atol=tol)
    return got


def engine_factories(geometry: dict, scale: float = 0.2, seed: int = 3,
                     cache_dtype: str = 'float32'):
    """(jax_factory, port_factory, params): engine factories over one set
    of numpy weights (std `scale`) of an f32 llama of `geometry`, taking a
    bench script's engine options (InferConfig fields) as keywords, with
    decode_steps 8 unless given.  For the bench twins' parity tests, whose
    sections build their engines through a module-level factory."""
    jcfg = JaxLlamaConfig(**geometry, dtype='float32')
    pcfg = PortLlamaConfig(**geometry, dtype=torch.float32)
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: rng.normal(0, scale, x.shape).astype(
        np.float32), shapes)
    sd = convert.state_dict_from_jax(params, pcfg)

    def jax_factory(**kw):
        kw = {'decode_steps': 8, **kw}
        return JaxEngine(jcfg, JaxInferConfig(
            cache_dtype=getattr(jnp, cache_dtype), **kw),
            params={'params': params}, rng=jax.random.PRNGKey(7))

    def port_factory(**kw):
        kw = {'decode_steps': 8, **kw}
        return port.InferenceEngine(
            pcfg, port.InferConfig(cache_dtype=getattr(torch, cache_dtype),
                                   **kw),
            params=sd, generator=torch.Generator().manual_seed(0),
            device='cpu')

    return jax_factory, port_factory, params


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """A module of tiny-model tests (import this fixture into the module
    to apply it) under pytest-xdist takes its share of the cores in torch
    threads: with torch's default of a thread per core, six workers
    oversubscribe the cores many times over on ops this small (a 4 s
    test took 168 s in the suite).  Alone, a module keeps the default."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)
