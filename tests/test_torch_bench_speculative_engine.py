"""scripts/bench_speculative_torch.py's run_engine held against the
reference script's (scripts/bench_speculative.py, loaded by path) on the
CPU: at draft_len 0 and 4 over the same weights (carried across by
models/convert.state_dict_from_jax, bf16 on both sides) it gives the JAX
engine's tokens, spec_stats, acceptance and copy fidelity, and
speculation leaves the greedy tokens of the windowed decode."""
import importlib.util
import pathlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import LlamaConfig

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# A tiny llama the run_engine config fits (max_cache_len 256).
GEOMETRY = dict(name='induct-test', vocab_size=101, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=256, tie_embeddings=True)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_speculative', 'scripts/bench_speculative.py')
TWIN = _load('bench_speculative_torch', 'scripts/bench_speculative_torch.py')


@pytest.fixture
def tiny(monkeypatch):
    """Both scripts' model_config give the f32 tiny llama."""
    jcfg = JaxLlamaConfig(**GEOMETRY, dtype='float32')
    pcfg = LlamaConfig(**GEOMETRY, dtype=torch.float32)
    for mod, cfg in ((REF, jcfg), (TWIN, pcfg)):
        monkeypatch.setattr(mod, 'MODEL', GEOMETRY['name'])
        monkeypatch.setattr(mod, 'model_config', lambda name, c=cfg: c)
    return jcfg, pcfg


def _params(jcfg, scale=0.2, seed=3):
    """The flax tree's shapes, every leaf drawn with numpy at std `scale`
    (large enough that greedy paths change token every few steps)."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.normal(0, scale, x.shape).astype(
        np.float32), shapes)


def _params(jcfg, scale=0.2, seed=3):
    """The flax tree's shapes, every leaf drawn with numpy at std `scale`
    (large enough that greedy paths change token every few steps)."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.normal(0, scale, x.shape).astype(
        np.float32), shapes)


def _jax_results(monkeypatch):
    """Record what the reference's engines generate (its run_engine keeps
    only counters)."""
    calls = []
    plain = JaxEngine.generate

    def generate(self, requests):
        out = plain(self, requests)
        calls.append(out)
        return out

    monkeypatch.setattr(JaxEngine, 'generate', generate)
    return calls


def test_run_engine_equals_the_jax_engine(tiny, monkeypatch):
    """Grounded traffic at draft_len 0 and 4 over one set of weights:
    tokens, spec_stats, acceptance, tokens per dispatch and copy fidelity
    equal the reference's; draft 4's tokens equal draft 0's."""
    jcfg, pcfg = tiny
    params = _params(jcfg)
    sd = {k: v.to(torch.bfloat16) for k, v in
          convert.state_dict_from_jax(params, pcfg).items()}
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    calls = _jax_results(monkeypatch)
    want, got, results = {}, {}, {}
    for draft in (0, 4):
        label = f'grounded_draft_{draft}'
        REF.run_engine(jparams, draft, REF.grounded_requests(6, 101),
                       label, want, copy_check=True)
        ref_tokens = [r.output_tokens for r in calls[-1]]
        TWIN.run_engine(sd, draft, TWIN.grounded_requests(6, 101), label,
                        got, copy_check=True, device='cpu',
                        results=results)
        assert [r.output_tokens for r in results[label]] == ref_tokens
        for row in (want[label], got[label]):
            for key in ('output_tokens_per_second', 'requests_per_second'):
                assert row.pop(key) > 0
        assert got[label] == want[label]
    assert got['grounded_draft_4']['spec']['drafted'] > 0
    assert [r.output_tokens for r in results['grounded_draft_4']] == \
        [r.output_tokens for r in results['grounded_draft_0']]
