"""The port's Llama (skypilot_tpu_torch.models) held against the flax Llama
of the JAX package: the same weights (carried across with
state_dict_from_jax) and the same numpy tokens give the same logits.
Everything on the CPU at *-debug size."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu_torch.models import convert, llama, registry

# f32 on both sides: only summation order differs.
TOL_F32 = 1e-4
# bf16: the two frameworks round activations at different places (XLA
# fuses elementwise chains in f32 before rounding, PyTorch rounds after
# each op), so the logits (|logit| <= ~1.3 here) drift by about one bf16
# ulp of the residual stream (3.1e-3 observed).
TOL_BF16 = 1e-2

ROPE_SCALING = dict(rope_scaling_factor=8.0, rope_scaling_low_freq=1.0,
                    rope_scaling_high_freq=4.0,
                    rope_scaling_original_max_len=32)

# name -> (registry config, overrides, seq len)
CASES = {
    'llama-debug': ('llama-debug', {}, 40),
    'gemma-debug': ('gemma-debug', {}, 40),
    'gemma-mqa-debug': ('gemma-mqa-debug', {}, 40),
    # gemma's own head_dim, the width the Hopper kernels took last
    'gemma-mqa-debug-head-dim-256': ('gemma-mqa-debug', {'head_dim': 256},
                                     40),
    'llama-debug-window48': ('llama-debug', {'sliding_window': 48}, 96),
    'llama-debug-attention-bias': ('llama-debug', {'attention_bias': True},
                                   40),
    'llama-debug-rope-llama3.1': ('llama-debug', ROPE_SCALING, 64),
    'llama-debug-untied': ('llama-debug', {'tie_embeddings': False}, 40),
}


def _configs(name, overrides, jax_dtype=jnp.float32,
             torch_dtype=torch.float32):
    jcfg = dataclasses.replace(jax_model_config(name), dtype=jax_dtype,
                               **overrides)
    tcfg = dataclasses.replace(registry.get_model_config(name),
                               dtype=torch_dtype, **overrides)
    return jcfg, tcfg


def _jax_params(jcfg, tokens, seed=0):
    """The flax param tree's structure and shapes (from an abstract init),
    every leaf drawn with numpy at std 0.02 -- norm scales and biases
    included, so they matter too.  Returns numpy params['params']."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.asarray(tokens)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, 0.02, x.shape).astype(np.float32), shapes)


def _jax_forward(jcfg, params, tokens, **kwargs):
    fn = jax.jit(lambda p, t: JaxLlama(jcfg).apply({'params': p}, t,
                                                   **kwargs))
    return np.asarray(fn(params, jnp.asarray(tokens)))


def _port(tcfg, params):
    model = llama.Llama(tcfg, device='cpu').eval()
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    return model


def _tokens(s, b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_logits_match_flax(case):
    name, overrides, s = CASES[case]
    jcfg, tcfg = _configs(name, overrides)
    tokens = _tokens(s)
    params = _jax_params(jcfg, tokens)
    ref = _jax_forward(jcfg, params, tokens)
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_F32)


def test_out_of_range_token_ids_map_as_the_flax_gather():
    """ROADMAP C1: ids outside [0, V) -- V, V + 7, -1, -V, -V - 1 -- give
    the flax model's logits (its jitted gather wraps a negative id once
    and clamps), instead of raising."""
    jcfg, tcfg = _configs('llama-debug', {})
    v = jcfg.vocab_size
    tokens = np.array([[v, v + 7, -1, 5, -v, -v - 1, 0, v - 1]])
    params = _jax_params(jcfg, np.zeros((1, 8), np.int64))
    ref = _jax_forward(jcfg, params, tokens)
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize('name', ['llama-debug', 'gemma-debug'])
def test_hidden_only_matches_flax(name):
    jcfg, tcfg = _configs(name, {})
    tokens = _tokens(24)
    params = _jax_params(jcfg, tokens)
    ref = _jax_forward(jcfg, params, tokens, hidden_only=True)
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(tokens), hidden_only=True)
    assert out.shape == (2, 24, tcfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_F32)


def test_bf16_logits_match_flax_within_rounding():
    jcfg, tcfg = _configs('llama-debug', {}, jnp.bfloat16, torch.bfloat16)
    tokens = _tokens(40)
    params = _jax_params(jcfg, tokens)
    ref = _jax_forward(jcfg, params, tokens)
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(tokens))
    assert out.dtype == torch.float32     # logits stay f32 in bf16 models
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_BF16)


@pytest.mark.parametrize('case', ['llama-debug', 'llama-debug-window48',
                                  'gemma-mqa-debug'])
def test_cache_path_matches_no_cache_forward(case):
    """Prefill 8 tokens into init_cache, then 4 single-token steps through
    write_kv_and_attend: the logits equal the no-cache forward's at the
    same positions."""
    name, overrides, _ = CASES[case]
    overrides = {**overrides, 'sliding_window': 6} \
        if 'sliding_window' in overrides else overrides
    jcfg, tcfg = _configs(name, overrides)
    tokens = _tokens(12)
    model = _port(tcfg, _jax_params(jcfg, tokens))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        full = model(t)
        cache = llama.init_cache(tcfg, 2, 16, torch.float32)
        pos = torch.arange(8).expand(2, 8)
        logits, cache = model(t[:, :8], pos, cache)
        outs = [logits]
        for i in range(8, 12):
            step, cache = model(t[:, i:i + 1], torch.full((2, 1), i), cache)
            outs.append(step)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=0, atol=TOL_F32)


def test_cache_write_clamps_past_the_end_like_jax():
    """A write whose positions run past the cache end lands on the last
    rows (JAX dynamic_update_slice clamping) instead of raising."""
    cache = (torch.zeros(1, 1, 4, 2), torch.zeros(1, 1, 4, 2))
    k = torch.ones(1, 1, 1, 2)
    q = torch.ones(1, 1, 1, 2)
    llama.write_kv_and_attend(cache, k, 2 * k, q, torch.tensor([[9]]))
    assert cache[0][0, 0, 3].tolist() == [1.0, 1.0]
    assert cache[1][0, 0, :3].abs().sum() == 0


@pytest.mark.parametrize('name', ['llama-debug', 'gemma-debug',
                                  'llama-1b', 'qwen2-7b'])
def test_state_dict_layout_matches_module(name):
    """Both weight paths produce exactly the module's keys and shapes
    (checked on the meta device: no memory for the large configs)."""
    cfg = registry.get_model_config(name)
    with torch.device('meta'):
        model = llama.Llama(cfg)
    expect = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if cfg.num_layers <= 2:
        jcfg = jax_model_config(name)
        params = _jax_params(jcfg, _tokens(8))
        got = convert.state_dict_from_jax(params, cfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == expect


def test_init_params_distributions():
    cfg = dataclasses.replace(registry.get_model_config('llama-debug'),
                              num_layers=8, attention_bias=True)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    model = llama.Llama(cfg, device='cpu')
    model.load_state_dict(sd)     # strict: same keys and shapes
    o_std = sd['layers.0.attn.o_proj.weight'].std().item()
    assert abs(o_std - 0.02 / 4) < 0.1 * 0.02 / 4
    assert abs(sd['embedding'].std().item() - 0.02) < 0.002
    assert sd['layers.3.input_norm.scale'].abs().sum() == 0
    assert sd['layers.3.attn.q_proj.bias'].abs().sum() == 0
    # Projections live in the compute dtype, norms/embedding in f32.
    assert model.layers[0].attn.q_proj.weight.dtype == cfg.dtype
    assert model.embedding.dtype == torch.float32
    assert model.layers[0].input_norm.scale.dtype == torch.float32


def test_unported_features_raise():
    """Every family of the JAX registry is ported: GPT-2 and Mixtral, and
    since the encoder and vision families too, give every config of the
    JAX registry's at its sizes; LoRA, ported since, builds, and at
    init (B = 0) gives the base model's logits; int8 weights, ported
    since, build and give the flax int8 model's logits over the JAX
    package's quantize_params of the same weights."""
    base = dataclasses.replace(registry.get_model_config('llama-debug'),
                               dtype=torch.float32)
    sd = convert.init_params(base, torch.Generator().manual_seed(0))
    lcfg = dataclasses.replace(base, lora_rank=4)
    adapted = llama.Llama(lcfg, device='cpu')
    adapted.load_state_dict({**convert.init_params(
        lcfg, torch.Generator().manual_seed(1)), **sd})
    plain = llama.Llama(base, device='cpu')
    plain.load_state_dict(sd)
    tokens = torch.arange(12)[None]
    with torch.no_grad():
        assert torch.equal(adapted(tokens), plain(tokens))
    from skypilot_tpu.models.quantize import quantize_params
    jcfg, _ = _configs('llama-debug', {'weight_dtype': 'int8'})
    jparams = quantize_params(_jax_params(
        dataclasses.replace(jcfg, weight_dtype='bf16'), tokens.numpy()))
    int8 = llama.Llama(dataclasses.replace(base, weight_dtype='int8'),
                       device='cpu')
    int8.load_state_dict(convert.state_dict_from_jax(jparams, int8.config))
    assert int8.layers[0].attn.q_proj.weight_q.dtype == torch.int8
    want = JaxLlama(jcfg).apply({'params': jparams}, jnp.asarray(tokens))
    with torch.no_grad():
        np.testing.assert_allclose(int8(tokens).numpy(), np.asarray(want),
                                   atol=TOL_F32)
    for name in ('bert-base', 'bert-debug', 'resnet50', 'resnet18-debug'):
        mine, ref = registry.get_model_config(name), jax_model_config(name)
        assert type(mine).__name__ == type(ref).__name__
        for f in dataclasses.fields(ref):
            if f.name != 'dtype':
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert str(mine.dtype)[6:] == ref.dtype.__name__
        assert not registry.is_causal_lm(mine)
    for name in ('gpt2', 'gpt2-medium', 'gpt2-large', 'gpt2-debug',
                 'mixtral-8x7b', 'mixtral-debug'):
        mine, ref = registry.get_model_config(name), jax_model_config(name)
        assert type(mine).__name__ == type(ref).__name__
        for f in dataclasses.fields(ref):
            if f.name != 'dtype':
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.num_params == ref.num_params
        assert registry.is_causal_lm(mine)
    with pytest.raises(ValueError, match='Unknown model'):
        registry.get_model_config('no-such-model')
