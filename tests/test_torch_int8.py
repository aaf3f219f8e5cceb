"""Int8 weights in the port (models/quantize.py, llama.QuantLinear, the
converter's kernel_q/scale leaves and the random int8 init) held against
the JAX package on the CPU, in f32: the quantized bytes against
``quantize_params`` followed by the converter; ``QuantLinear`` against
``QuantDenseGeneral`` at every projection's shape; the int8 engine's
greedy tokens against the JAX int8 engine's, dense and paged, with and
without an adapter on the int8 base, from quantized weights and from the
JAX package's random int8 init; the port's own random init; and what the
trainer does with int8 weights."""
import contextlib
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import (COMMON, JAX_CFG, PORT_CFG, WEIGHT_SCALE,
                           WindowAudit, make_params)
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models.llama import QuantDenseGeneral
from skypilot_tpu.models.quantize import quantize_params
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert, llama, quantize
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer as tt
from test_torch_lora_serving import LORA, PROMPTS, _tree

JAX_CFG8 = dataclasses.replace(JAX_CFG, weight_dtype='int8')
PORT_CFG8 = dataclasses.replace(PORT_CFG, weight_dtype='int8')
PAGED = dict(kv_block_size=8, auto_prefix_cache=True)
# f32 on both sides: the same products in another summation order.
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def qparams(params):
    return quantize_params(params)


@pytest.fixture(scope='module')
def jax_random_int8():
    """The JAX engine's own random int8 init, its scales times
    WEIGHT_SCALE (the helpers' weight scale: at the init's 0.02 a 2-layer
    model's logits are nearly flat)."""
    eng = JaxEngine(JAX_CFG8, JaxInferConfig(**COMMON,
                                             cache_dtype=jnp.float32),
                    rng=jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray,
                        flax.linen.meta.unbox(eng.params)['params'])
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * np.float32(WEIGHT_SCALE)
        if jax.tree_util.keystr(p).endswith("['scale']") and
        'norm' not in jax.tree_util.keystr(p) else x, tree)


def test_quantize_gives_the_jax_bytes(params):
    """quantize_state_dict over the converted f32 and bf16 weights (LoRA
    leaves beside them pass through) equals quantize_params followed by
    state_dict_from_jax: every int8 byte and every f32 scale."""
    cfg = dataclasses.replace(PORT_CFG, lora_rank=4, lora_alpha=8.0)
    full = dict(params)
    adapters = _tree(1)
    for name, layer in adapters.items():
        full[name] = {**params[name], 'attn': {
            **params[name]['attn'], **layer['attn']}}
    for dt in (np.float32, jnp.bfloat16):
        tree = jax.tree.map(lambda x: np.asarray(x.astype(dt)), full)
        want = convert.state_dict_from_jax(
            quantize_params(tree), dataclasses.replace(cfg,
                                                       weight_dtype='int8'))
        got = quantize.quantize_state_dict(
            {k: v.to(torch.bfloat16) if dt is jnp.bfloat16 else v
             for k, v in convert.state_dict_from_jax(tree, cfg).items()})
        assert got.keys() == want.keys()
        assert sum(k.endswith('weight_q') for k in got) == 14
        assert any(lora.is_lora_path(k) for k in got)
        for k, v in got.items():
            if k.endswith('weight_q'):
                assert v.dtype == want[k].dtype == torch.int8, k
            if k.endswith('_proj.scale'):
                assert v.dtype == want[k].dtype == torch.float32, k
            assert torch.equal(v.float(), want[k].float()), k


@pytest.mark.parametrize('proj', ['q_proj', 'k_proj', 'o_proj', 'up_proj',
                                  'down_proj'])
def test_quant_linear_matches_quant_dense_general(proj):
    """QuantLinear against QuantDenseGeneral at each projection's flax
    shape (q/k with a bias, o_proj contracting two dims), the int8 kernel
    and scales drawn with numpy and carried by the converter, to 1e-6."""
    h, heads, d, f = 64, 4, 16, 128
    feats, axis, n_in, n_out = {
        'q_proj': ((heads, d), -1, h, heads * d),
        'k_proj': ((2, d), -1, h, 2 * d),
        'o_proj': (h, (-2, -1), heads * d, h),
        'up_proj': (f, -1, h, f),
        'down_proj': (h, -1, f, h)}[proj]
    bias = proj in ('q_proj', 'k_proj')
    mod = QuantDenseGeneral(features=feats, axis=axis, use_bias=bias,
                            dtype=jnp.float32)
    rng = np.random.default_rng(len(proj))
    x_shape = (2, 5) + ((heads, d) if proj == 'o_proj' else (n_in,))
    x = rng.standard_normal(x_shape).astype(np.float32)
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        mod.init, jax.random.PRNGKey(0), jnp.asarray(x)))['params']
    p = {'kernel_q': rng.integers(-127, 128, shapes['kernel_q'].shape
                                  ).astype(np.int8),
         'scale': rng.uniform(1e-3, 1e-2, shapes['scale'].shape
                              ).astype(np.float32)}
    if bias:
        p['bias'] = rng.standard_normal(shapes['bias'].shape).astype(
            np.float32)
    want = np.asarray(mod.apply({'params': p}, jnp.asarray(x)))
    lin = llama.QuantLinear(n_in, n_out, bias, torch.float32, torch.float32)
    layout = {'o_proj': lambda k: k.reshape(-1, h).T,
              'up_proj': lambda k: k.T, 'down_proj': lambda k: k.T}.get(
        proj, lambda k: k.reshape(h, -1).T)
    lin.weight_q.copy_(layout(torch.from_numpy(p['kernel_q'])))
    lin.scale.copy_(torch.from_numpy(p['scale']).reshape(-1))
    if bias:
        with torch.no_grad():
            lin.bias.copy_(torch.from_numpy(p['bias']).reshape(-1))
    with torch.no_grad():
        got = lin(torch.from_numpy(x).reshape(2, 5, n_in)).numpy()
    np.testing.assert_allclose(got, want.reshape(2, 5, n_out), **TOL)


def _engines(tree, tmp_path=None, **kw):
    """The JAX and the port int8 engines over the same flax int8 tree,
    with adapters 'a' and 'b' registered when LoRA is on."""
    je = JaxEngine(JAX_CFG8, JaxInferConfig(**{**COMMON, **kw},
                                            cache_dtype=jnp.float32),
                   params={'params': tree}, rng=jax.random.PRNGKey(7))
    pe = port.InferenceEngine(
        PORT_CFG8, port.InferConfig(**{**COMMON, **kw},
                                    cache_dtype=torch.float32),
        params=convert.state_dict_from_jax(tree, PORT_CFG8),
        generator=torch.Generator().manual_seed(0), device='cpu')
    if kw.get('lora_rank'):
        for i, name in enumerate(('a', 'b')):
            path = str(tmp_path / f'{name}.npz')
            jlora.save_adapter_npz(_tree(i + 1), path)
            assert je.register_adapter(name, jlora.load_adapter_npz(
                path)) == i
            assert pe.register_adapter(name, lora.load_adapter_npz(
                path)) == i
    return je, pe


@pytest.mark.parametrize('weights,layout,adapters', [
    ('quantized', 'dense', False), ('quantized', 'paged', True),
    ('random_init', 'dense', True)])
def test_int8_engine_tokens_match_jax(qparams, jax_random_int8, tmp_path,
                                      weights, layout, adapters):
    """Greedy tokens, finish reasons and logprobs of the int8 engine equal
    the JAX int8 engine's over the same weights -- base rows and rows of
    two adapters in one batch when LoRA is on -- dense and paged, from
    quantized weights and from the JAX package's random int8 init; the
    paged pool stays conserved after every window."""
    tree = qparams if weights == 'quantized' else jax_random_int8
    kw = {**(PAGED if layout == 'paged' else {}),
          **(LORA if adapters else {})}
    je, pe = _engines(tree, tmp_path, **kw)

    def reqs(cls):       # one prefill bucket (16) keeps the JAX compiles few
        if adapters:      # three rows over the same prompt
            return [cls(tokens=list(PROMPTS[0]), max_new_tokens=8,
                        adapter=a) for a in (None, 'a', 'b')]
        return [cls(tokens=list(PROMPTS[i]), max_new_tokens=8)
                for i in (0, 3)]

    want = je.generate(reqs(JaxRequest))
    with (WindowAudit(pe) if layout == 'paged' else
          contextlib.nullcontext()) as audit:
        got = pe.generate(reqs(port.Request))
    assert audit is None or (audit.windows > 0 and audit.errors == [])
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4,
                                   atol=1e-5)
    if adapters:
        assert got[0].output_tokens != got[1].output_tokens


def test_random_int8_init_draws_as_the_reference():
    """iter_params with weight_dtype int8: every projection's weight_q int8
    within +-127 with the reference's spread (normal * std / scale0, so a
    standard deviation of 127/4 in int8 steps), and every channel's scale
    4 * std / 127 (std 0.02; o_proj's depth-scaled); norms zero, the
    embedding f32; a model built from it runs."""
    cfg = dataclasses.replace(PORT_CFG8, num_layers=2)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    o_std = 0.02 / (2 * cfg.num_layers) ** 0.5
    n_q = 0
    for k, v in sd.items():
        if k.endswith('weight_q'):
            n_q += 1
            assert v.dtype == torch.int8 and int(v.abs().max()) <= 127
            # Within 5 standard errors of the normal draw's spread.
            assert abs(float(v.float().std()) - 127 / 4) < \
                5 * (127 / 4) / (2 * v.numel()) ** 0.5, k
            std = o_std if 'o_proj' in k else 0.02
            scale = sd[k[:-len('weight_q')] + 'scale']
            assert scale.dtype == torch.float32
            assert torch.equal(scale, torch.full_like(
                scale, 4.0 * std / 127.0))
        assert not k.endswith('.weight') or 'proj' not in k, k
    assert n_q == 7 * cfg.num_layers
    model = llama.Llama(cfg, device='cpu')
    model.load_state_dict(sd)
    with torch.no_grad():
        assert torch.isfinite(model(torch.arange(10)[None])).all()


def test_trainer_with_int8_weights_does_what_the_jax_trainer_does(
        qparams):
    """A full train step over int8 weights fails with a TypeError in both
    packages (jax.grad refuses an int8 leaf: int8 is a serving path);
    LoRA adapters on the int8 base train in both, with the same first
    step's loss and grad_norm (JAX's on a one-device mesh)."""
    tc = dict(model='serve-test', batch_size=2, seq_len=16,
              learning_rate=1e-2, warmup_steps=1, total_steps=10)
    tokens = np.random.default_rng(0).integers(0, JAX_CFG.vocab_size,
                                               (2, 17))
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(JAX_CFG8, jt.TrainConfig(**tc),
                                        mesh, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match='int8'), mesh:
        jt.make_train_step(mesh)(jstate, {'tokens': jnp.asarray(tokens)})
    trainer = tt.Trainer(tt.TrainConfig(**tc), PORT_CFG8, device='cpu')
    trainer.setup(params=convert.state_dict_from_jax(qparams, PORT_CFG8))
    with pytest.raises(TypeError, match='int8'):
        trainer._step_fn(trainer.state, {'tokens': torch.from_numpy(tokens)})

    jcfg = dataclasses.replace(JAX_CFG8, lora_rank=4, lora_alpha=8.0)
    pcfg = dataclasses.replace(PORT_CFG8, lora_rank=4, lora_alpha=8.0)
    jstate, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**tc), mesh,
                                        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate.params)
    trainer = tt.Trainer(tt.TrainConfig(**tc), pcfg, device='cpu')
    trainer.setup(params=convert.state_dict_from_jax(tree, pcfg))
    with mesh:
        _, jm = jt.make_train_step(mesh, trainable=jlora.is_lora_path)(
            jstate, {'tokens': jnp.asarray(tokens)})
    m = trainer._step_fn(trainer.state, {'tokens': torch.from_numpy(tokens)})
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5)
    assert float(jm['grad_norm']) > 0
