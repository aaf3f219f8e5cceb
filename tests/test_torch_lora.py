"""The port's LoRA (skypilot_tpu_torch.train.lora, the adapters in
models/llama.py, the converter and the frozen-base trainer) held against
the JAX package's (skypilot_tpu/train/lora.py): the adapter module in both
forms at every target's shapes, the weights carried across both ways,
the .npz written by either package loaded by the other, the adapter
count, and three frozen-base train steps against JAX
make_train_step(trainable=lora.is_lora_path).  All on the CPU, in f32, at
llama-debug size."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, llama, registry
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer as tt

# f32 on both sides; only summation order differs.
TOL_MODULE = 1e-6        # absolute, the adapter's output
TOL_LOGITS = 1e-5        # absolute, a 2-layer forward's logits
TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, adapter params after three steps
ALL_TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj', 'gate_proj',
               'up_proj', 'down_proj')

# llama-debug's projections: (input feature dims, output feature dims);
# o_proj contracts (heads, head_dim), as the flax module does.
SHAPES = {'q_proj': ((64,), (4, 16)), 'k_proj': ((64,), (2, 16)),
          'v_proj': ((64,), (2, 16)), 'o_proj': ((4, 16), (64,)),
          'gate_proj': ((64,), (128,)), 'up_proj': ((64,), (128,)),
          'down_proj': ((128,), (64,))}


def _configs(**overrides):
    jcfg = dataclasses.replace(jax_model_config('llama-debug'),
                               dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(registry.get_model_config('llama-debug'),
                               dtype=torch.float32, **overrides)
    return jcfg, tcfg


def _random_params(jcfg, seed=0, std=0.02, b_std=0.05):
    """The flax tree's shapes, every leaf drawn with numpy (lora_b too, so
    the adapters' delta is not zero)."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32),
        **({'adapter_ids': jnp.zeros((1,), jnp.int32)}
           if jcfg.lora_num_adapters else {})))['params']
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(
            0, b_std if 'lora_b' in jax.tree_util.keystr(path) else std,
            x.shape).astype(np.float32), shapes)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


@pytest.mark.parametrize('stacked', [False, True], ids=['single', 'stacked'])
@pytest.mark.parametrize('target', ALL_TARGETS)
def test_adapter_matches_flax_module(target, stacked):
    """LoRAAdapter against the flax module at the target's shapes: equal
    within 1e-6 with random A and B (stacked: ids with -1 among them, a
    base row), and exactly zero at init (B = 0) on both.  A and B at std
    0.1 give outputs of order 0.3, where f32 summation order moves a few
    ulps (~1e-7)."""
    fin, fout = SHAPES[target]
    n = 3 if stacked else 0
    rank, alpha = 4, 8.0
    in_dim, out_dim = int(np.prod(fin)), int(np.prod(fout))
    rng = np.random.default_rng(len(target) + n)
    stack = (n,) if n else ()
    a = rng.normal(0, 0.1, stack + (in_dim, rank)).astype(np.float32)
    b = rng.normal(0, 0.1, stack + (rank, out_dim)).astype(np.float32)
    x = rng.standard_normal((4, 5) + fin).astype(np.float32)
    ids = np.array([2, -1, 0, 1], np.int32)
    mod = jlora.LoRAAdapter(features=fout, rank=rank, alpha=alpha,
                            num_contract_dims=len(fin), dtype=jnp.float32,
                            num_adapters=n)
    ours = lora.LoRAAdapter(in_dim, out_dim, rank, alpha, torch.float32, n)
    xt = torch.from_numpy(x.reshape(4, 5, in_dim))
    kw = {'adapter_ids': jnp.asarray(ids)} if n else {}
    tkw = {'adapter_ids': torch.from_numpy(ids).long()} if n else {}
    for bb in (b, np.zeros_like(b)):
        want = np.asarray(mod.apply({'params': {'lora_a': a, 'lora_b': bb}},
                                    jnp.asarray(x), **kw))
        with torch.no_grad():
            ours.lora_a.copy_(torch.from_numpy(a))
            ours.lora_b.copy_(torch.from_numpy(bb))
            got = ours(xt, **tkw).numpy().reshape(want.shape)
        if bb is b:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_MODULE)
        else:
            assert not got.any() and not want.any()
    if n:
        assert not got[1].any()          # id -1: the base model


def test_adapter_init_and_base_rows_are_masked():
    """The init draws A ~ N(0, 0.02) and B = 0 from the generator; a base
    row (id -1) gets an exact zero delta even when slot 0, where -1
    would gather from, holds inf (C4: the flax module gives NaN)."""
    ad = lora.LoRAAdapter(64, 32, 4, 16.0, torch.float32, num_adapters=2)
    a, b = lora.adapter_init((2, 64, 4), (2, 4, 32),
                             torch.Generator().manual_seed(0))
    assert abs(a.std().item() - 0.02) < 0.004 and not b.any()
    with torch.no_grad():
        ad.lora_a.copy_(a)
        ad.lora_b.copy_(b)
        ad.lora_a[0].fill_(float('inf'))
        ad.lora_b[0].fill_(float('inf'))
        ad.lora_b[1].normal_()
        out = ad(torch.ones(3, 2, 64), torch.tensor([-1, 0, 1]))
    assert torch.equal(out[0], torch.zeros(2, 32))
    assert not torch.isfinite(out[1]).any() and torch.isfinite(out[2]).all()
    mod = jlora.LoRAAdapter(features=(32,), rank=4, alpha=16.0,
                            dtype=jnp.float32, num_adapters=2)
    want = np.asarray(mod.apply(
        {'params': {'lora_a': ad.lora_a.detach().numpy(),
                    'lora_b': ad.lora_b.detach().numpy()}},
        jnp.ones((3, 2, 64)), jnp.asarray([-1, 0, 1])))
    assert np.isnan(want[0]).all()


@pytest.mark.parametrize('stacked', [False, True], ids=['single', 'stacked'])
def test_converter_both_ways(stacked):
    """A LoRA model's flax params (adapters on every target, random B)
    through state_dict_from_jax give the flax logits within 1e-5 --
    stacked with per-row ids, -1 included, on the no-cache and the
    cached paths -- and extract_adapter_tree gives back the flax
    adapter tree exactly."""
    n = 3 if stacked else 0
    jcfg, tcfg = _configs(lora_rank=4, lora_alpha=8.0,
                          lora_targets=ALL_TARGETS, lora_num_adapters=n)
    params = _random_params(jcfg, seed=4)
    model = llama.Llama(tcfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    tokens = np.random.default_rng(5).integers(0, 256, (3, 12))
    ids = np.array([1, -1, 2], np.int32)
    kw = {'adapter_ids': jnp.asarray(ids)} if n else {}
    tkw = {'adapter_ids': torch.from_numpy(ids).long()} if n else {}
    want = np.asarray(JaxLlama(jcfg).apply({'params': params},
                                           jnp.asarray(tokens), **kw))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), **tkw).numpy()
        cache = llama.init_cache(tcfg, 3, 16, torch.float32)
        pos = torch.arange(12).expand(3, 12)
        cached, _ = model(torch.from_numpy(tokens), pos, cache, **tkw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS)
    np.testing.assert_allclose(cached.numpy(), want, rtol=0, atol=TOL_LOGITS)
    mine = lora.extract_adapter_tree(model)
    theirs = jlora.extract_adapter_tree(params)
    flat_m = flax.traverse_util.flatten_dict(mine, sep='/')
    flat_t = flax.traverse_util.flatten_dict(theirs, sep='/')
    assert flat_m.keys() == flat_t.keys()
    for key, val in flat_t.items():
        assert np.array_equal(flat_m[key], np.asarray(val)), key
    if stacked:
        assert flat_m['layer_1/mlp/down_proj_lora/lora_b'].shape == (3, 4,
                                                                     64)


def test_npz_interchange(tmp_path):
    """A port-written .npz loads in the JAX package and a JAX-written one
    in the port: the same keys, the same f32 bytes; the JAX file written
    with the {'params': ...} wrapper keeps it on both sides."""
    jcfg, tcfg = _configs(lora_rank=4, lora_targets=ALL_TARGETS)
    params = _random_params(jcfg, seed=6)
    model = llama.Llama(tcfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    port_path, jax_path = tmp_path / 'port.npz', tmp_path / 'jax.npz'
    assert lora.save_adapter_npz(model, str(port_path)) == 28
    assert jlora.save_adapter_npz(params, str(jax_path)) == 28
    with np.load(port_path) as p, np.load(jax_path) as j:
        assert sorted(p.files) == sorted(j.files)
        assert 'layer_0/attn/q_proj_lora/lora_a' in p.files
        for key in j.files:
            assert p[key].dtype == j[key].dtype == np.float32
            assert p[key].tobytes() == j[key].tobytes(), key
    for mine, theirs in ((lora.load_adapter_npz(str(jax_path)),
                          jlora.load_adapter_npz(str(port_path))),):
        fm = flax.traverse_util.flatten_dict(mine, sep='/')
        ft = flax.traverse_util.flatten_dict(theirs, sep='/')
        assert fm.keys() == ft.keys()
        for key in fm:
            assert np.array_equal(fm[key], ft[key]), key
    wrapped = tmp_path / 'wrapped.npz'
    jlora.save_adapter_npz({'params': params}, str(wrapped))
    assert set(lora.load_adapter_npz(str(wrapped))) == {'params'}
    with pytest.raises(ValueError, match='no \\*_lora leaves'):
        lora.save_adapter_npz({'embedding': np.zeros(3)}, str(wrapped))


def test_merge_base_params_grafts_a_base_state():
    """merge_base_params: every base entry replaces its counterpart in
    the LoRA state's dtype, the adapters keep their init, and a base
    entry the LoRA model lacks is a KeyError (the flax function's)."""
    _, tcfg = _configs(lora_rank=4)
    base_cfg = dataclasses.replace(tcfg, lora_rank=0)
    full = convert.init_params(tcfg, torch.Generator().manual_seed(0))
    base = {k: v.double() for k, v in convert.init_params(
        base_cfg, torch.Generator().manual_seed(1)).items()}
    merged = lora.merge_base_params(full, base)
    assert merged.keys() == full.keys()
    for k, v in merged.items():
        assert v.dtype == full[k].dtype
        want = full[k] if lora.is_lora_path(k) else base[k].float()
        assert torch.equal(v, want), k
    with pytest.raises(KeyError, match='missing from the LoRA model'):
        lora.merge_base_params(full, {'nope': torch.zeros(1)})


def test_num_adapter_params():
    """The count matches the JAX package's on llama-debug with every
    target; llama-1b at rank 16 on q/k/v/o holds
    22 x (65,536 + 49,152 + 49,152 + 65,536) = 5,046,272 (a meta-device
    model: no memory)."""
    jcfg, tcfg = _configs(lora_rank=4, lora_targets=ALL_TARGETS)
    params = _random_params(jcfg)
    model = llama.Llama(tcfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    # Per layer, rank 4: q and o 4 x (64 + 64), k and v 4 x (64 + 32),
    # gate, up and down 4 x (64 + 128); two layers.
    assert lora.num_adapter_params(model) == \
        jlora.num_adapter_params(params) == \
        2 * 4 * (2 * 128 + 2 * 96 + 3 * 192) == 8192
    big = dataclasses.replace(registry.get_model_config('llama-1b'),
                              lora_rank=16)
    assert lora.num_adapter_params(llama.Llama(big, device='meta')) == \
        5_046_272
    assert lora.is_lora_path('layers.3.attn.q_proj_lora.lora_a')
    assert lora.is_lora_path(('layer_3', 'attn', 'q_proj_lora', 'lora_b'))
    assert not lora.is_lora_path('layers.3.attn.q_proj.weight')


# Frozen-base training cases: (config overrides, make_train_step kwargs).
# The MLP targets are held by the module and converter tests above.
TRAIN_CASES = {
    'qkvo': ({}, {}),
    'qkvo-accum2': ({}, {'grad_accum_steps': 2}),
    'q-only': ({'lora_targets': ('q_proj',)}, {}),
    'o-only-full-logits': ({'lora_targets': ('o_proj',)},
                           {'loss_chunk': None}),
}


@pytest.mark.parametrize('case', list(TRAIN_CASES))
def test_frozen_base_train_steps_match_jax(case):
    """Three frozen-base steps against JAX make_train_step(trainable=
    lora.is_lora_path) with make_optimizer(cfg, model_config) (the
    multi_transform that zeroes the base), from the same params (random
    B): loss and grad_norm within 1e-5 relative each step, the adapters
    within 1e-6 after the third, the base bit-identical to where it
    started, and optimizer state for the adapters alone."""
    overrides, step_kw = TRAIN_CASES[case]
    jcfg, tcfg = _configs(lora_rank=4, lora_alpha=8.0, **overrides)
    cfg_kwargs = dict(model='llama-debug', batch_size=4, seq_len=32,
                      learning_rate=1e-2, warmup_steps=1, total_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**cfg_kwargs),
                                        mesh, jax.random.PRNGKey(0))
    params = _random_params(jcfg, seed=8)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    sd = convert.state_dict_from_jax(params, tcfg)
    trainer = tt.Trainer(tt.TrainConfig(**cfg_kwargs,
                                        **{k: v for k, v in step_kw.items()
                                           if k == 'grad_accum_steps'}),
                         tcfg, device='cpu')
    trainer.setup(params=sd)
    state = trainer.state
    jstep = jt.make_train_step(mesh, trainable=jlora.is_lora_path,
                               **step_kw)
    step = tt.make_train_step(**step_kw)
    for i in range(3):
        tokens = np.random.default_rng(20 + i).integers(0, 256, (4, 33))
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(state, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)
    want = convert.state_dict_from_jax(_np_tree(jstate.params), tcfg)
    moved = 0
    for key, p in state.model.state_dict().items():
        if lora.is_lora_path(key):
            np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                       atol=TOL_PARAMS, err_msg=key)
            moved += not torch.equal(p, sd[key])
        else:
            assert torch.equal(p, sd[key]), key
    assert moved > 0
    held = [p for p in state.optimizer.state]
    names = {id(p): n for n, p in state.model.named_parameters()}
    assert held and all(lora.is_lora_path(names[id(p)]) for p in held)
    moments = sum(v.numel() for st in state.optimizer.state.values()
                  for k, v in st.items() if k != 'step')
    assert moments == 2 * lora.num_adapter_params(state.model)


@pytest.mark.parametrize('needs', ['q', 'kv'])
def test_flash_backward_with_frozen_inputs(needs):
    """FlashAttentionFunction's backward always returns dq, dk and dv; with
    only q (or only k and v) requiring grad -- a frozen base whose
    adapters target q_proj alone, or k/v alone -- the gradients that
    are asked for equal the plain attention's (the Function's CPU path
    runs the kernels' plain versions)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16)))
    grads = []
    for fn in (lambda a, b, c: fa.FlashAttentionFunction.apply(
                   a, b, c, True, 0.25, None),
               lambda a, b, c: fa.reference_attention(a, b, c, causal=True,
                                                      scale=0.25)):
        a, b, c = (t.clone().requires_grad_(
            (needs == 'q') == (i == 0)) for i, t in enumerate((q, k, v)))
        (fn(a, b, c) ** 2).sum().backward()
        grads.append([t.grad for t in (a, b, c)])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_lora_checkpoint_resume(tmp_path):
    """A LoRA trainer checkpointed after 2 steps and resumed for 2 more
    ends where 4 straight steps end: adapters, base and optimizer."""
    _, tcfg = _configs(lora_rank=4)

    def trainer(ckpt=None):
        cfg = tt.TrainConfig(model='llama-debug', batch_size=2, seq_len=16,
                             learning_rate=1e-2, warmup_steps=1,
                             total_steps=10, loss_chunk=8,
                             checkpoint_dir=ckpt, checkpoint_every=2)
        t = tt.Trainer(cfg, tcfg, device='cpu')
        t.setup(seed=0)
        return t

    batches = [{'tokens': torch.from_numpy(np.random.default_rng(i).integers(
        0, 256, (2, 17)))} for i in range(4)]
    straight = trainer()
    straight.train(iter(batches), num_steps=4)
    first = trainer(str(tmp_path))
    first.train(iter(batches[:2]), num_steps=2)
    resumed = trainer(str(tmp_path))
    assert resumed.state.step == 2
    resumed.train(iter(batches[2:]), num_steps=2)
    want = straight.state.model.state_dict()
    for name, p in resumed.state.model.state_dict().items():
        assert torch.equal(p, want[name]), name
    # Two layers x q/k/v/o x (A, B): the adapters' tensors alone.
    assert len(resumed.state.optimizer.state) == \
        len(straight.state.optimizer.state) == 16
