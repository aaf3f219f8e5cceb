"""LoRA on Mixtral (attention adapters over a frozen base: the router and
the experts included) through the port's Trainer, held against the JAX
Trainer's step (make_train_step(trainable=lora.is_lora_path)) on the CPU,
in f32, at mixtral-debug size with rank 4: three steps with every layer
checkpointed, with and without two-way gradient accumulation; the
adapters' init; and the adapter .npz of either package loaded by the
other."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import mixtral as jmix
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer as tt

# f32 on both sides, the same routing decisions: only summation order
# differs.
TOL_LOSS = 1e-4          # relative, loss and grad_norm
TOL_ADAPTERS = 1e-5      # absolute, adapters after three steps
TOL_LOGITS = 1e-5        # absolute, logits through the other's adapters
RANK = 4
CFG_KWARGS = dict(model='mixtral-debug', batch_size=4, seq_len=32,
                  learning_rate=1e-2, warmup_steps=1, total_steps=10)


def _configs():
    jcfg = dataclasses.replace(jax_model_config('mixtral-debug'),
                               dtype=jnp.float32, lora_rank=RANK)
    tcfg = dataclasses.replace(registry.get_model_config('mixtral-debug'),
                               dtype=torch.float32, lora_rank=RANK)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _random_params(jcfg, seed):
    """The flax tree's shapes, every leaf drawn with numpy (lora_b at 0.05,
    so the adapters' delta is not zero)."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        jmix.Mixtral(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(
            0, 0.05 if 'lora_b' in jax.tree_util.keystr(path) else 0.02,
            x.shape).astype(np.float32), shapes)


@pytest.mark.parametrize('accum', [1, 2], ids=['remat', 'accum2'])
def test_frozen_base_steps_match_the_jax_trainer(accum, tmp_path):
    """Three steps from the same params: the loss (the routers' aux term
    in it) and grad_norm each step within 1e-4 relative, the adapters
    within 1e-5 after the third, every base tensor -- the routers and the
    experts too -- bit-identical to where it started, optimizer state for
    the adapters alone.  Then each package's .npz of its trained adapters
    loads in the other: the same keys, and the other package's logits
    through them within 1e-5 of the writer's own."""
    jcfg, tcfg = _configs()
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(
        jcfg, jt.TrainConfig(**CFG_KWARGS, grad_accum_steps=accum), mesh,
        jax.random.PRNGKey(0))
    params = _random_params(jcfg, seed=8)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    sd = convert.state_dict_from_jax(params, tcfg)
    assert sum(lora.is_lora_path(k) for k in sd) == 2 * 4 * 2
    trainer = tt.Trainer(tt.TrainConfig(**CFG_KWARGS,
                                        grad_accum_steps=accum),
                         tcfg, device='cpu')
    trainer.setup(params=sd)
    state = trainer.state
    jstep = jt.make_train_step(mesh, trainable=jlora.is_lora_path,
                               grad_accum_steps=accum)
    step = tt.make_train_step(grad_accum_steps=accum)
    for i in range(3):
        tokens = np.random.default_rng(30 + i).integers(0, 256, (4, 33))
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(state, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)
        assert 0 < m['router_aux_loss'].item() < m['loss'].item()
    want = convert.state_dict_from_jax(_np_tree(jstate.params), tcfg)
    model = state.model
    for key, p in model.state_dict().items():
        if lora.is_lora_path(key):
            np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                       atol=TOL_ADAPTERS, err_msg=key)
            assert not torch.equal(p, sd[key]), key
        else:
            assert torch.equal(p, sd[key]), key
    names = {id(p): n for n, p in model.named_parameters()}
    assert state.optimizer.state and all(
        lora.is_lora_path(names[id(p)]) for p in state.optimizer.state)

    port_npz, jax_npz = tmp_path / 'port.npz', tmp_path / 'jax.npz'
    assert lora.save_adapter_npz(model, str(port_npz)) == 16
    assert jlora.save_adapter_npz(_np_tree(jstate.params),
                                  str(jax_npz)) == 16
    with np.load(port_npz) as p, np.load(jax_npz) as j:
        assert sorted(p.files) == sorted(j.files)
        assert 'layer_1/attn/o_proj_lora/lora_b' in p.files
    tokens = np.random.default_rng(40).integers(0, 256, (2, 12))
    with torch.no_grad():
        mine = model(torch.from_numpy(tokens)).numpy()
    flat = flax.traverse_util.flatten_dict(
        lora.load_adapter_npz(str(jax_npz)), sep='/')
    model.load_state_dict({lora.port_name(k): torch.from_numpy(v)
                           for k, v in flat.items()}, strict=False)
    jadapters = jlora.load_adapter_npz(str(port_npz))
    merged = flax.traverse_util.unflatten_dict({
        **flax.traverse_util.flatten_dict(params),
        **flax.traverse_util.flatten_dict(jadapters)})
    theirs = np.asarray(jmix.Mixtral(jcfg).apply(
        {'params': merged}, jnp.asarray(tokens)))
    np.testing.assert_allclose(theirs, mine, rtol=0, atol=TOL_LOGITS)
    with torch.no_grad():
        through_jax = model(torch.from_numpy(tokens)).numpy()
    jgot = np.asarray(jmix.Mixtral(jcfg).apply(
        {'params': _np_tree(jstate.params)}, jnp.asarray(tokens)))
    np.testing.assert_allclose(through_jax, jgot, rtol=0, atol=TOL_LOGITS)


def test_trainer_draws_adapters_over_the_seeded_base():
    """Trainer.setup with no params: the base a plain mixtral trainer
    draws from the seed, bit for bit, and adapters on q/k/v/o of every
    layer, A normal(0.02) and B zeros, the only trainable tensors."""
    _, tcfg = _configs()
    lora_trainer = tt.Trainer(tt.TrainConfig(model='mixtral-debug'), tcfg,
                              device='cpu')
    lora_trainer.setup(seed=3)
    plain = tt.Trainer(tt.TrainConfig(model='mixtral-debug'),
                       dataclasses.replace(tcfg, lora_rank=0), device='cpu')
    plain.setup(seed=3)
    base = plain.state.model.state_dict()
    model = lora_trainer.state.model
    adapters = {}
    for name, p in model.named_parameters():
        if lora.is_lora_path(name):
            assert p.requires_grad, name
            adapters[name] = p.detach()
        else:
            assert not p.requires_grad and torch.equal(p, base[name]), name
    assert len(adapters) == 16
    for name, p in adapters.items():
        if name.endswith('lora_b'):
            assert not p.any(), name
        else:
            assert abs(p.std().item() / 0.02 - 1) < 0.2, name
    assert lora.num_adapter_params(model) == 2 * RANK * (
        (64 + 64) + 2 * (64 + 32) + (64 + 64))
