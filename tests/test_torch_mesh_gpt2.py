"""GPT-2 training under 'tensor' in the port (the fused c_attn split by
heads within each of q, k and v, c_fc column-parallel, both c_proj
row-parallel) held against the JAX package on the CPU, in f32: three
steps of ``Trainer`` over 2 and 4 gloo ranks at tensor=2 and fsdp=2 x
tensor=2 against JAX create_sharded_state + make_train_step on a mesh of
the same shape from jax.devices()[:n]; a resume from tensor=2 to fsdp=2,
and the tensor=2 checkpoint restored with no mesh; and each rank's
c_attn rows against the JAX kernel's shard on 'heads'."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.train import trainer as tt

TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, params after 3 AdamW steps
MODEL = 'gpt2-debug'
TRAIN = dict(batch_size=8, seq_len=32, learning_rate=3e-4, warmup_steps=2,
             total_steps=10)
C_ATTN = ('h.0.attn.c_attn.weight', 'h.0.attn.c_attn.bias')
# (name, ranks, mesh, resume mesh for step 3); the resume leg is held
# against the tensor=2 leg.
LEGS = [
    ('gpt2-tensor2', 2, dict(tensor=2), None),
    ('gpt2-fsdp2-tensor2', 4, dict(fsdp=2, tensor=2), None),
    ('gpt2-resume-tensor2-to-fsdp2', 2, dict(tensor=2), dict(fsdp=2)),
]
JAX_CFG = dataclasses.replace(jax_model_config(MODEL), dtype=jnp.float32)
PORT_CFG = dataclasses.replace(registry.get_model_config(MODEL),
                               dtype=torch.float32)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _jax_leg(spec, batches, n):
    """Three JAX steps on a mesh of `spec` over jax.devices()[:n]: each
    step's loss and grad_norm, the final params, and each device's shard
    of layer 0's c_attn kernel, in the mesh's device order."""
    mesh = jm.make_mesh(jm.MeshSpec(**spec), devices=jax.devices()[:n])
    state, _ = jt.create_sharded_state(JAX_CFG, jt.TrainConfig(**TRAIN),
                                       mesh, jax.random.PRNGKey(0))
    kernel = state.params['h_0']['attn']['c_attn']['kernel']
    shards = [np.asarray(next(s.data for s in kernel.addressable_shards
                              if s.device == d))
              for d in np.asarray(mesh.devices).flat]
    step = jt.make_train_step(mesh)
    losses, norms = [], []
    with mesh:
        for tokens in batches:
            state, m = step(state, {'tokens': jnp.asarray(tokens)})
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
    return losses, norms, _np_tree(state.params), shards


@pytest.fixture(scope='module')
def legs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh_gpt2')
    mesh = jm.make_mesh(jm.MeshSpec(), devices=jax.devices()[:1])
    state, _ = jt.create_sharded_state(JAX_CFG, jt.TrainConfig(**TRAIN),
                                       mesh, jax.random.PRNGKey(0))
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        _np_tree(state.params), PORT_CFG).items()}
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (TRAIN['batch_size'],
                                     TRAIN['seq_len'] + 1))
               for _ in range(3)]
    workers = {}
    for world in (2, 4):
        port_legs = [hd.TrainLeg(
            name=name, mesh=spec, model=MODEL, overrides={},
            train=dict(TRAIN), params=sd, batches=batches,
            ckpt=str(tmp / name) if resume else '',
            resume_at=2 if resume else 0, resume_mesh=resume,
            local_names=C_ATTN if name == 'gpt2-tensor2' else ())
            for name, n, spec, resume in LEGS if n == world]
        workers[world] = (port_legs, hd.Workers(hd.trainer_legs, world, tmp,
                                                port_legs))
    want = {name: _jax_leg(spec, batches, n)
            for name, n, spec, resume in LEGS if resume is None}
    got = {}
    for world, (port_legs, w) in workers.items():
        ranks = w.join()
        for i, leg in enumerate(port_legs):
            got[leg.name] = {**ranks[0][i],
                             'loads': [r[i]['loads'] for r in ranks],
                             'local': [r[i]['local'] for r in ranks]}
    return got, want, sd, batches, tmp


@pytest.mark.parametrize('name', [leg[0] for leg in LEGS])
def test_gpt2_on_a_tensor_mesh_matches_jax(legs, name):
    """Loss and grad_norm of each of 3 steps within 1e-5 relative and every
    parameter within 1e-6 after them, against the JAX step on a mesh of
    the same shape; the resume leg's third step ran on fsdp=2 from the
    tensor=2 checkpoint, which rank 0 alone read."""
    got, want, *_ = legs
    g = got[name]
    jl, jn, jp, _ = want['gpt2-tensor2' if 'resume' in name else name]
    np.testing.assert_allclose(g['loss'], jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['grad_norm'], jn, rtol=TOL_LOSS)
    ref = convert.state_dict_from_jax(jp, PORT_CFG)
    assert g['params'].keys() == ref.keys()
    for key, p in g['params'].items():
        np.testing.assert_allclose(p, ref[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)
    if 'resume' in name:
        assert g['loads'] == [1, 0]


def test_c_attn_rows_are_the_jax_heads_shard(legs):
    """At tensor=2 each rank's c_attn weight rows are the JAX kernel's
    shard on 'heads' on the device of the same tensor coordinate (its
    heads of q, of k and of v), and its bias rows the same heads of the
    full bias."""
    got, want, sd, *_ = legs
    shards = want['gpt2-tensor2'][3]
    heads = JAX_CFG.num_heads // 2
    for rank, local in enumerate(got['gpt2-tensor2']['local']):
        kernel = shards[rank]                         # [embed, 3, H/2, D]
        assert kernel.shape[2] == heads
        np.testing.assert_array_equal(
            local[C_ATTN[0]], kernel.reshape(kernel.shape[0], -1).T)
        bias = sd[C_ATTN[1]].reshape(3, JAX_CFG.num_heads, -1)
        np.testing.assert_array_equal(
            local[C_ATTN[1]],
            bias[:, rank * heads:(rank + 1) * heads].reshape(-1))


def test_tensor2_checkpoint_restores_with_no_mesh(legs, tmp_path):
    """The checkpoint the tensor=2 trainer wrote after step 2 (the full
    state in the no-mesh layout) restores into a single-device trainer,
    whose step 3 gives the JAX tensor=2 step 3's loss and parameters."""
    got, want, sd, batches, tmp = legs
    src = os.path.join(tmp, 'gpt2-resume-tensor2-to-fsdp2', 'step_00000002')
    shutil.copytree(src, tmp_path / 'step_00000002')
    tr = tt.Trainer(tt.TrainConfig(model=MODEL, **TRAIN,
                                   checkpoint_dir=str(tmp_path)),
                    PORT_CFG, device='cpu')
    tr.setup(params={k: torch.from_numpy(v) for k, v in sd.items()})
    assert tr.state.step == 2
    m = tr._step_fn(tr.state, {'tokens': torch.from_numpy(batches[2])})
    jl, _, jp, _ = want['gpt2-tensor2']
    np.testing.assert_allclose(float(m['loss']), jl[2], rtol=TOL_LOSS)
    ref = convert.state_dict_from_jax(jp, PORT_CFG)
    for key, p in tr.state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)
