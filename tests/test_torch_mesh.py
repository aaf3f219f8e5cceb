"""The port's mesh (skypilot_tpu_torch/parallel/mesh.py) and its trainer
on a mesh, held against the JAX package on the CPU, in f32: MeshSpec,
the rules table and its resolution, the env reading; then the trainer
over 2 and 4 gloo ranks at fsdp=2, data=2 x fsdp=2 (grad accumulation
2), fsdp=2 x tensor=2 and data=2 x tensor=2 (accumulation 2) against JAX
create_sharded_state + make_train_step on a mesh of the same shape from
jax.devices()[:n], over 3 steps; Mixtral at data=2 x fsdp=2 (the routing
of the global token group) and fsdp=2 x tensor=2 (expert parallelism),
at a capacity that drops pairs; and a resume across two mesh shapes in
which rank 0 alone reads the checkpoint."""
import dataclasses

import flax.linen as nn
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
from skypilot_tpu_torch.parallel import mesh as tm

TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, params after 3 AdamW steps
MODEL = 'llama-debug'
TRAIN = dict(batch_size=8, seq_len=32, learning_rate=3e-4, warmup_steps=2,
             total_steps=10)


def test_mesh_spec_and_rules_match_jax():
    """MeshSpec's fields, shape order, device count and constructors; the
    axes; the rules with overrides prepended; and each parameter's
    logical axes resolved as flax resolves them."""
    assert tm.MESH_AXES == jm.MESH_AXES
    for kw in ({}, dict(data=2, fsdp=3, seq=5, tensor=7, stage=11)):
        mine, theirs = tm.MeshSpec(**kw), jm.MeshSpec(**kw)
        assert mine.shape == theirs.shape
        assert mine.num_devices == theirs.num_devices
    assert tm.MeshSpec.auto(8).shape == jm.MeshSpec.auto(8).shape
    assert tm.MeshSpec.fsdp_only(4).shape == jm.MeshSpec.fsdp_only(4).shape
    extra = [('heads', None)]
    assert tm.logical_axis_rules() == jm.logical_axis_rules()
    assert tm.logical_axis_rules(extra) == jm.logical_axis_rules(extra)
    tried = [axes for _, axes in tm._PARAM_AXES] + [
        ('batch', None), ('activation_batch', 'activation_seq',
                          'activation_embed'), ('norm',), (None, None)]
    for axes in tried:
        want = nn.logical_to_mesh_axes(axes, jm.logical_axis_rules())
        got = tm.resolve_axes(axes)
        want = tuple(() if w is None else
                     ((w,) if isinstance(w, str) else tuple(w))
                     for w in want)
        assert got == want, axes
    assert tm.param_logical_axes('layers.3.attn.q_proj.weight', 2) == \
        ('heads', 'embed')
    assert tm.param_logical_axes('layers.0.moe.w_down', 3) == \
        ('expert', 'mlp', 'embed')
    assert tm.param_logical_axes('something.else', 2) == (None, None)


def test_env_reading(monkeypatch):
    """The podlet's SKYTPU_* env and torchrun's, each to its rendezvous
    and the backend the device asks for; a multi-process env without an
    address refuses; a single process starts no group."""
    for k in ('SKYTPU_COORDINATOR_ADDRESS', 'SKYTPU_NUM_PROCESSES',
              'SKYTPU_PROCESS_ID', 'WORLD_SIZE', 'RANK', 'MASTER_ADDR',
              'MASTER_PORT', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(tm.dist, 'init_process_group',
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(tm.dist, 'is_initialized', lambda: False)
    assert tm.initialize_distributed_from_env('cpu') is False
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDRESS', '10.0.0.1:8476')
    monkeypatch.setenv('SKYTPU_NUM_PROCESSES', '4')
    monkeypatch.setenv('SKYTPU_PROCESS_ID', '2')
    assert tm.initialize_distributed_from_env('cpu') is True
    assert calls[-1] == ('gloo', dict(init_method='tcp://10.0.0.1:8476',
                                      rank=2, world_size=4))
    monkeypatch.delenv('SKYTPU_COORDINATOR_ADDRESS')
    with pytest.raises(ValueError, match='SKYTPU_COORDINATOR_ADDRESS'):
        tm.initialize_distributed_from_env('cpu')
    monkeypatch.delenv('SKYTPU_NUM_PROCESSES')
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='MASTER_ADDR'):
        tm.initialize_distributed_from_env('cpu')
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    monkeypatch.setenv('RANK', '1')
    assert tm.initialize_distributed_from_env('cpu') is True
    assert calls[-1] == ('gloo', dict(init_method='env://', rank=1,
                                      world_size=2))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tm.initialize_distributed_from_env()
    with pytest.raises(RuntimeError, match='needs a process group'):
        tm.make_mesh(tm.MeshSpec())


def _jax_params(jcfg, seed=0):
    mesh = jm.make_mesh(jm.MeshSpec(), devices=jax.devices()[:1])
    state, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**TRAIN), mesh,
                                       jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.array(x, np.float32), state.params)


def _router_aux(apply_fn):
    """params, tokens -> the sum of the sown router_aux_loss values of the
    forward on the step's inputs (the router term the step adds)."""

    @jax.jit
    def aux(params, tokens):
        _, inter = apply_fn({'params': params}, tokens[:, :-1],
                            mutable=['intermediates'])
        return sum(jnp.sum(v) for v in jax.tree.leaves(inter))

    return aux


def _jax_leg(jcfg, spec, batches, accum, n):
    """Three JAX steps on a mesh of `spec` over jax.devices()[:n]: each
    step's loss, grad_norm and (Mixtral) router term, and the final
    params."""
    mesh = jm.make_mesh(jm.MeshSpec(**spec), devices=jax.devices()[:n])
    state, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**TRAIN), mesh,
                                       jax.random.PRNGKey(0))
    step = jt.make_train_step(mesh, grad_accum_steps=accum)
    losses, norms, aux = [], [], []
    router_aux = _router_aux(state.apply_fn)
    with mesh:
        for tokens in batches:
            if hasattr(jcfg, 'num_experts'):
                aux.append(float(router_aux(state.params,
                                            jnp.asarray(tokens))))
            state, m = step(state, {'tokens': jnp.asarray(tokens)})
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
    params = jax.tree.map(lambda x: np.array(x, np.float32), state.params)
    return losses, norms, aux, params


# Mixtral at a capacity factor that drops pairs: each expert takes
# int(0.5 * G * 2 / 4) = G / 4 of the G global tokens' 2G pairs.
MOE = ('mixtral-debug', dict(capacity_factor=0.5))
# (name, ranks, (model, overrides), mesh, grad accumulation, resume mesh
# for step 3).  The resume leg is held against the JAX leg of its first
# mesh.
LEGS = [
    ('fsdp2', 2, (MODEL, {}), dict(fsdp=2), 1, None),
    ('data2-fsdp2-accum2', 4, (MODEL, {}), dict(data=2, fsdp=2), 2, None),
    ('fsdp2-tensor2', 4, (MODEL, {}), dict(fsdp=2, tensor=2), 1, None),
    ('data2-tensor2-accum2', 4, (MODEL, {}), dict(data=2, tensor=2), 2,
     None),
    ('mixtral-data2-fsdp2', 4, MOE, dict(data=2, fsdp=2), 1, None),
    ('mixtral-fsdp2-tensor2', 4, MOE, dict(fsdp=2, tensor=2), 1, None),
    ('resume-fsdp2-tensor2-to-data2-fsdp2', 4, (MODEL, {}),
     dict(fsdp=2, tensor=2), 1, dict(data=2, fsdp=2)),
]


def _configs(model, overrides):
    jcfg = dataclasses.replace(jax_model_config(model), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(registry.get_model_config(model),
                               dtype=torch.float32, **overrides)
    return jcfg, tcfg


@pytest.fixture(scope='module')
def legs(tmp_path_factory):
    """Every leg on the port's ranks (2 and 4 at once) while the JAX legs
    run here; the JAX state's params carried across."""
    tmp = tmp_path_factory.mktemp('mesh')
    models = {(m, tuple(o.items())): _configs(m, o)
              for _, _, (m, o), *_ in LEGS}
    sds = {key: {k: v.numpy() for k, v in convert.state_dict_from_jax(
        _jax_params(jcfg), tcfg).items()}
        for key, (jcfg, tcfg) in models.items()}
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (TRAIN['batch_size'],
                                     TRAIN['seq_len'] + 1))
               for _ in range(3)]
    assert all(t.vocab_size == 256 for _, t in models.values())
    workers = {}
    for world in (2, 4):
        port_legs = [hd.TrainLeg(
            name=name, mesh=spec, model=m, overrides=o,
            train={**TRAIN, 'grad_accum_steps': accum},
            params=sds[m, tuple(o.items())], batches=batches,
            ckpt=str(tmp / name) if resume else '',
            resume_at=2 if resume else 0, resume_mesh=resume,
            local_rows=name == 'fsdp2-tensor2')
            for name, n, (m, o), spec, accum, resume in LEGS if n == world]
        workers[world] = (port_legs, hd.Workers(hd.trainer_legs, world, tmp,
                                                port_legs))
    want = {name: (_jax_leg(models[m, tuple(o.items())][0], spec, batches,
                            accum, n), models[m, tuple(o.items())][1])
            for name, n, (m, o), spec, accum, resume in LEGS
            if resume is None}
    want[LEGS[-1][0]] = want['fsdp2-tensor2']
    got = {}
    for world, (port_legs, w) in workers.items():
        ranks = w.join()
        for i, leg in enumerate(port_legs):
            got[leg.name] = {**ranks[0][i],
                             'loads': [r[i]['loads'] for r in ranks]}
    return got, want


@pytest.mark.parametrize('name', [leg[0] for leg in LEGS])
def test_trainer_on_a_mesh_matches_jax(legs, name):
    """Loss, grad_norm and (Mixtral) the router term of each of 3 steps
    within 1e-5 relative and every parameter within 1e-6 after them,
    against the JAX step on a mesh of the same shape; the resume leg's
    third step ran in a second Trainer, on another mesh, from the
    first's checkpoint, which rank 0 alone read; the fsdp2-tensor2 leg fed
    each rank only its rows (ShardInfo.current and shard_batch, as a
    loader over processes does)."""
    got, want = legs
    g = got[name]
    (jl, jn, jaux, jp), tcfg = want[name]
    np.testing.assert_allclose(g['loss'], jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['grad_norm'], jn, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['router_aux_loss'], jaux, rtol=TOL_LOSS)
    assert len(jaux) == (3 if name.startswith('mixtral') else 0)
    if name.startswith('resume'):
        assert g['loads'] == [1, 0, 0, 0]
    ref = convert.state_dict_from_jax(jp, tcfg)
    assert g['params'].keys() == ref.keys()
    for key, p in g['params'].items():
        np.testing.assert_allclose(p, ref[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)
