"""The port's GPipe pipelining (skypilot_tpu_torch/parallel/pipeline.py)
held against the JAX package's on the CPU, in f32: ``pipeline`` against
a sequential stack and against JAX ``pipeline`` on a stage mesh, outputs
and gradients, over 2 and 4 gloo ranks; the trainer at stage=2, and at
stage=2 x data=2 with grad accumulation 2, against the JAX step through
``make_pipelined_apply`` (as tests/test_pipeline.py runs it); and the
refusals, with the JAX texts."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu.parallel import pipeline as jp
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.parallel import mesh as tm
from skypilot_tpu_torch.parallel import pipeline as tp
from skypilot_tpu_torch.train import trainer as tt
from test_torch_mesh import MODEL, TRAIN, _jax_params

TOL = 1e-5               # absolute, outputs and gradients
TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, params after 3 AdamW steps
H = 8


def _stage_inputs(stages, micro, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((stages, H, H)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((stages, H)) * 0.1).astype(np.float32)
    mbs = rng.standard_normal((micro, 2, H)).astype(np.float32)
    return w, b, mbs


def _jax_pipeline(w, b, mbs):
    """JAX pipeline on a stage mesh: outputs and gradients of
    sum(out ** 2), and the same of the sequential stack."""
    stages = w.shape[0]
    mesh = jm.make_mesh(jm.MeshSpec(stage=stages),
                        devices=jax.devices()[:stages])

    def stage_fn(p, x, consts):
        return jnp.tanh(x @ p['w'] + p['b'])

    def seq(p, x):
        outs = []
        for i in range(x.shape[0]):
            h = x[i]
            for s in range(stages):
                h = jnp.tanh(h @ p['w'][s] + p['b'][s])
            outs.append(h)
        return jnp.stack(outs)

    def pipe(p, x):
        return jp.pipeline(stage_fn, p, x, (), mesh)

    res = []
    for fn in (pipe, seq):
        def loss(p, x):
            out = fn(p, x)
            return jnp.sum(out ** 2), out

        with mesh:
            (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))({'w': w, 'b': b}, mbs)
        res.append({'out': np.asarray(out), 'dw': np.asarray(gp['w']),
                    'db': np.asarray(gp['b']), 'dx': np.asarray(gx)})
    return res


# (name, ranks, mesh, grad accumulation, pipeline microbatches)
TRAIN_LEGS = [('stage2', 2, dict(stage=2), 1, 2),
              ('stage2-data2-accum2', 4, dict(stage=2, data=2), 2, 2)]


def _jax_pipelined_leg(jcfg, spec, batches, accum, micro, n):
    mesh = jm.make_mesh(jm.MeshSpec(**spec), devices=jax.devices()[:n])
    cfg = jt.TrainConfig(**TRAIN, grad_accum_steps=accum,
                         pipeline_microbatches=micro)
    apply = jp.make_pipelined_apply(jcfg, mesh, num_microbatches=micro)
    state, _ = jt.create_sharded_state(jcfg, cfg, mesh,
                                       jax.random.PRNGKey(0), apply_fn=apply)
    step = jt.make_train_step(mesh, grad_accum_steps=accum)
    losses, norms = [], []
    with mesh:
        for tokens in batches:
            state, m = step(state, {'tokens': jnp.asarray(tokens)})
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
    return losses, norms, jax.tree.map(lambda x: np.array(x, np.float32),
                                       state.params)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipe')
    prims = {n: _stage_inputs(n, 4, seed=n) for n in (2, 4)}
    prim_workers = {n: hd.Workers(hd.pipeline_stages, n, tmp, *prims[n])
                    for n in (2, 4)}
    jcfg = dataclasses.replace(jax_model_config(MODEL), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_model_config(MODEL),
                               dtype=torch.float32)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        _jax_params(jcfg), tcfg).items()}
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, tcfg.vocab_size, (TRAIN['batch_size'],
                                                 TRAIN['seq_len'] + 1))
               for _ in range(3)]
    train_workers = {}
    for name, n, spec, accum, micro in TRAIN_LEGS:
        leg = hd.TrainLeg(name=name, mesh=spec, model=MODEL, overrides={},
                          train={**TRAIN, 'grad_accum_steps': accum,
                                 'pipeline_microbatches': micro},
                          params=sd, batches=batches)
        train_workers[name] = hd.Workers(hd.trainer_legs, n, tmp, [leg])
    want_prims = {n: _jax_pipeline(*prims[n]) for n in (2, 4)}
    want_train = {name: _jax_pipelined_leg(jcfg, spec, batches, accum,
                                           micro, n)
                  for name, n, spec, accum, micro in TRAIN_LEGS}
    got_prims = {n: w.join() for n, w in prim_workers.items()}
    got_train = {name: w.join()[0][0] for name, w in train_workers.items()}
    return got_prims, want_prims, got_train, want_train, tcfg


@pytest.mark.parametrize('n', [2, 4])
def test_pipeline_matches_sequential_and_jax(runs, n):
    """Every stage's outputs, each stage's w and b gradients and stage
    0's microbatch gradient, within 1e-5 of JAX's pipeline and of the
    sequential stack; fewer microbatches than stages raises the JAX
    text.  The hops pass no tag (NCCL has none): a gradient send that met
    another microbatch's receive would swap their gradients here."""
    got, want = runs[0][n], runs[1][n]
    for ref in want:
        for rank, r in enumerate(got):
            np.testing.assert_allclose(r['out'], ref['out'], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(r['dw'], ref['dw'][rank], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(r['db'], ref['db'][rank], rtol=0,
                                       atol=TOL)
        np.testing.assert_allclose(got[0]['dx'], ref['dx'], rtol=0,
                                   atol=TOL)
    w, b, mbs = _stage_inputs(n, 4, seed=n)
    mesh = jm.make_mesh(jm.MeshSpec(stage=n), devices=jax.devices()[:n])
    with pytest.raises(ValueError) as theirs:
        jp.pipeline(lambda p, x, c: x, {'w': w, 'b': b}, mbs[:n - 1], (),
                    mesh)
    assert all(r['short'] == str(theirs.value) for r in got)


@pytest.mark.parametrize('name', [leg[0] for leg in TRAIN_LEGS])
def test_pipelined_trainer_matches_jax(runs, name):
    """Three trainer steps through the GPipe schedule against the JAX
    step through make_pipelined_apply on a mesh of the same shape."""
    *_, got, want, tcfg = runs
    g = got[name]
    jl, jn, params = want[name]
    np.testing.assert_allclose(g['loss'], jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['grad_norm'], jn, rtol=TOL_LOSS)
    ref = convert.state_dict_from_jax(params, tcfg)
    for key, p in g['params'].items():
        np.testing.assert_allclose(p, ref[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_refusals_match_jax():
    """The trainer's pipeline validations (tensor or seq beside stage,
    too few microbatches, a batch that does not split into them or their
    rows over data * fsdp), a non-llama config and layers that do not
    divide into stages: the JAX texts."""
    from skypilot_tpu.train.trainer import Trainer as JaxTrainer
    for mesh, kw in [(dict(stage=2, tensor=2), {}),
                     (dict(stage=2, seq=2), {}),
                     (dict(stage=2, data=2), dict(pipeline_microbatches=1)),
                     (dict(stage=4), dict(batch_size=6,
                                          pipeline_microbatches=4)),
                     (dict(stage=2, data=4), dict(batch_size=8,
                                                  pipeline_microbatches=4))]:
        cfg = {**TRAIN, **kw}
        mine = _raised(lambda: tt.Trainer(tt.TrainConfig(
            model=MODEL, mesh=tm.MeshSpec(**mesh), **cfg), device='cpu'))
        theirs = _raised(lambda: JaxTrainer(jt.TrainConfig(
            model=MODEL, mesh=jm.MeshSpec(**mesh), **cfg)))
        assert mine == theirs, mesh
    jmesh = jm.make_mesh(jm.MeshSpec(stage=2, data=4))
    stub = types.SimpleNamespace(shape={'stage': 2}, coord=lambda *a: 0)
    moe = 'mixtral-debug'
    assert _raised(lambda: tp.make_pipelined_apply(
        registry.get_model_config(moe), stub)) == _raised(
        lambda: jp.make_pipelined_apply(jax_model_config(moe), jmesh))
    odd = dict(num_layers=3)
    assert _raised(lambda: tp.make_pipelined_apply(dataclasses.replace(
        registry.get_model_config(MODEL), **odd), stub)) == _raised(
        lambda: jp.make_pipelined_apply(dataclasses.replace(
            jax_model_config(MODEL), **odd), jmesh))
    apply = tp.make_pipelined_apply(registry.get_model_config(MODEL), stub,
                                    num_microbatches=4)
    japply = jp.make_pipelined_apply(jax_model_config(MODEL), jmesh,
                                     num_microbatches=4)
    assert _raised(lambda: apply(None, torch.zeros(6, 8))) == _raised(
        lambda: japply({'params': {}}, jnp.zeros((6, 8), jnp.int32)))
