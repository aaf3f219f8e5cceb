"""The port's sequence parallelism (skypilot_tpu_torch/ops/ring_attention.py)
held against the JAX package's on the CPU, in f32: ring and Ulysses
attention, causal and not, outputs and gradients over 2 and 4 gloo ranks
against ring_attention / ulysses_attention under shard_map on a 'seq'
mesh of the same size, and against the no-mesh reference; the refusals
(sliding window under 'seq', Ulysses' head divisibility); and the trainer
at seq=2 (ring) against the JAX step on a seq=2 mesh."""
import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from skypilot_tpu.ops.flash_attention import reference_attention
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu_torch.ops import ring_attention as tra
from test_torch_mesh import MODEL, TRAIN, _jax_leg, _jax_params

# The package's ops/__init__ re-exports the function under the module's name.
jra = importlib.import_module('skypilot_tpu.ops.ring_attention')
TOL = 1e-5               # absolute, outputs and gradients (|x| <= ~1)
TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, params after 3 AdamW steps
P = jax.sharding.PartitionSpec
# B 2, Hq 8, Hkv 4 (GQA), S 32, D 16: Ulysses splits 4 kv heads over 4.
SHAPE = (2, 8, 4, 32, 16)
CASES = [(mode, causal) for mode in ('ring', 'ulysses')
         for causal in (True, False)]


def _inputs(seed):
    b, hq, hkv, s, d = SHAPE
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {'q': draw(b, hq, s, d), 'k': draw(b, hkv, s, d),
            'v': draw(b, hkv, s, d), 'dout': draw(b, hq, s, d)}


def _jax_attention(x, mode, causal, n):
    """JAX's ring/ulysses under shard_map over a seq mesh of n devices:
    the output and the gradients of sum(out * dout)."""
    mesh = jm.make_mesh(jm.MeshSpec(seq=n), devices=jax.devices()[:n])
    inner = jra.ring_attention if mode == 'ring' else jra.ulysses_attention
    spec = P(None, None, 'seq', None)
    fn = jax.shard_map(functools.partial(inner, axis_name='seq',
                                         causal=causal),
                       mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * x['dout']), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x['q'], x['k'], x['v'])
    return [np.asarray(a) for a in (out, *grads)]


def _reference(x, causal):
    """The no-mesh reference attention (the JAX package's) and its
    gradients."""
    def loss(q, k, v):
        out = reference_attention(q, k, v, causal=causal)
        return jnp.sum(out * x['dout']), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x['q'], x['k'], x['v'])
    return [np.asarray(a) for a in (out, *grads)]


def _trainer_legs(tmp, sd, batches):
    return [hd.TrainLeg(name='seq2', mesh=dict(seq=2), model=MODEL,
                        overrides={}, train=TRAIN, params=sd,
                        batches=batches)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The port's attention cases on 2 and 4 ranks and its trainer at
    seq=2, started first; the JAX side computed meanwhile."""
    from skypilot_tpu.models import get_model_config as jax_model_config
    from skypilot_tpu_torch.models import convert, registry
    tmp = tmp_path_factory.mktemp('ring')
    inputs = {n: _inputs(n) for n in (2, 4)}
    cases = {n: [dict(mode=m, causal=c, **inputs[n]) for m, c in CASES]
             for n in (2, 4)}
    attn = {n: hd.Workers(hd.seq_attention, n, tmp, cases[n])
            for n in (2, 4)}
    jcfg = dataclasses.replace(jax_model_config(MODEL), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_model_config(MODEL),
                               dtype=torch.float32)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        _jax_params(jcfg), tcfg).items()}
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, tcfg.vocab_size, (TRAIN['batch_size'],
                                                 TRAIN['seq_len'] + 1))
               for _ in range(3)]
    train = hd.Workers(hd.trainer_legs, 2, tmp,
                       _trainer_legs(tmp, sd, batches))
    want = {(n, m, c): _jax_attention(inputs[n], m, c, n)
            for n in (2, 4) for m, c in CASES}
    ref = {(n, c): _reference(inputs[n], c) for n in (2, 4)
           for c in (True, False)}
    jtrain = _jax_leg(jcfg, dict(seq=2), batches, 1, 2)
    got = {n: attn[n].join() for n in (2, 4)}
    return got, want, ref, train.join()[0][0], jtrain, tcfg


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('mode,causal', CASES)
def test_outputs_and_gradients_match_jax(runs, n, mode, causal):
    """Each rank's output block and its q/k/v gradient blocks, joined
    along the sequence, within 1e-5 of JAX's shard_map'd function and of
    the no-mesh reference attention."""
    got, want, ref, *_ = runs
    i = CASES.index((mode, causal))
    joined = [np.concatenate([r[i][key] for r in got[n]], axis=2)
              for key in ('out', 'dq', 'dk', 'dv')]
    for name, g, w, r in zip(('out', 'dq', 'dk', 'dv'), joined,
                             want[(n, mode, causal)], ref[(n, causal)]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL, err_msg=name)


def test_refusals_match_jax(runs):
    """Ulysses with heads that do not split over the group, and a sliding
    window under 'seq', raise the JAX texts; with no mesh or a 'seq'
    degree of 1 the call is plain flash attention."""
    got = runs[0]
    mesh = jm.make_mesh(jm.MeshSpec(seq=4), devices=jax.devices()[:4])
    z = jnp.zeros((1, 3, 4, 8))
    with pytest.raises(ValueError) as theirs:
        jax.shard_map(functools.partial(jra.ulysses_attention,
                                        axis_name='seq'),
                      mesh=mesh, in_specs=(P(None, None, 'seq', None),) * 3,
                      out_specs=P(None, None, 'seq', None))(z, z, z)
    assert got[4][0][-1] == str(theirs.value)
    zz = jnp.zeros((1, 2, 8, 8))
    with pytest.raises(NotImplementedError) as theirs:
        jra.sequence_parallel_attention(zz, zz, zz, window=4, mesh=mesh)
    t = torch.zeros(1, 2, 8, 8)
    stub = types.SimpleNamespace(shape={'seq': 4})
    with pytest.raises(NotImplementedError) as mine:
        tra.sequence_parallel_attention(t, t, t, window=4, mesh=stub)
    assert str(mine.value) == str(theirs.value)
    assert tra.seq_parallel_degree() == jra.seq_parallel_degree() == 1
    x = torch.from_numpy(_inputs(0)['q'][:, :4])
    np.testing.assert_allclose(
        tra.sequence_parallel_attention(x, x, x).numpy(),
        np.asarray(reference_attention(x.numpy(), x.numpy(), x.numpy())),
        rtol=0, atol=TOL)


def test_trainer_at_seq2_matches_jax(runs):
    """Three trainer steps at MeshSpec(seq=2) (ring attention, positions
    offset per block, gradients summed over 'seq') against the JAX step on
    a seq=2 mesh: loss and grad_norm 1e-5 relative, params 1e-6."""
    from skypilot_tpu_torch.models import convert
    *_, g, (jl, jn, _, jp), tcfg = runs
    np.testing.assert_allclose(g['loss'], jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['grad_norm'], jn, rtol=TOL_LOSS)
    ref = convert.state_dict_from_jax(jp, tcfg)
    for key, p in g['params'].items():
        np.testing.assert_allclose(p, ref[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)
