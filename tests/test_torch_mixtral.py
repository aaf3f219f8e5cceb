"""The port's Mixtral (skypilot_tpu_torch/models/mixtral.py) held against
the JAX package's on the CPU, in f32: ``top_k_routing`` (dispatch,
combine and aux, at capacities that drop tokens and that do not), the
MoE block's exact and capacity paths, the model's logits without and
with a cache, the engine's greedy streams (dense, chunked prefill, the
fp8 cache, multi-step windows) against the JAX engine's, the engine
against a drop-free no-cache scorer, three train steps with the router
aux loss (remat on, full logits, gradient accumulation 2), and the
refusals (the paged cache, multi-LoRA, LoRA training) with the JAX
texts."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import mixtral as jmix
from skypilot_tpu.models.llama import init_cache as jax_init_cache
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, llama, mixtral, registry
from skypilot_tpu_torch.train import trainer as tt

# f32 on both sides, the same routing decisions: only summation order
# differs.  The MoE block's outputs are O(1) at MOE_STD.
TOL_MOE = 1e-6
TOL_LOGITS = 1e-5
TOL_LOSS = 1e-5          # relative, loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, after three AdamW steps
MOE_STD = 0.1

# tests/test_infer.py's tiny MoE geometry (4 experts, top 2).
GEOMETRY = dict(name='moe-test', vocab_size=101, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, num_experts=4, experts_per_token=2,
                capacity_factor=1.25, max_seq_len=128, tie_embeddings=True)
JAX_CFG = jmix.MixtralConfig(**GEOMETRY, dtype=jnp.float32)
PORT_CFG = mixtral.MixtralConfig(**GEOMETRY, dtype=torch.float32)
# Weights at 0.02 * WEIGHT_SCALE: greedy paths that change token often.
WEIGHT_SCALE = 10.0


def _draw(tree, std, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, std, x.shape).astype(np.float32), tree)


@pytest.fixture(scope='module')
def params():
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        jmix.Mixtral(JAX_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    return _draw(shapes, 0.02 * WEIGHT_SCALE, 3)


def _port_model(cfg, params):
    model = mixtral.Mixtral(cfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, cfg))
    return model


def _dense(r, num_experts):
    """The JAX module's one-hot (dispatch, combine) [G, E, C] from the
    port's index form."""
    k, g = r.expert.shape
    dispatch = torch.zeros(g, num_experts, r.capacity)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(g).expand(k, g)
    at = (tok[r.kept], r.expert[r.kept], r.slot[r.kept])
    dispatch.index_put_(at, torch.ones_like(r.gate[r.kept]), accumulate=True)
    combine.index_put_(at, r.gate[r.kept], accumulate=True)
    return dispatch, combine


@pytest.mark.parametrize('cap', [6, 16, 40])
def test_top_k_routing_matches_jax(cap):
    """Dispatch and combine (densified from the port's indices) equal the
    JAX one-hots, the aux loss agrees: 40 tokens, 4 experts, top 2, at a
    capacity that drops most pairs (6), some (16, cf 0.8) and none."""
    logits = np.random.default_rng(cap).normal(size=(40, 4)).astype(
        np.float32)
    d, c, aux = jmix.top_k_routing(jnp.asarray(logits), 4, 2, cap)
    r = mixtral.top_k_routing(torch.from_numpy(logits), 4, 2, cap)
    dispatch, combine = _dense(r, 4)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(d))
    np.testing.assert_allclose(combine.numpy(), np.asarray(c), rtol=0,
                               atol=TOL_MOE)
    np.testing.assert_allclose(r.aux.item(), float(aux), rtol=TOL_MOE)
    dropped = 80 - int(dispatch.sum())
    assert (dropped > 0) == (cap < 40)


@pytest.mark.parametrize('case', ['exact', 'capacity', 'capacity_drops'])
def test_moe_block_matches_jax(case):
    """MoEBlock on [2, 24, 32] f32 inputs: the exact (all experts) path,
    the capacity path at cf 1.25 and at cf 0.5 (tokens dropped), against
    the flax block with the same weights; the capacity path's weighted
    aux against the sown value."""
    cf = 0.5 if case == 'capacity_drops' else 1.25
    jcfg = dataclasses.replace(JAX_CFG, capacity_factor=cf)
    tcfg = dataclasses.replace(PORT_CFG, capacity_factor=cf)
    exact = case == 'exact'
    x = np.random.default_rng(1).normal(size=(2, 24, 32)).astype(np.float32)
    block = jmix.MoEBlock(jcfg, exact=exact)
    p = _draw(flax.linen.meta.unbox(block.init(
        jax.random.PRNGKey(0), jnp.asarray(x))['params']), MOE_STD, 2)
    want, inter = block.apply({'params': p}, jnp.asarray(x),
                              mutable=['intermediates'])
    mine = mixtral.MoEBlock(tcfg, device='cpu')
    mine.load_state_dict({
        'router.weight': torch.from_numpy(p['router']['kernel']).T,
        **{n: torch.from_numpy(p[n]) for n in ('w_gate', 'w_up', 'w_down')}})
    with torch.no_grad():
        got, aux = mine(torch.from_numpy(x), exact=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_MOE)
    if exact:
        assert aux is None and not inter
        return
    [sown] = inter['intermediates']['router_aux_loss']
    np.testing.assert_allclose(aux.item(), float(sown), rtol=TOL_MOE)
    g = 48
    routed = mixtral.top_k_routing(
        mine.router(torch.from_numpy(x).reshape(g, 32)), 4, 2,
        mixtral.capacity(tcfg, g))
    assert (not bool(routed.kept.all())) == (case == 'capacity_drops')


@pytest.mark.parametrize('cf', [1.25, 0.5])
def test_logits_match_jax(params, cf):
    """The no-cache forward (capacity routing; cf 0.5 drops tokens) and
    its final hidden states against the flax module's."""
    jcfg = dataclasses.replace(JAX_CFG, capacity_factor=cf)
    tcfg = dataclasses.replace(PORT_CFG, capacity_factor=cf)
    tokens = np.random.default_rng(4).integers(0, 101, (2, 20))
    want = jmix.Mixtral(jcfg).apply({'params': params}, jnp.asarray(tokens))
    hidden = jmix.Mixtral(jcfg).apply({'params': params},
                                      jnp.asarray(tokens), hidden_only=True)
    model = _port_model(tcfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
        got_hidden = model(torch.from_numpy(tokens), hidden_only=True)
    scale = float(np.abs(np.asarray(want)).max())
    assert 1.0 < scale < 20.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_LOGITS)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden),
                               rtol=0, atol=TOL_LOGITS)


def test_cache_path_matches_jax_and_the_drop_free_forward(params):
    """A prefill of 12 tokens then two single-token steps through the
    cache (exact routing) against the flax module's cached forward, and
    against the drop-free (cf = E/k) no-cache forward over the same
    14 tokens."""
    tokens = np.random.default_rng(5).integers(0, 101, (2, 14))
    jm = jmix.Mixtral(JAX_CFG)
    jcache = jax_init_cache(JAX_CFG.as_llama(), 2, 32, jnp.float32)
    model = _port_model(PORT_CFG, params)
    cache = llama.init_cache(PORT_CFG, 2, 32, torch.float32)
    got, want = [], []
    for lo, hi in ((0, 12), (12, 13), (13, 14)):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo))
        jl, jcache = jm.apply({'params': params},
                              jnp.asarray(tokens[:, lo:hi]),
                              jnp.asarray(pos), jcache)
        with torch.no_grad():
            tl, cache = model(torch.from_numpy(tokens[:, lo:hi]),
                              torch.from_numpy(pos.copy()), cache)
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS)
    free = _port_model(dataclasses.replace(PORT_CFG, capacity_factor=2.0),
                       params)
    with torch.no_grad():
        full = free(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=TOL_LOGITS)


TRAIN_CASES = {
    'remat_chunked_loss': dict(),
    'full_logits': dict(loss_chunk=None),
    'grad_accum_2': dict(grad_accum_steps=2),
}


@pytest.mark.parametrize('case', list(TRAIN_CASES))
def test_train_steps_match_jax(case):
    """Three make_train_step steps of mixtral-debug (f32, every layer
    checkpointed) against JAX make_train_step on a one-device mesh from
    the JAX state's params: the loss with the router aux term and
    grad_norm each step, every parameter after the third, the routers
    included; the router's term is recorded beside the loss and its
    gradient reaches the routers."""
    kw = TRAIN_CASES[case]
    jcfg = dataclasses.replace(jax_model_config('mixtral-debug'),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_model_config('mixtral-debug'),
                               dtype=torch.float32)
    cfg_kwargs = dict(model='mixtral-debug', batch_size=4, seq_len=32,
                      learning_rate=3e-4, warmup_steps=2, total_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**cfg_kwargs),
                                        mesh, jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    model = mixtral.Mixtral(tcfg, device='cpu', param_dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_jax(
        to_np(jstate.params), tcfg))
    opt, sched = tt.make_optimizer(tt.TrainConfig(**cfg_kwargs),
                                   model.parameters())
    state = tt.TrainState(0, model, opt, sched)
    loss_chunk = kw.get('loss_chunk', 128)
    accum = kw.get('grad_accum_steps', 1)
    jstep = jt.make_train_step(mesh, loss_chunk=loss_chunk,
                               grad_accum_steps=accum)
    step = tt.make_train_step(loss_chunk=loss_chunk, grad_accum_steps=accum)
    for i in range(3):
        tokens = np.random.default_rng(10 + i).integers(0, 256, (4, 33))
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(state, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)
        assert 0 < m['router_aux_loss'].item() < m['loss'].item()
        router_grad = model.layers[0].moe.router.weight.grad
        assert router_grad is not None and bool(router_grad.abs().sum() > 0)
    want = convert.state_dict_from_jax(to_np(jstate.params), tcfg)
    for key, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)
