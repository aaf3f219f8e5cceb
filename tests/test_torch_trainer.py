"""The port's trainer (skypilot_tpu_torch.train) held against the JAX
package's (skypilot_tpu.train.trainer): the LR schedule, the chunked loss
and its gradients, three optimizer steps of llama-debug from the same
params on the same numpy batches, and one step's gradients of the loss
variants.  Then the port's own guarantees: grad accumulation, evaluate,
checkpoint/resume, f32 master weights and the unported options.  All on
the CPU, in f32, at llama-debug size."""
import dataclasses
import itertools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, llama, registry
from skypilot_tpu_torch.parallel.mesh import MeshSpec as PortMeshSpec
from skypilot_tpu_torch.train import trainer as tt

# f32 on both sides; only summation order differs.
TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_GRAD = 1e-5          # absolute, gradients (|g| <= ~0.1 here)
# Params after three AdamW steps, absolute.  Adam divides by sqrt(v):
# where a gradient is near 0, round-off in g moves m / sqrt(v), and with it
# an update, by up to lr -- 1.5 * peak over these steps in the worst case.
# With these inputs no element comes near that (they agree to 1.5e-8), so
# every element is held to 1e-6, which a wrong update rule or lr fails.
PEAK_LR = 3e-4
TOL_PARAMS = 1e-6


def _configs(name='llama-debug', **overrides):
    jcfg = dataclasses.replace(jax_model_config(name), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(registry.get_model_config(name),
                               dtype=torch.float32, **overrides)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _random_params(jcfg, seq, seed=0):
    """The flax param tree's shapes (abstract init), every leaf drawn with
    numpy at std 0.02 -- norm scales included, so they matter too."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, seq), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, 0.02, x.shape).astype(np.float32), shapes)


def _tokens(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1))


def _port_model(tcfg, params):
    model = llama.Llama(tcfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    return model


def _port_state(cfg, tcfg, sd):
    model = llama.Llama(tcfg, device='cpu', param_dtype=torch.float32)
    model.load_state_dict(sd)
    opt, sched = tt.make_optimizer(cfg, model.parameters())
    return tt.TrainState(0, model, opt, sched)


def test_schedule_matches_optax():
    """make_optimizer's lr at steps 0..12, read from the optimizer as each
    update would use it, against optax.warmup_cosine_decay_schedule."""
    cfg = tt.TrainConfig(learning_rate=3e-4, warmup_steps=3, total_steps=10)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1)
    w = torch.zeros(2, requires_grad=True)
    opt, sched = tt.make_optimizer(cfg, [w])
    got = []
    for _ in range(13):
        got.append(opt.param_groups[0]['lr'])
        opt.step()
        sched.step()
    want = [float(ref(i)) for i in range(13)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == 0.0 and got[3] == pytest.approx(3e-4)


def test_chunked_cross_entropy_matches_jax():
    """Value and gradients (hidden, proj) with a mask and T = 37, not a
    multiple of the chunk, against the JAX function; and the same value
    as cross_entropy_loss on the full logits."""
    rng = np.random.default_rng(3)
    b, t, h, v = 2, 37, 16, 50
    hidden = rng.standard_normal((b, t, h)).astype(np.float32)
    proj = rng.standard_normal((h, v)).astype(np.float32) * 0.3
    targets = rng.integers(0, v, (b, t))
    mask = (rng.random((b, t)) < 0.7).astype(np.float32)

    jval, (jgh, jgp) = jax.value_and_grad(
        lambda hh, pp: jt.chunked_cross_entropy(
            hh, pp, jnp.asarray(targets), jnp.asarray(mask), chunk_t=8),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(proj))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tp = torch.from_numpy(proj).requires_grad_(True)
    tt_, tm = torch.from_numpy(targets), torch.from_numpy(mask)
    val = tt.chunked_cross_entropy(th, tp, tt_, tm, chunk_t=8)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=TOL_LOSS)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh),
                               atol=TOL_GRAD)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp),
                               atol=TOL_GRAD)
    full = tt.cross_entropy_loss(th.detach() @ tp.detach(), tt_, tm)
    np.testing.assert_allclose(val.item(), full.item(), rtol=TOL_LOSS)


def _three_steps_match_jax(name, **overrides):
    """Three make_train_step steps of model `name` (f32, `overrides` on
    both sides' configs) against JAX make_train_step on a one-device mesh,
    from the JAX state's params carried across by state_dict_from_jax:
    loss and grad_norm each step, params after the third."""
    jcfg, tcfg = _configs(name, **overrides)
    cfg_kwargs = dict(model=name, batch_size=4, seq_len=32,
                      learning_rate=PEAK_LR, warmup_steps=2, total_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**cfg_kwargs),
                                        mesh, jax.random.PRNGKey(0))
    sd = convert.state_dict_from_jax(_np_tree(jstate.params), tcfg)
    state = _port_state(tt.TrainConfig(**cfg_kwargs), tcfg, sd)
    jstep = jt.make_train_step(mesh)
    step = tt.make_train_step()
    for i in range(3):
        tokens = _tokens(4, 32, seed=10 + i, vocab=tcfg.vocab_size)
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(state, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)
    assert state.step == 3
    want = convert.state_dict_from_jax(_np_tree(jstate.params), tcfg)
    for key, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)


def test_three_train_steps_match_jax():
    """Three make_train_step steps on llama-debug (f32) against JAX
    make_train_step on a one-device mesh, from the JAX state's params
    carried across by state_dict_from_jax.  warmup_steps=2, so the steps
    take lr 0, then half of peak, then peak."""
    _three_steps_match_jax('llama-debug')


# Gemma (gelu_tanh, scaled embeddings, zero-centred norms, an explicit
# head_dim): its debug configs, MHA-like GQA 4/2 and MQA, and the MQA one
# at gemma's own head_dim 256 -- the width the Hopper kernels took last.
GEMMA_TRAIN_CASES = {
    'gemma-debug': ('gemma-debug', {}),
    'gemma-mqa-debug': ('gemma-mqa-debug', {}),
    'gemma-mqa-debug-head-dim-256': ('gemma-mqa-debug', {'head_dim': 256}),
}


@pytest.mark.parametrize('case', list(GEMMA_TRAIN_CASES))
def test_gemma_train_steps_match_jax(case):
    """Three make_train_step steps of each Gemma debug config (f32)
    against JAX make_train_step, held as llama-debug's are."""
    name, overrides = GEMMA_TRAIN_CASES[case]
    _three_steps_match_jax(name, **overrides)


@pytest.mark.parametrize('variant', ['full_logits', 'window_48'])
def test_loss_variants_gradients_match_jax(variant):
    """One step's loss and gradients with loss_chunk=None (full logits)
    and with sliding_window=48 at S 96 (fused chunked loss), against
    jax.value_and_grad of the same loss."""
    if variant == 'full_logits':
        (jcfg, tcfg), s, chunk = _configs(), 40, None
    else:
        (jcfg, tcfg), s, chunk = _configs(sliding_window=48), 96, 32
    params = _random_params(jcfg, s)
    tokens = _tokens(2, s, seed=5)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        if chunk:
            hidden = JaxLlama(jcfg).apply({'params': p}, inputs,
                                          hidden_only=True)
            return jt.chunked_cross_entropy(
                hidden, jt.output_projection(p), targets, chunk_t=chunk)
        return jt.cross_entropy_loss(
            JaxLlama(jcfg).apply({'params': p}, inputs), targets)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want = convert.state_dict_from_jax(_np_tree(jgrads), tcfg)
    model = _port_model(tcfg, params)
    loss = tt.loss_fn(model, torch.from_numpy(inputs),
                      torch.from_numpy(targets), loss_chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=TOL_LOSS)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=TOL_GRAD, err_msg=name)


def test_remat_policies_give_the_same_gradients():
    """'none', 'dots' and 'full' recompute, and so change nothing."""
    _, tcfg = _configs()
    params = convert.init_params(tcfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_tokens(2, 24, seed=6))
    grads = {}
    for policy in ('none', 'dots', 'full'):
        model = llama.Llama(dataclasses.replace(tcfg, remat_policy=policy),
                            device='cpu')
        model.load_state_dict(params)
        tt.loss_fn(model, tokens[:, :-1], tokens[:, 1:],
                   loss_chunk=8).backward()
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
    for policy in ('dots', 'full'):
        for name, g in grads['none'].items():
            torch.testing.assert_close(grads[policy][name], g, rtol=0,
                                       atol=1e-7)
    with pytest.raises(ValueError, match='remat_policy'):
        llama.Llama(dataclasses.replace(tcfg, remat_policy='some'),
                    device='cpu')(tokens)


def test_grad_accumulation_equals_one_pass():
    """grad_accum_steps=2 on a batch whose two microbatches have unequal
    mask counts gives the one-pass update: the sum form exists for this
    case.  Tolerances as the JAX package's own test (other f32 order)."""
    _, tcfg = _configs()
    cfg = tt.TrainConfig(model='llama-debug', batch_size=4, seq_len=24,
                         warmup_steps=0, total_steps=10)
    sd = convert.init_params(tcfg, torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(_tokens(4, 24, seed=7))
    mask = torch.ones(tokens.shape)
    mask[:2, 6:] = 0.0          # microbatch 0 keeps far fewer targets
    batch = {'tokens': tokens, 'mask': mask}
    one, two = _port_state(cfg, tcfg, sd), _port_state(cfg, tcfg, sd)
    for _ in range(2):
        m1 = tt.make_train_step(loss_chunk=8)(one, batch)
        m2 = tt.make_train_step(loss_chunk=8, grad_accum_steps=2)(two, batch)
        np.testing.assert_allclose(m2['loss'].item(), m1['loss'].item(),
                                   rtol=5e-5)
        np.testing.assert_allclose(m2['grad_norm'].item(),
                                   m1['grad_norm'].item(), rtol=1e-4)
    p2 = two.model.state_dict()
    for name, p in one.model.state_dict().items():
        torch.testing.assert_close(p2[name], p, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match='not divisible'):
        tt.make_train_step(grad_accum_steps=3)(two, batch)


def _trainer(tmp_path=None, **kwargs):
    _, tcfg = _configs()
    cfg = tt.TrainConfig(model='llama-debug', batch_size=2, seq_len=16,
                         warmup_steps=2, total_steps=10, loss_chunk=8,
                         checkpoint_dir=str(tmp_path) if tmp_path else None,
                         checkpoint_every=2, **kwargs)
    trainer = tt.Trainer(cfg, tcfg, device='cpu')
    trainer.setup(seed=0)
    return trainer


def _batches(n, seed=0):
    return [{'tokens': torch.from_numpy(_tokens(2, 16, seed=seed + i))}
            for i in range(n)]


def test_evaluate_equals_train_path_loss():
    trainer = _trainer()
    batch = _batches(1)[0]
    ev = trainer.evaluate(iter([batch]), num_batches=5)
    assert ev['batches'] == 1
    loss = trainer._step_fn(trainer.state, batch)['loss'].item()
    np.testing.assert_allclose(ev['eval_loss'], loss, rtol=1e-6)
    assert ev['perplexity'] == pytest.approx(np.exp(ev['eval_loss']))
    assert np.isnan(trainer.evaluate(iter([]))['eval_loss'])


def test_checkpoint_resume_equals_straight_run(tmp_path):
    """4 steps straight equal 2 steps, save, a new Trainer restored from
    the checkpoint, then 2 more: the params are equal exactly."""
    batches = _batches(4)
    straight = _trainer()
    out = straight.train(iter(batches), num_steps=4, log_every=1)
    assert set(out) == {'steps', 'final_loss', 'tokens_per_second',
                        'tokens_per_second_per_device'}
    assert [s for s, _ in straight.history] == [1, 2, 3, 4]

    first = _trainer(tmp_path)
    first.train(iter(batches[:2]), num_steps=2)
    resumed = _trainer(tmp_path)
    assert resumed.state.step == 2
    resumed.train(iter(batches[2:]), num_steps=2, log_every=1)
    assert resumed.state.step == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'step_00000002', 'step_00000004']
    want = straight.state.model.state_dict()
    for name, p in resumed.state.model.state_dict().items():
        assert torch.equal(p, want[name]), name
    assert resumed.history[-1][1] == out['final_loss']


def test_unported_options_raise():
    """A mesh that is no MeshSpec is refused; a 'tensor' degree that does
    not divide the heads is refused for GPT-2 and for LoRA as for any
    model, before a process group starts (LoRA and tensor-parallel GPT-2
    under a mesh train since: tests/test_torch_mesh_lora.py and
    tests/test_torch_mesh_gpt2.py); pipeline_microbatches without a
    'stage' axis is accepted and unused, as in the JAX trainer (the mesh
    paths themselves: tests/test_torch_mesh.py and the others of
    A9.1)."""
    _, tcfg = _configs()
    cfg = tt.TrainConfig(model='llama-debug')
    with pytest.raises(TypeError, match='must be a MeshSpec'):
        tt.Trainer(dataclasses.replace(cfg, mesh=object()), tcfg,
                   device='cpu')
    for mc in (dataclasses.replace(tcfg, lora_rank=4),
               registry.get_model_config('gpt2-debug')):
        with pytest.raises(ValueError, match='tensor 3 must divide the '
                                             'heads'):
            tt.Trainer(dataclasses.replace(cfg, mesh=PortMeshSpec(
                tensor=3)), mc, device='cpu')
    tt.Trainer(dataclasses.replace(cfg, pipeline_microbatches=2), tcfg,
               device='cpu').setup()
    # LoRA, ported since, trains the adapters alone.
    lora = tt.Trainer(cfg, dataclasses.replace(tcfg, lora_rank=4),
                      device='cpu')
    lora.setup()
    names = {n for n, p in lora.state.model.named_parameters()
             if p.requires_grad}
    assert names and all('_lora.' in n for n in names)
    # GPT-2 and Mixtral, ported since, train; LoRA on Mixtral, ported
    # since, trains the attention adapters alone (the router and the
    # experts frozen).
    for name in ('gpt2-debug', 'mixtral-debug'):
        tt.Trainer(tt.TrainConfig(model=name), device='cpu').setup()
    mixtral = registry.get_model_config('mixtral-debug')
    moe_lora = tt.Trainer(tt.TrainConfig(model='mixtral-debug'),
                          dataclasses.replace(mixtral, lora_rank=4),
                          device='cpu')
    moe_lora.setup()
    names = {n for n, p in moe_lora.state.model.named_parameters()
             if p.requires_grad}
    assert len(names) == 16 and all('attn.' in n and '_lora.' in n
                                    for n in names)
    # BERT and ResNet, ported since, are no causal LMs: the JAX trainer's
    # ValueError, text for text (tests/test_model_zoo.py's refusal).
    for name in ('bert-debug', 'resnet18-debug'):
        texts = []
        for make in (lambda: jt.Trainer(jt.TrainConfig(model=name)),
                     lambda: tt.Trainer(tt.TrainConfig(model=name),
                                        device='cpu')):
            with pytest.raises(ValueError) as e:
                make()
            texts.append(str(e.value))
        assert texts[0] == texts[1] and 'not a causal-LM family' in texts[0]
    with pytest.raises(ValueError, match='not divisible'):
        tt.Trainer(dataclasses.replace(cfg, batch_size=3,
                                       grad_accum_steps=2), tcfg,
                   device='cpu')


def test_f32_master_weights_compute_in_bf16():
    """param_dtype=float32 with dtype=bfloat16: the projections are stored
    in f32, computed in bf16, and their gradients land in f32."""
    cfg = registry.get_model_config('llama-debug')    # dtype bf16
    model = llama.Llama(cfg, device='cpu', param_dtype=torch.float32)
    model.load_state_dict(convert.init_params(
        cfg, torch.Generator().manual_seed(0)))
    proj = model.layers[0].attn.q_proj
    assert proj.weight.dtype == torch.float32
    x = torch.randn(2, 8, cfg.hidden_size).to(torch.bfloat16)
    assert proj(x).dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(2, 8, seed=1))
    hidden = model(tokens[:, :-1], hidden_only=True)
    assert hidden.dtype == torch.bfloat16
    tt.chunked_cross_entropy(hidden, tt.output_projection(model),
                             tokens[:, 1:], chunk_t=8).backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    serving = llama.Llama(cfg, device='cpu')
    assert serving.layers[0].attn.q_proj.weight.dtype == torch.bfloat16


def test_synthetic_data_is_seeded():
    a = tt.synthetic_data(2, 8, 100, seed=3, device='cpu')
    b = tt.synthetic_data(2, 8, 100, seed=3, device='cpu')
    for x, y in itertools.islice(zip(a, b), 2):
        assert x['tokens'].shape == (2, 9)
        assert torch.equal(x['tokens'], y['tokens'])
        assert int(x['tokens'].max()) < 100
