"""LoRA training under a mesh in the port (the trainer's frozen base over
FSDP2, the adapters placed with their projections over 'tensor') held
against the JAX package on the CPU, in f32: three steps of
``Trainer`` over 2 and 4 gloo ranks at fsdp=2, fsdp=2 x tensor=2 (every
projection adapted), data=2 x fsdp=2 (gradient accumulation 2) and
Mixtral at fsdp=2, against JAX ``make_train_step(trainable=
lora.is_lora_path)`` on a mesh of the same shape from jax.devices()[:n];
a LoRA resume from fsdp=2 x tensor=2 to data=2 x fsdp=2; and
``examples/finetune_llama31_torch.py`` over 2 ranks from a random HF
checkpoint, stopped after two steps and resumed, against a straight
run."""
import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import mixtral as jmix
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.train import lora

TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_ADAPTERS = 1e-5      # absolute, adapters after three steps
TRAIN = dict(batch_size=8, seq_len=32, learning_rate=1e-2, warmup_steps=1,
             total_steps=10)
LORA = dict(lora_rank=4, lora_alpha=8.0)
ALL_TARGETS = dict(LORA, lora_targets=('q_proj', 'k_proj', 'v_proj',
                                       'o_proj', 'gate_proj', 'up_proj',
                                       'down_proj'))
# (name, ranks, (model, overrides), mesh, grad accumulation, resume mesh
# for step 3).  The resume leg is held against the JAX leg of its first
# mesh.
LEGS = [
    ('lora-fsdp2', 2, ('llama-debug', LORA), dict(fsdp=2), 1, None),
    ('lora-fsdp2-tensor2', 4, ('llama-debug', ALL_TARGETS),
     dict(fsdp=2, tensor=2), 1, None),
    ('lora-data2-fsdp2-accum2', 4, ('llama-debug', LORA),
     dict(data=2, fsdp=2), 2, None),
    ('mixtral-lora-fsdp2', 2, ('mixtral-debug', LORA), dict(fsdp=2), 1,
     None),
    ('lora-resume-fsdp2-tensor2-to-data2-fsdp2', 4,
     ('llama-debug', ALL_TARGETS), dict(fsdp=2, tensor=2), 1,
     dict(data=2, fsdp=2)),
]


def _configs(model, overrides):
    jcfg = dataclasses.replace(jax_model_config(model), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(registry.get_model_config(model),
                               dtype=torch.float32, **overrides)
    return jcfg, tcfg


def _random_params(jcfg, seed):
    """The flax tree's shapes, every leaf drawn with numpy (lora_b at 0.05,
    so the adapters' delta is not zero)."""
    module = jmix.Mixtral if hasattr(jcfg, 'num_experts') else JaxLlama
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        module(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(
            0, 0.05 if 'lora_b' in jax.tree_util.keystr(path) else 0.02,
            x.shape).astype(np.float32), shapes)


def _jax_leg(jcfg, params, spec, batches, accum, n):
    """Three frozen-base JAX steps on a mesh of `spec` over
    jax.devices()[:n] from `params`: each step's loss and grad_norm, and
    the final params."""
    mesh = jm.make_mesh(jm.MeshSpec(**spec), devices=jax.devices()[:n])
    state, _ = jt.create_sharded_state(
        jcfg, jt.TrainConfig(**TRAIN, grad_accum_steps=accum), mesh,
        jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree.map(
        lambda a, x: jax.device_put(a, x.sharding), params, state.params))
    step = jt.make_train_step(mesh, grad_accum_steps=accum,
                              trainable=jlora.is_lora_path)
    losses, norms = [], []
    with mesh:
        for tokens in batches:
            state, m = step(state, {'tokens': jnp.asarray(tokens)})
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
    final = jax.tree.map(lambda x: np.array(x, np.float32), state.params)
    return losses, norms, final


@pytest.fixture(scope='module')
def legs(tmp_path_factory, twin):
    """Every leg on the port's ranks (2 and 4 at once, after the twin's
    runs started) while the JAX legs run here."""
    tmp = tmp_path_factory.mktemp('mesh_lora')
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, (TRAIN['batch_size'],
                                     TRAIN['seq_len'] + 1))
               for _ in range(3)]
    inputs = {}
    for name, _, (model, overrides), *_ in LEGS:
        jcfg, tcfg = _configs(model, overrides)
        params = _random_params(jcfg, seed=8)
        sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
            params, tcfg).items()}
        inputs[name] = (jcfg, tcfg, params, sd)
    workers = {}
    for world in (2, 4):
        port_legs = [hd.TrainLeg(
            name=name, mesh=spec, model=m, overrides=o,
            train={**TRAIN, 'grad_accum_steps': accum},
            params=inputs[name][3], batches=batches,
            ckpt=str(tmp / name) if resume else '',
            resume_at=2 if resume else 0, resume_mesh=resume)
            for name, n, (m, o), spec, accum, resume in LEGS if n == world]
        workers[world] = (port_legs, hd.Workers(hd.trainer_legs, world, tmp,
                                                port_legs))
    want = {name: _jax_leg(*inputs[name][::2], spec, batches, accum, n)
            for name, n, _, spec, accum, resume in LEGS if resume is None}
    got = {}
    for world, (port_legs, w) in workers.items():
        ranks = w.join()
        for i, leg in enumerate(port_legs):
            got[leg.name] = {**ranks[0][i],
                             'loads': [r[i]['loads'] for r in ranks]}
    return got, want, inputs


@pytest.mark.parametrize('name', [leg[0] for leg in LEGS])
def test_lora_on_a_mesh_matches_jax(legs, name):
    """Loss and grad_norm of each of 3 steps within 1e-5 relative and the
    adapters within 1e-5 after them, against the JAX frozen-base step on a
    mesh of the same shape; the base bit-identical to where it started;
    Adam moments for exactly the adapters' parameters (two each); the
    resume leg's third step ran in a second Trainer on another mesh, from
    the first's checkpoint, which rank 0 alone read."""
    got, want, inputs = legs
    g = got[name]
    jl, jn, jp = want['lora-fsdp2-tensor2' if 'resume' in name else name]
    _, tcfg, _, sd = inputs[name]
    np.testing.assert_allclose(g['loss'], jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(g['grad_norm'], jn, rtol=TOL_LOSS)
    ref = convert.state_dict_from_jax(jp, tcfg)
    assert g['params'].keys() == ref.keys() == sd.keys()
    moved = 0
    for key, p in g['params'].items():
        if lora.is_lora_path(key):
            np.testing.assert_allclose(p, ref[key].numpy(), rtol=0,
                                       atol=TOL_ADAPTERS, err_msg=key)
            moved += not np.array_equal(p, sd[key])
        else:
            assert np.array_equal(p, sd[key]), key
    assert moved > 0
    assert g['moments'] == 2 * lora.num_adapter_params(sd)
    if 'resume' in name:
        assert g['loads'] == [1, 0, 0, 0]


def _hf_llama(path):
    """A random LlamaForCausalLM written with save_pretrained (f32, 2
    layers, 64 wide, 4:2 heads, vocab 256)."""
    import transformers
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False)
    transformers.LlamaForCausalLM(cfg).save_pretrained(str(path))
    return path


@pytest.fixture(scope='module')
def twin(tmp_path_factory):
    """examples/finetune_llama31_torch.py over 2 gloo ranks (LORA_RANK=4,
    from a random HF llama): 4 steps straight in one pool, and 2 steps, a
    stop and a resume to 4 in another, both started here and joined by
    the test (they run while the legs do)."""
    tmp = tmp_path_factory.mktemp('twin')
    hf = _hf_llama(tmp / 'hf')
    argv = ['--device', 'cpu', '--batch-size', '4', '--seq-len', '32',
            '--grad-accum', '2', '--checkpoint-every', '1']

    def run(ckpt, steps):
        return {'env': {'HF_MODEL_DIR': str(hf), 'CHECKPOINT_DIR': ckpt,
                        'STEPS': str(steps), 'LORA_RANK': '4'},
                'argv': argv}

    straight, stopped = str(tmp / 'straight'), str(tmp / 'stopped')
    pools = [hd.Workers(hd.finetune_example, 2, tmp, [run(straight, 4)]),
             hd.Workers(hd.finetune_example, 2, tmp,
                        [run(stopped, 2), run(stopped, 4)])]
    return hf, straight, stopped, pools


def test_finetune_twin_resumes_as_it_ran_straight(twin):
    """The twin's stopped-and-resumed run ends at the straight run's step
    with the same model (the grafted HF base, unchanged, and the
    adapters) and the same optimizer state, bit for bit; the fresh run
    grafted the checkpoint's weights over the trainer's drawn base."""
    hf, straight, stopped, pools = twin
    assert pools[0].join() == [[4]] * 2
    assert pools[1].join() == [[2, 4]] * 2
    a = torch.load(os.path.join(straight, 'step_00000004', 'state.pt'),
                   weights_only=True)
    b = torch.load(os.path.join(stopped, 'step_00000004', 'state.pt'),
                   weights_only=True)
    assert a['model'].keys() == b['model'].keys()
    for key, v in a['model'].items():
        assert torch.equal(v, b['model'][key]), key
    for i, st in a['optimizer']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, b['optimizer']['state'][i][k]), (i, k)
    import transformers
    base = transformers.LlamaForCausalLM.from_pretrained(str(hf))
    assert torch.equal(a['model']['layers.0.attn.q_proj.weight'],
                       base.model.layers[0].self_attn.q_proj.weight)
    assert any(lora.is_lora_path(k) for k in a['model'])
