"""HF-imported checkpoints at the head dims the Hopper kernels take since
they run any head dim up to 256 in a wider tile: held against the JAX
package on the CPU, in f32.  Narrow random transformers models keep the
head dims of public checkpoints -- a llama at head_dim 96 with one kv
head for two q heads (h2o-danube3-500m's 96), a mistral at 80 with a
16-token sliding window (h2o-danube-1.8b's 80 and its window), a bert at
32 (all-MiniLM-L6-v2's) -- each saved with ``save_pretrained`` and loaded
by both packages' ``load_hf_model``: the same config, logits within
1e-5, three train steps (the trainer's; BERT's task-loop step against
examples/finetune_bert.py's) within 1e-5 relative, and the same greedy
engine tokens.  On the CPU the attention is the kernels' plain version;
chip_smoke.py's head_dims phase runs the kernels at these widths."""
import dataclasses
import importlib.util
import pathlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import transformers

from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models import hf_import as jhf
from skypilot_tpu.models import list_models as jax_list_models
from skypilot_tpu.models import registry as jax_registry
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert, hf_import, list_models
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.train import tasks
from skypilot_tpu_torch.train import trainer as tt

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 on both sides: only summation order differs.
TOL_LOGITS = 1e-5        # absolute, of logits at most ~1 in size
TOL_LOSS = 1e-5          # relative, per-step loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, BERT's parameters after three steps


def _llama_d96():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=192, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False))


def _mistral_d80():
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=128, hidden_size=160, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, sliding_window=16,
        tie_word_embeddings=False))


def _bert_d32():
    return transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=128, hidden_size=96, num_hidden_layers=2,
        num_attention_heads=3, intermediate_size=192,
        max_position_embeddings=64, type_vocab_size=2))


# family -> (model constructor, seed, head dim)
FAMILIES = {'llama_d96': (_llama_d96, 0, 96),
            'mistral_d80_window16': (_mistral_d80, 1, 80),
            'bert_d32': (_bert_d32, 2, 32)}
CAUSAL = ('llama_d96', 'mistral_d80_window16')


@pytest.fixture(scope='module')
def loaded(tmp_path_factory):
    """family -> (port config, port state_dict, JAX config, JAX params),
    both from load_hf_model in f32 on one saved random checkpoint."""
    out = {}
    for fam, (make, seed, _) in FAMILIES.items():
        torch.manual_seed(seed)
        path = str(tmp_path_factory.mktemp(fam))
        make().save_pretrained(path)
        cfg, sd = hf_import.load_hf_model(path, dtype=torch.float32)
        jcfg, jparams = jhf.load_hf_model(path, dtype=jnp.float32)
        out[fam] = (cfg, sd, jcfg, jax.tree.map(np.asarray, jparams))
    return out


@pytest.mark.parametrize('family', list(FAMILIES))
def test_config_and_logits_match_jax(loaded, family):
    """The config's fields the JAX config's, head_dim among them; the
    logits (the MLM head for bert) within TOL_LOGITS of the JAX import's
    on the same tokens, past mistral's window."""
    cfg, sd, jcfg, jparams = loaded[family]
    for f in dataclasses.fields(jcfg):
        if f.name != 'dtype':
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.head_dim_ == FAMILIES[family][2]
    head = 'lm' if family in CAUSAL else 'mlm'
    model = registry.build_model(cfg, head=head, device='cpu')
    model.load_state_dict(sd)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    want = np.asarray(jax_registry.build_model(jcfg, head=head).apply(
        {'params': jparams}, jnp.asarray(tokens)))
    assert np.abs(want).max() < 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS)


@pytest.mark.parametrize('family', CAUSAL)
def test_three_train_steps_match_the_jax_trainer(loaded, family):
    """Three make_train_step steps from the imported weights against JAX
    make_train_step on a one-device mesh: loss and grad_norm each step
    within TOL_LOSS relative (seq 32 passes mistral's 16-token window)."""
    cfg, sd, jcfg, jparams = loaded[family]
    cfg_kwargs = dict(model=family, batch_size=4, seq_len=32,
                      learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(jcfg, jt.TrainConfig(**cfg_kwargs),
                                        mesh, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, jparams))
    trainer = tt.Trainer(tt.TrainConfig(**cfg_kwargs), cfg, device='cpu')
    trainer.setup(params=sd)
    jstep, step = jt.make_train_step(mesh), tt.make_train_step()
    for i in range(3):
        tokens = np.random.default_rng(20 + i).integers(
            0, cfg.vocab_size, (4, 33))
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(trainer.state, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)


@pytest.mark.parametrize('family', CAUSAL)
def test_greedy_engine_tokens_match_jax(loaded, family):
    """The dense engine over the imported weights: greedy tokens and
    finish reasons the JAX engine's, for prompts of 5-30 tokens and 12
    new ones (mistral's decode passes its window)."""
    cfg, sd, jcfg, jparams = loaded[family]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (5, 17, 30)]
    common = dict(num_slots=2, max_cache_len=64, prefill_buckets=(16, 32),
                  max_new_tokens=12)
    want = JaxEngine(jcfg, JaxInferConfig(**common,
                                          cache_dtype=jnp.float32),
                     params={'params': jparams},
                     rng=jax.random.PRNGKey(7)).generate(
        [JaxRequest(tokens=p) for p in prompts])
    got = port.InferenceEngine(
        cfg, port.InferConfig(**common, cache_dtype=torch.float32),
        params=sd, generator=torch.Generator().manual_seed(0),
        device='cpu').generate([port.Request(tokens=p) for p in prompts])
    assert [r.output_tokens for r in got] == [r.output_tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert len({t for r in got for t in r.output_tokens}) > 3


def _example(name):
    """A JAX example module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'examples' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bert_finetune_steps_match_the_example(loaded):
    """The imported encoder under a classify head drawn by the JAX init:
    three tasks.bert_step steps against examples/finetune_bert.py's step
    at its AdamW (weight decay 0.01), lr 1e-4: loss within TOL_LOSS
    relative and accuracy each step, every parameter after the third
    within TOL_PARAMS."""
    cfg, _, jcfg, jparams = loaded['bert_d32']
    example = _example('finetune_bert')
    jmodel = jax_registry.build_model(jcfg, head='classify')
    tokens = np.zeros((1, 8), np.int32)
    init = flax.linen.meta.unbox(jmodel.init(jax.random.PRNGKey(5),
                                             jnp.asarray(tokens))['params'])
    params = jax.tree.map(np.asarray, {**init, 'bert': jparams['bert']})
    sd = convert.state_dict_from_jax(params, cfg)
    lr = 1e-4
    state = tasks.bert_setup(cfg, lr, device='cpu', params=sd)
    opt = optax.adamw(lr, weight_decay=0.01)

    def loss_fn(p, toks, labels):
        logits = jmodel.apply(p, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), (jnp.argmax(logits, -1) == labels).mean()

    @jax.jit
    def jstep(p, s, batch):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, batch['tokens'], batch['labels'])
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, acc

    jp = {'params': jax.tree.map(jnp.asarray, params)}
    js = opt.init(jp)
    batches = example.synthetic_batches(np.random.default_rng(0),
                                        cfg.vocab_size, 8, 32,
                                        cfg.num_classes)
    for _ in range(3):
        batch = next(batches)
        jp, js, jloss, jacc = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        loss, acc = tasks.bert_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL_LOSS)
        assert acc.item() == float(jacc)
    want = convert.state_dict_from_jax(
        jax.tree.map(np.asarray, jp['params']), cfg)
    for key, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)


def test_list_models_matches_the_jax_registry():
    """list_models, exported from the models package as the JAX package
    exports its own: the same sorted names."""
    assert list_models() == jax_list_models()
    assert list_models() == sorted(list_models())
