"""The port's BERT (skypilot_tpu_torch/models/bert.py), its task loop
(train/tasks.py) and its HF import held against the JAX package on the
CPU, in f32, at bert-debug size: the encoder and both heads with and
without a padding mask, with type ids and out-of-range ids; the
over-long refusal; the init distributions; three fine-tuning steps
against examples/finetune_bert.py's step (AdamW, weight decay 0.01); and
transformers' BertForMaskedLM through load_hf_model against the HF
forward and the JAX import."""
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

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import hf_import as jhf
from skypilot_tpu.models import registry as jax_registry
from skypilot_tpu_torch.models import convert, hf_import, registry
from skypilot_tpu_torch.train import tasks
from skypilot_tpu_torch.train import trainer as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 on both sides; only summation order differs.
TOL_F32 = 1e-5           # absolute, logits and hidden states
TOL_LOSS = 1e-5          # relative, per-step loss
TOL_PARAMS = 1e-6        # absolute, parameters after three AdamW steps
TOL_HF = dict(atol=2e-3, rtol=1e-3)     # tests/test_hf_import.py's
HEADS = ('lm', 'mlm', 'classify')


def _configs(name='bert-debug'):
    jcfg = dataclasses.replace(jax_model_config(name), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_model_config(name),
                               dtype=torch.float32)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _jax_params(jmodel, tokens, seed=0):
    return _np_tree(flax.linen.meta.unbox(jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(tokens))['params']))


def _example(name):
    """A JAX example module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'examples' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('masked', [False, True], ids=['flash', 'masked'])
@pytest.mark.parametrize('head', HEADS)
def test_forward_matches_flax(head, masked):
    """Each head's output against the flax module's on the same weights:
    type ids of both kinds, ids past both ends of the vocabulary (wrapped
    once, then clamped, as the JAX gather), and with `masked` a padding
    mask (the plain masked path) where one row keeps 9 of 16 keys."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16))
    tokens[0, :3] = (-1, -300, 700)
    type_ids = rng.integers(0, 2, (2, 16))
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    jmodel = jax_registry.build_model(jcfg, head=head)
    params = _jax_params(jmodel, tokens)
    model = registry.build_model(tcfg, head=head, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
    args = (type_ids, mask if masked else None)
    # Jitted, as the JAX package runs it: an eager gather refuses an
    # out-of-range id.
    want = np.asarray(jax.jit(jmodel.apply)(
        {'params': params}, jnp.asarray(tokens),
        *(None if a is None else jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens),
                    *(None if a is None else torch.from_numpy(a)
                      for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_F32)


def test_bf16_flow_and_over_long_input():
    """The bf16 config's outputs take the JAX module's dtypes (the MLM
    logits f32, the encoder bf16) and stay within bf16 rounding of the
    flax module's (0.05: a few bf16 ulps of values near 1 after two
    layers; the sums run in bf16 before each f32 LayerNorm on both
    sides, in different orders); a sequence past max_seq_len raises the
    JAX module's ValueError, text for text."""
    jcfg = jax_model_config('bert-debug')
    tcfg = registry.get_model_config('bert-debug')
    tokens = np.random.default_rng(4).integers(0, 256, (2, 16))
    for head, dtype in (('lm', torch.bfloat16), ('mlm', torch.float32)):
        jmodel = jax_registry.build_model(jcfg, head=head)
        params = _jax_params(jmodel, tokens)
        model = registry.build_model(tcfg, head=head, device='cpu',
                                     param_dtype=torch.float32)
        model.load_state_dict(convert.state_dict_from_jax(params, tcfg))
        want = jmodel.apply({'params': params}, jnp.asarray(tokens))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens))
        assert got.dtype == dtype and str(want.dtype) == str(dtype)[6:]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=0.05)
    long = np.zeros((1, jcfg.max_seq_len + 1), np.int32)
    texts = []
    for run in (lambda: jmodel.apply({'params': params}, jnp.asarray(long)),
                lambda: model(torch.from_numpy(long))):
        with pytest.raises(ValueError) as e:
            run()
        texts.append(str(e.value))
    assert texts[0] == texts[1] and 'max_seq_len' in texts[0]


@pytest.mark.parametrize('head', HEADS)
def test_init_distributions(head):
    """init_params gives the flax init's tensors (names and shapes of the
    converted tree) with its distributions: kernels and tables
    normal(0.02) (mean and std per tensor), biases 0, LayerNorm scale 1 and
    bias 0."""
    jcfg, tcfg = _configs()
    tokens = np.zeros((1, 8), np.int64)
    want = convert.state_dict_from_jax(
        _jax_params(jax_registry.build_model(jcfg, head=head), tokens), tcfg)
    got = convert.init_params(tcfg, torch.Generator().manual_seed(0), head)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for key, t in got.items():
        if key.endswith('.bias'):
            assert not t.any() and not want[key].any(), key
        elif key.endswith('.scale'):
            assert torch.equal(t, torch.ones_like(t)), key
            assert torch.equal(want[key], t), key
        else:
            for w in (t, want[key]):
                n = w.numel()
                assert abs(w.mean().item()) < 5 * 0.02 / n ** 0.5, key
                assert abs(w.std().item() / 0.02 - 1) < 6 / n ** 0.5, key
    model = registry.build_model(tcfg, head=head, device='cpu')
    model.load_state_dict(got)


def _jax_finetune_step(jmodel, lr):
    """examples/finetune_bert.py's step, as its main() builds it."""
    opt = optax.adamw(lr, weight_decay=0.01)

    def loss_fn(p, tokens, labels):
        logits = jmodel.apply(p, tokens)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        acc = (jnp.argmax(logits, -1) == labels).mean()
        return loss, acc

    @jax.jit
    def step(p, s, batch):
        (loss, acc), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, batch['tokens'], batch['labels'])
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, acc

    return opt, step


def test_three_finetune_steps_match_the_example():
    """tasks.bert_step against the JAX example's step from the same
    weights and the same batches (tasks.synthetic_bert_batches, checked
    equal to the example's generator): loss and accuracy each step, every
    parameter after the third.  At the recipe's lr 2e-5 the three steps
    move the weights by up to ~6e-5, 60x TOL_PARAMS; at 1e-3 Adam's
    m / (sqrt(v) + eps) turns the float noise of a gradient near eps into
    2.8e-6 of one embedding element."""
    jcfg, tcfg = _configs()
    lr, batch_size, seq_len = 2e-5, 8, 32
    example = _example('finetune_bert')
    mine = tasks.synthetic_bert_batches(np.random.default_rng(0),
                                        tcfg.vocab_size, batch_size,
                                        seq_len, tcfg.num_classes)
    theirs = example.synthetic_batches(np.random.default_rng(0),
                                       jcfg.vocab_size, batch_size, seq_len,
                                       jcfg.num_classes)
    batches = [next(mine) for _ in range(3)]
    for b in batches:
        ref = next(theirs)
        assert all(np.array_equal(b[k], ref[k]) for k in ref)
    jmodel = jax_registry.build_model(jcfg, head='classify')
    params = _jax_params(jmodel, batches[0]['tokens'], seed=5)
    state = tasks.bert_setup(tcfg, lr, device='cpu',
                             params=convert.state_dict_from_jax(params,
                                                                tcfg))
    opt, jstep = _jax_finetune_step(jmodel, lr)
    jp = {'params': jax.tree.map(jnp.asarray, params)}
    js = opt.init(jp)
    for batch in batches:
        jp, js, jloss, jacc = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        loss, acc = tasks.bert_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL_LOSS)
        assert acc.item() == float(jacc)
    want = convert.state_dict_from_jax(_np_tree(jp['params']), tcfg)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    start = convert.state_dict_from_jax(params, tcfg)
    moved = max((p - start[key]).abs().max().item()
                for key, p in got.items())
    assert moved > 20 * TOL_PARAMS
    for key, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)


def test_finetune_loop_prints_the_example_lines(capsys):
    """finetune_bert on the CPU: the example's lines (every 10th step and
    the last, then the throughput line), the history they print, and a
    trainer that refuses the family with the JAX trainer's ValueError."""
    out = tasks.finetune_bert('bert-debug', steps=12, batch_size=4,
                              seq_len=16, device='cpu')
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in lines] == \
        ['step 0', 'step 10', 'step 11', 'done']
    assert [s for s, _, _ in out['history']] == [0, 10, 11]
    assert lines[-1].startswith('done: ') and 'sequences/s, final acc' in \
        lines[-1]
    assert out['final_acc'] == out['history'][-1][2]
    with pytest.raises(ValueError, match='not a causal-LM family'):
        tt.Trainer(tt.TrainConfig(model='bert-debug'), device='cpu')


def _hf_bert():
    torch.manual_seed(0)
    return transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2)).eval()


def test_hf_import_matches_transformers_and_the_jax_import(tmp_path):
    """load_hf_model on a saved BertForMaskedLM: the JAX config's fields,
    the JAX import's weights exactly (through state_dict_from_jax), and
    MLM logits against the HF forward and the JAX import's at
    tests/test_hf_import.py's tolerance, with and without a mask."""
    hf = _hf_bert()
    hf.save_pretrained(str(tmp_path))
    cfg, sd = hf_import.load_hf_model(str(tmp_path), dtype=torch.float32)
    jcfg = dataclasses.replace(jhf.config_from_hf(hf.config,
                                                  name=str(tmp_path)),
                               dtype=jnp.float32)
    for f in dataclasses.fields(jcfg):
        if f.name != 'dtype':
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    jparams = jhf.convert_state_dict(jcfg, hf.state_dict())
    want_sd = convert.state_dict_from_jax(jparams, cfg)
    assert sd.keys() == want_sd.keys()
    for k, v in sd.items():
        assert torch.equal(v.float(), want_sd[k]), k
    model = registry.build_model(cfg, head='mlm', device='cpu')
    model.load_state_dict(sd)
    tokens = np.random.default_rng(7).integers(0, 128, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    jmodel = jax_registry.build_model(jcfg, head='mlm')
    for m in (None, mask):
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), None,
                        None if m is None else torch.from_numpy(m)).numpy()
            want = hf(torch.from_numpy(tokens),
                      attention_mask=None if m is None
                      else torch.from_numpy(m)).logits.numpy()
        jgot = np.asarray(jmodel.apply(
            {'params': jparams}, jnp.asarray(tokens), None,
            None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, **TOL_HF)
        np.testing.assert_allclose(got, jgot, **TOL_HF)
