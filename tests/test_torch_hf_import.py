"""The port's HF import (skypilot_tpu_torch/models/hf_import.py) held
against transformers and the JAX package's importer on the CPU: random
transformers models of each llama-family type (llama, llama3.1 rope
scaling, qwen2, mistral, gemma), and gpt2 and mixtral, built from a
config and saved to tmp_path; the port's logits against the HF forward and against the JAX
import at tests/test_hf_import.py's tolerance, its weights against the
JAX import's exactly; each refusal's type and text against the JAX
package's; and ``--hf-model`` with and without ``--weight-dtype int8``
through the port's ``run()`` against the JAX server's on the same
checkpoint (qwen2, and gpt2 without int8)."""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.models import hf_import as jhf
from skypilot_tpu.models import registry as jax_registry
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu_torch.infer import server as port_server
from skypilot_tpu_torch.infer.engine import Request
from skypilot_tpu_torch.models import convert, hf_import, registry
from skypilot_tpu_torch.models.llama import Llama
from skypilot_tpu_torch.parallel.mesh import shard_state_dict

TOL = dict(atol=2e-3, rtol=1e-3)     # tests/test_hf_import.py's


def _llama():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False))


def _llama31():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=True,
        rope_theta=10000.0,
        rope_scaling={'rope_type': 'llama3', 'factor': 4.0,
                      'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                      'original_max_position_embeddings': 16}))


def _qwen2():
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        tie_word_embeddings=False))


def _mistral():
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, sliding_window=8,
        tie_word_embeddings=False, attn_implementation='eager'))


def _gemma():
    hf = transformers.GemmaForCausalLM(transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, max_position_embeddings=64, rms_norm_eps=1e-6))
    # Non-zero norm weights: zeros would hide a wrong +-1 shift.
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if 'norm' in n:
                p.copy_(torch.randn_like(p) * 0.1)
    return hf


# family -> (model constructor, seed, tokens shape): the sequences of
# tests/test_hf_import.py (llama3.1 scores 3x its original window;
# mistral's 12 tokens pass its 8-token band).
FAMILIES = {'llama': (_llama, 0, (2, 12)), 'llama3.1': (_llama31, 4, (1, 48)),
            'qwen2': (_qwen2, 6, (2, 12)), 'mistral': (_mistral, 21, (2, 12)),
            'gemma': (_gemma, 9, (2, 12))}


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """family -> (directory, the HF model in eval mode)."""
    out = {}
    for fam, (make, seed, _) in FAMILIES.items():
        torch.manual_seed(seed)
        hf = make().eval()
        path = tmp_path_factory.mktemp(fam.replace('.', '_'))
        hf.save_pretrained(str(path))
        out[fam] = (str(path), hf)
    return out


@pytest.mark.parametrize('family', list(FAMILIES))
def test_logits_match_hf_and_the_jax_import(checkpoints, family):
    """load_hf_model's f32 model: logits against the HF forward and the
    JAX import's; weights exactly the JAX import's, mapped through
    convert.state_dict_from_jax; the config's fields the JAX config's."""
    path, hf = checkpoints[family]
    _, _, shape = FAMILIES[family]
    cfg, sd = hf_import.load_hf_model(path, dtype=torch.float32)
    jcfg = dataclasses.replace(jhf.config_from_hf(hf.config, name=path),
                               dtype=jnp.float32)
    for f in dataclasses.fields(cfg):
        if f.name != 'dtype':
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    jparams = jhf.convert_state_dict(jcfg, hf.state_dict())
    want_sd = convert.state_dict_from_jax(jparams, cfg)
    assert sd.keys() == want_sd.keys()
    for k, v in sd.items():
        assert torch.equal(v.float(), want_sd[k]), k
    model = Llama(cfg, device='cpu')
    model.load_state_dict(sd)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, cfg.vocab_size, size=shape).astype(np.int64)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jgot = np.asarray(JaxLlama(jcfg).apply({'params': jparams},
                                           jnp.asarray(tokens)))
    np.testing.assert_allclose(got, jgot, **TOL)


def test_bf16_conversion_keeps_f32_norms(checkpoints):
    """param_dtype bf16 (the server's): weights in bf16, norm scales f32
    after the bf16 round (as the JAX importer), the same values as the
    JAX import's bf16 tree."""
    path, hf = checkpoints['llama']
    cfg = hf_import.config_from_hf(hf.config)
    sd = hf_import.convert_state_dict(cfg, hf.state_dict(),
                                      param_dtype=torch.bfloat16)
    jparams = jhf.convert_state_dict(jhf.config_from_hf(hf.config),
                                     hf.state_dict(),
                                     param_dtype=jnp.bfloat16)
    assert sd['embedding'].dtype == torch.bfloat16
    assert sd['layers.0.mlp.gate_proj.weight'].dtype == torch.bfloat16
    assert sd['final_norm.scale'].dtype == torch.float32
    want = convert.state_dict_from_jax(jparams, cfg)
    for k, v in sd.items():
        assert torch.equal(v.float(), want[k]), k


def _both(fn):
    """(type, text) of what fn raises with each package's importer."""
    out = []
    for mod in (hf_import, jhf):
        with pytest.raises(Exception) as e:
            fn(mod)
        out.append((type(e.value), str(e.value)))
    return out


@pytest.mark.parametrize('case', ['rope_linear', 'qwen2_window',
                                  'gemma_act', 'unknown_type',
                                  'unknown_config', 'unconverted'])
def test_refusals_match_the_jax_package(case):
    """Each refusal of the JAX importer, with its type and text."""
    small = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=1, num_attention_heads=2,
                 num_key_value_heads=2)
    if case == 'unconverted':
        torch.manual_seed(0)
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **small, attention_bias=True))
        mine, ref = _both(lambda m: m.convert_state_dict(
            m.config_from_hf(hf.config), hf.state_dict()))
        loose = hf_import.convert_state_dict(
            hf_import.config_from_hf(hf.config), hf.state_dict(),
            strict=False)
        assert 'layers.0.attn.q_proj.weight' in loose
    elif case == 'unknown_config':
        mine, ref = _both(lambda m: m.convert_state_dict(object(), {}))
        assert 'no HF converter' in mine[1]
    else:
        hf_cfg = {
            'rope_linear': lambda: transformers.LlamaConfig(
                **small, rope_scaling={'rope_type': 'linear',
                                       'factor': 2.0}),
            'qwen2_window': lambda: transformers.Qwen2Config(
                **small, use_sliding_window=True, sliding_window=16,
                max_window_layers=0),
            'gemma_act': lambda: transformers.GemmaConfig(
                **small, head_dim=16, hidden_activation='relu'),
            'unknown_type': lambda: transformers.T5Config(),
        }[case]()
        mine, ref = _both(lambda m: m.config_from_hf(hf_cfg))
    if case == 'unknown_config':
        assert mine[0] is ref[0] is ValueError
        assert mine[1].split(';')[0] == ref[1].split(';')[0]
    else:
        assert mine == ref


def _gpt2(**kw):
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        **{'vocab_size': 128, 'n_embd': 64, 'n_layer': 2, 'n_head': 4,
           'n_positions': 64, **kw}))


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-5))


def _bert():
    return transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2))


@pytest.mark.parametrize('family', ['gpt2', 'mixtral', 'bert'])
def test_other_families_name_their_item(family, tmp_path):
    """gpt2, mixtral and bert, ported since, load as the llama family
    does: tests/test_hf_import.py's models, saved to tmp_path, give the
    JAX import's config (mixtral's drop-free capacity E/k) and weights
    exactly, and logits against the HF forward and the JAX import's at
    the file's tolerance (bert: the MLM head's)."""
    torch.manual_seed(0)
    hf = {'gpt2': _gpt2, 'mixtral': _mixtral, 'bert': _bert}[family]().eval()
    hf.save_pretrained(str(tmp_path))
    cfg, sd = hf_import.load_hf_model(str(tmp_path), dtype=torch.float32)
    jcfg = dataclasses.replace(jhf.config_from_hf(hf.config,
                                                  name=str(tmp_path)),
                               dtype=jnp.float32)
    for f in dataclasses.fields(jcfg):
        if f.name != 'dtype':
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    if family == 'mixtral':
        assert cfg.capacity_factor == 2.0
    jparams = jhf.convert_state_dict(jcfg, hf.state_dict())
    want_sd = convert.state_dict_from_jax(jparams, cfg)
    assert sd.keys() == want_sd.keys()
    for k, v in sd.items():
        assert torch.equal(v.float(), want_sd[k]), k
    head = 'mlm' if family == 'bert' else 'lm'
    model = registry.build_model(cfg, head=head, device='cpu')
    model.load_state_dict(sd)
    tokens = np.random.RandomState(7).randint(0, 128, size=(2, 12))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jmodel = jax_registry.build_model(jcfg, head=head)
    jgot = np.asarray(jmodel.apply({'params': jparams}, jnp.asarray(tokens)))
    np.testing.assert_allclose(got, jgot, **TOL)


def _run_both(monkeypatch, path, **kw):
    """The engines that the port's and the JAX server's run() build for
    the same flags (serve() replaced by a capture)."""
    engines = []
    for mod in (port_server, jax_server):
        monkeypatch.setattr(mod, 'serve',
                            lambda engine, **_: engines.append(engine))
    port_server.run(hf_model=path, device='cpu', num_slots=2,
                    max_cache_len=64, **kw)
    jax_server.run(hf_model=path, num_slots=2, max_cache_len=64, **kw)
    return engines


@pytest.mark.parametrize('weight_dtype', ['bf16', 'int8'])
def test_hf_model_through_run_matches_the_jax_server(checkpoints,
                                                     monkeypatch, capsys,
                                                     weight_dtype):
    """``run(hf_model=...)`` on a checkpoint without tokenizer files: both
    servers warn and serve token-only; the port's engine holds the JAX
    engine's weights bit for bit (bf16, or int8 bytes and scales) under
    the same config, and both serve the same greedy tokens."""
    path, _ = checkpoints['qwen2']
    mine, ref = _run_both(monkeypatch, path, weight_dtype=weight_dtype)
    warnings = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith('warning: no tokenizer')]
    assert len(warnings) == 2
    assert mine.model_config.weight_dtype == weight_dtype
    assert mine.model_config.name == ref.model_config.name == path
    want = convert.state_dict_from_jax(
        jax_server_params(ref), mine.model_config)
    got = mine.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v.to(want[k].dtype), want[k]), k
    if weight_dtype == 'int8':
        assert got['layers.0.attn.q_proj.weight_q'].dtype == torch.int8
    prompt = [5, 9, 17, 33, 2, 71, 8]
    [a] = mine.generate([Request(tokens=prompt, max_new_tokens=6)])
    [b] = ref.generate([jax_server.Request(tokens=prompt,
                                           max_new_tokens=6)])
    assert a.output_tokens == b.output_tokens


@pytest.mark.parametrize('weight_dtype', ['bf16', 'int8'])
def test_hf_model_through_run_at_tp2_is_read_by_rank_0_alone(
        checkpoints, monkeypatch, tmp_path, weight_dtype):
    """``run(hf_model=..., tensor_parallel=2)`` on the CPU: rank 0 alone
    reads the checkpoint (it is moved away as soon as rank 0 has read it,
    so a rank that read it too would fail), rank 0's engine holds the
    tp=1 engine's weights sliced (bf16, or int8 bytes and scales), and it
    serves the tp=1 engine's greedy tokens."""
    src, _ = checkpoints['qwen2']
    path = str(tmp_path / 'qwen2')
    shutil.copytree(src, path)
    real = hf_import.load_hf_model
    prompt = [5, 9, 17, 33, 2, 71, 8]
    seen = []

    def load_once(name, **kw):
        out = real(name, **kw)
        shutil.move(path, path + '.read')
        return out

    def serve(engine, **_):
        seen.append((
            {k: v.clone() for k, v in engine.model.state_dict().items()},
            engine.generate([Request(tokens=prompt, max_new_tokens=6)]
                            )[0].output_tokens))

    monkeypatch.setattr(hf_import, 'load_hf_model', load_once)
    monkeypatch.setattr(port_server, 'serve', serve)
    kw = dict(device='cpu', num_slots=2, max_cache_len=64,
              weight_dtype=weight_dtype)
    port_server.run(hf_model=path, tensor_parallel=2, **kw)
    shutil.move(path + '.read', path)
    monkeypatch.setattr(hf_import, 'load_hf_model', real)
    port_server.run(hf_model=path, **kw)
    (got, tokens), (single, want_tokens) = seen
    want = shard_state_dict(single, 2, 0)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert got['layers.0.attn.q_proj.bias'].shape[0] == \
        single['layers.0.attn.q_proj.bias'].shape[0] // 2
    assert tokens == want_tokens


def jax_server_params(engine):
    """The JAX engine's params['params'] as numpy (bf16 leaves as f32)."""
    import jax
    return jax.tree.map(
        lambda x: np.asarray(x, np.int8 if x.dtype == jnp.int8
                             else np.float32), engine.params['params'])


def test_run_refusals(checkpoints, tmp_path, monkeypatch):
    """An explicit tokenizer that fails still raises, as the JAX server's
    does; a checkpoint that is no causal LM gets the JAX server's
    ValueError before any weight is read; --weight-dtype int8 on a gpt2
    checkpoint gets the JAX server's ValueError, and without it run()
    serves the checkpoint with the JAX server's weights and tokens (and
    at --tensor-parallel 2 since: tests/test_torch_tp_serving_gpt2.py)."""
    path, _ = checkpoints['llama']
    raised = []
    for mod, kw in ((port_server, {'device': 'cpu'}), (jax_server, {})):
        monkeypatch.setattr(mod, 'serve', lambda engine, **_: None)
        with pytest.raises(Exception) as e:
            mod.run(hf_model=path, tokenizer_name=path, max_cache_len=64,
                    **kw)
        raised.append(type(e.value))
    assert raised[0] is raised[1]
    bert = tmp_path / 'bert'
    transformers.BertConfig(num_hidden_layers=1).save_pretrained(str(bert))
    texts = []
    for mod, kw in ((port_server, {'device': 'cpu'}), (jax_server, {})):
        with pytest.raises(ValueError) as e:
            mod.run(hf_model=str(bert), **kw)
        texts.append(str(e.value))
    assert texts[0] == texts[1] and 'bert' in texts[0]
    gpt2 = tmp_path / 'gpt2'
    torch.manual_seed(0)
    _gpt2(n_layer=1).save_pretrained(str(gpt2))
    texts = []
    for mod, kw in ((port_server, {'device': 'cpu'}), (jax_server, {})):
        with pytest.raises(ValueError) as e:
            mod.run(hf_model=str(gpt2), weight_dtype='int8',
                    max_cache_len=64, **kw)
        texts.append(str(e.value))
    assert texts[0] == texts[1] and 'GPT2Config' in texts[0]
    # GPT-2, ported since: run() serves the checkpoint as the JAX server
    # does, the same bf16 weights and greedy tokens.
    mine, ref = _run_both(monkeypatch, str(gpt2))
    want = convert.state_dict_from_jax(jax_server_params(ref),
                                       mine.model_config)
    got = mine.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v.to(want[k].dtype), want[k]), k
    prompt = [5, 9, 17, 33, 2, 71, 8]
    [a] = mine.generate([Request(tokens=prompt, max_new_tokens=6)])
    [b] = ref.generate([jax_server.Request(tokens=prompt,
                                           max_new_tokens=6)])
    assert a.output_tokens == b.output_tokens
