"""Tensor-parallel GPT-2 serving in the port (the rank-local GPT-2 of
``GPT2RankConfig``: each rank's heads of q, k and v in its fused c_attn,
H / 2 cache heads) and serving meshes with 'seq' and 'stage' ranks, held
against the JAX engine over ``tp_mesh(2)`` and the port's single-rank
engine on the CPU, in f32.  gpt2-debug's weights are drawn at std 0.2
(ten times the init's: at 0.02 its greedy streams repeat one token),
every leaf from numpy.  Also ``run(hf_model=..., tensor_parallel=2)`` on
a random HF gpt2 (read by rank 0 alone) and ``run(model='gpt2-debug',
tensor_parallel=2)``."""
import dataclasses
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import helpers_torch_dist as hd
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import gpt2 as jgpt2
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.infer import server as port_server
from skypilot_tpu_torch.models import convert, hf_import, registry
from skypilot_tpu_torch.parallel.mesh import shard_state_dict

TOL = 1e-5               # logprobs, f32 on both sides
GEOMETRY = dict(name='gpt2-debug', vocab_size=256, hidden_size=64,
                num_layers=2, num_heads=4, max_seq_len=128)
JAX_CFG = dataclasses.replace(jax_model_config('gpt2-debug'),
                              dtype=jnp.float32)
PORT_CFG = dataclasses.replace(registry.get_model_config('gpt2-debug'),
                               dtype=torch.float32)
ENGINE = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16, 32),
              max_new_tokens=8, decode_steps=4)
PROMPTS = [[(7 * j + 3 * i) % 251 + 1 for j in range(n)]
           for i, n in enumerate((3, 7, 12, 21))]
GREEDY = [dict(tokens=p, max_new_tokens=8) for p in PROMPTS]
SAMPLED = [dict(tokens=p, max_new_tokens=6, temperature=0.9)
           for p in PROMPTS[:2]]
SCORED = [dict(tokens=PROMPTS[3], max_new_tokens=3,
               want_prompt_logprobs=True)]


@pytest.fixture(scope='module')
def params():
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        jgpt2.GPT2(JAX_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda x: rng.normal(0, 0.2, x.shape).astype(
        np.float32), shapes)


def _dense(**kw):
    return {**ENGINE, 'cache_dtype': torch.float32, **kw}


def _jax(params, mesh=True, **kw):
    return JaxEngine(JAX_CFG, JaxInferConfig(
        **{**ENGINE, 'cache_dtype': jnp.float32, **kw}),
        params={'params': params}, mesh=tp_mesh(2) if mesh else None)


def _single(params, **kw):
    return port.InferenceEngine(
        PORT_CFG, port.InferConfig(**_dense(**kw)),
        params=convert.state_dict_from_jax(params, PORT_CFG),
        generator=torch.Generator().manual_seed(0), device='cpu')


def _run(eng, reqs, cls):
    return eng.generate([cls(**r) for r in reqs])


@pytest.fixture(scope='module')
def runs(params, tmp_path_factory):
    """The port's runs on 2 ranks (tensor=2) and on 4 (seq=2 x tensor=2,
    stage=2 x tensor=2), started first; the JAX TP engines meanwhile."""
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        params, PORT_CFG).items()}
    tmp = tmp_path_factory.mktemp('tp_gpt2')
    two = [hd.ServeRun('dense', 'gpt2', GEOMETRY, _dense(), sd, [
               ('generate', GREEDY), ('generate', SAMPLED), ('stats',),
               ('shard',), ('drift',), ('qkv_drift',),
               ('generate', SCORED)]),
           hd.ServeRun('chunked', 'gpt2', GEOMETRY, _dense(prefill_chunk=8),
                       sd, [('generate', GREEDY)])]
    four = [hd.ServeRun(name, 'gpt2', GEOMETRY, _dense(), sd,
                        [('generate', GREEDY), ('stats',), ('shard',)],
                        mesh=mesh)
            for name, mesh in (('seq2', dict(seq=2, tensor=2)),
                               ('stage2', dict(stage=2, tensor=2)))]
    pools = [(two, hd.Workers(hd.tp_serving, 2, tmp, two)),
             (four, hd.Workers(hd.tp_serving, 4, tmp, four))]
    eng = _jax(params)
    want = {'dense': _run(eng, GREEDY, JaxRequest),
            'scored': _run(eng, SCORED, JaxRequest),
            'stats': eng.stats(),
            'chunked': _run(_jax(params, prefill_chunk=8), GREEDY,
                            JaxRequest)}
    got = {}
    for serve_runs, w in pools:
        out = w.join()
        got.update({r.name: [rank[i] for rank in out]
                    for i, r in enumerate(serve_runs)})
    return got, want


def _same(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['tokens'] == list(w.output_tokens)
        assert g['finish'] == w.finish_reason
        np.testing.assert_allclose(g['logprobs'], w.logprobs, rtol=0,
                                   atol=tol)


def test_dense_and_chunked_tp2_give_the_jax_tp_tokens(runs, params):
    """Greedy generation of gpt2-debug at tp=2, dense and with chunked
    prefill: the JAX tp=2 engine's tokens and finish reasons exactly,
    logprobs within 1e-5, and the port's single-rank engine's; the
    streams vary (the weights' scale)."""
    got, want = runs
    dense = got['dense'][0]['values'][0]
    _same(dense, want['dense'])
    _same(got['chunked'][0]['values'][0], want['chunked'])
    _same(dense, _run(_single(params), GREEDY, port.Request))
    assert len({t for g in dense for t in g['tokens']}) > 4


def test_prompt_logprobs_under_tp(runs):
    """Prompt scoring at tp=2: the JAX tp=2 engine's prompt logprobs
    within 1e-5 and its tokens."""
    got, want = runs
    [g] = got['dense'][0]['values'][6]
    [w] = want['scored']
    assert g['tokens'] == list(w.output_tokens)
    np.testing.assert_allclose(
        np.asarray(g['prompt_logprobs'][1:], np.float64),
        np.asarray(w.prompt_logprobs[1:], np.float64), rtol=0, atol=TOL)


def test_each_rank_holds_its_heads_and_samples_alike(runs):
    """Each rank's cache holds H / 2 heads, the per-chip accounting is the
    JAX tp=2 engine's, and under temperature > 0 every rank samples the
    same token at every step."""
    got, want = runs
    ranks = got['dense']
    heads = GEOMETRY['num_heads'] // 2
    assert [r['cache_heads'] for r in ranks] == [heads] * 2
    assert ranks[0]['sampled'] == ranks[1]['sampled']
    assert ranks[0]['sampled']
    stats = ranks[0]['values'][2]
    assert stats['kv']['tp'] == want['stats']['kv']['tp'] == 2
    assert stats['kv']['bytes'] == want['stats']['kv']['bytes']


def test_shard_check_holds_the_fused_qkv_heads(runs):
    """check_shard_layout at tp=2 passes on the live engine, and raises on
    a cache leaf holding every head and on c_attn rows shifted by one
    head (the shapes unchanged: only the head check sees it)."""
    values = runs[0]['dense'][0]['values']
    report, drift, qkv = values[3], values[4], values[5]
    assert report['tensor_degree'] == 2
    assert 0 < report['param_leaves_sharded'] < report['param_leaves']
    assert drift is not None and 'cache layer 0 k' in drift
    assert qkv is not None and 'h.0.attn.c_attn.weight rows are not heads' \
        in qkv


def _without_rates(stats):
    stats = dict(stats, qos=dict(stats['qos']))
    stats['qos'].pop('service_rate_tokens_per_s')
    return stats


@pytest.mark.parametrize('axis', ['seq2', 'stage2'])
def test_seq_and_stage_ranks_serve_as_replicas(runs, axis):
    """A serving mesh of 4 ranks with seq=2 (or stage=2) x tensor=2: the
    tokens, finish reasons and logprobs of the tensor=2 mesh without the
    axis, the same stats() (but the wall-clock service rate) and
    stats()['kv']['tp'], H / 2 cache heads on every rank and a clean
    shard check: those ranks hold their tensor group's slices."""
    got, _ = runs
    ranks = got[axis]
    base = got['dense'][0]['values']
    assert ranks[0]['values'][0] == base[0]
    stats = ranks[0]['values'][1]
    assert stats['kv']['tp'] == 2
    assert _without_rates(stats) == _without_rates(base[2])
    assert [r['cache_heads'] for r in ranks] == [2] * 4
    assert ranks[0]['values'][2]['tensor_degree'] == 2


def _hf_gpt2(path):
    torch.manual_seed(0)
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4,
        n_positions=64)).save_pretrained(str(path))
    return str(path)


def test_run_serves_gpt2_over_two_ranks(tmp_path, monkeypatch):
    """run(hf_model=<gpt2>, tensor_parallel=2) on the CPU: rank 0 alone
    reads the checkpoint (moved away once rank 0 read it), rank 0's
    engine holds the tp=1 engine's weights sliced by heads, and it serves
    the tp=1 engine's greedy tokens; run(model='gpt2-debug',
    tensor_parallel=2) serves the single engine's tokens on the same
    seed-0 weights."""
    path = _hf_gpt2(tmp_path / 'gpt2')
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
            engine.generate([port.Request(tokens=prompt, max_new_tokens=6)]
                            )[0].output_tokens))

    monkeypatch.setattr(hf_import, 'load_hf_model', load_once)
    monkeypatch.setattr(port_server, 'serve', serve)
    kw = dict(device='cpu', num_slots=2, max_cache_len=64)
    port_server.run(hf_model=path, tensor_parallel=2, **kw)
    shutil.move(path + '.read', path)
    monkeypatch.setattr(hf_import, 'load_hf_model', real)
    port_server.run(hf_model=path, **kw)
    port_server.run(model='gpt2-debug', tensor_parallel=2, **kw)
    port_server.run(model='gpt2-debug', **kw)
    (got, tokens), (single, want_tokens) = seen[:2]
    want = shard_state_dict(single, 2, 0)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert got['h.0.attn.c_attn.weight'].shape[0] == 3 * 64 // 2
    assert tokens == want_tokens
    assert seen[2][1] == seen[3][1]
