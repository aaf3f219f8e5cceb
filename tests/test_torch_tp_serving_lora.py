"""Multi-LoRA serving over a 'tensor' mesh in the port (the adapter stacks
sliced with their projections, ``register_adapter`` a dispatch whose
slices rank 0 validates and scatters) held against the JAX engine over
``tp_mesh(2)`` with ``lora_rank`` and against the port's single-rank
engine, on 2 gloo ranks with the tiny f32 llama of tests/helpers_torch
(CPU): mixed base and adapter batches dense and paged (radix on),
re-registration dropping stale rows (ROADMAP C3), a non-finite adapter
in slot 0 sparing base rows (C4), the registration refusals and an
unknown adapter's error, int8 weights with an fp8 cache, sampling
identical across ranks, the shard check of the adapter leaves, and
``run(tensor_parallel=2, lora_rank=4, adapter_dir=...)`` answering
``POST /load_adapter`` with the JAX server's bodies."""
import dataclasses
import json
import threading
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from helpers_torch import (COMMON, GEOMETRY, JAX_CFG, PORT_CFG, make_params,
                           port_engine)
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.models.quantize import quantize_params
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu.train import lora as jlora
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.infer import server as port_server
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.train import lora

# f32 on both sides; adapters with B at std 0.5 move greedy tokens and
# give logprobs of a few nats, held to 1e-5 of their size.
TOL = dict(rtol=1e-5, atol=1e-6)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_max_adapters=3)
RADIX = dict(kv_block_size=8, auto_prefix_cache=True)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [1, 2, 3], [9] * 17,
           [21, 3, 44, 7, 19, 2, 60, 33, 12]]
MIXED = [dict(tokens=p, max_new_tokens=8, adapter=a)
         for p in PROMPTS for a in (None, 'a', 'b')]
SAMPLED = [dict(tokens=p, max_new_tokens=6, adapter=a, temperature=0.9)
           for p, a in zip(PROMPTS[:3], (None, 'a', 'b'))]
C3_PROMPT = [(3 * j + 7) % 97 + 1 for j in range(17)]
UNKNOWN = [dict(tokens=[1, 2], adapter='zzz')]
INT8_GEOMETRY = {**GEOMETRY, 'weight_dtype': 'int8'}
FP8 = torch.float8_e4m3fn


def _tree(seed, cfg=JAX_CFG, rank=4):
    """An adapter tree for `cfg` at `rank` with every leaf drawn with
    numpy: A at 0.02, B at 0.5."""
    cfg = dataclasses.replace(cfg, lora_rank=rank, lora_alpha=8.0)
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        JaxLlama(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(seed)
    full = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.normal(
            0, 0.5 if 'lora_b' in jax.tree_util.keystr(p) else 0.02,
            x.shape).astype(np.float32), shapes)
    return jlora.extract_adapter_tree(full)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Adapters 'a' and 'b' written by the JAX package, 'c' by the port."""
    root = tmp_path_factory.mktemp('adapters')
    jlora.save_adapter_npz(_tree(1), str(root / 'a.npz'))
    jlora.save_adapter_npz(_tree(2), str(root / 'b.npz'))
    lora.save_adapter_npz(_tree(3), str(root / 'c.npz'))
    return root


def _bad_trees(files):
    """A leaf with no target (wrong targets) and a rank mismatch."""
    tree = jlora.load_adapter_npz(str(files / 'b.npz'))
    mlp = {'layer_0': {'mlp': {'up_proj_lora': tree['layer_0']['attn'][
        'q_proj_lora']}}}
    wide = jax.tree.map(lambda x: np.concatenate([x, x], axis=-1), tree)
    return mlp, wide


def _inf_tree(files):
    good = jlora.load_adapter_npz(str(files / 'a.npz'))
    return jax.tree.map(lambda x: np.full_like(x, np.inf), good)


def _jax(params, int8=False, **kw):
    cfg = dataclasses.replace(JAX_CFG, weight_dtype='int8') if int8 \
        else JAX_CFG
    return JaxEngine(cfg, JaxInferConfig(
        **{**COMMON, 'cache_dtype': jnp.float32, **kw}),
        params={'params': params}, rng=jax.random.PRNGKey(7),
        mesh=tp_mesh(2))


def _jax_run(eng, reqs):
    return eng.generate([JaxRequest(**r) for r in reqs])


@pytest.fixture(scope='module')
def runs(params, files, tmp_path_factory):
    """The port's runs on 2 ranks, started first; the JAX TP engines
    meanwhile."""
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        params, PORT_CFG).items()}
    qparams = quantize_params(params)
    qsd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        qparams, dataclasses.replace(PORT_CFG, weight_dtype='int8')).items()}
    a, b = str(files / 'a.npz'), str(files / 'b.npz')
    mlp, wide = _bad_trees(files)
    dense = {**COMMON, 'cache_dtype': torch.float32, **LORA}
    serve_runs = [
        hd.ServeRun('dense', 'llama', GEOMETRY, dense, sd, [
            ('register', 'a', a), ('register', 'b', b),
            ('generate', MIXED), ('generate', SAMPLED),
            ('register_error', 'x', mlp), ('register_error', 'x', wide),
            ('generate', UNKNOWN), ('shard',), ('adapter_drift',),
            ('attr', 'adapters')]),
        hd.ServeRun('paged', 'llama', GEOMETRY, {**dense, **RADIX}, sd, [
            ('register', 'a', a), ('register', 'b', b),
            ('generate', MIXED),
            ('register', 't', a),
            ('generate', [dict(tokens=C3_PROMPT, max_new_tokens=8,
                               adapter='t')]),
            ('register', 't', b),
            ('generate', [dict(tokens=C3_PROMPT, max_new_tokens=8,
                               adapter='t')]),
            ('attr', 'radix_stats')], audit=True),
        hd.ServeRun('c4', 'llama', GEOMETRY, dense, sd, [
            ('register', 'bad', _inf_tree(files)), ('register', 'good', a),
            ('generate', [dict(tokens=PROMPTS[0], max_new_tokens=8,
                               adapter=x) for x in (None, 'bad', 'good')])]),
        hd.ServeRun('int8-fp8', 'llama', INT8_GEOMETRY,
                    {**dense, 'cache_dtype': FP8}, qsd, [
                        ('register', 'a', a), ('register', 'b', b),
                        ('generate', MIXED), ('shard',)]),
    ]
    workers = hd.Workers(hd.tp_serving, 2,
                         tmp_path_factory.mktemp('tp_lora'), serve_runs)
    want = {}
    eng = _jax(params, **LORA)
    for name, path in (('a', a), ('b', b)):
        eng.register_adapter(name, jlora.load_adapter_npz(path))
    want['dense'] = _jax_run(eng, MIXED)
    errors = []
    for bad in (mlp, wide):
        try:
            eng.register_adapter('x', bad)
        except (KeyError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    want['errors'] = errors
    want['unknown'] = _jax_run(eng, UNKNOWN)
    want['adapters'] = eng.adapters
    paged = _jax(params, **LORA, **RADIX)
    for name, path in (('a', a), ('b', b)):
        paged.register_adapter(name, jlora.load_adapter_npz(path))
    want['paged'] = _jax_run(paged, MIXED)
    fresh = _jax(params, **LORA, **RADIX)
    fresh.register_adapter('t', jlora.load_adapter_npz(b))
    want['c3'] = _jax_run(fresh, [dict(tokens=C3_PROMPT, max_new_tokens=8,
                                       adapter='t')])
    c4 = _jax(params, **LORA)
    c4.register_adapter('bad', _inf_tree(files))
    c4.register_adapter('good', jlora.load_adapter_npz(a))
    want['c4'] = _jax_run(c4, [dict(tokens=PROMPTS[0], max_new_tokens=8,
                                    adapter=x)
                               for x in (None, 'bad', 'good')])
    want['base'] = _jax_run(_jax(params), [dict(tokens=PROMPTS[0],
                                                max_new_tokens=8)])
    q = _jax(qparams, int8=True, **LORA, cache_dtype=jnp.float8_e4m3fn)
    for name, path in (('a', a), ('b', b)):
        q.register_adapter(name, jlora.load_adapter_npz(path))
    want['int8-fp8'] = _jax_run(q, MIXED)
    out = workers.join()
    got = {r.name: [rank[i] for rank in out]
           for i, r in enumerate(serve_runs)}
    return got, want


def _same(got, want, **tol):
    tol = tol or TOL
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['tokens'] == list(w.output_tokens)
        assert g['finish'] == w.finish_reason
        np.testing.assert_allclose(g['logprobs'], w.logprobs, **tol)


@pytest.mark.parametrize('layout', ['dense', 'paged'])
def test_mixed_batches_at_tp2_match_the_jax_tp_engine(runs, params, files,
                                                      layout):
    """Base and adapter requests in one batch at tp=2, dense and paged with
    the radix cache: the JAX tp=2 engine's tokens and finish reasons
    exactly, logprobs within 1e-5 of their size; the adapters move the
    streams; the paged pool stays conserved after every window."""
    got, want = runs
    ranks = got[layout]
    values = ranks[0]['values']
    assert values[:2] == [0, 1]
    _same(values[2], want[layout])
    assert len({tuple(v['tokens']) for v in values[2][:3]}) == 3
    assert ranks[0]['conservation'] == []
    if layout == 'dense':
        single = port_engine(params, **LORA)
        for name in ('a', 'b'):
            single.register_adapter(name, lora.load_adapter_npz(
                str(files / f'{name}.npz')))
        _same(values[2], single.generate([port.Request(**r)
                                          for r in MIXED]))


def test_sampling_under_adapters_is_identical_across_ranks(runs):
    """Temperature > 0 with adapters: every rank samples the same token at
    every step."""
    ranks = runs[0]['dense']
    assert ranks[0]['sampled'] == ranks[1]['sampled']
    assert len(ranks[0]['sampled']) > 0
    assert all(v['finish'] == 'length' for v in ranks[0]['values'][3])


def test_registration_refusals_and_unknown_adapter_match_jax(runs):
    """At tp=2 rank 0 refuses a leaf with no target and a rank mismatch
    with the JAX engine's types and texts (no worker sees the tree: the
    run goes on), a request naming an unknown adapter ends with the JAX
    engine's error, and the registered names and slots are the JAX
    engine's."""
    got, want = runs
    values = got['dense'][0]['values']
    assert [tuple(v) for v in values[4:6]] == want['errors']
    assert 'rank mismatch' in values[5][1]
    [u] = values[6]
    [w] = want['unknown']
    assert (u['finish'], u['error']) == (w.finish_reason, w.error)
    assert values[9] == want['adapters'] == {'a': 0, 'b': 1}


def test_c3_reregistration_under_tp_drops_stale_rows(runs):
    """ROADMAP C3 at tp=2: a prompt served under 't', 't' re-registered
    with other weights, the prompt served again: a fresh JAX tp=2 engine
    with the new weights' tokens, and no radix hit on the stale rows."""
    got, want = runs
    values = got['paged'][0]['values']
    assert values[3] == values[5] == 2
    _same(values[6], want['c3'])
    assert values[4][0]['tokens'] != values[6][0]['tokens']
    assert values[7]['hits'] == 0


def test_c4_nonfinite_slot_0_spares_base_rows_under_tp(runs):
    """ROADMAP C4 at tp=2: an all-inf adapter in stack slot 0 beside a good
    one; the base request in the same batch gets the JAX base engine's
    clean tokens (where the JAX LoRA engine kills it), the broken
    adapter's request ends 'error' as in JAX, the good one matches."""
    got, want = runs
    base, bad, good = got['c4'][0]['values'][2]
    jbase, jbad, jgood = want['c4']
    assert jbase.finish_reason == 'error'
    _same([base], want['base'])
    assert bad['finish'] == jbad.finish_reason == 'error'
    _same([good], [jgood])


def test_int8_fp8_adapters_under_tp(runs):
    """int8 weights, an fp8 cache and adapters at tp=2 (serve_lora.yaml's
    flags with --tensor-parallel 2): the JAX int8 fp8 tp=2 engine's
    tokens, logprobs within 1e-4."""
    got, want = runs
    values = got['int8-fp8'][0]['values']
    _same(values[2], want['int8-fp8'], rtol=0, atol=1e-4)
    assert values[3]['tensor_degree'] == 2


def test_adapter_leaves_hold_their_rank_local_shapes(runs):
    """The shard check at tp=2 passes with the adapter stacks sliced (each
    rank half of q/k/v's lora_b columns and of o_proj's lora_a rows) and
    raises on a lora_b stack planted at its full width on rank 0."""
    values = runs[0]['dense'][0]['values']
    report, drift = values[7], values[8]
    assert report['tensor_degree'] == 2
    assert report['param_leaves_sharded'] > 0
    assert drift is not None and \
        'rank 0: param layers.0.attn.q_proj_lora.lora_b' in drift


def _http(port, method, path, body=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


class _Live:
    """An InferenceServer behind its own listener on 127.0.0.1:0."""

    def __init__(self, mod, engine, **kw):
        self.srv = mod.InferenceServer(engine, **kw)
        self.srv.start()
        assert self.srv.ready.wait(120)
        self.httpd = ThreadingHTTPServer(('127.0.0.1', 0),
                                         mod._make_handler(self.srv))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.stop()


LOAD_BODIES = [{'name': 'x'}, {'name': 'x', 'path': '../a.npz'},
               {'name': 'x', 'path': 'missing.npz'},
               {'name': 'x', 'path': 'rank8.npz'},
               {'name': 'tuned', 'path': 'good.npz'}]


def test_run_tp2_answers_load_adapter_as_the_jax_server(tmp_path,
                                                        monkeypatch):
    """run(model='llama-debug', tensor_parallel=2, lora_rank=4,
    adapter_dir=...) on the CPU: POST /load_adapter answers a missing
    field, an escaping path, a missing file, a rank mismatch and a good
    adapter with the JAX server's bodies (rank 0 reads the file), and the
    loaded adapter's greedy tokens equal the single-rank engine's on the
    same seed-0 weights."""
    cfg = jax_model_config('llama-debug')
    jlora.save_adapter_npz(_tree(5, cfg), str(tmp_path / 'good.npz'))
    jlora.save_adapter_npz(_tree(6, cfg, rank=8), str(tmp_path / 'rank8.npz'))
    prompt = [5, 9, 17, 33, 2, 71, 8]
    gen = {'tokens': prompt, 'adapter': 'tuned', 'max_new_tokens': 6}
    seen = {}

    def serve(engine, adapter_dir=None, **_):
        live = _Live(port_server, engine, adapter_dir=adapter_dir)
        try:
            seen['bodies'] = [_http(live.port, 'POST', '/load_adapter', b)
                              for b in LOAD_BODIES]
            seen['tokens'] = _http(live.port, 'POST', '/generate',
                                   gen)[1]['output_tokens']
        finally:
            live.close()

    monkeypatch.setattr(port_server, 'serve', serve)
    port_server.run(model='llama-debug', device='cpu', tensor_parallel=2,
                    num_slots=2, max_cache_len=64, lora_rank=4,
                    lora_max_adapters=2, adapter_dir=str(tmp_path))
    jeng = JaxEngine(dataclasses.replace(cfg, dtype=jnp.float32),
                     JaxInferConfig(num_slots=2, max_cache_len=64,
                                    lora_rank=4, lora_max_adapters=2),
                     rng=jax.random.PRNGKey(0))
    live = _Live(jax_server, jeng, adapter_dir=str(tmp_path))
    try:
        want = [_http(live.port, 'POST', '/load_adapter', b)
                for b in LOAD_BODIES]
    finally:
        live.close()
    assert seen['bodies'] == want
    assert want[-1] == (200, {'adapter': 'tuned', 'slot': 0})
    assert 'rank mismatch' in want[3][1]['error']
    single = port.engine_from_name('llama-debug', port.InferConfig(
        model='llama-debug', num_slots=2, max_cache_len=64, lora_rank=4,
        lora_max_adapters=2), device='cpu')
    single.register_adapter('tuned', lora.load_adapter_npz(
        str(tmp_path / 'good.npz')))
    [r] = single.generate([port.Request(**gen)])
    assert seen['tokens'] == r.output_tokens
