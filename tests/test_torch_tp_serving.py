"""Tensor-parallel serving in the port (infer/tp.py, the engine over a
'tensor' mesh) held against the JAX package's TP engine on the CPU: the
tiny f32 llama of tests/test_tp_paged.py (vocab 101, 32 wide, 4:2 heads,
2 layers) on 2 gloo ranks against the JAX engine over ``tp_mesh(2)`` on
the conftest's virtual devices and against the port's single-rank
engine.  Dense layout: offline generation (greedy and sampled), the
per-chip accounting, the shard-layout check, a registered prefix, the
fp8 cache, speculation and int8 weights; and the kv-heads refusal the
JAX engine makes."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from helpers_torch import (COMMON, GEOMETRY, JAX_CFG, PORT_CFG, make_params,
                           port_engine)
from skypilot_tpu.analysis import sanitizers as jax_sanitizers
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models.quantize import quantize_params
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.registry import get_model_config
from skypilot_tpu_torch.parallel.mesh import shard_state_dict

# f32 on both sides; the tensor split sums the attention and MLP outputs
# of two ranks, another summation order than one rank's.
TOL = 1e-5
PREFIX = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20]
GREEDY = [dict(tokens=[4, 5, 6, 7], max_new_tokens=6),
          dict(tokens=[9, 10, 11], max_new_tokens=8),
          dict(tokens=[(3 * j) % 97 + 1 for j in range(20)],
               max_new_tokens=5),
          dict(tokens=[2, 7, 1, 8, 2, 8, 1, 8], max_new_tokens=7)]
SAMPLED = [dict(tokens=[4, 5, 6, 7], max_new_tokens=6, temperature=0.8),
           dict(tokens=[9, 10, 11], max_new_tokens=8, temperature=1.3)]
PREFIXED = [dict(tokens=PREFIX + [40 + i], max_new_tokens=6)
            for i in range(3)] + [dict(tokens=[5, 6], max_new_tokens=4)]
# Repetitive prompts: prompt lookup drafts; the first ends where this
# model's greedy stream of GREEDY[0] settles into repeating 52, so the
# verify accepts.
SPEC = [dict(tokens=[4, 5, 6, 7, 63, 69, 77, 52, 52], max_new_tokens=8),
        dict(tokens=[7, 8, 9, 7, 8, 9, 7, 8], max_new_tokens=8)]
FP8 = torch.float8_e4m3fn
INT8_GEOMETRY = {**GEOMETRY, 'weight_dtype': 'int8'}
JAX_CFG8 = dataclasses.replace(JAX_CFG, weight_dtype='int8')


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax(params, mesh=True, int8=False, **overrides):
    kw = {**COMMON, 'cache_dtype': jnp.float32, **overrides}
    return JaxEngine(JAX_CFG8 if int8 else JAX_CFG, JaxInferConfig(**kw),
                     params={'params': params}, rng=jax.random.PRNGKey(7),
                     mesh=tp_mesh(2) if mesh else None)


def _jax_run(eng, reqs):
    return eng.generate([JaxRequest(**r) for r in reqs])


def _jax_shards(eng):
    """Each tensor rank's shard of the JAX TP engine's params, as numpy
    trees (the device at that rank's place on the mesh)."""
    devices = list(np.asarray(eng._mesh.devices).flat)
    return [jax.tree.map(lambda x, d=d: np.asarray(next(
        s.data for s in x.addressable_shards if s.device == d)),
        eng.params['params']) for d in devices]


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def runs(params, tmp_path_factory):
    """The port's TP runs on 2 ranks, started first; the JAX TP engines
    meanwhile."""
    sd = _np(convert.state_dict_from_jax(params, PORT_CFG))
    qparams = quantize_params(params)
    dense = {**COMMON, 'cache_dtype': torch.float32}
    serve_runs = [
        hd.ServeRun('dense', 'llama', GEOMETRY, dense, sd, [
            ('generate', GREEDY), ('generate', SAMPLED), ('stats',),
            ('kv_health',), ('shard',), ('drift',),
            ('register_prefix', PREFIX), ('generate', PREFIXED),
            ('attr', 'prefix_stats')]),
        hd.ServeRun('fp8', 'llama', GEOMETRY, {**dense, 'cache_dtype': FP8},
                    sd, [('generate', GREEDY), ('stats',)]),
        hd.ServeRun('spec', 'llama', GEOMETRY, {**dense, 'draft_len': 3},
                    sd, [('generate', SPEC[:1]), ('generate', SPEC[1:]),
                         ('attr', 'spec_stats')]),
        hd.ServeRun('int8', 'llama', INT8_GEOMETRY, dense, _np(
            convert.state_dict_from_jax(qparams, dataclasses.replace(
                PORT_CFG, weight_dtype='int8'))),
                    [('generate', GREEDY), ('shard',)]),
    ]
    workers = hd.Workers(hd.tp_serving, 2,
                         tmp_path_factory.mktemp('tp_serving'), serve_runs)
    jax_out = {}
    eng = _jax(params)
    jax_out['shards'] = _jax_shards(eng)
    jax_out['dense'] = _jax_run(eng, GREEDY)
    jax_out['stats'] = eng.stats()
    jax_out['kv_health'] = eng.kv_health()
    jax_out['shard'] = jax_sanitizers.check_shard_layout(eng)
    eng.register_prefix(PREFIX)
    jax_out['prefixed'] = _jax_run(eng, PREFIXED)
    jax_out['prefix_stats'] = dict(eng.prefix_stats)
    single = _jax(params, mesh=False)
    jax_out['single_stats'] = single.stats()
    jax_out['fp8'] = _jax_run(_jax(params, cache_dtype=jnp.float8_e4m3fn),
                              GREEDY)
    spec = _jax(params, draft_len=3)
    jax_out['spec'] = _jax_run(spec, SPEC[:1]) + _jax_run(spec, SPEC[1:])
    jax_out['spec_stats'] = dict(spec.spec_stats)
    int8 = _jax(qparams, int8=True)
    jax_out['int8'] = _jax_run(int8, GREEDY)
    jax_out['int8_shards'] = _jax_shards(int8)
    out = workers.join()
    return {'port': {r.name: [rank[i] for rank in out]
                     for i, r in enumerate(serve_runs)},
            'jax': jax_out}


@pytest.fixture(scope='module')
def protocol(params, tmp_path_factory):
    """``helpers_torch_dist.tp_protocol`` on 2 ranks (a pool of its own:
    the control group is made first there)."""
    sd = _np(convert.state_dict_from_jax(params, PORT_CFG))
    run = hd.ServeRun('protocol', 'llama', GEOMETRY,
                      {**COMMON, 'cache_dtype': torch.float32}, sd, [])
    return hd.Workers(hd.tp_protocol, 2,
                      tmp_path_factory.mktemp('tp_protocol'), run, 4.0,
                      1.5).join()


def _same(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['tokens'] == list(w.output_tokens)
        assert g['finish'] == w.finish_reason
        np.testing.assert_allclose(g['logprobs'], w.logprobs, rtol=0,
                                   atol=tol)


def test_dense_tp2_gives_the_jax_tp_and_single_engine_tokens(runs, params):
    """Greedy offline generation on a tp=2 port engine: the JAX tp=2
    engine's tokens and finish reasons exactly, logprobs within 1e-5;
    and the port's single-rank engine's."""
    got = runs['port']['dense'][0]['values'][0]
    _same(got, runs['jax']['dense'])
    single = port_engine(params).generate(
        [port.Request(**r) for r in GREEDY])
    _same(got, single)


@pytest.mark.parametrize('int8', [False, True], ids=['f32', 'int8'])
def test_rank_slices_are_the_jax_engines_shards(runs, params, int8):
    """shard_state_dict of the full state_dict, rank by rank, equals the
    JAX TP engine's shard on that rank's device through
    state_dict_from_jax: the same rules table and the same replication
    of a dim the degree does not divide (_fit_sharding).  int8: the
    int8 kernel sliced as its float kernel, the scale sliced for the
    column-parallel projections and whole for o_proj and down_proj."""
    cfg = dataclasses.replace(PORT_CFG, weight_dtype='int8') if int8 \
        else PORT_CFG
    full = convert.state_dict_from_jax(
        quantize_params(params) if int8 else params, cfg)
    shards = runs['jax']['int8_shards' if int8 else 'shards']
    for rank, tree in enumerate(shards):
        want = convert.state_dict_from_jax(tree, cfg)
        got = shard_state_dict(full, 2, rank)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert torch.equal(v, want[k]), (rank, k)
    scale = [got[f'layers.0.{n}.scale'].shape[0] for n in (
        'attn.q_proj', 'attn.o_proj', 'mlp.gate_proj', 'mlp.down_proj')] \
        if int8 else None
    assert scale in (None, [32 // 2, 32, 64 // 2, 32])


def test_sampling_is_identical_across_ranks(runs, params):
    """Temperature > 0: every rank samples the same token at every step
    (identically seeded generators on logits gathered whole), and the
    stream equals the single-rank engine's from the same seed after the
    same dispatches (each draws noise for every row it samples)."""
    ranks = runs['port']['dense']
    assert ranks[0]['sampled'] == ranks[1]['sampled']
    assert len(ranks[0]['sampled']) > 0
    got = ranks[0]['values'][1]
    single = port_engine(params)
    single.generate([port.Request(**r) for r in GREEDY])
    _same(got, single.generate([port.Request(**r) for r in SAMPLED]))


def test_each_rank_holds_half_the_kv_heads(runs):
    """Every run's cache holds Hkv / 2 kv heads on each rank."""
    for name, ranks in runs['port'].items():
        assert [r['cache_heads'] for r in ranks] == \
            [GEOMETRY['num_kv_heads'] // 2] * 2, name


def test_per_chip_accounting_matches_the_jax_engine(runs):
    """kv_health()['tp'], stats()['kv']['tp'] and the per-chip bytes
    equal the JAX tp=2 engine's (per_chip = total // 2), and half the
    single-chip engine's per-chip bytes."""
    values = runs['port']['dense'][0]['values']
    stats, health = values[2], values[3]
    want = runs['jax']['stats']
    assert health['tp'] == runs['jax']['kv_health']['tp'] == 2
    assert stats['kv']['tp'] == want['kv']['tp'] == 2
    assert stats['kv']['bytes'] == want['kv']['bytes']
    b = stats['kv']['bytes']
    assert b['per_chip_total'] == b['total'] // 2
    assert b['per_chip_resident'] == b['resident'] // 2
    single = runs['jax']['single_stats']['kv']['bytes']
    assert b['per_chip_total'] * 2 == single['per_chip_total']
    fp8 = runs['port']['fp8'][0]['values'][1]['kv']['bytes']
    assert fp8['per_chip_total'] * 4 == b['per_chip_total']   # f32: 4 B


def test_shard_layout_report_and_planted_drift(runs):
    """check_shard_layout on the live tp=2 engine returns the JAX
    report's keys (tensor degree 2, the cache's leaves, sharded
    weights), and a cache leaf re-allocated with every kv head on rank 0
    makes it raise."""
    values = runs['port']['dense'][0]['values']
    report, drift = values[4], values[5]
    assert report.keys() == runs['jax']['shard'].keys()
    assert report['tensor_degree'] == runs['jax']['shard']['tensor_degree']
    assert report['cache_leaves'] == runs['jax']['shard']['cache_leaves']
    assert report['paged_pool_leaves'] == 0
    assert 0 < report['param_leaves_sharded'] < report['param_leaves']
    assert drift is not None and 'rank 0: cache layer 0 k' in drift
    int8 = runs['port']['int8'][0]['values'][1]
    assert int8['param_leaves_sharded'] > report['param_leaves_sharded']


def test_registered_prefix_under_tp(runs):
    """A dense registered prefix (its rows held on each rank under a
    handle): the JAX TP engine's tokens and prefix hits."""
    values = runs['port']['dense'][0]['values']
    assert values[6] == len(PREFIX)
    _same(values[7], runs['jax']['prefixed'])
    assert values[8] == runs['jax']['prefix_stats']
    assert values[8]['hits'] == 3


def test_fp8_cache_under_tp(runs):
    """The fp8 cache at tp=2: the JAX fp8 TP engine's tokens."""
    _same(runs['port']['fp8'][0]['values'][0], runs['jax']['fp8'], tol=1e-4)


def test_speculation_under_tp(runs):
    """Prompt-lookup speculation at tp=2: the JAX TP engine's tokens and
    acceptance counters."""
    values = runs['port']['spec'][0]['values']
    _same(values[0] + values[1], runs['jax']['spec'])
    assert values[2] == runs['jax']['spec_stats']
    assert values[2]['accepted'] > 0


def test_int8_weights_under_tp(runs):
    """int8 weights at tp=2 (kernel_q sliced as its float kernel, the
    scale sliced for a column-parallel projection and whole for a
    row-parallel one): the JAX int8 TP engine's tokens."""
    _same(runs['port']['int8'][0]['values'][0], runs['jax']['int8'])


def _mesh(**sizes):
    """A stand-in for a Mesh: the refusals read only its axis sizes."""
    return types.SimpleNamespace(
        size=lambda *axes: int(np.prod([sizes.get(a, 1) for a in axes])))


def test_unported_mesh_surfaces_name_their_item():
    """The refusal a serving mesh keeps is the JAX engine's: kv heads the
    tensor degree does not divide, for the llama family and for GPT-2
    (whose heads are its kv heads).  Multi-LoRA, GPT-2 and 'seq'/'stage'
    ranks serve since (tests/test_torch_tp_serving_lora.py and
    tests/test_torch_tp_serving_gpt2.py)."""
    cfg = port.InferConfig(max_cache_len=64, cache_dtype=torch.float32)
    with pytest.raises(ValueError, match='num_kv_heads 2 not divisible by '
                                         'tensor degree 4'):
        port.InferenceEngine(PORT_CFG, cfg, device='cpu',
                             mesh=_mesh(tensor=4))
    gpt2 = get_model_config('gpt2-debug')
    assert isinstance(gpt2, GPT2Config)
    with pytest.raises(ValueError, match='num_kv_heads 4 not divisible by '
                                         'tensor degree 3'):
        port.InferenceEngine(gpt2, cfg, device='cpu', mesh=_mesh(tensor=3))


def test_run_serves_over_two_ranks_from_one_command(monkeypatch):
    """run(tensor_parallel=2) on the CPU starts rank 1 itself (a file
    store in a temporary directory) and serves from rank 0: /healthz's
    kv.tp is 2, rank 0's cache holds half the kv heads, its greedy tokens
    are the single engine's on the same seed-0 weights, and rank 1 exits
    when rank 0 stops (the process group is gone after)."""
    from torch import distributed as dist

    from skypilot_tpu_torch.infer import server as port_server
    seen = {}

    def serve(engine, **_):
        srv = port_server.InferenceServer(engine)
        srv.start()
        try:
            assert srv.ready.wait(timeout=60)
            seen['kv'] = srv.health()['kv']
        finally:
            srv.stop()
        seen['heads'] = engine.cache[0][0].shape[1]
        seen['tokens'] = engine.generate(
            [port.Request(tokens=[5, 9, 17, 33], max_new_tokens=6)]
        )[0].output_tokens

    monkeypatch.setattr(port_server, 'serve', serve)
    port_server.run(model='llama-debug', device='cpu', tensor_parallel=2,
                    num_slots=2, max_cache_len=64)
    assert not dist.is_initialized()
    assert seen['kv']['tp'] == 2 and seen['heads'] == 1
    single = port.engine_from_name('llama-debug', port.InferConfig(
        model='llama-debug', num_slots=2, max_cache_len=64), device='cpu')
    want = single.generate([port.Request(tokens=[5, 9, 17, 33],
                                         max_new_tokens=6)])
    assert seen['tokens'] == want[0].output_tokens


def test_idle_worker_outlasts_the_default_timeout(protocol):
    """The control group carries its own timeout: made while gloo's
    default is 1.5 s, it keeps rank 1 waiting through 4 s of rank 0's
    idle time, and the generation after the idle spell gives the same
    tokens as the one before."""
    first, after = protocol[0]['first'], protocol[0]['after_idle']
    assert first[0]['tokens'] and first[0]['error'] is None
    assert after == first


def test_worker_only_failure_stops_the_replica(protocol):
    """A dispatch that fails on rank 1 alone raises on rank 0 at that
    dispatch, the next dispatch raises instead of serving from a shard
    that missed an op, and rank 1 leaves serve_worker with the error."""
    rank0, rank1 = protocol
    assert 'failed on another rank' in rank0['failed']
    assert 'shut down' in rank0['next']
    assert 'failed on this rank' in rank1['worker_error']



# run(tensor_parallel=2) in a process of its own (one torch thread, the
# rendezvous under tmp_path), for the kill cases below.
RUN_SOURCE = '''
import sys
from skypilot_tpu_torch.infer import server
server.run(model='llama-debug', host='127.0.0.1', port=int(sys.argv[1]),
           device='cpu', tensor_parallel=2, num_slots=2, max_cache_len=64)
'''


def _healthz(port):
    import json
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/healthz',
                                    timeout=2) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())
    except OSError:
        return None


def _children(pid):
    import glob
    out = []
    for path in glob.glob(f'/proc/{pid}/task/*/children'):
        with open(path) as f:
            out += [int(p) for p in f.read().split()]
    return out


def _cmdline(pid):
    with open(f'/proc/{pid}/cmdline', 'rb') as f:
        return f.read().replace(b'\0', b' ').decode()


@pytest.fixture(scope='module')
def run_groups(tmp_path_factory):
    """Two run(tensor_parallel=2) replicas started side by side, each
    ready: {'proc', 'port', 'worker', 'log'} apiece.  Every process of
    both sessions is killed at the end."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    import time

    from skypilot_tpu_torch.infer import chaos
    root = pathlib.Path(__file__).resolve().parents[1]
    tmp = tmp_path_factory.mktemp('run_tp_kill')
    groups = []
    for i in range(2):
        port = chaos.free_port()
        log = open(tmp / f'run{i}.log', 'wb')
        env = {**os.environ, 'PYTHONPATH': str(root), 'OMP_NUM_THREADS': '1',
               'TMPDIR': str(tmp)}
        proc = subprocess.Popen([sys.executable, '-c', RUN_SOURCE,
                                 str(port)], env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        groups.append({'proc': proc, 'port': port, 'log': tmp / f'run{i}.log'})
    try:
        deadline = time.monotonic() + 90
        for g in groups:
            while (_healthz(g['port']) or {}).get('status') != 'ok':
                assert g['proc'].poll() is None, g['log'].read_text()
                assert time.monotonic() < deadline, g['log'].read_text()
                time.sleep(0.1)
            [g['worker']] = [p for p in _children(g['proc'].pid)
                             if 'spawn_main' in _cmdline(p)]
        yield groups
    finally:
        for g in groups:
            try:
                os.killpg(g['proc'].pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            g['proc'].wait()


def test_run_rank0_kill_ends_its_worker(run_groups):
    """SIGKILL rank 0 of a run()-started tp=2 group: its worker, blocked
    on the control group, exits within 10 s (gloo reports the closed
    connection), so no orphan holds the replica's memory."""
    import os
    import signal
    import time

    from skypilot_tpu_torch.infer import chaos
    g = run_groups[0]
    os.kill(g['proc'].pid, signal.SIGKILL)
    t0 = time.monotonic()
    while chaos.pid_alive(g['worker']) and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    assert not chaos.pid_alive(g['worker']), g['log'].read_text()


def test_run_worker_kill_reads_dead(run_groups):
    """SIGKILL the worker of an idle run()-started tp=2 group: rank 0,
    watching the ranks it started, stops its engine, so /healthz answers
    'dead' within 10 s though no dispatch ran."""
    import os
    import signal
    import time
    g = run_groups[1]
    os.kill(g['worker'], signal.SIGKILL)
    t0 = time.monotonic()
    doc = None
    while time.monotonic() - t0 < 10:
        doc = _healthz(g['port'])
        if doc and doc['status'] == 'dead':
            break
        time.sleep(0.05)
    assert doc and doc['status'] == 'dead', g['log'].read_text()
