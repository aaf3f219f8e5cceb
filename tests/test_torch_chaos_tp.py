"""A tensor-parallel replica in the port's chaos fleet
(skypilot_tpu_torch.infer.chaos.ProcessReplica) on the CPU: two gloo
ranks, each a process of its own with one torch thread, beside two
in-process port replicas behind the serve plane's unchanged
SkyTpuLoadBalancer (scripts/chaos_smoke_torch.py's ``lb_factory``), all
three at the twin's ``_replica_engine`` config on one set of numpy
weights, held against the JAX engine over ``tp_mesh(2)`` at the same
config (scripts/chaos_smoke.py's ``_replica_engine(tp=2)``):

- (a) clean streams through the tp replica are the JAX tp engine's
  (tokens exact, logprobs 1e-5), and the child's sanitizers
  (SKYTPU_SANITIZERS=1 on every rank) audit and find nothing;
- (b) a 'group' kill once every stream has its first chunk: no process
  of the replica left within 5 s, every stream byte-identical through
  the LB (the tp replica's resumed on a peer);
- (c) a 'rank0' kill: every worker gone within 10 s;
- (d) a 'worker' kill: /healthz 'dead' within 10 s, every in-flight
  stream one terminal result (none hangs), the next requests served by
  the peers;
- after each kill the replica respawns at its port and its re-issued
  greedy stream is byte-identical;
- (e) one sweep episode (seed 0) with the tp replica last keeps the
  reference's properties with the JAX engine's tokens.

Kills land at a deterministic point: once each of three concurrent
streams (least load puts one on each replica) has its first chunk."""
import functools
import importlib.util
import json
import os
import pathlib
import threading
import time
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers_torch import (JAX_CFG, PORT_CFG, make_params,  # noqa: F401
                           one_torch_thread)
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu_torch.infer import chaos
from skypilot_tpu_torch.models import convert

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The twin's replica config (scripts/chaos_smoke_torch.py
# _replica_engine; scripts/chaos_smoke.py on the JAX side).
REPLICA_INFER = dict(num_slots=4, max_cache_len=64,
                     prefill_buckets=(8, 16, 32), max_new_tokens=32,
                     decode_steps=4, kv_block_size=8,
                     auto_prefix_cache=True, host_kv_bytes=32 << 20)
N_STREAMS = 3
MAX_NEW = 32
EPISODE_REQUESTS = 12


def _load_script():
    spec = importlib.util.spec_from_file_location(
        'chaos_smoke_torch', ROOT / 'scripts' / 'chaos_smoke_torch.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_script()


def _spec(i):
    """Stream i of a kill case: the sweep's prompt i, 32 new tokens (a
    stream outlives the three first chunks)."""
    return {**SMOKE._request_spec(i), 'max_new_tokens': MAX_NEW}


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def jax_refs(params):
    """The JAX engine over tp_mesh(2) at the replica config: its results
    for the kill cases' streams and for the sweep's requests."""
    eng = JaxEngine(JAX_CFG, JaxInferConfig(**REPLICA_INFER,
                                            cache_dtype=jnp.float32),
                    params={'params': params}, rng=jax.random.PRNGKey(7),
                    mesh=tp_mesh(2))
    assert jax.device_count() >= 2
    specs = [_spec(i) for i in range(N_STREAMS + 1)] + [
        SMOKE._request_spec(i) for i in range(EPISODE_REQUESTS)]
    out = eng.generate([JaxRequest(tokens=s['tokens'],
                                   max_new_tokens=s['max_new_tokens'])
                        for s in specs])
    streams = out[:N_STREAMS + 1]
    episode = {i: r.output_tokens
               for i, r in enumerate(out[N_STREAMS + 1:])}
    return streams, episode


@pytest.fixture(scope='module')
def fleet(params, tmp_path_factory):
    """Two in-process port replicas and one tp=2 ProcessReplica (last)
    behind the unchanged LB, SKYTPU_SANITIZERS=1 on every replica and
    rank, each loop pass slowed by the twin's stall fault (tokens
    unaffected)."""
    saved = {k: os.environ.get(k) for k in
             ('SKYTPU_SERVE_LB_PROBE_INTERVAL', 'SKYTPU_SANITIZERS')}
    os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = '0.2'
    # Every start of the tp replica passes it to its ranks.
    os.environ['SKYTPU_SANITIZERS'] = '1'
    sd = convert.state_dict_from_jax(params, PORT_CFG)
    tmp = tmp_path_factory.mktemp('chaos-tp')
    tp = chaos.ProcessReplica(
        chaos.EngineRecipe(SMOKE._replica_engine, 'cpu', params=sd),
        chaos.free_port(), tp=2, device='cpu', threads=1,
        workdir=str(tmp / 'replica'))
    factories = [functools.partial(SMOKE._replica_engine, 'cpu',
                                   params=sd)] * 2 + [tp]
    fl = chaos.ChaosFleet(factories, 3, SMOKE.lb_factory(),
                          journal_path=str(tmp / 'lb_journal.jsonl'))
    fl.tp = tp
    try:
        fl.start()
        yield fl
    finally:
        fl.stop()
        assert tp.live_pids() == []
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _read_sse(resp, on_first_event=None):
    buf, events, fired = b'', [], False
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b'\n\n' in buf:
            ev, buf = buf.split(b'\n\n', 1)
            for line in ev.split(b'\n'):
                if line.startswith(b'data: '):
                    events.append(json.loads(line[6:]))
        if events and not fired and on_first_event is not None:
            fired = True
            on_first_event()
    return events


def _post_stream(port, payload, timeout=30, on_first_event=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=timeout)
    conn.request('POST', '/generate',
                 body=json.dumps({**payload, 'stream': True}).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    try:
        return _read_sse(resp, on_first_event)
    finally:
        conn.close()


def _done_of(events):
    done = [e for e in events if e.get('done')]
    assert len(done) == 1, events
    return done[0]


def _wait_fleet_settled(fleet, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        stats = fleet.lb.lb_stats()
        if len(fleet.live_replicas()) == len(fleet.replicas) and \
                not stats['breaker_open_now'] and \
                not stats['draining_replicas'] and \
                len(stats['ready_replicas']) == len(fleet.replicas):
            return
        time.sleep(0.05)
    raise TimeoutError(f'fleet never settled: {fleet.lb.lb_stats()}')


def _streams_under_kill(fleet, mode):
    """Three concurrent streams through the LB; once each has its first
    chunk (and the tp replica holds one), kill the tp replica in `mode`.
    Returns (each client's events or exception, the kill's monotonic
    time); every client must end within 30 s."""
    tp = fleet.tp
    first = [threading.Event() for _ in range(N_STREAMS)]
    out = {}

    def client(i):
        try:
            out[i] = _post_stream(fleet.lb.port, _spec(i),
                                  on_first_event=first[i].set)
        except Exception as e:  # noqa: BLE001 -- reported per client
            out[i] = e

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(N_STREAMS)]
    for th in threads:
        th.start()
    assert all(ev.wait(30) for ev in first), out
    assert tp.busy(), 'no stream reached the tp replica'
    tp.kill(mode)
    killed_at = time.monotonic()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads), 'a client hung'
    return out, killed_at


def _respawned_identical(fleet, want):
    tp = fleet.tp
    tp.respawn()
    assert tp.alive and tp.live_pids() != []
    assert _done_of(_post_stream(tp.port, _spec(0)))['output_tokens'] == \
        want[0].output_tokens
    _wait_fleet_settled(fleet)


def test_a_clean_streams_equal_the_jax_tp_engine(fleet, jax_refs):
    """Four concurrent streams straight to the tp replica: the JAX tp
    engine's tokens exactly, its logprobs within 1e-5; rank 0 and one
    worker run; the sanitizers' quiesce audits find nothing."""
    want, _ = jax_refs
    tp = fleet.tp
    pids = tp.pids()
    assert pids['rank0'] and len(pids['workers']) == 1
    got = {}

    def client(i):
        got[i] = _post_stream(tp.port, _spec(i))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_STREAMS + 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    for i, w in enumerate(want):
        done = _done_of(got[i])
        assert done['finish_reason'] == w.finish_reason
        assert done['output_tokens'] == list(w.output_tokens)
        np.testing.assert_allclose(done['logprobs'], w.logprobs, rtol=0,
                                   atol=1e-5)
    doc = tp.health()
    assert doc['status'] == 'ok' and doc['kv']['tp'] == 2
    deadline = time.time() + 10
    report = None
    while time.time() < deadline:
        report = tp.sanitizer_report()
        if report and report['audits'] >= 2:
            break
        time.sleep(0.1)
    assert report and report['audits'] >= 2, report
    assert report['findings'] == []


def test_b_group_kill_resumes_byte_identical(fleet, jax_refs):
    want, _ = jax_refs
    _wait_fleet_settled(fleet)
    before = fleet.lb.lb_stats()['streams_resumed']
    out, _ = _streams_under_kill(fleet, 'group')
    gone = fleet.tp.wait_gone(5.0)
    assert len(gone) == 2 and all(t is not None and t <= 5.0
                                  for t in gone.values()), gone
    for i in range(N_STREAMS):
        done = _done_of(out[i])
        assert done['output_tokens'] == want[i].output_tokens, done
    assert fleet.lb.lb_stats()['streams_resumed'] >= before + 1
    _respawned_identical(fleet, want)


def test_c_rank0_kill_ends_every_worker(fleet, jax_refs):
    want, _ = jax_refs
    _wait_fleet_settled(fleet)
    workers = fleet.tp.pids()['workers']
    out, _ = _streams_under_kill(fleet, 'rank0')
    gone = fleet.tp.wait_gone(10.0)
    assert all(gone[w] is not None and gone[w] <= 10.0 for w in workers), \
        gone
    for i in range(N_STREAMS):
        assert _done_of(out[i])['output_tokens'] == want[i].output_tokens
    _respawned_identical(fleet, want)


def test_d_worker_kill_reads_dead_and_peers_serve(fleet, jax_refs):
    want, _ = jax_refs
    _wait_fleet_settled(fleet)
    tp = fleet.tp
    out, killed_at = _streams_under_kill(fleet, 'worker')
    status = None
    while time.monotonic() - killed_at < 10.0:
        doc = tp.health()
        status = doc and doc['status']
        if status == 'dead':
            break
        time.sleep(0.05)
    assert status == 'dead', tp.log_tail()
    # Every in-flight stream ended with one terminal result: the clean
    # finish (resumed or untouched) or the typed error event.
    for i in range(N_STREAMS):
        assert not isinstance(out[i], Exception), out[i]
        done = _done_of(out[i])
        assert (done['output_tokens'] == want[i].output_tokens or
                (done['finish_reason'] == 'error' and
                 done.get('error_class'))), done
    # The LB's prober opens the dead replica's breaker; the next
    # requests are served by the peers, byte-identical.
    deadline = time.time() + 10
    while tp.url not in fleet.lb.lb_stats()['breaker_open_now'] and \
            time.time() < deadline:
        time.sleep(0.05)
    assert tp.url in fleet.lb.lb_stats()['breaker_open_now']
    for i in range(N_STREAMS):
        assert _done_of(_post_stream(fleet.lb.port, _spec(i)))[
            'output_tokens'] == want[i].output_tokens
    assert tp.health()['inflight'] == 0
    _respawned_identical(fleet, want)


def test_e_sweep_episode_with_the_jax_engines_tokens(fleet, jax_refs):
    """One episode of the twin's replica sweep (seed 0, 12 requests in
    lanes of two, the SeededKiller preempting replicas) over the mixed
    fleet: every stream finishes with the JAX engine's tokens; the tp
    replica ends it alive, with no process of an earlier start left."""
    _, episode = jax_refs
    _wait_fleet_settled(fleet)
    assert SMOKE.kill_episode(fleet, 0, EPISODE_REQUESTS, episode) == []
    assert all(r.alive for r in fleet.replicas)
    assert len(fleet.tp.live_pids()) == 2


def test_no_fallback_a_failed_child_raises_with_its_stderr():
    """A child whose engine fails to build makes start() raise with its
    log (the rank's traceback), and nothing serves at the port; stop()
    removes the replica's own temporary directory; with no card visible,
    device=None raises as resolve_device does."""
    import torch
    bad = chaos.ProcessReplica(
        chaos.EngineRecipe(SMOKE._replica_engine, 'cpu',
                           params={'bogus': torch.zeros(1)}),
        chaos.free_port(), tp=2, device='cpu', threads=1)
    with pytest.raises(RuntimeError, match='before it was ready') as err:
        bad.start(ready_timeout=60)
    assert "KeyError: 'bogus'" in str(err.value)
    assert not bad.alive and bad.health() is None
    assert os.path.isdir(bad.workdir)
    bad.stop()
    assert not os.path.exists(bad.workdir)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device is visible'):
            chaos.ProcessReplica(chaos.EngineRecipe(SMOKE._replica_engine,
                                                    'cuda'),
                                 chaos.free_port())
