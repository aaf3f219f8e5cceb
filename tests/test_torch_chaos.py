"""The port's chaos harness (skypilot_tpu_torch.infer.chaos) on the CPU:
port replicas behind the serve plane's unchanged SkyTpuLoadBalancer,
built through ChaosFleet's LB factory (scripts/chaos_smoke_torch.py's
``lb_factory``), held to the reference's replica-plane properties
(tests/test_serve_failover.py, scripts/chaos_smoke.py):

- the fault-free stream through the LB is the JAX engine's greedy output
  on the same weights, and a drain finishes its in-flight stream with
  zero 5xx;
- a mid-stream replica kill resumes byte-identical; a sampled stream
  fails fast with the typed non-resumable error;
- an LB kill and warm restart with its journal loses no request, and
  every answer is byte-identical;
- a killed replica's engine is released once its threads unwind;
- DegradedReplica's delays for a seed are the reference proxy's;
- one episode of the fault sweep (seed 0) keeps its properties, and its
  clean finishes are the JAX engine's tokens.

Kills land at a deterministic point: once the first SSE chunk of a
stream has arrived (the replica's gen_inflight > 0), never on a timer."""
import gc
import importlib.util
import json
import os
import pathlib
import socket
import threading
import time
import types
import weakref
from http.client import HTTPConnection

import pytest

from helpers_torch import jax_engine, make_params, port_engine
from skypilot_tpu.infer import FaultPlan as JaxFaultPlan
from skypilot_tpu.infer import FaultSpec as JaxFaultSpec
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import chaos as jax_chaos
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
from skypilot_tpu_torch.infer import chaos

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT = [3, 14, 15, 9, 2, 6]
MAX_NEW = 24


def _load_script():
    spec = importlib.util.spec_from_file_location(
        'chaos_smoke_torch', ROOT / 'scripts' / 'chaos_smoke_torch.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_script()


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def fleet(params, tmp_path_factory):
    """Two port replicas behind the unchanged LB (least load) with a
    journal, each loop pass slowed by a stall fault so a kill lands
    mid-stream (the stall only sleeps; tokens are unaffected)."""
    old = os.environ.get('SKYTPU_SERVE_LB_PROBE_INTERVAL')
    os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = '0.2'

    def make_engine():
        eng = port_engine(params, max_new_tokens=32, decode_steps=4)
        eng.arm_faults(FaultPlan(seed=0, specs=[
            FaultSpec(site='stall', prob=1.0, stall_s=0.05)]))
        return eng

    journal = str(tmp_path_factory.mktemp('chaos-lb') / 'lb_journal.jsonl')
    fl = chaos.ChaosFleet(make_engine, 2, SMOKE.lb_factory(),
                          journal_path=journal)
    fl.start()
    yield fl
    fl.stop()
    if old is None:
        del os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL']
    else:
        os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = old


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


def _post_stream(port, payload, timeout=60, on_first_event=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=timeout)
    conn.request('POST', '/generate', body=json.dumps(payload).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    try:
        return _read_sse(resp, on_first_event)
    finally:
        conn.close()


def _tokens_of(events):
    return [t for e in events
            if not e.get('done') and isinstance(e.get('tokens'), list)
            for t in e['tokens']]


def _done_of(events):
    done = [e for e in events if e.get('done')]
    assert len(done) == 1, events
    return done[0]


def _reference(fleet, params):
    """The fault-free greedy stream through the LB, once: the JAX
    engine's tokens on the same weights."""
    if not hasattr(fleet, 'reference'):
        events = _post_stream(fleet.lb.port,
                              {'tokens': PROMPT, 'max_new_tokens': MAX_NEW,
                               'stream': True})
        done = _done_of(events)
        assert done['finish_reason'] in ('length', 'eos')
        assert _tokens_of(events) == done['output_tokens']
        assert 'resumed' not in done
        [want] = jax_engine(params).generate([JaxRequest(
            tokens=PROMPT, max_new_tokens=MAX_NEW)])
        assert done['output_tokens'] == want.output_tokens
        fleet.reference = done['output_tokens']
    return fleet.reference


def _wait_fleet_settled(fleet, timeout=30):
    """Block until every replica is live and routable again (breakers
    closed, no draining flags)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        stats = fleet.lb.lb_stats()
        if len(fleet.live_replicas()) == len(fleet.replicas) and \
                not stats['breaker_open_now'] and \
                not stats['draining_replicas']:
            return
        time.sleep(0.05)
    raise TimeoutError(f'fleet never settled: {fleet.lb.lb_stats()}')


def test_clean_stream_then_drain_with_zero_5xx(fleet, params):
    """Drain the replica serving a stream: the stream completes
    byte-identical, new traffic lands on the survivor, the LB answers
    zero 5xx."""
    ref = _reference(fleet, params)
    _wait_fleet_settled(fleet)
    result = {}
    draining = threading.Event()

    def drain_busy():
        busy = next(r for r in fleet.replicas if r.busy())
        conn = HTTPConnection('127.0.0.1', busy.port, timeout=10)
        conn.request('POST', '/drain', body=b'{"deadline_s": 30}')
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())['draining']
        conn.close()
        result['busy'] = busy
        draining.set()

    def client():
        result['events'] = _post_stream(
            fleet.lb.port, {'tokens': PROMPT, 'max_new_tokens': MAX_NEW,
                            'stream': True}, on_first_event=drain_busy)

    t = threading.Thread(target=client)
    t.start()
    assert draining.wait(30), 'stream never reached a replica'
    for _ in range(3):
        events = _post_stream(fleet.lb.port, {'tokens': PROMPT,
                                              'max_new_tokens': 6,
                                              'stream': True})
        assert _done_of(events)['output_tokens'] == ref[:6]
    t.join(60)
    assert not t.is_alive()
    assert _done_of(result['events'])['output_tokens'] == ref
    busy = result['busy']
    assert busy.server.drained.wait(30)
    assert busy.server.gen_inflight == 0
    conn = HTTPConnection('127.0.0.1', busy.port, timeout=10)
    conn.request('POST', '/drain', body=b'{"cancel": true}')
    assert conn.getresponse().status == 200
    conn.close()
    assert fleet.lb.lb_stats()['drains_honored'] >= 1


def test_midstream_kill_resumes_byte_identical(fleet, params):
    ref = _reference(fleet, params)
    _wait_fleet_settled(fleet)
    before = fleet.lb.lb_stats()['streams_resumed']

    def kill():
        assert fleet.kill_one() is not None     # the busy replica

    events = _post_stream(fleet.lb.port,
                          {'tokens': PROMPT, 'max_new_tokens': MAX_NEW,
                           'stream': True}, on_first_event=kill)
    done = _done_of(events)
    assert done.get('resumed') is True
    assert done['output_tokens'] == ref
    assert _tokens_of(events) == ref
    stats = fleet.lb.lb_stats()
    assert stats['streams_resumed'] == before + 1
    assert stats['failovers'] >= 1
    fleet.respawn_dead()


def test_midstream_kill_sampled_fails_fast_with_typed_error(fleet):
    _wait_fleet_settled(fleet)

    def kill():
        assert fleet.kill_one() is not None

    events = _post_stream(fleet.lb.port,
                          {'tokens': PROMPT, 'max_new_tokens': MAX_NEW,
                           'stream': True, 'temperature': 0.7},
                          on_first_event=kill)
    done = _done_of(events)
    assert done.get('error_class') == 'non_resumable', done
    assert done['finish_reason'] == 'error'
    assert fleet.lb.lb_stats()['non_resumable_failures'] >= 1
    fleet.respawn_dead()


def test_lb_kill_and_warm_restart_lose_nothing(fleet, params):
    """Kill the LB once every client's stream has its first chunk,
    restart it on the same port with the journal: the severed clients
    retry and every answer is byte-identical."""
    ref = _reference(fleet, params)
    _wait_fleet_settled(fleet)
    n = 3
    first = [threading.Event() for _ in range(n)]
    results, errors = {}, []

    def client(i):
        attempts = 0
        deadline = time.time() + 90
        while time.time() < deadline:
            attempts += 1
            try:
                events = _post_stream(
                    fleet.lb_port, {'tokens': PROMPT,
                                    'max_new_tokens': MAX_NEW,
                                    'stream': True},
                    timeout=30, on_first_event=first[i].set)
                done = [e for e in events if e.get('done')]
                if len(done) == 1 and done[0]['finish_reason'] in (
                        'length', 'eos'):
                    results[i] = (done[0]['output_tokens'], attempts)
                    return
            except (OSError, AssertionError):
                pass
            time.sleep(0.2)
        errors.append(f'client {i} never completed')

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    assert all(ev.wait(30) for ev in first)
    fleet.kill_lb()
    fleet.restart_lb()
    for th in threads:
        th.join(120)
    assert not errors and len(results) == n
    assert all(tokens == ref for tokens, _ in results.values())
    assert sum(attempts > 1 for _, attempts in results.values()) >= 1
    assert fleet.lb_kills >= 1 and fleet.lb_restarts >= 1
    stats = fleet.lb.lb_stats()
    assert not stats.get('adopted_unverified')
    assert stats['journal_age_s'] is not None


def test_killed_replica_releases_its_engine(fleet):
    """A killed replica drops its engine: once its threads unwind (kill
    wakes the handlers still waiting on its stopped loop), nothing holds
    it."""
    _wait_fleet_settled(fleet)
    rep = fleet.replicas[0]
    eng = weakref.ref(rep.server.engine)
    rep.kill()
    deadline = time.time() + 10
    while eng() is not None and time.time() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert eng() is None
    rep.respawn()
    assert rep.alive and rep.server.engine is not None


def _proxy_sleeps(mod, plan, seed, n=12):
    """The sleeps a DegradedReplica of `mod` takes relaying n downstream
    chunks (a fake clock records them; nothing sleeps)."""
    sleeps = []
    fake = types.SimpleNamespace(sleep=sleeps.append)
    inner = types.SimpleNamespace(host='127.0.0.1', port=0)
    proxy = mod.DegradedReplica(inner, plan, seed=seed)
    src, src_peer = socket.socketpair()
    dst, dst_peer = socket.socketpair()
    real_time = mod.time
    mod.time = fake
    try:
        t = threading.Thread(target=proxy._splice, args=(src, dst, True))
        t.start()
        for k in range(n):
            src_peer.sendall(b'x' * (k + 1))
            got = b''
            while len(got) < k + 1:
                got += dst_peer.recv(65536)
        src_peer.close()
        t.join(10)
    finally:
        mod.time = real_time
        dst_peer.close()
    return sleeps, proxy.chunks_delayed


@pytest.mark.parametrize('seed', [0, 3])
def test_degraded_replica_delays_equal_the_reference(seed):
    specs = dict(site='net_degrade', prob=0.6, delay_s=0.4, jitter_s=0.1)
    got = _proxy_sleeps(chaos, FaultPlan(seed=seed, specs=[
        FaultSpec(**specs)]), seed)
    want = _proxy_sleeps(jax_chaos, JaxFaultPlan(seed=seed, specs=[
        JaxFaultSpec(**specs)]), seed)
    assert got == want
    assert 0 < got[1] < 12 and all(0.3 <= s <= 0.5 for s in got[0])


def test_episode_properties_hold_with_the_jax_engines_tokens(params):
    """One episode of the sweep (seed 0, 12 requests) over a paged port
    engine: no hang, one terminal result each, the pool balanced, and
    every clean finish the JAX engine's greedy tokens on the weights."""
    reqs = SMOKE.make_requests(12)
    want = jax_engine(params, kv_block_size=8).generate(
        [JaxRequest(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
         for r in reqs])
    reference = {r.request_id: w.output_tokens for r, w in zip(reqs, want)}
    eng = port_engine(params, kv_block_size=8)
    assert SMOKE.episode(eng, 0, 12, reference=reference) == []
    assert eng.fault_stats['internal_errors'] > 0
    # The planted divergence is caught: the property is not vacuous.
    wrong = {k: v[:-1] + [v[-1] + 1] for k, v in reference.items()}
    assert any(b.startswith('DIVERGED: ') for b in SMOKE.episode(
        port_engine(params, kv_block_size=8), 0, 12, reference=wrong))
