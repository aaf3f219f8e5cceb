"""The port's lock-order and block-conservation sanitizers
(skypilot_tpu_torch.analysis.sanitizers) held against the JAX package's
(skypilot_tpu/analysis/sanitizers.py), on the CPU:

- one acquisition script on both gives the same order graph and the same
  LockOrderError texts, and the env switches read the same;
- after one served paged wave (radix cache, a registered prefix, the host
  tier) over the same weights, check_block_conservation on the port
  engine returns the JAX function's accounting dict for the JAX engine;
- planted leaks, phantom and duplicate free-list entries raise
  BlockLeakError with the JAX function's text on the same planted state,
  and the serving loop's quiesce point raises under the switch;
- with the lock sanitizer on, the engine, scheduler, QoS and server
  locks are instrumented under the reference's role names, a served
  wave records their order, and the fault plan's lock stays plain."""
import ast
import copy
import pathlib
import queue
import threading
import time

import pytest

from helpers_torch import jax_engine, make_params, port_engine
from skypilot_tpu.analysis import sanitizers as jax_san
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.analysis import sanitizers as san
from skypilot_tpu_torch.infer import FaultPlan, Request
from skypilot_tpu_torch.infer import server as port_server

SWITCHES = ('SKYTPU_LOCK_SANITIZER', 'SKYTPU_BLOCK_SANITIZER',
            'SKYTPU_SHARD_SANITIZER', 'SKYTPU_SANITIZERS')

# A tight pool (12 usable blocks + dump) so radix eviction spills into the
# host tier within one wave; a registered prefix of two full blocks.
POOL = dict(num_slots=2, kv_block_size=8, kv_blocks=13,
            auto_prefix_cache=True, host_kv_bytes=1 << 20)
PREFIX = [(3 * j + 2) % 97 + 1 for j in range(16)]


def _wave():
    """The prefix's followers, then distinct 25-token prompts that churn
    the radix tree out of the pool (3 inserts each)."""
    return ([(f'p{i}', PREFIX + [40 + i], 4) for i in range(2)] +
            [(f'c{i}', [(7 * j + 11 * i) % 97 + 1 for j in range(25)], 4)
             for i in range(4)])


@pytest.fixture(autouse=True)
def _switches_off(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope='module')
def params():
    return make_params()


def _serve(eng, reqs):
    """Serve `reqs` through the engine's serving loop; results by id."""
    q, results, stop = queue.Queue(), {}, threading.Event()
    for r in reqs:
        q.put(r)
    t = threading.Thread(target=eng.generate_stream, daemon=True,
                         args=(q, lambda res: results.setdefault(
                             res.request_id, res), stop))
    t.start()
    deadline = time.time() + 60
    while len(results) < len(reqs) and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(30)
    assert not t.is_alive() and len(results) == len(reqs)
    return results


@pytest.fixture(scope='module')
def served(params):
    """A JAX and a port engine over the same weights after the same
    served wave: a registered prefix, its followers and the churn."""
    jax_eng = jax_engine(params, **POOL)
    port_eng = port_engine(params, **POOL)
    assert jax_eng.register_prefix(PREFIX) == \
        port_eng.register_prefix(PREFIX)
    want = _serve(jax_eng, [JaxRequest(request_id=i, tokens=t,
                                       max_new_tokens=m)
                            for i, t, m in _wave()])
    got = _serve(port_eng, [Request(request_id=i, tokens=t,
                                    max_new_tokens=m)
                            for i, t, m in _wave()])
    assert {k: r.output_tokens for k, r in got.items()} == \
        {k: r.output_tokens for k, r in want.items()}
    return jax_eng, port_eng


# --------------------------------------------------------------- switches

@pytest.mark.parametrize('env', [
    {}, {'SKYTPU_LOCK_SANITIZER': '1'}, {'SKYTPU_BLOCK_SANITIZER': 'TRUE'},
    {'SKYTPU_SHARD_SANITIZER': ' on '}, {'SKYTPU_SANITIZERS': 'yes'},
    {'SKYTPU_SANITIZERS': '0', 'SKYTPU_LOCK_SANITIZER': 'off'},
    {'SKYTPU_BLOCK_SANITIZER': '2'}])
def test_switches_read_as_the_reference_reads_them(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for fn in ('lock_sanitizer_enabled', 'block_sanitizer_enabled',
               'shard_sanitizer_enabled'):
        assert getattr(san, fn)() == getattr(jax_san, fn)(), fn


# ------------------------------------------------------------- lock order

def _in_thread(fn):
    """Run fn on a thread of its own (its held-lock stack starts empty
    and dies with it); returns what it returned."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(10)
    return out[0]


def _script(mod):
    """One acquisition script: the edges it records and the errors it
    raises, in order.  Each step runs on a fresh thread, so the steps
    after an error do not depend on what the error left on its thread
    (see test_c9_a_refused_acquisition_leaves_no_held_record)."""
    mod.reset_lock_order()
    a = mod.instrument_lock(threading.Lock(), 'test.a')
    b = mod.instrument_lock(threading.Lock(), 'test.b')
    c = mod.instrument_lock(threading.Lock(), 'test.c')

    def nested(outer, inner):
        def run():
            with outer:
                try:
                    with inner:
                        return None
                except mod.LockOrderError as e:
                    return str(e)
        return run

    def reacquire():
        with a:
            try:
                a.acquire()
            except mod.LockOrderError as e:
                return str(e)

    errors = [_in_thread(step) for step in (
        nested(a, b), nested(b, c), nested(c, a), nested(b, a),
        reacquire)]
    assert not any(lock.locked() for lock in (a, b, c))
    edges = mod.lock_order_edges()
    mod.reset_lock_order()
    return edges, errors


def test_lock_order_edges_and_errors_equal_the_reference(monkeypatch):
    monkeypatch.setenv('SKYTPU_LOCK_SANITIZER', '1')
    got, want = _script(san), _script(jax_san)
    assert got == want
    edges, errors = got
    assert edges == {'test.a': {'test.b'}, 'test.b': {'test.c', 'test.a'},
                     'test.c': {'test.a'}}
    assert errors[:2] == [None, None]
    assert errors[2] == (
        "lock-order inversion: acquired 'test.a' while holding 'test.c', "
        'but the reverse order was also observed (cycle: test.a -> '
        'test.b -> test.c -> test.a)')
    assert "acquired 'test.a' while holding 'test.b'" in errors[3]
    assert errors[4].startswith(
        "thread re-acquiring non-reentrant lock 'test.a'")


def test_c9_a_refused_acquisition_leaves_no_held_record(monkeypatch):
    """A reference fault the port does not copy: after a LockOrderError
    the reference's thread keeps the refused lock's name on its held
    stack (the real lock is released), so its next legal acquisition of
    that lock raises a false re-acquisition error (and any other records
    an edge from a lock it does not hold).  The port drops the name with
    the lock."""
    monkeypatch.setenv('SKYTPU_LOCK_SANITIZER', '1')
    outcomes = []
    for mod in (san, jax_san):
        mod.reset_lock_order()
        a = mod.instrument_lock(threading.Lock(), 'test.a')
        b = mod.instrument_lock(threading.Lock(), 'test.b')

        def run():
            with a:
                with b:
                    pass
            with b:
                try:
                    with a:                  # refused: a -> b was seen
                        pass
                except mod.LockOrderError:
                    pass
            try:
                with a:                      # legal: nothing is held
                    pass
            except mod.LockOrderError as e:
                return str(e)
            return None

        outcomes.append(_in_thread(run))
        mod.reset_lock_order()
    assert outcomes[0] is None
    assert outcomes[1].startswith(
        "thread re-acquiring non-reentrant lock 'test.a'")


def test_off_switch_returns_the_lock_itself():
    lock = threading.Lock()
    assert san.instrument_lock(lock, 'test.off') is lock


class _Recorder(san._OrderGraph):
    """The order graph, also recording every role acquired."""

    def __init__(self):
        super().__init__()
        self.acquired = set()

    def after_acquire(self, name: str) -> None:
        self.acquired.add(name)
        super().after_acquire(name)


def test_served_wave_records_the_instrumented_roles(monkeypatch, params):
    """With the lock sanitizer on, the port's locks carry the reference's
    role names, and a wave through the HTTP server's admission, the
    auto-prefix counter, the QoS scheduler and the FIFO one acquires each
    of them with no inversion raised.  Left plain, as in the reference:
    the fault plan's lock (consulted under every other lock, it takes
    none itself); and the tensor-parallel dispatch lock of infer/tp.py,
    which is reentrant (a dispatch inside a dispatch re-enters it), what
    the sanitizer forbids."""
    monkeypatch.setenv('SKYTPU_LOCK_SANITIZER', '1')
    graph = _Recorder()
    monkeypatch.setattr(san, '_GRAPH', graph)
    long_cache = dict(max_cache_len=128, prefill_buckets=(8, 16, 32, 64,
                                                          128))
    eng = port_engine(params, qos=True, **long_cache)
    fifo = port_engine(params)
    srv = port_server.InferenceServer(eng, auto_prefix=True)
    roles = {'infer.engine._lock': eng._lock,
             'infer.qos.wfq._lock': eng._sched._lock,
             'infer.server._auto_lock': srv._auto_lock,
             'infer.server._adm_lock': srv._adm_lock,
             'infer.scheduler.fifo._lock': fifo._sched._lock}
    for name, lock in roles.items():
        assert isinstance(lock, san.InstrumentedLock) and \
            lock.name == name, name
    assert not isinstance(FaultPlan()._lock, san.InstrumentedLock)
    srv.start()
    try:
        assert srv.ready.wait(60)
        prompts = [t for _, t, _ in _wave()[:3]] + [list(range(1, 71))]
        outs = [srv.submit(Request(tokens=t, max_new_tokens=4))
                for t in prompts]
    finally:
        srv.stop()
    outs += fifo.generate_served([Request(request_id='f', tokens=[5, 6, 7],
                                          max_new_tokens=4)])
    assert all(r.finish_reason == 'length' for r in outs)
    assert set(roles) <= graph.acquired
    tp_src = (pathlib.Path(__file__).resolve().parents[1] /
              'skypilot_tpu_torch/infer/tp.py').read_text()
    locks = [node.value for node in ast.walk(ast.parse(tp_src))
             if isinstance(node, ast.Assign) and
             any(isinstance(t, ast.Attribute) and t.attr == 'lock'
                 for t in node.targets)]
    assert len(locks) == 1 and ast.unparse(locks[0]) == 'threading.RLock()'


# ------------------------------------------------------ block conservation

def test_accounting_equals_the_reference_after_a_served_wave(served):
    jax_eng, port_eng = served
    got = san.check_block_conservation(port_eng)
    assert got == jax_san.check_block_conservation(jax_eng)
    # Under the radix cache a registered prefix pins radix nodes.
    assert got['radix_refs'] > 0 and port_eng._radix.pinned > 0
    assert got['host_tier_entries'] > 0
    assert san.check_block_conservation(port_engine(make_params())) is None


def test_accounting_counts_registered_prefix_blocks(params):
    """Without the radix cache a paged registered prefix holds its blocks
    itself: the prefix_refs clause, on both engines."""
    pool = dict(kv_block_size=8, num_slots=2)
    counts = []
    for make, req, mod in ((jax_engine, JaxRequest, jax_san),
                           (port_engine, Request, san)):
        eng = make(params, **pool)
        eng.register_prefix(PREFIX)
        eng.generate([req(tokens=PREFIX + [7], max_new_tokens=3)])
        counts.append(mod.check_block_conservation(eng))
    assert counts[0] == counts[1]
    assert counts[1]['prefix_refs'] == 2 and counts[1]['radix_refs'] == 0


def _plant_leak(eng):
    return eng._free_blocks.pop()                 # refcount 0, unlisted


def _plant_phantom(eng):
    held = next(b for b in range(1, eng._num_blocks)
                if eng._block_refs[b] > 0)
    eng._free_blocks.append(held)
    return held


def _plant_duplicate(eng):
    eng._free_blocks.append(eng._free_blocks[0])


def _plant_refcount(eng):
    held = next(b for b in range(1, eng._num_blocks)
                if eng._block_refs[b] > 0)
    eng._block_refs[held] += 1


@pytest.mark.parametrize('plant,text', [
    (_plant_leak, 'leaked blocks (refcount 0, not on free list)'),
    (_plant_phantom, 'free-listed blocks with nonzero refcount'),
    (_plant_duplicate, 'free list contains duplicates (1)'),
    (_plant_refcount, 'referers (slot tables + radix + prefixes)')])
def test_planted_faults_raise_the_reference_text(served, plant, text):
    jax_eng, port_eng = served
    saved = [(e._free_blocks, e._block_refs)
             for e in (jax_eng, port_eng)]
    saved = [(list(f), r.copy()) for f, r in saved]
    msgs = []
    try:
        for eng, mod in ((jax_eng, jax_san), (port_eng, san)):
            plant(eng)
            with pytest.raises(mod.BlockLeakError) as err:
                mod.check_block_conservation(eng)
            msgs.append(str(err.value))
    finally:
        for eng, (free, refs) in zip((jax_eng, port_eng), saved):
            eng._free_blocks[:] = free
            eng._block_refs[:] = refs
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith('block conservation violated:\n  ')
    assert text in msgs[1]
    assert san.check_block_conservation(port_eng) is not None


def test_host_tier_drift_fails_the_check(served):
    """A byte-ledger drift in the host tier is a leak across the tier
    boundary: both checks raise it with the same text."""
    msgs = []
    for eng, mod in zip(served, (jax_san, san)):
        eng._host_tier._bytes += 1
        try:
            with pytest.raises(mod.BlockLeakError) as err:
                mod.check_block_conservation(eng)
        finally:
            eng._host_tier._bytes -= 1
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert 'leak across the tier boundary' in msgs[1]


def test_quiesce_point_raises_under_the_switch(monkeypatch, params):
    """A planted leak: the serving loop's idle pass raises BlockLeakError
    (the supervisor restarts the loop, then gives up and re-raises) with
    the block sanitizer on, and serves on with it off."""
    eng = port_engine(params, **POOL)
    eng.generate([Request(tokens=PREFIX + [9], max_new_tokens=3)])
    leaked = _plant_leak(eng)
    stop = threading.Event()
    t = threading.Thread(target=eng.generate_stream, daemon=True,
                         args=(queue.Queue(), lambda res: None, stop))
    t.start()
    time.sleep(0.2)
    stop.set()
    t.join(10)
    assert not t.is_alive() and eng.fault_stats['loop_restarts'] == 0
    monkeypatch.setenv('SKYTPU_BLOCK_SANITIZER', '1')
    with pytest.raises(san.BlockLeakError, match=r'\[' + str(leaked)):
        eng.generate_stream(queue.Queue(), lambda res: None,
                            threading.Event())
    assert eng.fault_stats['loop_restarts'] == 4
    eng._free_blocks.append(leaked)
    assert san.check_block_conservation(eng)['free'] == \
        len(eng._free_blocks)


def test_window_audit_helper_reports_through_the_sanitizer(served):
    """conservation_errors (the tests' per-window audit) reports the
    sanitizer's violations plus its own idle-slot clause."""
    from helpers_torch import conservation_errors
    _, port_eng = served
    assert conservation_errors(port_eng) == []
    leaked = _plant_leak(port_eng)
    try:
        errs = conservation_errors(port_eng)
    finally:
        port_eng._free_blocks.append(leaked)
    assert errs == [f'leaked blocks (refcount 0, not on free list): '
                    f'[{leaked}]']
    saved = copy.copy(port_eng._slot_nblocks)
    port_eng._slot_nblocks[0] = 1
    try:
        errs = conservation_errors(port_eng)
    finally:
        port_eng._slot_nblocks[:] = saved
    assert errs[0] == 'idle slot 0 holds 1 blocks'


def test_report_keeps_the_quiesce_audits_and_first_errors(monkeypatch,
                                                          params):
    """sanitizers.report() (what a replica in a process of its own hands
    its harness): the quiesce audits run with a gate on and, of each
    kind, the first error raised, as 'Kind: message'."""
    monkeypatch.setattr(san, '_REPORT', {'audits': 0, 'findings': {}})
    eng = port_engine(params, **POOL)
    eng.generate([Request(tokens=PREFIX + [9], max_new_tokens=3)])
    san.audit_quiesce(eng)                       # every gate off
    assert san.report() == {'audits': 0, 'findings': []}
    monkeypatch.setenv('SKYTPU_BLOCK_SANITIZER', '1')
    san.audit_quiesce(eng)
    assert san.report() == {'audits': 1, 'findings': []}
    leaked = [_plant_leak(eng)]
    try:
        with pytest.raises(san.BlockLeakError) as first:
            san.audit_quiesce(eng)
        leaked.append(_plant_leak(eng))
        with pytest.raises(san.BlockLeakError):
            san.audit_quiesce(eng)
    finally:
        eng._free_blocks.extend(leaked)
    monkeypatch.setenv('SKYTPU_LOCK_SANITIZER', '1')
    _, errors = _script(san)
    assert san.report() == {
        'audits': 3,
        'findings': [f'BlockLeakError: {first.value}',
                     f'LockOrderError: {errors[2]}']}
