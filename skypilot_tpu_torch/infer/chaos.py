"""Process-level chaos harness of the port: the twin of
``skypilot_tpu/infer/chaos.py``, over the port's engine and server.

The engine-level fault sites (``faults.py``) prove per-request
containment inside one process.  This module proves the layer above --
the replica plane: N replicas behind a load balancer, with a seeded
killer thread that consults a ``FaultPlan``'s ``replica_kill`` site on a
fixed tick and kills live replicas mid-decode (listener closed,
in-flight client sockets severed, serving loop stopped).  Greedy
decoding is schedule- and replica-independent, so an offline
``engine.generate`` run on an identically built engine is the byte-exact
reference every streamed answer -- including ones resumed across a
kill -- must match.

A single-device replica is in-process (``KillableReplica``): a killed
replica must look exactly like a preempted VM from the network's point of
view (connection refused on new connects, reset on in-flight ones),
which ``_TrackingHTTPServer.sever_all`` delivers, while a respawn only
builds a new engine.  A killed replica drops its engine, so once its
threads have unwound it holds no card memory.

A tensor-parallel replica is one process a rank, so it is a
``ProcessReplica``: rank 0 in a child process of its own session, the
other ranks started by rank 0 as ``server.run()`` starts them.  The
kernel delivers the preemption there: ``kill('group')`` SIGKILLs every
rank (the preempted VM), ``kill('rank0')`` rank 0 alone (the OOM killer),
``kill('worker')`` one worker alone.  A worker exits when rank 0 dies
(its pending gloo broadcast fails), and rank 0 watches the ranks it
started: a lost one stops its serving loop (``/healthz`` answers
``dead``).

One difference from the reference: ``ChaosFleet`` builds its load
balancer through a factory its caller passes in, never by import.  The
serve plane's ``SkyTpuLoadBalancer`` belongs to the JAX package's
JAX-free planes, which the port uses by import from outside the package
(``scripts/chaos_smoke_torch.py``, the tests), never from inside it.

Used by ``scripts/chaos_smoke_torch.py``, ``chip_smoke.py``'s chaos
phase and ``tests/test_torch_chaos.py``, ``tests/test_torch_chaos_tp.py``.
"""
import faulthandler
import functools
import importlib
import importlib.util
import json
import logging
import os
import shutil
import signal
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from multiprocessing import forkserver
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import multiprocessing as mp

from skypilot_tpu_torch.analysis import sanitizers
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.infer import tp as tp_lib
from skypilot_tpu_torch.infer.engine import InferenceEngine
from skypilot_tpu_torch.infer.server import (InferenceServer,
                                             _BurstTolerantHTTPServer,
                                             _make_handler)
from skypilot_tpu_torch.parallel.mesh import tp_mesh

logger = logging.getLogger(__name__)

# make_lb(port, replica_urls, journal_path, server_cls) -> a load balancer
# with run(), stop(), port, journal, _httpd and policy (the serve plane's
# SkyTpuLoadBalancer over a fresh policy seeded with replica_urls, and a
# journal at journal_path when it is not None).
LBFactory = Callable[[int, List[str], Optional[str], type], Any]


class _TrackingHTTPServer(_BurstTolerantHTTPServer):
    """ThreadingHTTPServer that can sever EVERY open connection.

    `shutdown()` only stops accepting; handler threads keep their
    sockets and finish politely -- useless for simulating preemption.
    This server tracks accepted client sockets so `sever_all()` can
    close the listener AND reset the in-flight connections, which is
    what a killed VM looks like from the LB's side.
    """

    def __init__(self, *args, **kwargs):
        self._clients_lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.chaos._clients_lock')
        self._clients: set = set()  # guarded-by: _clients_lock
        super().__init__(*args, **kwargs)

    def get_request(self):
        sock, addr = super().get_request()
        with self._clients_lock:
            self._clients.add(sock)
        return sock, addr

    def shutdown_request(self, request):
        with self._clients_lock:
            self._clients.discard(request)
        super().shutdown_request(request)

    def sever_all(self) -> None:
        """Close the listener and hard-reset every open client socket."""
        try:
            self.socket.close()
        except OSError:
            pass
        with self._clients_lock:
            clients = list(self._clients)
            self._clients.clear()
        for sock in clients:
            # shutdown(), not close(): the handler thread's rfile/wfile
            # hold _io_refs on the socket, so close() from here only
            # drops a refcount and the connection would stay open until
            # the handler exits.  shutdown tears the TCP stream down now.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


def _release_waiters(srv: InferenceServer) -> None:
    """Wake every handler thread still waiting on a stopped loop: a
    stream reads its inactivity timeout, a plain request its timed-out
    wait.  Each writes to a severed socket and unwinds now, not minutes
    later, so nothing keeps the killed replica's engine alive."""
    for chunks in list(srv._stream_queues.values()):
        chunks.put(('timeout', None))
    for ev in list(srv._events.values()):
        ev.set()


class KillableReplica:
    """One in-process replica that can be killed and respawned.

    The port is pinned at construction so the replica keeps its URL
    identity across kill/respawn -- the LB's per-replica breaker state
    keys on the URL, and recovery (half-open probe succeeding against
    the respawned process) only makes sense at a stable address.
    """

    def __init__(self, make_engine: Callable[[], InferenceEngine],
                 port: int, host: str = '127.0.0.1',
                 tokenizer: Optional[object] = None):
        self.make_engine = make_engine
        self.host = host
        self.port = port
        self.tokenizer = tokenizer
        self.server: Optional[InferenceServer] = None
        self.httpd: Optional[_TrackingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.alive = False
        self.kills = 0

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def start(self, ready_timeout: float = 120.0) -> None:
        assert not self.alive, 'start() on a live replica'
        engine = self.make_engine()
        srv = InferenceServer(engine, tokenizer=self.tokenizer)
        srv.start()
        if not srv.ready.wait(ready_timeout):
            raise TimeoutError(
                f'replica :{self.port} never became ready')
        httpd = _TrackingHTTPServer((self.host, self.port),
                                    _make_handler(srv))
        httpd.daemon_threads = True
        thread = threading.Thread(target=httpd.serve_forever,
                                  kwargs={'poll_interval': 0.05},
                                  daemon=True,
                                  name=f'replica-{self.port}')
        thread.start()
        self.server, self.httpd, self._thread = srv, httpd, thread
        self.alive = True

    def busy(self) -> bool:
        """True while a generate request is in flight (the interesting
        moment to kill)."""
        return self.alive and self.server is not None and \
            self.server.gen_inflight > 0

    def kill(self) -> None:
        """Preempt: RST every connection, stop accepting, stop the
        engine's serving loop, drop the engine.  From the LB's view this
        is a dead VM."""
        if not self.alive:
            return
        self.alive = False
        self.kills += 1
        httpd, srv, thread = self.httpd, self.server, self._thread
        self.httpd, self.server, self._thread = None, None, None
        if httpd is not None:
            # Stop the accept loop BEFORE closing its socket: a closed
            # fd inside serve_forever's selector raises in that thread
            # and shutdown() would then wait on a loop that already
            # died.  Only after shutdown returns is the listener closed
            # (connects refuse) and every in-flight connection RST.
            httpd.shutdown()
            httpd.sever_all()
        if thread is not None:
            thread.join(timeout=5)
        if srv is not None:
            srv.stop()
            _release_waiters(srv)
        logger.info('chaos: killed replica :%d', self.port)

    def respawn(self, ready_timeout: float = 120.0) -> None:
        """Fresh engine + server on the SAME port (recovered VM)."""
        if self.alive:
            return
        self.start(ready_timeout)
        logger.info('chaos: respawned replica :%d', self.port)


KILL_MODES = ('group', 'rank0', 'worker')


class EngineRecipe:
    """A picklable engine factory: a module-level function and its
    arguments.  ``recipe(mesh)`` returns ``fn(*args, mesh=mesh,
    **kwargs)``; ``recipe()`` is an engine factory of ``KillableReplica``
    (no mesh).  Another process finds the function again by its module's
    name or, for a script run as ``__main__`` or a module loaded by path,
    by the module's file."""

    def __init__(self, fn: Callable[..., InferenceEngine], *args, **kwargs):
        if isinstance(fn, functools.partial):
            args, kwargs = fn.args + args, {**fn.keywords, **kwargs}
            fn = fn.func
        self.module = fn.__module__
        self.file = fn.__code__.co_filename
        self.name = fn.__qualname__
        self.args, self.kwargs = tuple(args), dict(kwargs)

    def function(self) -> Callable[..., InferenceEngine]:
        mod = sys.modules.get(self.module)
        if not hasattr(mod, self.name):
            try:
                mod = importlib.import_module(self.module)
            except ImportError:
                mod = None
        if not hasattr(mod, self.name):
            # A script, or a module loaded by path: load its file.
            name = f'_chaos_recipe_{self.module.strip("_")}'
            spec = importlib.util.spec_from_file_location(name, self.file)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        return getattr(mod, self.name)

    def __call__(self, mesh=None) -> InferenceEngine:
        return self.function()(*self.args, mesh=mesh, **self.kwargs)


def pid_alive(pid: int) -> bool:
    """Whether `pid` is a running process: a zombie is not (an orphan's
    stays one where nothing reaps it)."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            state = f.read().rsplit(')', 1)[1].split()[0]
    except OSError:
        return False
    return state not in ('Z', 'X')


class ProcessReplica:
    """A tensor-parallel replica in processes of its own, killable and
    respawnable like ``KillableReplica`` (the same interface: ``url``,
    ``port``, ``alive``, ``kills``, ``start()``, ``busy()``, ``kill()``,
    ``respawn()``), so ``ChaosFleet``, ``SeededKiller`` and the LB take it
    unchanged.

    Rank 0 runs in a child process, forked from a server process that has
    imported the port, in a session of its own: it starts ranks 1..tp-1
    with ``server._join_tp_group`` (forked from it, so they inherit its
    session), builds its engine over ``tp_mesh(tp)`` from `recipe` (an
    ``EngineRecipe``, or a ``functools.partial`` of a module-level
    function that takes ``mesh=``), sends the recipe to the other ranks
    (``server._tp_worker`` builds theirs from it) and serves the unchanged
    routes through ``InferenceServer`` at the port pinned here.  The
    group is gloo on the CPU and where ranks share a card (one card:
    every rank on card 0), NCCL with a card a rank (``_init_rank``).

    The child's stdout and stderr go to ``stderr.log`` in the replica's
    temporary directory, its pids to ``pids.json``, and, with a sanitizer
    gate on (``SKYTPU_SANITIZERS`` and the others pass to every rank),
    rank 0's ``sanitizers.report()`` to ``sanitizers.json``: the serving
    loop's quiesce audits (block conservation, every rank's shard layout)
    and the first lock-order, leak or layout error.  A child that fails
    to build or to reach readiness makes ``start()`` raise with the tail
    of that log; nothing stands in for it.  ``stop()`` removes the
    temporary directory unless the caller named it (`workdir`).
    """

    def __init__(self, recipe, port: int, tp: int = 2,
                 host: str = '127.0.0.1', device=None,
                 workdir: Optional[str] = None,
                 threads: Optional[int] = None):
        self.recipe = (recipe if isinstance(recipe, EngineRecipe) else
                       EngineRecipe(recipe))
        self.port = port
        self.tp = tp
        self.host = host
        # None means the card, and raises without one (resolve_device).
        self.device = resolve_device(device).type
        self._own_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix='chaos-tp-')
        self.threads = threads
        self.alive = False
        self.kills = 0
        self.starts = 0
        self._proc = None
        self._pids: Dict[str, Any] = {}
        self._dir: Optional[str] = None
        # The last kill: {'mode', 'at' (time.monotonic())}.
        self.last_kill: Optional[Dict[str, Any]] = None

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    # ------------------------------------------------------------- start

    def start(self, ready_timeout: float = 180.0) -> None:
        assert not self.alive, 'start() on a live replica'
        self.reap(10.0)
        self.starts += 1
        self._dir = os.path.join(self.workdir, f'start{self.starts}')
        os.makedirs(self._dir)
        env = {k: os.environ.get(k) for k in _PASSED_ENV}
        spec = {'recipe': self.recipe, 'tp': self.tp, 'device': self.device,
                'host': self.host, 'port': self.port, 'dir': self._dir,
                'threads': self.threads, 'env': env}
        self._proc = _context().Process(target=_replica_main, args=(spec,),
                                        daemon=True,
                                        name=f'chaos-tp-{self.port}')
        self._proc.start()
        deadline = time.monotonic() + ready_timeout  # det-ok: startup wait (harness)
        while True:
            if not self._proc.is_alive():
                code = self._proc.exitcode
                self._terminate()       # a worker it had started
                raise RuntimeError(
                    f'tensor-parallel replica :{self.port} exited '
                    f'({code}) before it was ready:\n{self.log_tail()}')
            pids = self._read_pids()
            if pids is not None and self.health() is not None:
                self._pids = pids
                break
            if time.monotonic() > deadline:  # det-ok: startup wait (harness)
                self._terminate()
                raise TimeoutError(
                    f'tensor-parallel replica :{self.port} not ready in '
                    f'{ready_timeout} s:\n{self.log_tail()}')
            time.sleep(0.05)
        self.alive = True

    def _read_pids(self) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(self._dir, 'pids.json')) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def health(self, timeout: float = 1.0) -> Optional[Dict[str, Any]]:
        """Rank 0's /healthz document (any status), or None when it does
        not answer."""
        try:
            with urllib.request.urlopen(f'{self.url}/healthz',
                                        timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except ValueError:
                return None
        except (OSError, ValueError):
            return None

    def log_tail(self, n: int = 4000) -> str:
        """The end of the child's stdout and stderr (every rank's)."""
        if self._dir is None:
            return ''
        try:
            with open(os.path.join(self._dir, 'stderr.log'), 'rb') as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors='replace')
        except OSError:
            return ''

    # ----------------------------------------------------------- reading

    def busy(self) -> bool:
        """True while a generate request is in flight (rank 0's
        /healthz ``inflight``)."""
        if not self.alive:
            return False
        doc = self.health(timeout=0.5)
        return bool(doc and doc.get('inflight', 0) > 0)

    def pids(self) -> Dict[str, Any]:
        """{'rank0': pid, 'workers': [pid, ...]} of the current start."""
        return {'rank0': self._pids['rank0'],
                'workers': list(self._pids['workers'])}

    def _all_pids(self) -> List[int]:
        if not self._pids:
            return []
        return [self._pids['rank0']] + list(self._pids['workers'])

    def live_pids(self) -> List[int]:
        """The replica's processes still running (a zombie is not)."""
        return [p for p in self._all_pids() if pid_alive(p)]

    def wait_gone(self, timeout: float, pids: Optional[Sequence[int]] = None
                  ) -> Dict[int, Optional[float]]:
        """Wait up to `timeout` s for every process of the replica (or
        those of `pids`) to end; {pid: seconds from the last kill (or
        from now) to its end, None if it is still running}."""
        t0 = (self.last_kill or {}).get('at', time.monotonic())  # det-ok: kill-to-gone wall time (recorded)
        gone: Dict[int, Optional[float]] = {}
        deadline = time.monotonic() + timeout  # det-ok: harness wait
        pending = [p for p in self._all_pids() if pids is None or p in pids]
        while True:
            if self._proc is not None and not self._proc.is_alive():
                self._proc.join(0)        # reap rank 0 (our child)
            for pid in list(pending):
                if not pid_alive(pid):
                    gone[pid] = time.monotonic() - t0  # det-ok: kill-to-gone wall time (recorded)
                    pending.remove(pid)
            if not pending or time.monotonic() > deadline:  # det-ok: harness wait
                break
            time.sleep(0.01)
        gone.update({pid: None for pid in pending})
        return gone

    def sanitizer_report(self) -> Optional[Dict[str, Any]]:
        """The child's findings (``sanitizers.json``: audits run and
        findings), or None when no gate is on or no audit ran yet."""
        if self._dir is None:
            return None
        try:
            with open(os.path.join(self._dir, 'sanitizers.json')) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -------------------------------------------------------------- kill

    def kill(self, mode: str = 'group') -> None:
        """Preempt.  'group': SIGKILL every rank (the preempted VM);
        'rank0': rank 0 alone; 'worker': the last worker rank alone.  New
        connects are refused and in-flight ones reset once rank 0 is
        gone; after a worker's death rank 0 answers /healthz 'dead'."""
        if mode not in KILL_MODES:
            raise ValueError(f'kill mode {mode!r}; one of {KILL_MODES}')
        if not self.alive:
            return
        self.alive = False
        self.kills += 1
        self.last_kill = {'mode': mode, 'at': time.monotonic()}  # det-ok: kill stamp for the gone time
        if mode == 'group':
            _signal_group(self._pids['rank0'])
        elif mode == 'rank0':
            _signal(self._pids['rank0'])
        else:
            _signal(self._pids['workers'][-1])
        logger.info('chaos: killed tensor-parallel replica :%d (%s)',
                    self.port, mode)

    def reap(self, grace: float) -> List[int]:
        """End what is left of the last start: wait up to `grace` s for
        its processes to end by themselves (none after a 'worker' kill:
        rank 0 stays up by design, answering 'dead'), then SIGKILL its
        session.  Returns the pids that had to be killed."""
        if not self._pids:
            return []
        if self.alive or (self.last_kill or {}).get('mode') == 'worker':
            grace = 0.0
        left = [p for p, t in self.wait_gone(grace).items() if t is None]
        if left:
            # The workers were forked into rank 0's session.
            _signal_group(self._pids['rank0'])
            self.wait_gone(5.0)
        if self._proc is not None:
            self._proc.join(5.0)
        self._pids, self._proc = {}, None
        return left

    def _terminate(self) -> None:
        """End a start that never became ready: its whole session."""
        _signal_group(self._proc.pid)
        self._proc.join(10)
        self._pids, self._proc = {}, None

    def respawn(self, ready_timeout: float = 180.0) -> None:
        """Fresh ranks on the SAME port (recovered VM), once what is left
        of the killed ones has ended (``reap``)."""
        if self.alive:
            return
        self.start(ready_timeout)
        logger.info('chaos: respawned tensor-parallel replica :%d',
                    self.port)

    def stop(self) -> None:
        """Kill every rank, then remove the temporary directory (logs
        and reports) unless the caller named it."""
        if self.alive:
            self.kill('group')
        self.reap(5.0)
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


# The env the harness passes to every rank as it is when the replica
# starts (the child is forked from a server process started earlier,
# whose env is the harness's at that time).
_PASSED_ENV = ('SKYTPU_SANITIZERS', 'SKYTPU_LOCK_SANITIZER',
               'SKYTPU_BLOCK_SANITIZER', 'SKYTPU_SHARD_SANITIZER')
# A replica forms its own group: the harness's rendezvous env is not its.
_GROUP_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',
              'LOCAL_RANK', 'SKYTPU_COORDINATOR_ADDRESS',
              'SKYTPU_PROCESS_ID', 'SKYTPU_NUM_PROCESSES')
# What the server process imports once: the caller's main script (when
# it is one, a rank 0 need not import it again) and the port.
_SERVER_MODULES = ['__main__', 'skypilot_tpu_torch.infer.chaos']


@functools.lru_cache(maxsize=None)
def _context():
    """The start method of rank 0: forked from a server process that
    imported the port once (seconds of imports saved on every start),
    and that never touches the card."""
    ctx = mp.get_context('forkserver')
    ctx.set_forkserver_preload(_SERVER_MODULES)
    return ctx


def start_fork_server() -> None:
    """Start the server process that ProcessReplicas fork their rank 0
    from, so that its imports overlap the caller's other work instead of
    the first start (it starts at the first ``start()`` otherwise)."""
    _context()
    forkserver.ensure_running()


def _signal(pid: int) -> None:
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _signal_group(pgid: int) -> None:
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _replica_main(spec: Dict[str, Any]) -> None:
    """Rank 0 of a ``ProcessReplica`` (its child process)."""
    os.setsid()          # a session of its own: kill('group') is killpg
    # Daemonic for the harness (it ends rank 0 when it exits), yet rank 0
    # starts the other ranks.
    mp.current_process().daemon = False
    log = os.open(os.path.join(spec['dir'], 'stderr.log'),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(log, 1)
    os.dup2(log, 2)
    # SIGUSR1 prints where every thread of rank 0 is (a hang's witness).
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    for k in _GROUP_ENV:
        os.environ.pop(k, None)
    for k, v in spec['env'].items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    # The ranks' rendezvous file lands in the replica's directory.
    tempfile.tempdir = spec['dir']
    if spec['threads']:
        torch.set_num_threads(spec['threads'])
    tp, device, recipe = spec['tp'], spec['device'], spec['recipe']
    ranks = server_lib._join_tp_group(tp, device, start_method='fork')
    mesh = tp_mesh(tp, device)
    tp_lib.control_group()
    tp_lib.broadcast_object(recipe)
    engine = recipe(mesh=mesh)
    server_lib._watch_ranks(ranks, engine)
    srv = InferenceServer(engine)
    srv.start()
    srv.ready.wait()
    httpd = _BurstTolerantHTTPServer((spec['host'], spec['port']),
                                     _make_handler(srv))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name='replica-http').start()
    _write_json(os.path.join(spec['dir'], 'pids.json'),
                {'rank0': os.getpid(), 'workers': [p.pid for p in ranks]})
    _report_forever(os.path.join(spec['dir'], 'sanitizers.json'))


def _write_json(path: str, doc: Dict[str, Any]) -> None:
    with open(path + '.tmp', 'w') as f:
        json.dump(doc, f)
    os.replace(path + '.tmp', path)


def _report_forever(path: str, period_s: float = 0.5) -> None:
    """Rank 0's main thread from readiness on: with a sanitizer gate on,
    ``sanitizers.report()`` to `path` whenever it changes."""
    gated = (sanitizers.block_sanitizer_enabled() or
             sanitizers.shard_sanitizer_enabled() or
             sanitizers.lock_sanitizer_enabled())
    last = None
    while True:
        time.sleep(period_s)
        doc = sanitizers.report()
        if gated and doc != last:
            _write_json(path, doc)
            last = doc


def free_port(host: str = '127.0.0.1') -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ChaosFleet:
    """N killable replicas behind a standalone load balancer.

    Standalone: the replica set is seeded directly into the policy (by
    ``make_lb``) and stays FIXED across kills -- ejection and
    re-admission of dead/respawned replicas is exactly the breaker/probe
    machinery under test, not set management.  ``make_lb`` is called
    again for every LB generation (``restart_lb``), so it must build a
    fresh policy each time.
    """

    def __init__(self,
                 make_engine: Union[Callable[[], InferenceEngine],
                                    Sequence[Union[
                                        Callable[[], InferenceEngine],
                                        'ProcessReplica']]],
                 n_replicas: int, make_lb: LBFactory,
                 host: str = '127.0.0.1',
                 journal_path: Optional[str] = None):
        # One factory for a homogeneous fleet, or one per replica for a
        # mixed one: an engine factory (an in-process replica) or a
        # ProcessReplica (a tensor-parallel one, its port its own).
        if callable(make_engine):
            factories = [make_engine] * n_replicas
        else:
            factories = list(make_engine)
            if len(factories) != n_replicas:
                raise ValueError(
                    f'{len(factories)} engine factories for '
                    f'{n_replicas} replicas')
        self.replicas = [
            f if isinstance(f, ProcessReplica) else
            KillableReplica(f, free_port(host), host=host)
            for f in factories
        ]
        self.host = host
        self.make_lb = make_lb
        self.journal_path = journal_path
        # Degraded (gray-failure) proxies by replica index: routing
        # goes through the proxy URL while the replica itself stays
        # reachable at its own port (the two URLs are distinct replica
        # identities from the LB's point of view -- deliberate, so the
        # probation verdict lands on the degraded path).
        self.degraded: Dict[int, 'DegradedReplica'] = {}
        # LB port pinned ONCE: kill_lb/restart_lb keep the URL clients
        # hold stable across LB generations (the contract the
        # supervisor gives the real serve plane).
        self.lb_port = free_port(host)
        self.lb_kills = 0
        self.lb_restarts = 0
        self.lb = self._new_lb()
        self._lb_thread: Optional[threading.Thread] = None

    def _new_lb(self):
        lb = self.make_lb(self.lb_port, self._replica_urls(),
                          self.journal_path, _TrackingHTTPServer)
        self.policy = lb.policy
        return lb

    def _replica_urls(self) -> List[str]:
        return [
            self.degraded[i].url if i in self.degraded else r.url
            for i, r in enumerate(self.replicas)
        ]

    @property
    def lb_url(self) -> str:
        return f'http://127.0.0.1:{self.lb.port}'

    def start(self) -> None:
        for r in self.replicas:
            r.start()
        self._lb_thread = threading.Thread(target=self.lb.run,
                                           daemon=True, name='chaos-lb')
        self._lb_thread.start()
        self._wait_lb_up()

    def _wait_lb_up(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout  # det-ok: harness wait
        while time.monotonic() < deadline:  # det-ok: harness wait
            try:
                with socket.create_connection(
                        ('127.0.0.1', self.lb.port), timeout=0.2):
                    return
            except OSError:
                time.sleep(0.05)
        raise TimeoutError('load balancer never came up')

    # ----------------------------------------------- control-plane chaos

    def kill_lb(self) -> None:
        """Crash the load balancer: listener closed, every in-flight
        proxied connection RST -- from a client's view the service's one
        front door slams shut mid-stream."""
        lb, thread = self.lb, self._lb_thread
        # Crash fidelity: a SIGKILL'd LB never gets to journal its
        # in-flight lease releases.  Detach the journal BEFORE severing
        # so unwinding handler threads can't write `held: False` -- the
        # successor must see the orphaned leases and adopt them.
        lb.journal = None
        httpd = lb._httpd  # pylint: disable=protected-access
        if httpd is not None:
            httpd.shutdown()
            httpd.sever_all()
        lb.stop()
        if thread is not None:
            thread.join(timeout=5)
        self.lb_kills += 1
        logger.info('chaos: killed LB :%d', self.lb_port)

    def restart_lb(self, wait_adopted: bool = True,
                   timeout: float = 10.0) -> None:
        """Bring a FRESH LB up on the same port (what the supervisor
        does in the real serve plane): new policy instance, journal
        re-adopted in the constructor.  With `wait_adopted`, block until
        the restarted LB has re-verified every journal-adopted replica
        with a live probe (adopted_unverified drains to []) -- traffic
        sent before that may be quarantined away from healthy replicas.
        """
        self.lb = self._new_lb()
        self._lb_thread = threading.Thread(target=self.lb.run,
                                           daemon=True, name='chaos-lb')
        self._lb_thread.start()
        self._wait_lb_up(timeout)
        self.lb_restarts += 1
        if wait_adopted:
            deadline = time.monotonic() + timeout  # det-ok: harness wait
            while time.monotonic() < deadline:  # det-ok: harness wait
                try:
                    with urllib.request.urlopen(
                            f'{self.lb_url}/lb/stats', timeout=2) as resp:
                        stats = json.loads(resp.read())
                    if not stats.get('adopted_unverified'):
                        break
                except OSError:
                    pass
                time.sleep(0.05)
        logger.info('chaos: restarted LB :%d (journal=%s)', self.lb_port,
                    bool(self.journal_path))

    def lb_stats(self) -> Dict[str, Any]:
        """One `/lb/stats` snapshot from the CURRENT LB generation.
        The batch chaos leg reads this after restart_lb() to assert the
        journal hand-off (``batch_leases_adopted``) actually happened --
        a restart that silently dropped its leases would still pass the
        byte-identity check (the coordinator retries), so the counter
        is the only witness that recovery took the journal path."""
        with urllib.request.urlopen(f'{self.lb_url}/lb/stats',
                                    timeout=5) as resp:
            return json.loads(resp.read())

    def degrade_one(self, index: int, plan,
                    seed: int = 0) -> 'DegradedReplica':
        """Put a gray-failure proxy in front of replica `index` and
        re-seed routing through it.  The replica stays perfectly
        healthy; only its network path rots -- the case the probation
        track exists for."""
        if index in self.degraded:
            return self.degraded[index]
        proxy = DegradedReplica(self.replicas[index], plan, seed=seed,
                                host=self.host)
        proxy.start()
        self.degraded[index] = proxy
        self.policy.set_ready_replicas(self._replica_urls())
        logger.info('chaos: degraded replica :%d behind proxy :%d',
                    self.replicas[index].port, proxy.port)
        return proxy

    def live_replicas(self) -> List[Union[KillableReplica,
                                          'ProcessReplica']]:
        return [r for r in self.replicas if r.alive]

    def kill_one(self, prefer_busy: bool = True) -> \
            Optional[Union[KillableReplica, 'ProcessReplica']]:
        """Kill one live replica -- busy ones first (mid-decode kills
        are the case under test) -- but NEVER the last live one: with
        zero replicas every request fails by construction and the run
        proves nothing about failover."""
        live = self.live_replicas()
        if len(live) <= 1:
            return None
        busy = [r for r in live if r.busy()] if prefer_busy else []
        victim = busy[0] if busy else live[0]
        victim.kill()
        return victim

    def respawn_dead(self) -> None:
        for r in self.replicas:
            if not r.alive:
                r.respawn()

    def stop(self) -> None:
        self.lb.stop()
        for proxy in self.degraded.values():
            proxy.stop()
        for r in self.replicas:
            if isinstance(r, ProcessReplica):
                r.stop()         # its ranks too, whatever killed it
            else:
                r.kill()


class SeededKiller(threading.Thread):
    """Consults the plan's ``replica_kill`` site on a fixed tick and
    kills per its verdicts.  Determinism note: WHICH consult fires is a
    pure function of (seed, consult index); which replica dies and
    where its streams were depends on timing -- the assertions
    (byte-identity of every completed answer) are timing-independent,
    which is the point.
    """

    def __init__(self, fleet: ChaosFleet, plan, tick_s: float = 0.05):
        super().__init__(daemon=True, name='chaos-killer')
        self.fleet = fleet
        self.plan = plan
        self.tick_s = tick_s
        self.kills = 0
        self.lb_kills = 0
        # NOT named _stop: that would shadow threading.Thread._stop,
        # which join() calls internally.
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            if self.plan.check('replica_kill') is not None:
                if self.fleet.kill_one() is not None:
                    self.kills += 1
            if self.plan.check('lb_kill') is not None:
                # Kill + supervisor-style restart on the same port: the
                # window where clients see connection errors is the
                # restart latency, exactly as in the real serve plane.
                self.fleet.kill_lb()
                self.fleet.restart_lb()
                self.lb_kills += 1
            self._halt.wait(self.tick_s)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)


class DegradedReplica:
    """Gray-failure wrapper: a TCP splice proxy in front of a healthy
    replica.

    Crashes are the EASY failure -- connection refused trips the
    breaker in seconds.  The failure that silently ruins a fleet's
    tail is the replica that stays alive and keeps answering probes
    while its responses crawl.  This proxy manufactures exactly that:
    the client->server direction passes through untouched, and each
    server->client chunk consults the plan's ``net_degrade`` site -- a
    firing spec either sleeps ``delay_s +- jitter_s`` (seeded uniform)
    before relaying, or, with ``blackhole``, stops relaying the
    connection's downstream bytes entirely (a hung-but-open socket).

    The proxy has its own pinned port: the LB routes to the PROXY url,
    so from the control plane's view the degraded path IS the replica --
    TTFT samples, probation verdicts, and weight shed all land on it
    while the wrapped engine stays pristine.
    """

    def __init__(self, inner: KillableReplica, plan, seed: int = 0,
                 host: str = '127.0.0.1'):
        self.inner = inner
        self.plan = plan
        self.host = host
        self.port = free_port(host)
        # Jitter draws come from the proxy's own seeded stream (NOT the
        # plan's per-spec streams, which must stay consult-aligned).
        self._rng = np.random.default_rng(seed)  # guarded-by: _rng_lock
        self._rng_lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.chaos.degraded._rng_lock')
        self._halt = threading.Event()
        self._listener: Optional[socket.socket] = None
        self.chunks_delayed = 0
        self.chunks_blackholed = 0

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def start(self) -> None:
        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen(64)
        self._listener = listener
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f'degrade-{self.port}').start()

    def stop(self) -> None:
        self._halt.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._halt.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            try:
                upstream = socket.create_connection(
                    (self.inner.host, self.inner.port), timeout=5)
            except OSError:
                client.close()
                continue
            threading.Thread(
                target=self._splice, args=(client, upstream, False),
                daemon=True, name=f'degrade-up-{self.port}').start()
            threading.Thread(
                target=self._splice, args=(upstream, client, True),
                daemon=True, name=f'degrade-down-{self.port}').start()

    def _splice(self, src: socket.socket, dst: socket.socket,
                degrade: bool) -> None:
        """Relay src->dst until either side dies.  Only the downstream
        (server->client) direction is degraded: requests arrive intact,
        responses rot -- the asymmetry real congested paths show."""
        blackholed = False
        try:
            while not self._halt.is_set():
                try:
                    chunk = src.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                if degrade and not blackholed:
                    spec = self.plan.check('net_degrade')
                    if spec is not None:
                        if spec.blackhole:
                            # Hung-but-open: swallow this and every
                            # later downstream byte; the client waits
                            # on a socket that never speaks again.
                            blackholed = True
                            self.chunks_blackholed += 1
                        elif spec.delay_s > 0.0:
                            with self._rng_lock:
                                jitter = float(self._rng.uniform(
                                    -spec.jitter_s, spec.jitter_s))
                            time.sleep(max(0.0, spec.delay_s + jitter))
                            self.chunks_delayed += 1
                if blackholed and degrade:
                    continue
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
        finally:
            for sock in (src, dst):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
