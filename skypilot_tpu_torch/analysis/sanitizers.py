"""Opt-in runtime sanitizers of the port: the twin of
``skypilot_tpu/analysis/sanitizers.py``.  Each is env-gated and costs
nothing when off:

- ``SKYTPU_LOCK_SANITIZER=1``: ``instrument_lock(lock, name)`` wraps a
  ``threading.Lock`` so every acquisition records (per thread) what was
  already held, feeding a global lock-order graph.  Acquiring A while
  holding B after some thread ever acquired B while holding A raises
  ``LockOrderError``: the ABBA inversion is caught even when the timing
  never deadlocks.  Re-acquiring a lock the current thread already holds
  raises at once (a non-reentrant lock would block forever), before the
  real lock is touched.  With the gate off ``instrument_lock`` returns
  the lock unchanged.  Lock names are roles shared across instances
  (``'infer.engine._lock'``), so an order inversion between two engines
  is still an inversion.
- ``SKYTPU_BLOCK_SANITIZER=1``: ``check_block_conservation(engine)``
  verifies the paged pool's refcount conservation law at a quiesce
  point: every block's refcount equals the slot-table entries + radix
  nodes + registered-prefix entries holding it, and the free list is
  exactly the zero-refcount blocks.  With the host KV tier armed, its
  byte-ledger audit runs under the same lock.  Violations raise
  ``BlockLeakError``.  The serving loop calls ``audit_quiesce`` (this
  check and the next) on idle passes.
- ``SKYTPU_SHARD_SANITIZER=1``: ``check_shard_layout(engine)`` runs at
  the same quiesce point and asserts, on every rank of a tensor-parallel
  engine, that the live KV cache and weights hold their declared layout:
  every cache leaf holds ``Hkv // tp`` kv heads (a paged pool is exactly
  ``[num_blocks, Hkv // tp, block_size, D]``: dim 0 is the allocator's
  block-id space), every parameter has its rank-local shape by the rules
  table (``parallel.mesh.local_shape``) and lies on the rank's device,
  and under ``tensor`` > 1 at least one parameter is sharded (a fully
  replicated model is the silent memory blow-up).  The LoRA adapter
  stacks of multi-LoRA serving are parameters like the others: each leaf
  has its rank-local shape (``lora_b`` split with a column-parallel
  projection, ``lora_a`` with a row-parallel one).  GPT-2's fused
  ``c_attn`` must hold the rank's heads of q, k and v: each of its heads'
  sums equals that head's in the full weight, which rank 0 saw at
  placement (``qkv_head_sums``), so a contiguous row split, which gives
  rank 0 every q head, fails.  Violations raise ``ShardLayoutError``; an
  engine without a mesh is a no-op.

``SKYTPU_SANITIZERS=1`` enables all three.  ``report()`` gives the
quiesce audits run in the process and the first error of each kind
raised there, for a harness that cannot catch them (a replica in a
process of its own).  The reference's fourth, the
compile budget, has no counterpart: the port compiles no graphs.
"""
import os
import threading
from typing import Any, Dict, List, Optional, Set

import torch

from skypilot_tpu_torch.parallel.mesh import local_shape

_TRUTHY = frozenset({'1', 'true', 'yes', 'on'})


def _env_on(name: str) -> bool:
    return os.environ.get(name, '').strip().lower() in _TRUTHY


def lock_sanitizer_enabled() -> bool:
    return _env_on('SKYTPU_LOCK_SANITIZER') or _env_on('SKYTPU_SANITIZERS')


def block_sanitizer_enabled() -> bool:
    return _env_on('SKYTPU_BLOCK_SANITIZER') or _env_on('SKYTPU_SANITIZERS')


def shard_sanitizer_enabled() -> bool:
    return (_env_on('SKYTPU_SHARD_SANITIZER') or
            _env_on('SKYTPU_SANITIZERS'))


class LockOrderError(RuntimeError):
    """A lock acquisition violates the global acquisition order."""


class BlockLeakError(RuntimeError):
    """The paged pool's refcount conservation invariant is broken.
    ``errors`` holds the violations, one string each."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__('block conservation violated:\n  '
                         + '\n  '.join(self.errors))


class ShardLayoutError(RuntimeError):
    """A live cache leaf or weight drifted from the declared layout (or
    the weights replicated under tensor > 1)."""


# --------------------------------------------------------------- lock order

class _OrderGraph:
    """Global held->acquired edge graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # role name -> roles acquired at least once while it was held
        self.edges: Dict[str, Set[str]] = {}
        self._tls = threading.local()

    def _stack(self) -> List[str]:
        st = getattr(self._tls, 'stack', None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """BFS path src -> ... -> dst through edges, else None.
        Caller holds self._mu."""
        if src == dst:
            return [src]
        parents: Dict[str, str] = {}
        frontier = [src]
        while frontier:
            nxt: List[str] = []
            for node in frontier:
                for succ in self.edges.get(node, ()):
                    if succ in parents or succ == src:
                        continue
                    parents[succ] = node
                    if succ == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(parents[path[-1]])
                        return list(reversed(path))
                    nxt.append(succ)
            frontier = nxt
        return None

    def before_acquire(self, name: str) -> None:
        """Called BEFORE touching the real lock: self-deadlock check."""
        if name in self._stack():
            raise _recorded(LockOrderError(
                f"thread re-acquiring non-reentrant lock '{name}' it "
                'already holds (would deadlock); mark the helper '
                "'# locked:' and drop the inner acquisition"))

    def after_acquire(self, name: str) -> None:
        stack = self._stack()
        cycle: Optional[List[str]] = None
        with self._mu:
            for held in stack:
                self.edges.setdefault(held, set()).add(name)
            for held in stack:
                path = self._path(name, held)
                if path is not None:
                    cycle = path + [name]
                    break
        stack.append(name)
        if cycle is not None:
            raise _recorded(LockOrderError(
                'lock-order inversion: acquired '
                f"'{name}' while holding '{cycle[-2]}', but the reverse "
                f"order was also observed (cycle: {' -> '.join(cycle)})"))

    def on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def snapshot(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self.edges.items()}

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()


_GRAPH = _OrderGraph()


def lock_order_edges() -> Dict[str, Set[str]]:
    """Copy of the observed acquisition-order graph (for tests/debug)."""
    return _GRAPH.snapshot()


def reset_lock_order() -> None:
    """Drop all recorded edges (tests only -- the graph is global)."""
    _GRAPH.reset()


class InstrumentedLock:
    """Duck-types threading.Lock; feeds the global order graph."""

    __slots__ = ('_lock', 'name')

    def __init__(self, lock: Any, name: str) -> None:
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        _GRAPH.before_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            try:
                _GRAPH.after_acquire(self.name)
            except LockOrderError:
                # The violation aborts the acquisition whole: the lock is
                # released and leaves the thread's held stack, so a
                # caller that catches the error holds nothing, real or
                # recorded.  (The reference releases the lock but keeps
                # the name on the stack, and the thread's next
                # acquisitions record edges from a lock it does not hold.)
                _GRAPH.on_release(self.name)
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        _GRAPH.on_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> 'InstrumentedLock':
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f'<InstrumentedLock {self.name!r} {self._lock!r}>'


def instrument_lock(lock: Any, name: str) -> Any:
    """Wrap ``lock`` for order checking, or return it unchanged when
    the sanitizer is off.  ``name`` is the lock's ROLE (e.g.
    ``'infer.engine._lock'``), shared across instances."""
    if not lock_sanitizer_enabled():
        return lock
    return InstrumentedLock(lock, name)


# --------------------------------------------------------------- block leak

def _conservation(engine: Any) -> tuple:
    """The law's violations and accounting on a paged engine's pool, read
    by a caller that holds ``engine._lock``."""
    n = int(engine._num_blocks)
    refs = [int(r) for r in engine._block_refs]
    expected = [0] * n
    expected[0] = 1                     # permanent dump-block ref
    slot_refs = 0
    for slot in range(engine._tables_np.shape[0]):
        k = int(engine._slot_nblocks[slot])
        for b in engine._tables_np[slot, :k]:
            expected[int(b)] += 1
            slot_refs += 1
    radix_refs = 0
    if getattr(engine, '_radix', None) is not None:
        for node in engine._radix.walk():
            expected[int(node.block)] += 1
            radix_refs += 1
    prefix_refs = 0
    for entry in engine._prefixes.values():
        for b in entry.get('blocks', ()):
            expected[int(b)] += 1
            prefix_refs += 1
    free = [int(b) for b in engine._free_blocks]
    # Host tier (when armed): its byte ledger is the tier-boundary half
    # of the law -- a spilled entry whose bytes drifted from the ledger
    # is a leak across the boundary the device-side refcounts cannot see.
    tier = getattr(engine, '_host_tier', None)
    errors: List[str] = list(tier.audit()) if tier is not None else []
    tier_entries = tier.entries if tier is not None else 0
    bad = [(b, refs[b], expected[b]) for b in range(n)
           if refs[b] != expected[b]]
    for b, got, want in bad[:5]:
        errors.append(f'block {b}: refcount {got} != {want} referers '
                      '(slot tables + radix + prefixes'
                      f'{" + dump ref" if b == 0 else ""})')
    if len(bad) > 5:
        errors.append(f'... and {len(bad) - 5} more blocks')
    if len(set(free)) != len(free):
        errors.append(f'free list contains duplicates '
                      f'({len(free) - len(set(free))})')
    if 0 in free:
        errors.append('dump block 0 is on the free list')
    zero_ref = {b for b in range(1, n) if refs[b] == 0}
    free_set = set(free) - {0}
    leaked = sorted(zero_ref - free_set)
    phantom = sorted(free_set - zero_ref)
    if leaked:
        errors.append(f'leaked blocks (refcount 0, not on free list): '
                      f'{leaked[:10]}')
    if phantom:
        errors.append(f'free-listed blocks with nonzero refcount: '
                      f'{phantom[:10]}')
    return errors, {'blocks': n - 1, 'free': len(free),
                    'slot_refs': slot_refs, 'radix_refs': radix_refs,
                    'prefix_refs': prefix_refs,
                    'host_tier_entries': tier_entries}


def check_block_conservation(engine: Any,
                             lock: bool = True) -> Optional[Dict[str, int]]:
    """Verify refcount conservation on a paged engine's block pool.

    For every block b in [1, num_blocks): ``_block_refs[b]`` must equal
    the number of slot-table entries (within each slot's
    ``_slot_nblocks``) + radix nodes + registered-prefix entries
    holding b; the dump block 0 carries exactly its permanent ref plus
    any table entries; and the free list is exactly the zero-ref
    blocks, without duplicates.  Acquires ``engine._lock`` itself --
    call from OUTSIDE the lock, at a quiesce point -- unless ``lock`` is
    False: the caller holds it (a check inside a decode window).

    Returns a small accounting dict on success (None for non-paged
    engines); raises BlockLeakError on violation.
    """
    if not getattr(engine, '_paged', False):
        return None
    if lock:
        with engine._lock:
            errors, counts = _conservation(engine)
    else:
        errors, counts = _conservation(engine)
    if errors:
        raise BlockLeakError(errors)
    return counts


def maybe_check_block_conservation(engine: Any) -> None:
    """Serving-loop quiesce hook: no-op unless the gate is on."""
    if block_sanitizer_enabled():
        check_block_conservation(engine)


# ------------------------------------------------------------- shard layout


def qkv_head_sums(t: torch.Tensor, heads: int) -> torch.Tensor:
    """The f32 sums [3, heads] of each head's rows of q, k and v in a
    fused c_attn weight or bias (rows q, k, v, each heads-major)."""
    return t.detach().float().reshape(3, heads, -1).sum(-1).cpu()


def local_shard_report(engine: Any) -> Dict[str, Any]:
    """This rank's counts and errors (see ``check_shard_layout``)."""
    errors: List[str] = []
    tp = engine._tp
    mc = engine.model_config
    hkv = mc.num_kv_heads // tp
    paged = bool(engine._paged)
    cache_leaves = 0
    for li, (k, v) in enumerate(engine.cache):
        for tag, leaf in (('k', k), ('v', v)):
            cache_leaves += 1
            if leaf.shape[1] != hkv:
                errors.append(
                    f'cache layer {li} {tag}: holds {leaf.shape[1]} kv '
                    f'heads, the declared layout owns {hkv} '
                    f'(Hkv={mc.num_kv_heads} over tensor={tp})')
            elif paged and tuple(leaf.shape) != (
                    engine._num_blocks, hkv, engine.cfg.kv_block_size,
                    mc.head_dim_):
                errors.append(
                    f'paged pool layer {li} {tag}: leaf shape '
                    f'{tuple(leaf.shape)} != allocator geometry '
                    f'({engine._num_blocks}, {hkv}, '
                    f'{engine.cfg.kv_block_size}, {mc.head_dim_})')
    state = engine.model.state_dict()
    device = (engine.device if engine._cuda_index is None
              else torch.device('cuda', engine._cuda_index))
    sharded = 0
    for name, t in state.items():
        full = engine._full_shapes.get(name)
        if full is None:
            continue
        want = local_shape(name, full, tp)
        if tuple(t.shape) != want:
            errors.append(f'param {name}: shape {tuple(t.shape)} != '
                          f'rank-local {want} of {full}')
        elif t.device != device:
            errors.append(f'param {name}: on {t.device}, the rank is on '
                          f'{device}')
        elif want != full:
            sharded += 1
    if tp > 1 and state and sharded == 0:
        errors.append(f'weights fully replicated across a tensor={tp} '
                      'mesh: every rank holds the whole model')
    qkv = {name: qkv_head_sums(t, mc.num_heads // tp)
           for name, t in state.items() if name in engine._qkv_head_sums}
    return {'cache_leaves': cache_leaves,
            'paged_pool_leaves': cache_leaves if paged else 0,
            'param_leaves': len(state),
            'param_leaves_sharded': sharded,
            'tensor_degree': tp,
            'errors': errors, 'qkv_head_sums': qkv}


def _qkv_errors(engine: Any, reports: List[Dict[str, Any]]) -> List[str]:
    """Each rank's fused q/k/v heads against the full weights' (rank 0's
    record): rank r of tensor coordinate c must hold heads
    [c * H / tp, (c + 1) * H / tp) of each of q, k and v."""
    tp = engine._tp
    per = engine.model_config.num_heads // tp
    errors = []
    for r, rep in enumerate(reports):
        c = engine._tpc.coords[r]
        for name, got in rep['qkv_head_sums'].items():
            want = engine._qkv_head_sums[name][:, c * per:(c + 1) * per]
            if got.shape != want.shape or not torch.allclose(
                    got, want, rtol=1e-5, atol=1e-6):
                errors.append(
                    f'rank {r}: {name} rows are not heads '
                    f'[{c * per}, {(c + 1) * per}) of q, k and v')
    return errors


def check_shard_layout(engine: Any) -> Dict[str, int]:
    """Assert every rank's live cache and weights hold their declared
    layout (see the module docstring).  Called on rank 0 (a dispatch:
    every rank checks its own shard).  Returns the JAX report's keys ({}
    without a mesh); raises ShardLayoutError on drift."""
    if getattr(engine, '_tpc', None) is None:
        return {}
    reports = engine._shard_report()
    errors = [f'rank {r}: {e}' for r, rep in enumerate(reports)
              for e in rep['errors']] + _qkv_errors(engine, reports)
    if errors:
        raise ShardLayoutError(
            'shard layout drifted from the declared layout:\n  '
            + '\n  '.join(errors[:8]))
    return {k: v for k, v in reports[0].items()
            if k not in ('errors', 'qkv_head_sums')}


def maybe_check_shard_layout(engine: Any) -> None:
    """Quiesce hook: the check when its sanitizer gate is on."""
    if shard_sanitizer_enabled():
        check_shard_layout(engine)


# ----------------------------------------------------------------- report

# What the sanitizers saw in this process, for a harness that cannot
# catch their errors where they are raised (a replica in a process of its
# own): the quiesce audits run and the first error of each kind.
_REPORT_MU = threading.Lock()
_REPORT: Dict[str, Any] = {'audits': 0, 'findings': {}}


def _recorded(err: Exception) -> Exception:
    """`err`, kept by ``report()`` when it is the first of its kind."""
    with _REPORT_MU:
        _REPORT['findings'].setdefault(type(err).__name__,
                                       f'{type(err).__name__}: {err}')
    return err


def audit_quiesce(engine: Any) -> None:
    """The serving loop's quiesce hook: block conservation and the shard
    layout, each when its gate is on; the audit is counted and a
    violation kept for ``report()``, then raised."""
    if not (block_sanitizer_enabled() or shard_sanitizer_enabled()):
        return
    found = None
    try:
        maybe_check_block_conservation(engine)
        maybe_check_shard_layout(engine)
    except (BlockLeakError, ShardLayoutError) as e:
        found = _recorded(e)
    with _REPORT_MU:
        _REPORT['audits'] += 1
    if found is not None:
        raise found


def report() -> Dict[str, Any]:
    """{'audits': the quiesce audits run in this process, 'findings': the
    first LockOrderError, BlockLeakError and ShardLayoutError raised here,
    each as 'Kind: message'}."""
    with _REPORT_MU:
        return {'audits': _REPORT['audits'],
                'findings': list(_REPORT['findings'].values())}
