"""Tensor-parallel serving: the dispatch protocol between the ranks of one
engine over a mesh with a 'tensor' axis (the port of the JAX engine's
``mesh=`` serving, ``skypilot_tpu/infer/engine.py``).

JAX serves a tensor-parallel replica from one process over its mesh; a
PyTorch replica is one process per card.  Every rank builds the same
``InferenceEngine`` over its shard of the weights and of the KV cache (a
rank-local model: ``models.registry.rank_config``), and:

- rank 0 alone owns the host state and runs the unchanged scheduler,
  radix tree, block allocator, QoS, lookahead and adaptive window;
- before each device dispatch (the engine's methods marked with
  ``dispatch``), rank 0 broadcasts the op's name and its host inputs
  (ids, lengths, positions, tables, temperatures, host KV rows) on a
  gloo group of every rank, then runs it on its own shard; every other
  rank runs ``serve_worker``, a loop that receives the op and runs it on
  its shard, so the model's collectives over the 'tensor' group meet;
- a dispatch's device results that rank 0 feeds back into a later one
  (the decode chain of a lookahead window, the rows of a dense
  registered prefix) stay on each rank under a handle: rank 0 sends the
  handle, and frees it on every rank when its own tensor is collected.

A lockstep loop on every rank would diverge on wall-clock decisions (the
adaptive window, QoS sheds, ``max_ttft``) and deadlock; here no rank but
0 decides anything.  Sampling stays identical across ranks because every
rank draws from an identically seeded generator in the same order, on
logits that are gathered whole.  'data', 'fsdp', 'seq' and 'stage' ranks
of the mesh run the same ops as replicas of their tensor group (no
parameter sits on those axes).  A dispatch argument wrapped in
``PerRank`` carries one value a rank: rank 0 scatters them after the
op's broadcast, so each rank receives its own (an adapter's slices).

Only rank 0 reads given weights: it sends every other rank that rank's
slice of each tensor (``local_params``), so one host holds the model
once; drawn weights are drawn by every rank from rank 0's generator
state.  After each dispatch every rank reports whether the op failed on
it; a failure anywhere stops the replica on every rank (rank 0 raises,
the others leave ``serve_worker`` raising), since a rank whose shard
missed an op would serve wrong tokens.  A failure on one rank in the
middle of a forward leaves its peers in a collective of the model's
groups until that group's timeout fails them too.
"""
import collections
import datetime
import functools
import math
import threading
import traceback
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import distributed as dist

from skypilot_tpu_torch.parallel.mesh import (Mesh, is_fused_qkv,
                                             local_shape, mesh_context,
                                             shard_tensor)

_STOP = '_tp_stop'

# The control group's timeout.  The other ranks spend a served replica's
# idle time blocked on it, waiting for rank 0's next op, so it has to
# outlast any idle spell (gloo's default is 30 minutes).  A rank that
# dies still fails its peers at once: gloo sees the connection close.
CONTROL_TIMEOUT = datetime.timedelta(days=365)

_control: Dict[str, Any] = {'world': None, 'group': None}


def control_group() -> dist.ProcessGroup:
    """The gloo group of every rank that carries rank 0's ops, their host
    inputs and every rank's status (the model's collectives use the
    mesh's groups).  One per process group: every rank creates it at its
    first call, at the same point of its sequence of groups, as
    ``new_group`` requires."""
    world = dist.group.WORLD
    if _control['world'] is not world:
        _control['group'] = dist.new_group(backend='gloo',
                                           timeout=CONTROL_TIMEOUT)
        _control['world'] = world
    return _control['group']


def broadcast_object(obj: Any = None) -> Any:
    """Rank 0's `obj` on every rank, over the control group."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=control_group())
    return box[0]


class _Ref:
    """A device result held on every rank under a handle."""
    __slots__ = ('key',)

    def __init__(self, key):
        self.key = key


class PerRank:
    """A dispatch argument with one value for each rank of the world, in
    rank order: each rank's call receives its own (see ``TensorParallel``
    ``call``)."""
    __slots__ = ('values',)

    def __init__(self, values):
        self.values = list(values)


class _Scattered:
    """A ``PerRank`` argument in the broadcast message: its values follow
    by scatter, in the order the message lists them."""
    __slots__ = ()


class _Host:
    """A host input: the numpy array or CPU tensor a device argument was
    copied from."""
    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


def dispatch(keep: bool = False) -> Callable:
    """Mark an engine method as a device dispatch: with a mesh, rank 0
    broadcasts the call before running it, and every other rank runs it
    from ``serve_worker``.  keep: the call's tensors may be passed back
    to a later dispatch (they are held on every rank under a handle)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(engine, *args, **kwargs):
            tp = engine._tpc
            if tp is None or tp.rank != 0:
                return fn(engine, *args, **kwargs)
            return tp.call(engine, fn, args, kwargs, keep)

        run.raw = fn
        return run

    return wrap


class TensorParallel:
    """The protocol's state on one rank of an engine's mesh (see the
    module docstring)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.tensor = mesh.size('tensor')
        self.coord = mesh.coord('tensor')
        # Every rank's tensor coordinate, in rank order.
        self.coords = [mesh.coord('tensor', rank=r)
                       for r in range(dist.get_world_size())]
        self.group = mesh.group('tensor')
        self.ctl = control_group()
        # Orders the broadcasts and the local runs on rank 0: the serving
        # thread, register_prefix and the HTTP handlers all dispatch.
        self.lock = threading.RLock()
        self._inside = threading.local()
        self._next = 0  # guarded-by: lock
        # Rank 0: handles whose tensors were collected since the last
        # message; every rank: the tensors held under live handles.
        self._freed: 'collections.deque' = collections.deque()
        self._held: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}
        self.stopped = False  # guarded-by: lock
        # Rank 0: why a rank is gone (its death seen by ``lose`` or a
        # failed dispatch), else None; the engine's loop stops on it.
        self.lost: Optional[str] = None  # guarded-by: lock

    # ------------------------------------------------------------ rank 0

    def call(self, engine, fn, args, kwargs, keep: bool):
        if getattr(self._inside, 'on', False):
            # A dispatch inside a dispatch runs inside it on every rank.
            return fn(engine, *args, **kwargs)
        with self.lock:
            if self.stopped:
                raise RuntimeError('tensor-parallel engine is shut down' +
                                   (f': {self.lost}' if self.lost else ''))
            handle = None
            if keep:
                handle, self._next = self._next, self._next + 1
            freed = []
            while self._freed:
                freed.append(self._freed.popleft())
            scattered: list = []
            msg = (fn.__name__, self._encode(args, scattered),
                   self._encode(kwargs, scattered), handle, freed)
            failed = True
            try:
                dist.broadcast_object_list([msg], src=0, group=self.ctl)
                for values in scattered:
                    dist.scatter_object_list([None], values, src=0,
                                             group=self.ctl)
                args, kwargs = _own(args), _own(kwargs)
                self._inside.on = True
                try:
                    with mesh_context(self.mesh):
                        out = fn(engine, *args, **kwargs)
                    failed = False
                finally:
                    self._inside.on = False
                    others = self._settle(failed)
            except BaseException as e:
                # A collective that failed (a rank died in it) or an op
                # that failed here: no later op may run on a shard that
                # missed this one.
                self.lose(f'dispatch {fn.__name__} failed: {e!r}')
                raise
            if others:
                self.lose(f'dispatch {fn.__name__} failed on another rank')
                raise RuntimeError(
                    f'tensor-parallel dispatch {fn.__name__} failed on '
                    'another rank (its traceback is on that rank\'s '
                    'stderr); the replica is stopped')
            if keep:
                for path, t in _tensors(out):
                    t._tp_ref = (handle, path)
                    weakref.finalize(t, self._freed.append, (handle, path))
            return out

    def lose(self, reason: str) -> None:
        """Rank 0: the replica lost a rank (or an op failed on one): no
        dispatch runs from here on and the serving loop stops (the engine
        reads ``lost``).  Safe from any thread: a dispatch in flight fails
        in its collective by itself."""
        if self.lost is None:
            self.lost = reason  # lock-ok: a one-way flag any thread may raise
        self.stopped = True  # lock-ok: a one-way flag any thread may raise

    def stop(self) -> None:
        """Release every worker rank from ``serve_worker``."""
        with self.lock:
            if not self.stopped:
                self.stopped = True
                dist.broadcast_object_list([(_STOP, (), {}, None, [])],
                                           src=0, group=self.ctl)

    def local_params(self, params: Optional[Dict[str, torch.Tensor]],
                     draw: Callable[[], Iterable[Tuple[str, torch.Tensor]]],
                     dtypes: Dict[str, torch.dtype]
                     ) -> Iterator[Tuple[str, Tuple[int, ...], torch.Tensor,
                                         Optional[torch.Tensor]]]:
        """(name, full shape, this rank's slice in ``dtypes[name]``, the
        full tensor or None) of each weight: rank 0's full `params` when
        it has them (the other ranks' are not read; rank 0 keeps GPT-2's
        fused q/k/v whole for the shard check, the rest are freed at
        once), else the tensors of `draw()`, drawn by every rank alike
        (call ``share_generator`` first)."""
        if broadcast_object(params is not None if self.rank == 0 else None):
            yield from self._scatter(
                params.items() if self.rank == 0 else None, dtypes)
            return
        for name, full in draw():
            yield name, tuple(full.shape), shard_tensor(
                name, full, self.tensor, self.coord).to(dtypes[name]), full

    def _scatter(self, items: Optional[Iterable[Tuple[str, torch.Tensor]]],
                 dtypes: Dict[str, torch.dtype]
                 ) -> Iterator[Tuple[str, Tuple[int, ...], torch.Tensor,
                                     Optional[torch.Tensor]]]:
        """Rank 0's `items` (full tensors, read one at a time), each sliced
        there for every rank's tensor coordinate and sent to its rank: no
        other rank's host holds a whole tensor (``local_params``' tuples;
        GPT-2's fused q/k/v whole on rank 0 alone)."""
        rank0 = self.rank == 0
        it = iter(items) if rank0 else None
        while True:
            head = None
            if rank0:
                kv = next(it, None)
                if kv is not None:
                    name, full = kv[0], torch.as_tensor(kv[1])
                    head = (name, tuple(full.shape))
            name, shape = broadcast_object(head) or (None, None)
            if name is None:
                return
            dtype = dtypes[name]
            parts, kept = None, None
            if rank0:
                full = full.to(dtype)
                parts = [_as_bytes(shard_tensor(name, full, self.tensor, c))
                         for c in self.coords]
                # Only GPT-2's fused q/k/v is wanted whole (the shard
                # check's head sums); the rest is freed at once.
                kept = full if is_fused_qkv(name) else None
                del full
            local = local_shape(name, shape, self.tensor)
            buf = torch.empty(math.prod(local) * dtype.itemsize,
                              dtype=torch.uint8)
            dist.scatter(buf, parts, src=0, group=self.ctl)
            yield name, shape, buf.view(dtype).reshape(local), kept

    def share_generator(self, gen: torch.Generator) -> None:
        """Rank 0's generator state on every rank: every draw (weights,
        sampling) is the same on every rank from here on."""
        state = broadcast_object(gen.get_state() if self.rank == 0 else None)
        if self.rank != 0:
            gen.set_state(state)

    def _settle(self, failed: bool) -> bool:
        """Every rank's outcome of the op just run: whether it failed on
        any rank (a max over the control group)."""
        flag = torch.tensor([int(failed)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.ctl)
        return bool(flag.item())  # jit-ok: the failure flag, a CPU tensor of the gloo control group

    def _encode(self, x, scattered: list):
        if isinstance(x, PerRank):
            if len(x.values) != dist.get_world_size():
                raise ValueError(f'PerRank holds {len(x.values)} values '
                                 f'for {dist.get_world_size()} ranks')
            scattered.append(x.values)
            return _Scattered()
        if isinstance(x, torch.Tensor):
            ref = getattr(x, '_tp_ref', None)
            if ref is not None:
                return _Ref(ref)
            host = getattr(x, '_tp_host', None)
            return _Host(host if host is not None else x.detach().cpu())  # jit-ok: inputs made by _to_device/_rows_to_device carry their host copy
        if isinstance(x, (list, tuple)):
            return type(x)(self._encode(v, scattered) for v in x)
        if isinstance(x, dict):
            return {k: self._encode(v, scattered) for k, v in x.items()}
        return x

    # ------------------------------------------------------- other ranks

    def serve_worker(self, engine) -> None:
        """Run rank 0's dispatches on this rank's shard until it stops."""
        box = [None]
        with mesh_context(self.mesh), torch.inference_mode():
            while True:
                dist.broadcast_object_list(box, src=0, group=self.ctl)
                name, args, kwargs, handle, freed = box[0]
                args, kwargs = self._receive(args), self._receive(kwargs)
                for key in freed:
                    self._held.pop(key, None)
                if name == _STOP:
                    self.stopped = True  # lock-ok: a worker rank has one thread
                    return
                fn = getattr(type(engine), name).raw
                failed = True
                try:
                    out = fn(engine, *self._decode(engine, args),
                             **self._decode(engine, kwargs))
                    failed = False
                except Exception:  # noqa: BLE001 -- reported to every rank
                    traceback.print_exc()
                if self._settle(failed):
                    self.stopped = True  # lock-ok: a worker rank has one thread
                    raise RuntimeError(
                        f'tensor-parallel dispatch {name} failed on '
                        f'{"this" if failed else "another"} rank; the '
                        'replica is stopped')
                if handle is not None:
                    for path, t in _tensors(out):
                        self._held[(handle, path)] = t

    def _receive(self, x):
        """`x` with each ``_Scattered`` marker replaced by this rank's value,
        received in the message's order."""
        if isinstance(x, _Scattered):
            box = [None]
            dist.scatter_object_list(box, None, src=0, group=self.ctl)
            return box[0]
        if isinstance(x, (list, tuple)):
            return type(x)(self._receive(v) for v in x)
        if isinstance(x, dict):
            return {k: self._receive(v) for k, v in x.items()}
        return x

    def _decode(self, engine, x):
        if isinstance(x, _Ref):
            return self._held[x.key]
        if isinstance(x, _Host):
            v = x.value
            if isinstance(v, np.ndarray):
                return engine._to_device(v)
            if engine.device.type == 'cuda':
                v = v.pin_memory()
            return engine._rows_to_device(v)
        if isinstance(x, (list, tuple)):
            return type(x)(self._decode(engine, v) for v in x)
        if isinstance(x, dict):
            return {k: self._decode(engine, v) for k, v in x.items()}
        return x

    def gather_objects(self, obj: Any) -> list:
        """Every rank's `obj`, in rank order (inside a dispatch)."""
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.ctl)
        return out


def _own(x):
    """Rank 0's call arguments: each ``PerRank`` replaced by its value."""
    if isinstance(x, PerRank):
        return x.values[0]
    if isinstance(x, (list, tuple)):
        return type(x)(_own(v) for v in x)
    if isinstance(x, dict):
        return {k: _own(v) for k, v in x.items()}
    return x


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """`t`'s bytes as a flat uint8 CPU tensor (gloo moves any dtype so)."""
    return t.detach().reshape(-1).cpu().view(torch.uint8)


def _tensors(out, path=()):
    """(path, tensor) of every tensor in a nest of tuples and lists."""
    if isinstance(out, torch.Tensor):
        yield path, out
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _tensors(v, path + (i,))


def validate_mesh(mesh: Optional[Mesh], model_config) -> int:
    """The engine's check of a serving mesh (the JAX engine's text for the
    kv heads); returns the tensor degree (1 without a mesh).  Every axis
    but 'tensor' ('data', 'fsdp', 'seq', 'stage') holds no parameter in
    the rules table, so its ranks are replicas of their tensor group."""
    if mesh is None:
        return 1
    tp = mesh.size('tensor')
    if model_config.num_kv_heads % tp:
        raise ValueError(f'num_kv_heads {model_config.num_kv_heads} not '
                         f'divisible by tensor degree {tp}')
    return tp
