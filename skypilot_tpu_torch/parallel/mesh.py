"""Device meshes and the logical sharding vocabulary on torch.distributed:
the port of ``skypilot_tpu/parallel/mesh.py``.

The same five axes ('stage', 'data', 'fsdp', 'seq', 'tensor') and the
same rules table mapping logical axes to mesh axes.  One process runs per
card (NCCL), or per CPU rank when the caller asks for the CPU (gloo), and
``make_mesh`` lays the world's ranks out over the axes with
``init_device_mesh``: 'tensor' innermost, so its ranks are the closest.

  data   -- replicas; gradients are summed across it (HSDP's replicate
            dim of FSDP2).
  fsdp   -- parameter and optimizer sharding (FSDP2 ``fully_shard``).
  seq    -- sequence parallelism: ring or Ulysses attention
            (``ops.ring_attention``).
  tensor -- Megatron-style tensor parallelism (DTensor
            ``parallelize_module``), and expert parallelism for Mixtral.
  stage  -- GPipe pipeline stages (``parallel.pipeline``).

Model code never names mesh axes.  A model reads the active mesh from
``mesh_context`` (a context variable, the counterpart of JAX's
``with mesh:``) through ``active_mesh``, and the trainer places each
parameter by the logical axes of ``param_logical_axes`` resolved through
``logical_axis_rules``.
"""
import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import distributed as dist

from skypilot_tpu_torch.device import resolve_device

MESH_AXES = ('stage', 'data', 'fsdp', 'seq', 'tensor')

# Logical axis -> mesh axis (or tuple: sharded over both, or None); a copy
# of the JAX package's table.
_BASE_RULES: List[Tuple[str, object]] = [
    ('batch', ('data', 'fsdp')),
    ('activation_batch', ('data', 'fsdp')),
    ('activation_seq', 'seq'),
    ('activation_embed', None),
    ('activation_heads', 'tensor'),
    ('activation_kv', 'tensor'),
    ('activation_mlp', 'tensor'),
    ('embed', 'fsdp'),        # weight embed dim: FSDP-sharded
    ('mlp', 'tensor'),
    ('heads', 'tensor'),
    ('kv_heads', 'tensor'),
    ('qkv_embed', None),
    ('vocab', 'tensor'),
    ('vocab_table', 'fsdp'),
    ('embed_table', 'tensor'),
    ('expert', 'tensor'),
    ('norm', None),
]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parallelism degrees.  Product must equal the device count."""
    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    stage: int = 1

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.stage, self.data, self.fsdp, self.seq, self.tensor)

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.seq * self.tensor * self.stage

    @classmethod
    def fsdp_only(cls, n: int) -> 'MeshSpec':
        return cls(fsdp=n)

    @classmethod
    def auto(cls, n: int) -> 'MeshSpec':
        """Sensible single-node default: FSDP over all cards."""
        return cls(fsdp=n)


def logical_axis_rules(extra: Optional[List[Tuple[str, object]]] = None):
    """Base rules with optional overrides.  Resolution is FIRST-match, so
    user overrides are prepended."""
    rules = list(_BASE_RULES)
    if extra:
        rules = list(extra) + rules
    return rules


def resolve_axes(logical_axes: Sequence[Optional[str]],
                 rules: Optional[List[Tuple[str, object]]] = None
                 ) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes each dim of a tensor with these logical axes shards
    over, resolved as flax's ``logical_to_mesh_axes`` resolves them: the
    rules in order, each giving its mesh axes to the first dim of its
    logical name if that dim is still unassigned and none of those mesh
    axes is taken yet.  So a rule earlier in the table wins a mesh axis:
    ('mlp', 'tensor') takes 'tensor' before ('expert', 'tensor')."""
    rules = rules if rules is not None else logical_axis_rules()
    names = list(logical_axes)
    out: List[Optional[Tuple[str, ...]]] = [None] * len(names)
    for name, mesh_ax in rules:
        if name not in names:
            continue
        pos = names.index(name)
        axes = () if mesh_ax is None else (
            (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax))
        taken = {a for got in out if got for a in got}
        if out[pos] is None and not taken & set(axes):
            out[pos] = axes
    return tuple(got or () for got in out)


# Logical axes of each parameter in the port's (torch) layout, by the
# last components of its name: an nn.Linear weight is [out, in], so the
# flax kernel's axes appear reversed.  The JAX modules' annotations.
_PARAM_AXES: List[Tuple[Tuple[str, ...], Tuple[Optional[str], ...]]] = [
    (('embedding',), ('vocab_table', 'embed_table')),
    (('lm_head', 'weight'), ('vocab', 'embed')),
    (('q_proj', 'weight'), ('heads', 'embed')),
    (('k_proj', 'weight'), ('kv_heads', 'embed')),
    (('v_proj', 'weight'), ('kv_heads', 'embed')),
    (('q_proj', 'bias'), ('heads',)),
    (('k_proj', 'bias'), ('kv_heads',)),
    (('v_proj', 'bias'), ('kv_heads',)),
    (('o_proj', 'weight'), ('embed', 'heads')),
    (('gate_proj', 'weight'), ('mlp', 'embed')),
    (('up_proj', 'weight'), ('mlp', 'embed')),
    (('down_proj', 'weight'), ('embed', 'mlp')),
    (('router', 'weight'), (None, 'embed')),
    # int8 projections (``llama.QuantLinear``): the int8 weight is laid out
    # as the float one; the per-output-channel scale follows the output
    # dim, so a column-parallel projection's is sliced and a row-parallel
    # one's kept whole.
    (('q_proj', 'weight_q'), ('heads', 'embed')),
    (('k_proj', 'weight_q'), ('kv_heads', 'embed')),
    (('v_proj', 'weight_q'), ('kv_heads', 'embed')),
    (('o_proj', 'weight_q'), ('embed', 'heads')),
    (('gate_proj', 'weight_q'), ('mlp', 'embed')),
    (('up_proj', 'weight_q'), ('mlp', 'embed')),
    (('down_proj', 'weight_q'), ('embed', 'mlp')),
    (('q_proj', 'scale'), ('heads',)),
    (('k_proj', 'scale'), ('kv_heads',)),
    (('v_proj', 'scale'), ('kv_heads',)),
    (('o_proj', 'scale'), ('embed',)),
    (('gate_proj', 'scale'), ('mlp',)),
    (('up_proj', 'scale'), ('mlp',)),
    (('down_proj', 'scale'), ('embed',)),
    (('w_gate',), ('expert', 'embed', 'mlp')),
    (('w_up',), ('expert', 'embed', 'mlp')),
    (('w_down',), ('expert', 'mlp', 'embed')),
    (('scale',), ('norm',)),
    (('wte',), ('vocab_table', 'embed_table')),
    (('wpe',), (None, 'embed')),
    # GPT-2: the fused c_attn's rows are q, k and v, each heads-major, so
    # its 'heads' dim is sliced by heads within each of the three
    # (``shard_tensor``, ``group_qkv_by_rank``), the JAX kernel's
    # [embed, 3, heads, head_dim] sharded on 'heads'.
    (('attn', 'c_attn', 'weight'), ('heads', 'embed')),
    (('attn', 'c_attn', 'bias'), ('heads',)),
    (('attn', 'c_proj', 'weight'), ('embed', 'heads')),
    (('mlp', 'c_fc', 'weight'), ('mlp', 'embed')),
    (('mlp', 'c_fc', 'bias'), ('mlp',)),
    (('mlp', 'c_proj', 'weight'), ('embed', 'mlp')),
]


def _adapter_axes() -> List[Tuple[Tuple[str, ...],
                                  Tuple[Optional[str], ...]]]:
    """The logical axes of the LoRA adapters (``*_lora``): each follows
    its projection over 'tensor' (the JAX package replicates them, (None,
    None); the sums differ only in order).  A column-parallel
    projection's ``lora_b`` is split on its output columns and its
    ``lora_a`` kept whole; a row-parallel one's ``lora_a`` is split on its
    input rows and its ``lora_b`` kept whole.  Training's [in, r] /
    [r, out] and multi-LoRA serving's stacked [N, in, r] / [N, r, out]."""
    out = []
    for target, axis in (('q_proj', 'heads'), ('k_proj', 'kv_heads'),
                         ('v_proj', 'kv_heads'), ('gate_proj', 'mlp'),
                         ('up_proj', 'mlp')):
        out += [((f'{target}_lora', 'lora_b'), (None, axis)),
                ((f'{target}_lora', 'lora_b'), (None, None, axis))]
    for target, axis in (('o_proj', 'heads'), ('down_proj', 'mlp')):
        out += [((f'{target}_lora', 'lora_a'), (axis, None)),
                ((f'{target}_lora', 'lora_a'), (None, axis, None))]
    return out


_PARAM_AXES += _adapter_axes()


def param_logical_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of parameter `name` (a state_dict key) in the
    port's layout; None on every dim for a parameter the table does not
    name (replicated)."""
    parts = tuple(name.split('.'))
    for suffix, axes in _PARAM_AXES:
        if parts[-len(suffix):] == suffix and len(axes) == ndim:
            return axes
    return (None,) * ndim


def split(n: int, tensor: int) -> int:
    """A dim of size `n` on one of `tensor` ranks: n / tensor when the
    degree divides it, else n (replicated, as the JAX engine's
    ``_fit_sharding`` replicates a dim the mesh does not divide)."""
    return n // tensor if tensor > 1 and n % tensor == 0 else n


def tensor_dim(name: str, shape: Sequence[int],
               tensor: int) -> Optional[int]:
    """The dim of parameter `name` (a state_dict key of the full model)
    that tensor-parallel serving slices over `tensor` ranks: the expert
    dim of Mixtral's experts (each rank holds whole experts, as the
    trainer's expert parallelism does), else the dim the rules give
    'tensor'; None when they give it none or the degree does not divide
    it (the parameter is then replicated)."""
    if tensor <= 1:
        return None
    logical = param_logical_axes(name, len(shape))
    if 'expert' in logical:
        dim = logical.index('expert')
    else:
        dims = [i for i, axes in enumerate(resolve_axes(logical))
                if 'tensor' in axes]
        if not dims:
            return None
        dim = dims[0]
    # The fused q/k/v splits each of its three parts.
    parts = 3 * tensor if is_fused_qkv(name) else tensor
    return dim if shape[dim] % parts == 0 else None


def local_shape(name: str, shape: Sequence[int],
                tensor: int) -> Tuple[int, ...]:
    """The shape of parameter `name` on one of `tensor` ranks."""
    dim = tensor_dim(name, shape, tensor)
    out = list(shape)
    if dim is not None:
        out[dim] //= tensor
    return tuple(out)


def is_fused_qkv(name: str) -> bool:
    """True for GPT-2's fused q/k/v projection (weight or bias)."""
    return name.endswith(('c_attn.weight', 'c_attn.bias'))


def group_qkv_by_rank(t: torch.Tensor, tensor: int,
                      inverse: bool = False) -> torch.Tensor:
    """GPT-2's fused c_attn rows ``[3 * H * D, ...]`` (q, k, v, each
    heads-major) reordered to ``[tensor, 3, H / tensor * D, ...]``, so a
    contiguous split of dim 0 over `tensor` ranks gives each rank its own
    heads of q, of k and of v; ``inverse`` undoes it."""
    outer = (tensor, 3) if inverse else (3, tensor)
    return t.unflatten(0, (*outer, -1)).transpose(0, 1).flatten(0, 2)


def shard_tensor(name: str, t: torch.Tensor, tensor: int,
                 rank: int) -> torch.Tensor:
    """Rank `rank`'s slice of the full parameter `t` (``tensor_dim``), a
    copy of its own: the full tensor can be freed.  GPT-2's fused c_attn
    gives the rank its heads of q, k and v (``group_qkv_by_rank``)."""
    dim = tensor_dim(name, t.shape, tensor)
    if dim is None:
        return t
    if is_fused_qkv(name):
        return t.unflatten(0, (3, tensor, -1))[:, rank].flatten(0, 1).clone(
            memory_format=torch.contiguous_format)
    n = t.shape[dim] // tensor
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def shard_state_dict(state_dict: Dict[str, torch.Tensor], tensor: int,
                     rank: int) -> Dict[str, torch.Tensor]:
    """A full state_dict turned into rank `rank`'s of `tensor`: each
    parameter sliced by ``shard_tensor``, the counterpart of the JAX
    engine's placement by logical axes (``_param_shardings`` with
    ``_fit_sharding``)."""
    return {k: shard_tensor(k, v, tensor, rank)
            for k, v in state_dict.items()}


class Mesh:
    """The port's mesh: a ``DeviceMesh`` over the five axes (built by
    ``init_device_mesh``) and the process groups the parallel paths use.

    ``shape`` maps each axis to its size, as a JAX mesh's does.
    ``group(*axes)`` is this rank's process group over the named axes
    (one group per coordinate of the other axes; built for every
    combination the port uses when the mesh is made, since every rank of
    the world must take part in making each group); ``coord(*axes)`` is
    this rank's row-major index over them."""

    # Axis combinations whose flattened groups are built up front.
    _GROUPS = (('data', 'fsdp'), ('data', 'fsdp', 'seq'))

    def __init__(self, spec: MeshSpec, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh
        self.spec = spec
        self.device_type = device_type
        self.device_mesh = init_device_mesh(device_type, spec.shape,
                                            mesh_dim_names=MESH_AXES)
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, spec.shape))
        ranks = torch.arange(spec.num_devices).view(spec.shape)
        self._ranks = ranks
        self._coords = self._coords_of(dist.get_rank())
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        for axes in self._GROUPS:
            self._groups[axes] = self._flattened_group(ranks, axes)

    def _flattened_group(self, ranks: torch.Tensor,
                         axes: Tuple[str, ...]) -> dist.ProcessGroup:
        keep = [MESH_AXES.index(a) for a in axes]
        other = [i for i in range(len(MESH_AXES)) if i not in keep]
        blocks = ranks.permute(*other, *keep).reshape(
            -1, math.prod(ranks.shape[i] for i in keep))
        mine = None
        for block in blocks.tolist():
            group = dist.new_group(block)
            if dist.get_rank() in block:
                mine = group
        return mine

    def _coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(MESH_AXES, (int(c[0]) for c in
                                    torch.nonzero(self._ranks == rank).T)))

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def coord(self, *axes: str, rank: Optional[int] = None) -> int:
        """This rank's row-major index over `axes` (another `rank`'s when
        given)."""
        coords = self._coords if rank is None else self._coords_of(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, *axes: str) -> dist.ProcessGroup:
        if len(axes) == 1:
            return self.device_mesh[axes[0]].get_group()
        return self._groups[tuple(axes)]

    def __getitem__(self, axes):
        return self.device_mesh[axes]


def make_mesh(spec: Optional[MeshSpec] = None,
              device_type: Optional[str] = None) -> Mesh:
    """Lay the process group's ranks out over the five axes, 'tensor'
    innermost.  The process group must be up
    (``initialize_distributed_from_env`` or ``ensure_process_group``);
    `device_type` defaults to 'cuda' on NCCL and 'cpu' on gloo.

    Multi-node note: put the node dimension on 'data' (or 'stage'): the
    gradient reduction and the stage hops are its only traffic."""
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs a process group: call '
            'initialize_distributed_from_env() or ensure_process_group()')
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec.auto(world)
    if spec.num_devices != world:
        raise ValueError(
            f'MeshSpec {spec.shape} needs {spec.num_devices} devices, got '
            f'{world}.')
    if device_type is None:
        device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return Mesh(spec, device_type)


_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    'skypilot_tpu_torch_active_mesh', default=None)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make `mesh` the active mesh for the models' collective paths
    (sequence-parallel attention, expert parallelism) within the block:
    the counterpart of JAX's ``with mesh:``.  A context variable, so it
    ends with the block and never leaks into another thread or test."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``mesh_context``, or None."""
    return _ACTIVE.get()


def tp_mesh(tensor_parallel: Optional[int],
            device_type: Optional[str] = None) -> Optional[Mesh]:
    """The one way a serving replica builds its tensor-parallel mesh:
    None for degree <= 1 (an unsharded engine), else a mesh of
    ``MeshSpec(tensor=n)`` over the process group, which must hold
    exactly n ranks."""
    if tensor_parallel is None or tensor_parallel <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else \
        host_local_device_count()
    if tensor_parallel > world:
        raise ValueError(
            f'tensor_parallel {tensor_parallel} exceeds the {world} '
            'visible device(s); a mesh needs one chip per shard')
    return make_mesh(MeshSpec(tensor=tensor_parallel), device_type)


def host_local_device_count() -> int:
    """Cards visible to this process (1 without a card: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _env_rendezvous() -> Optional[Tuple[str, int, int]]:
    """(init_method, rank, world) from the podlet's env
    (SKYTPU_COORDINATOR_ADDRESS / SKYTPU_PROCESS_ID /
    SKYTPU_NUM_PROCESSES) or torchrun's (MASTER_ADDR / MASTER_PORT /
    RANK / WORLD_SIZE); None for a single process."""
    env = os.environ
    coord = env.get('SKYTPU_COORDINATOR_ADDRESS')
    nproc = int(env.get('SKYTPU_NUM_PROCESSES', '1'))
    if coord is not None and nproc > 1:
        return (f'tcp://{coord}', int(env.get('SKYTPU_PROCESS_ID', '0')),
                nproc)
    if coord is None and nproc > 1:
        raise ValueError(f'SKYTPU_NUM_PROCESSES={nproc} without '
                         'SKYTPU_COORDINATOR_ADDRESS: cannot join the group')
    world = int(env.get('WORLD_SIZE', '1'))
    if world > 1:
        if 'MASTER_ADDR' not in env or 'RANK' not in env:
            raise ValueError(f'WORLD_SIZE={world} without MASTER_ADDR and '
                             'RANK: cannot join the group')
        return 'env://', int(env['RANK']), world
    return None


def initialize_distributed_from_env(device=None) -> bool:
    """Start the process group from the env the podlet driver exports, or
    torchrun's.  Returns True if a multi-process group was started (or
    one is already up).  Each rank is bound to its local card
    (LOCAL_RANK, else its rank modulo the visible cards) on NCCL; with
    ``device='cpu'`` the group runs on gloo.

    Parity role: the JAX package's one call to jax.distributed.initialize
    from the same env."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    found = _env_rendezvous()
    if found is None:
        return False
    init_method, rank, world = found
    dev = resolve_device(device)
    if dev.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK',
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                            init_method=init_method, rank=rank,
                            world_size=world)
    return True


def ensure_process_group(device=None) -> torch.device:
    """The process group a mesh needs: the env's (see
    ``initialize_distributed_from_env``), or, in a single process, a
    one-rank group on an in-memory store (NCCL on the card, gloo on the
    CPU).  Returns this rank's device: its card, or the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized() and \
            not initialize_distributed_from_env(dev):
        if dev.type == 'cuda':
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def rank_device(mesh: Mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter gathered whole (differentiably: its gradient
    goes back to this rank's shard), any other tensor as it is.  The
    models read a tensor-sharded embedding or head through it."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`, every rank getting the total; the backward sums
    the gradients over the group (the transpose of a psum whose result
    every rank uses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradients over `group`
    (Megatron's f: a replicated input into rank-partial work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum of the ranks' partial results over `group`; identity backward
    (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` of `group` concatenated along `dim`, in rank order
    (serving: no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def tensor_group():
    """The active mesh's 'tensor' process group and this rank's coordinate
    on it: what a rank-local model (built from a ``llama.RankConfig``)
    sums and gathers over.  Raises outside a ``mesh_context``."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError('a tensor-parallel model runs inside '
                           'mesh_context(mesh)')
    return mesh.group('tensor'), mesh.coord('tensor')


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


@contextlib.contextmanager
def _within(context, mesh: Mesh) -> Iterator[None]:
    with context, mesh_context(mesh):
        yield


def recompute_in_active_mesh(context_fn=None):
    """A ``context_fn`` for ``torch.utils.checkpoint`` that re-enters the
    mesh active now when the checkpointed call is recomputed in backward
    (which can run on autograd's own thread, outside this context), on
    top of `context_fn`'s contexts; None with no active mesh."""
    mesh = active_mesh()
    if mesh is None:
        return context_fn

    def both():
        fwd, rec = (context_fn() if context_fn is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _within(rec, mesh)

    return both
