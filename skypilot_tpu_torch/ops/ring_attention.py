"""Sequence parallelism: ring attention and Ulysses all-to-all over the
mesh's 'seq' group -- the port of ``skypilot_tpu/ops/ring_attention.py``.

  ring    -- K/V shards rotate around the 'seq' group (point-to-point
             send/receive to the next rank) while each rank keeps its Q
             shard; each visiting chunk merges into an f32 online softmax
             (``_ring_step``, plain PyTorch as the reference's einsums
             are), and each step is checkpointed.
  ulysses -- ``all_to_all_single`` re-shards [heads <-> seq]: each rank
             gets the full sequence for heads/n heads, runs the port's
             ``flash_attention`` (the Hopper kernels on the card), and
             all-to-alls back.  Caps the degree at the kv head count.

The collectives carry no autograd of their own, so each is an
``autograd.Function`` whose backward is its transpose: the ring hop sends
the gradient the reverse way around the ring (ppermute's transpose), the
all-to-all runs the inverse all-to-all.

Unlike the reference, whose inputs are global arrays that ``shard_map``
cuts, every function here takes this rank's shards: q ``[B, Hq, S/n, D]``
and k/v ``[B, Hkv, S/n, D]`` of contiguous sequence blocks in 'seq'-rank
order.  The trainer cuts them, and refuses a batch or a sequence that
does not split over the mesh, so the reference's fallback for shapes that
do not block-shard (its batch-1 init sample) has no caller here; the
fallback to plain flash with no mesh or a 'seq' degree of 1 stays.
"""
import functools
from typing import List, Optional, Sequence

import torch
from torch import distributed as dist
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.ops.flash_attention import flash_attention
from skypilot_tpu_torch.parallel.mesh import Mesh, active_mesh

_NEG_INF = -1e30


def _chunk_scores(q: torch.Tensor, k: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Grouped (GQA) scores.  q: [B, Hq, Sq, D], k: [B, Hkv, Skv, D]
    -> [B, Hkv, G, Sq, Skv] in f32."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qr = q.reshape(b, hkv, hq // hkv, sq, d).float()
    return torch.einsum('bhgqd,bhkd->bhgqk', qr * scale, k.float())


def _ring_step(q, k, v, q_pos, kv_pos, acc, m, l, *, causal, scale):
    """Merge one visiting KV chunk into the online-softmax state.

    acc: [B, Hkv, G, Sq, D] unnormalised numerator (f32)
    m:   [B, Hkv, G, Sq]    running row max
    l:   [B, Hkv, G, Sq]    running denominator
    """
    s = _chunk_scores(q, k, scale)                       # [B,Hkv,G,Sq,Skv]
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(-1)
    pv = torch.einsum('bhgqk,bhkd->bhgqd', p, v.float())
    return acc * correction[..., None] + pv, m_new, l_new


def _exchange(tensors: Sequence[torch.Tensor], dst: int, src: int,
              group) -> List[torch.Tensor]:
    """Send `tensors` to global rank dst and receive as many of the same
    shapes from global rank src, all posted before any wait."""
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """K and V move one rank forward around the ring (rank i's shards go
    to i + 1); the backward moves their gradients one rank back."""

    @staticmethod
    def forward(ctx, k, v, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return tuple(_exchange((k, v), nxt, prv, group))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _exchange((gk, gv), ctx.prv, ctx.nxt, ctx.group)
        return gk, gv, None, None, None


def _all_to_all(x: torch.Tensor, group, n: int, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """Cut x into n blocks along split_dim, send block j to the group's
    rank j, and join the blocks received along concat_dim in rank order
    (``lax.all_to_all(..., tiled=True)``)."""
    inp = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` with the inverse all-to-all as its backward."""

    @staticmethod
    def forward(ctx, x, group, n: int, split_dim: int, concat_dim: int):
        ctx.args = (group, n, concat_dim, split_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), *ctx.args),
                None, None, None, None)


def _axis(mesh: Optional[Mesh], axis_name: str):
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise ValueError(f'no active mesh holds the axis {axis_name!r}; '
                         'call inside mesh_context(mesh) or pass mesh')
    return (mesh.group(axis_name), mesh.size(axis_name),
            mesh.coord(axis_name))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = 'seq', causal: bool = True,
                   scale: Optional[float] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Ring attention over the mesh's `axis_name` group (the active mesh
    by default).  q: [B, Hq, Sq, D] this rank's query block (global
    sequence = Sq * n, blocks in rank order); k/v: [B, Hkv, Sq, D] its KV
    block.  Returns this rank's output block, in q's dtype."""
    group, n, my = _axis(mesh, axis_name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    q_pos = my * sq + torch.arange(sq, device=dev)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d), device=dev)
    m = torch.full((b, hkv, hq // hkv, sq), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, hq // hkv, sq), device=dev)
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    step_fn = functools.partial(_ring_step, causal=causal, scale=scale)
    for step in range(n):
        src = (my - step) % n          # whose KV block we hold right now
        kv_pos = src * skv + torch.arange(skv, device=dev)
        acc, m, l = torch_checkpoint.checkpoint(
            step_fn, q, k, v, q_pos, kv_pos, acc, m, l, use_reentrant=False)
        if step != n - 1:
            k, v = _RingShift.apply(k, v, group, nxt, prv)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = 'seq', causal: bool = True,
                      scale: Optional[float] = None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Ulysses (DeepSpeed-style) sequence parallelism: all-to-all swaps the
    sharded dim from seq to heads, the port's flash attention runs on the
    full sequence of the local heads, and all-to-all swaps back.
    Requires head counts divisible by the group size."""
    group, n, _ = _axis(mesh, axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f'ulysses needs head counts divisible by seq axis ({n}): '
            f'Hq={q.shape[1]} Hkv={k.shape[1]}')
    # [B, H, S/n, D] -> [B, H/n, S, D]
    qg, kg, vg = (_AllToAll.apply(t, group, n, 1, 2) for t in (q, k, v))
    out = flash_attention(qg.contiguous(), kg.contiguous(), vg.contiguous(),
                          causal=causal, scale=scale)
    return _AllToAll.apply(out, group, n, 2, 1)


def seq_parallel_degree(mesh: Optional[Mesh] = None) -> int:
    """Size of the 'seq' axis of the given (or active) mesh; 1 if none."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get('seq', 1)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                scale: Optional[float] = None,
                                mode: str = 'ring',
                                mesh: Optional[Mesh] = None,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Attention with the sequence sharded over the mesh's 'seq' group
    (the active mesh by default): ring (the default) or Ulysses.  Plain
    flash attention when there is no mesh or its 'seq' degree is 1 (under
    a data, fsdp or tensor mesh each rank's flash runs on its own batch
    rows and heads, as the reference's per-shard flash does).

    window: sliding-window (banded causal) attention.  Supported on the
    flash path; ring/ulysses sequence parallelism raises, as the
    reference does."""
    degree = seq_parallel_degree(mesh)
    if degree > 1 and window is not None:
        raise NotImplementedError(
            'sliding-window attention with sequence parallelism is not '
            'supported; use data/fsdp/tensor axes for windowed models')
    if degree == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    inner = ring_attention if mode == 'ring' else ulysses_attention
    return inner(q, k, v, axis_name='seq', causal=causal, scale=scale,
                 mesh=mesh)
