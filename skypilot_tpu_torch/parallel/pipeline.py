"""GPipe pipeline parallelism over the mesh's 'stage' axis: the port of
``skypilot_tpu/parallel/pipeline.py``.

Layers are partitioned into S stages, one per 'stage' rank; M
microbatches flow through the GPipe schedule of M + S - 1 ticks (bubble
fraction (S-1)/(M+S-1)).  At tick t stage s runs microbatch t - s, if
there is one: stage 0 takes it from the inputs, every later stage from
the activation stage s - 1 sent it at tick t - 1.  The stage body is
checkpointed (``torch.utils.checkpoint``), so activation memory is one
microbatch's per stage.  The last stage's outputs reach every stage (the
reference's masked ``psum``).

The schedule is written out by hand, not with
``torch.distributed.pipelining.ScheduleGPipe``: the reference's stage
function closes over the trainer's model, loss and FSDP2 wrapping, which
``PipelineStage`` would have to own, and the hand-written loop differs
from the reference's only in skipping the bubble ticks' dead compute (the
reference computes and discards them), so the loss and gradients are
the reference's.  The backward falls out of autograd, as it does from
JAX's reverse mode: each hop is an ``autograd.Function`` whose backward
sends the activation's gradient back to the stage that sent it (ppermute's
transpose), and the broadcast of the outputs is an all-reduce whose
backward is an all-reduce, in one node that runs before any hop's
backward can start.  The hops carry no tag (NCCL has none): a send meets
its receive by order alone.  So every hop of a stage takes the previous
hop's token as an input, which chains them in schedule order; autograd
then runs their backwards in the exact reverse order on every stage --
microbatch M-1's gradient hops first, then M-2's, and so on -- and each
gradient send meets the receive of the same microbatch.

The parameter layout is untouched: every stage holds the full
per-layer model (its shards, under FSDP2) and runs its own layers; the
layers of other stages get zero gradients there, and the trainer sums
every gradient over the 'stage' group, so checkpoints and the optimizer
see the non-pipelined layout (the reference stacks the same per-layer
tree inside its step, :113-128).
"""
from typing import Any, Callable, List, Optional

import torch
from torch import distributed as dist
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.parallel.mesh import (Mesh, active_mesh,
                                              recompute_in_active_mesh)


def pipeline_degree(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get('stage', 1)


class _Send(torch.autograd.Function):
    """Send y to the next stage after the hop whose token is `after`;
    returns this hop's token (a zero scalar that ties the send into the
    graph).  Backward: receive y's gradient from there."""

    @staticmethod
    def forward(ctx, y, after, dst: int, group, pending: List):
        ctx.meta = (y.shape, y.dtype, y.device, dst, group)
        y = y.detach().contiguous()
        pending.append((dist.isend(y, dst, group=group), y))
        return torch.zeros((), device=y.device)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, group = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, dst, group=group)
        return g, torch.zeros((), device=device), None, None, None


class _Recv(torch.autograd.Function):
    """Receive an activation from the previous stage after the hop whose
    token is `after`; returns it and this hop's token.  Backward: send
    its gradient back."""

    @staticmethod
    def forward(ctx, after, shape, dtype, src: int, group):
        ctx.meta = (src, group)
        x = torch.empty(shape, dtype=dtype, device=after.device)
        dist.recv(x, src, group=group)
        return x, torch.zeros((), device=after.device)

    @staticmethod
    def backward(ctx, g, _):
        src, group = ctx.meta
        dist.send(g.contiguous(), src, group=group)
        return torch.zeros((), device=g.device), None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs to every stage: an all-reduce of the last
    stage's outputs and every other stage's zeros.  Its backward is the
    all-reduce of the gradients (the transpose), returned to the last
    stage's outputs; the last hop's token gets zero, so every hop's
    backward runs after this node's collective on every stage."""

    @staticmethod
    def forward(ctx, local, group, after):
        ctx.group = group
        out = local.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None, torch.zeros((), device=g.device)


def pipeline(stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
             stage_params: Any, microbatches: torch.Tensor, consts: Any,
             mesh: Mesh, axis_name: str = 'stage') -> torch.Tensor:
    """Run microbatches through the S pipeline stages of `mesh`.

    Args:
      stage_fn: (stage_params, x, consts) -> y with y.shape == x.shape
        (a chunk of transformer layers).
      stage_params: this rank's stage's parameters (here: its layers),
        passed to stage_fn as they are.
      microbatches: [M, mb, ...] stage-0 inputs (every stage passes them;
        stage 0 reads them).  This rank's batch rows under data/fsdp.
      consts: broadcast to every stage invocation (e.g. positions).
      mesh: the mesh holding `axis_name`.

    Returns [M, mb, ...] last-stage outputs, on every stage.  A value
    every stage computes from them counts once in total when each stage
    weighs it 1/S, as the trainer weighs its loss: the backward sums the
    stages' gradients of the outputs into the last stage's.
    """
    num_stages = mesh.shape[axis_name]
    num_micro = microbatches.shape[0]
    if num_micro < num_stages:
        raise ValueError(
            f'need microbatches ({num_micro}) >= stages ({num_stages}) '
            'to fill the pipeline')
    group = mesh.group(axis_name)
    s = mesh.coord(axis_name)
    last = s == num_stages - 1
    nxt = None if last else dist.get_global_rank(group, s + 1)
    prv = None if s == 0 else dist.get_global_rank(group, s - 1)

    context_fn = recompute_in_active_mesh()
    kwargs = {} if context_fn is None else {'context_fn': context_fn}

    def body(x):
        return torch_checkpoint.checkpoint(stage_fn, stage_params, x, consts,
                                           use_reentrant=False, **kwargs)

    # The token of this stage's last hop (see the module docstring).
    after = torch.zeros((), device=microbatches.device, requires_grad=True)
    outputs, pending = [], []
    for t in range(num_micro + num_stages - 1):
        mb = t - s
        if not 0 <= mb < num_micro:      # a bubble tick of this stage
            continue
        if s == 0:
            x = microbatches[mb]
        else:
            x, after = _Recv.apply(after, microbatches.shape[1:],
                                   microbatches.dtype, prv, group)
        y = body(x)
        if last:
            outputs.append(y)
        else:
            after = _Send.apply(y, after, nxt, group, pending)
    for req, _ in pending:
        req.wait()
    local = (torch.stack(outputs) if last
             else torch.zeros_like(microbatches))
    return _Broadcast.apply(local, group, after)


def make_pipelined_apply(config: Any, mesh: Mesh,
                         num_microbatches: Optional[int] = None
                         ) -> Callable:
    """A forward with the model's call signature that pipelines the
    decoder stack over the mesh's 'stage' axis (the GPipe schedule of
    ``pipeline``): ``apply(model, tokens, **kwargs)`` takes the model's
    keyword arguments (``hidden_only``, ``head``, ``positions``).

    The model's own forward runs (its embedding, final norm and head, and
    with them FSDP2's root hooks); only its layer loop is replaced, by
    the pipeline over this rank's stage's layers, so the parameter names
    -- and checkpoints and the optimizer -- are the non-pipelined ones."""
    from skypilot_tpu_torch.models.llama import LlamaConfig
    if not isinstance(config, LlamaConfig):
        raise ValueError(
            'pipeline-parallel training currently supports llama-family '
            f'models; got {type(config).__name__}')
    num_stages = mesh.shape['stage']
    if config.num_layers % num_stages:
        raise ValueError(
            f'num_layers {config.num_layers} must divide evenly into '
            f'{num_stages} stages')
    lps = config.num_layers // num_stages
    m = num_microbatches or num_stages
    first = mesh.coord('stage') * lps

    def stage_fn(layers, x, positions):
        for layer in layers:
            x = layer(x, positions)
        return x

    def apply(model, tokens: torch.Tensor, **kwargs):
        b, seq = tokens.shape
        if b % m:
            raise ValueError(
                f'batch {b} must divide into {m} pipeline microbatches')
        layers = list(model.layers[first:first + lps])

        def layer_stack(x, positions):
            mbs = x.reshape(m, b // m, seq, x.shape[-1])
            out = pipeline(stage_fn, layers, mbs, positions[:1], mesh)
            return out.reshape(b, seq, x.shape[-1])

        return model(tokens, layer_stack=layer_stack, **kwargs)

    return apply
