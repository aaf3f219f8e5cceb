"""Single-device training of the causal LMs (the llama family, GPT-2 and
Mixtral), the port of ``skypilot_tpu/train/trainer.py``.

The JAX trainer jits one step over a device mesh.  Here the step runs
eagerly on one card: the model's no-cache forward (each decoder layer
checkpointed -- by ``remat_policy`` for the llama family, always for GPT-2
and Mixtral, as their JAX modules do -- attention through the
flash-attention kernels and their autograd Function), the next-token loss
with the vocabulary projection chunked over the sequence, ``backward()``,
clipping by global norm and AdamW on f32 master weights -- what
``make_train_step`` computes, to float noise.  Names follow the JAX module so each piece has
an obvious counterpart.

With ``model_config.lora_rank`` > 0 the step trains the ``*_lora``
adapters only (``train.lora``): the base parameters get
``requires_grad_(False)``, so the backward computes no gradient for them
(dQ, dK and dV still flow through the attention kernels to reach the
q/k/v adapters), and the optimizer is built over the adapter parameters,
so clipping, ``grad_norm`` and weight decay see the adapters alone and
the base carries no Adam moments -- what ``make_train_step(trainable=
lora.is_lora_path)`` with the reference's ``multi_transform`` optimizer
computes.  On Mixtral the adapters sit on the attention projections and
the router and the experts stay frozen with the rest of the base; the
router's aux term stays in the loss and reaches the adapters through
the hidden states.

Mixtral adds its routers' load-balance loss to the objective: each
layer's ``aux * router_aux_loss_weight``, summed over layers and scaled by
1/K under K-step gradient accumulation (the term is a per-token mean that
ignores the mask), on the full-logit and the chunked-loss paths alike, as
the JAX step sums the sown ``router_aux_loss`` values.  The layer returns
its term from the checkpointed call, so backward's recomputation leaves
it as it was.  GPT-2's tied head is ``wte``.

With ``TrainConfig.mesh`` (a ``parallel.mesh.MeshSpec``) the step runs on
every rank of a ``torch.distributed`` process group laid out over the
five axes (``parallel.mesh.make_mesh``; NCCL on the cards, gloo when the
caller asks for the CPU), as the JAX step runs over its mesh:

- 'data' and 'fsdp': FSDP2 ``fully_shard`` over the ('data', 'fsdp')
  sub-mesh (HSDP when both are > 1), one per decoder layer and one at the
  root, each parameter sharded on the dim its logical axes map to 'fsdp'
  (``parallel.mesh.param_logical_axes``); each rank takes its rows of the
  global batch (micro-step major, as the JAX step's reshape splits it).
- 'tensor': DTensor ``parallelize_module`` -- a projection whose weight
  the rules shard on its output dim is column-wise (q/k/v/gate/up,
  GPT-2's c_attn and c_fc), on its input dim row-wise (o/down, GPT-2's
  c_proj) -- the embedding and head sharded by the same rules and
  gathered where they are used (the chunked loss gathers the
  vocab-sharded head: every tensor rank computes the loss whole),
  Mixtral's experts over 'tensor' (expert parallelism).  GPT-2's fused
  c_attn is split by heads within each of q, k and v: its rows are
  reordered rank-major first (``parallel.mesh.group_qkv_by_rank``), and
  back wherever a full state leaves the trainer (checkpoints), so a
  checkpoint of one mesh resumes on another.  A LoRA adapter follows
  its projection with no collective of its own: a column-parallel
  projection's ``lora_b`` is split on its output columns (``lora_a``
  replicated), a row-parallel one's ``lora_a`` on its input rows
  (``lora_b`` replicated), and its partial products join the
  projection's own sum over the group (the projection's output stays a
  partial sum until the adapter's delta is added).
- 'seq': each rank takes one sequence block of its rows and attention
  runs as ring attention (``ops.ring_attention``) across them.
- 'stage': GPipe over the layers (``parallel.pipeline``).

Gradients are summed, never averaged, across the ranks that split the
batch ('data', 'fsdp', 'seq') and across stages: each rank's loss is its
tokens' masked CE sum over the GLOBAL token count (divided by the stage
count, since every stage computes it), so the sum is the JAX step's
objective, and the ranks of a 'tensor' group compute the same replicated
loss.  FSDP2 sums over ('data', 'fsdp') (gradient divide factor 1), and
the step sums the local shards over 'seq' and 'stage' itself.  Under
gradient accumulation FSDP2 reduces once, after the last micro-step.  The
global norm of ``ClippedAdamW`` is the norm of every shard: one all-reduce
of the local sums of squares, each counted once however many ranks hold
it.  Checkpoints keep the port's format: the full state dict gathered
(``torch.distributed.checkpoint.state_dict``, ``full_state_dict=True``)
and written by rank 0, which alone reads it back and broadcasts it (each
rank keeps its shards), so a checkpoint of one mesh, or of none, resumes
at another.  ``mesh=None`` keeps the single-card path, with no process
group.

LoRA under a mesh freezes the base as without one: FSDP2 shards layers
that hold frozen and trainable parameters together (all f32) and
reduce-scatters the adapters' gradients alone, and the optimizer holds
the adapters alone.  ``train.lora.merge_base_params`` grafts a full base
state dict into a model already placed on a mesh.  BERT and ResNet are
no causal LMs: their task loops are ``train.tasks``, and the trainer
refuses them with the JAX trainer's ``ValueError``.  Checkpoints use the
port's own format (``torch.save``; there is no orbax).
"""
import dataclasses
import math
import os
import pathlib
import re
import shutil
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional
from typing import Tuple

import torch
from torch import distributed as dist
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.convert import init_params, iter_params
from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.mixtral import MixtralConfig
from skypilot_tpu_torch.models.registry import (CausalLMConfig, build_model,
                                                get_model_config,
                                                is_causal_lm)
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train.lora import LoRAAdapter, is_lora_path

Batch = Dict[str, torch.Tensor]
_CKPT_DIR = re.compile(r'step_(\d+)$')
_CKPT_KEEP = 3


@dataclasses.dataclass
class TrainConfig:
    model: str = 'llama-1b'
    batch_size: int = 8                  # global batch (sequences)
    seq_len: int = 2048
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # The parallelism degrees (parallel.mesh.MeshSpec); None trains on one
    # card with no process group.
    mesh: Optional[mesh_lib.MeshSpec] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    # Fused-loss sequence chunk (tokens); None = full-logits path.
    loss_chunk: Optional[int] = 128
    # Split each global batch into K sequential microbatches, accumulating
    # gradients in masked-sum form: the same update as one pass.
    grad_accum_steps: int = 1
    # Pipeline parallelism (mesh.stage > 1): GPipe microbatches per step;
    # None = the stage count (the minimum that fills the pipe).
    pipeline_microbatches: Optional[int] = None
    # torch.profiler trace (Chrome JSON) of steps
    # [profile_start, profile_start + profile_steps) into this dir.
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 3


@dataclasses.dataclass
class TrainState:
    """The counterpart of flax's TrainState: the step count, the model
    (its parameters) and the optimizer with its LR schedule.  The train
    step updates it in place."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR


def warmup_cosine_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps,
    0.1 * lr)`` with decay_steps = max(total, warmup + 1), counted from
    step 0: a linear warmup, then a cosine down to a tenth of the peak."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * (0.9 * cosine + 0.1)

    return lr


def global_norm(tensors: List[torch.Tensor],
                mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32
    (``optax.global_norm``).  Under a mesh the tensors are this rank's
    (DTensor shards or replicated tensors): each local sum of squares is
    divided by the number of ranks that hold the same values, and one
    all-reduce over the world adds them."""
    if mesh is None:
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.float()) for t in tensors]))
    world = mesh.spec.num_devices
    total = torch.zeros((), device=mesh_lib.rank_device(mesh))
    for t in tensors:
        local, copies = t, world
        if isinstance(t, DTensor):
            local = t.to_local()
            # Every placement but Replicate splits the values (a strided
            # shard too: FSDP2 over a dim 'tensor' splits already).
            copies //= math.prod(
                t.device_mesh.size(i) for i, p in enumerate(t.placements)
                if not p.is_replicate())
        total = total + local.float().pow(2).sum() / copies
    dist.all_reduce(total)
    return total.sqrt()


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(...))``: each
    step first scales every gradient by min(1, max_norm / ||g||), written
    by hand as optax does (``clip_grad_norm_`` adds 1e-6 to the norm),
    then takes the AdamW step.  AdamW's decoupled decay
    p * (1 - lr * wd) equals optax's lr * wd * p term.  ``grad_norm`` holds
    the last step's norm before clipping (the train step's metric)."""

    def __init__(self, params: Iterable[torch.Tensor], max_norm: float,
                 mesh: Optional[mesh_lib.Mesh] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.max_norm = max_norm
        self.mesh = mesh
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group['params'] if p.grad is not None]
        if grads:
            self.grad_norm = global_norm(grads, self.mesh)
            scale = (self.max_norm / self.grad_norm).clamp(max=1.0)
            for g in grads:
                (g.to_local() if isinstance(g, DTensor) else g).mul_(scale)
        return super().step(closure)


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor],
                   mesh: Optional[mesh_lib.Mesh] = None
                   ) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer of ``make_optimizer`` (clip by global norm, AdamW b1
    0.9, b2 0.95, eps 1e-8, weight decay on every parameter in one group,
    as optax's adamw masks nothing) and its warmup-cosine LR schedule.

    The schedule's ``step()`` follows the optimizer's, so the k-th update
    uses lr(k - 1) -- optax reads its schedule at the update count before
    the increment, and the first step takes lr(0) = 0.  Under a mesh
    the parameters are DTensors of more than one mesh, which the
    one-tensor-at-a-time update takes (``foreach=False``)."""
    kwargs = {} if mesh is None else {'mesh': mesh, 'foreach': False}
    optimizer = ClippedAdamW(params, cfg.grad_clip, lr=1.0,
                             betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=cfg.weight_decay, **kwargs)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, warmup_cosine_schedule(cfg))
    return optimizer, schedule


def trainable_parameters(model: torch.nn.Module
                         ) -> List[torch.nn.Parameter]:
    """The parameters a train step updates: with ``lora_rank`` > 0 the
    ``*_lora`` adapters only, after freezing every other parameter
    (``requires_grad_(False)``: no gradient, no optimizer state); else
    all of them."""
    if not getattr(model.config, 'lora_rank', 0):
        return list(model.parameters())
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_lora_path(name))
        if p.requires_grad:
            out.append(p)
    return out


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       normalizer: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked mean CE; with `normalizer` given, masked SUM * normalizer
    instead (grad accumulation passes 1/global_token_count)."""
    losses = F.cross_entropy(logits.flatten(0, -2).float(),
                             targets.flatten(), reduction='none'
                             ).view(targets.shape)
    if mask is None:
        mask = torch.ones_like(losses)
    total = (losses * mask).sum()
    if normalizer is not None:
        return total * normalizer
    return total / mask.sum().clamp_min(1)


def output_projection(model: torch.nn.Module) -> torch.Tensor:
    """[H, V] lm-head matrix (tied families use the [V, H] embedding:
    llama and mixtral ``embedding``, gpt2 ``wte``)."""
    return model.output_projection()


def _chunk_loss(hidden: torch.Tensor, proj: torch.Tensor,
                targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logits = hidden.float() @ proj.float()
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - gold) * mask).sum()


def chunked_cross_entropy(hidden: torch.Tensor, proj: torch.Tensor,
                          targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk_t: int = 128,
                          normalizer: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Next-token CE without materialising [B, T, V] f32 logits.

    The vocabulary projection and logsumexp run per sequence chunk, each
    under ``torch.utils.checkpoint``, so backward recomputes a chunk's
    logits and no more than one chunk's [B, chunk_t, V] exist at a time.
    T is padded to a multiple of chunk_t and the pad masked out."""
    b, t, _ = hidden.shape
    pad = (-t) % chunk_t
    mask = (torch.ones((b, t), device=hidden.device) if mask is None
            else mask.float())
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), device=hidden.device)
    for c in range(0, t + pad, chunk_t):
        sl = slice(c, c + chunk_t)
        total = total + torch_checkpoint.checkpoint(
            _chunk_loss, hidden[:, sl], proj, targets[:, sl], mask[:, sl],
            use_reentrant=False)
    if normalizer is not None:   # grad-accum: sum form, caller normalizes
        return total * normalizer
    return total / mask.sum().clamp_min(1.0)


def _call(model: torch.nn.Module, tokens: torch.Tensor, **kwargs):
    return model(tokens, **kwargs)


def objective(model: torch.nn.Module, inputs: torch.Tensor,
              targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
              loss_chunk: Optional[int] = 128,
              normalizer: Optional[torch.Tensor] = None,
              aux_scale: float = 1.0,
              positions: Optional[torch.Tensor] = None,
              forward: Callable = _call
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The train step's objective on one (micro)batch and its router term:
    the fused chunked loss over the final hidden states (computed inside
    the model's forward, as its ``head``), or with loss_chunk None the CE
    of the full logits, plus for Mixtral aux_scale times the routers'
    weighted load-balance losses summed over layers.  `positions` are the
    inputs' (a sequence block's under 'seq'); `forward(model, tokens,
    **kwargs)` calls the model (the pipelined forward under 'stage').
    Returns (objective, the router term as added; None for the dense
    families)."""
    kwargs = {} if positions is None else {'positions': positions}
    if loss_chunk:
        kwargs['head'] = lambda hidden, proj: chunked_cross_entropy(
            hidden, proj, targets, mask, chunk_t=loss_chunk,
            normalizer=normalizer)
    if isinstance(model.config, MixtralConfig):
        out, aux = forward(model, inputs, return_aux=True, **kwargs)
    else:
        out, aux = forward(model, inputs, **kwargs), None
    loss = out if loss_chunk else cross_entropy_loss(
        out, targets, mask, normalizer=normalizer)
    if aux is None:
        return loss, None
    aux = aux * aux_scale
    return loss + aux, aux


def loss_fn(model: torch.nn.Module, inputs: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
            loss_chunk: Optional[int] = 128,
            normalizer: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The train step's objective on one (micro)batch (``objective``'s
    first value)."""
    return objective(model, inputs, targets, mask, loss_chunk,
                     normalizer)[0]


def _shift(state: TrainState, batch: Batch):
    """(inputs, targets, mask) on the model's device: tokens[:, :-1],
    tokens[:, 1:] and the mask of the targets."""
    dev = next(state.model.parameters()).device
    tokens = batch['tokens'].to(dev, non_blocking=True)
    mask = batch.get('mask')
    if mask is not None:
        mask = mask.to(dev, non_blocking=True)[:, 1:]
    return tokens[:, :-1], tokens[:, 1:], mask


def _split_batch(mesh: Optional[mesh_lib.Mesh], inputs: torch.Tensor,
                 targets: torch.Tensor, mask: Optional[torch.Tensor],
                 global_batch: Optional[int], k: int):
    """This rank's share of a batch for K micro-steps: (inputs, targets,
    mask, positions, count), the first three [K, rows / K, ...].

    With no mesh, the batch's rows split into the K micro-steps in order,
    positions None and count the batch's target count.  Under a mesh, its
    ('data', 'fsdp') rows of each micro-step's rows (the JAX step's
    reshape(K, B/K): micro-step i takes global rows [i*B/K, (i+1)*B/K),
    sharded over the batch axes in order), its 'seq' block of each row,
    their positions (None with no 'seq' axis) and the target count of the
    whole global batch.  A batch of global_batch / (data * fsdp) rows is
    already this rank's (``data.loader.shard_batch``): its rows are split
    into the K micro-steps in order."""
    if mask is None:   # all-ones mask == unmasked mean loss
        mask = torch.ones(targets.shape, device=targets.device)
    rows = inputs.shape[0]
    if mesh is None:
        if rows % k:
            raise ValueError(f'batch {rows} not divisible by '
                             f'grad_accum_steps {k}')
        inputs, targets, mask = (x.reshape(k, -1, *x.shape[1:]) for x in
                                 (inputs, targets, mask.float()))
        return inputs, targets, mask, None, mask.sum()
    dp, di = mesh.size('data', 'fsdp'), mesh.coord('data', 'fsdp')
    if rows == global_batch:
        def pick(x):
            return x.reshape(k, dp, -1, *x.shape[1:])[:, di]
    elif rows * dp == global_batch:
        def pick(x):
            return x.reshape(k, -1, *x.shape[1:])
    else:
        raise ValueError(
            f'a batch of {rows} rows is neither the global batch '
            f'{global_batch} nor one rank\'s share of it ({dp} ranks)')
    inputs, targets, mask = pick(inputs), pick(targets), pick(mask.float())
    n, c = mesh.size('seq'), mesh.coord('seq')
    positions = None
    if n > 1:
        t = inputs.shape[-1] // n
        blk = slice(c * t, (c + 1) * t)
        inputs, targets, mask = (x[..., blk] for x in (inputs, targets, mask))
        positions = (c * t + torch.arange(t, device=inputs.device)).expand(
            inputs.shape[1], t)
    count = mask.sum()
    dist.all_reduce(count, group=mesh.group('data', 'fsdp', 'seq'))
    return inputs, targets, mask, positions, count


def _size(mesh: Optional[mesh_lib.Mesh], *axes: str) -> int:
    """The ranks along `axes` (1 with no mesh)."""
    return 1 if mesh is None else mesh.size(*axes)


def _sum_grads_over(model: torch.nn.Module,
                    mesh: Optional[mesh_lib.Mesh]) -> None:
    """Sum each gradient's local shard over the 'seq' and 'stage' groups
    (FSDP2 has summed it over 'data' and 'fsdp'); a parameter with no
    gradient on this rank (another stage's layer) adds zeros.  Nothing
    to do with no mesh."""
    for axis in ('seq', 'stage'):
        if _size(mesh, axis) == 1:
            continue
        group = mesh.group(axis)
        for p in model.parameters():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad
            dist.all_reduce(g.to_local() if isinstance(g, DTensor) else g,
                            group=group)


def _total(mesh: Optional[mesh_lib.Mesh], *values: torch.Tensor
           ) -> List[torch.Tensor]:
    """The global value of per-rank contributions: summed over the world,
    over the 'tensor' ranks that each hold all of it; with no mesh, the
    values as they are."""
    if mesh is None:
        return list(values)
    total = torch.stack([v.float() for v in values])
    dist.all_reduce(total)
    return list(total / mesh.size('tensor'))


def make_train_step(loss_chunk: Optional[int] = 128,
                    grad_accum_steps: int = 1,
                    mesh: Optional[mesh_lib.Mesh] = None,
                    global_batch: Optional[int] = None,
                    forward: Callable = _call
                    ) -> Callable[[TrainState, Batch],
                                  Dict[str, torch.Tensor]]:
    """The train step: next-token loss, gradients, clip + AdamW update of
    ``state`` in place.  Returns {'loss', 'grad_norm'} as device scalars
    (grad_norm before clipping; the loss includes Mixtral's router term,
    which is also returned alone as 'router_aux_loss').

    grad_accum_steps: K sequential microbatches of backward(), each CE in
    masked-sum form scaled by 1/global token count, so the K losses and
    gradients add up to the full-batch mean exactly, even when the
    microbatches' mask counts differ; then one update.

    mesh: the step of every rank of the mesh over its share of the global
    batch of `global_batch` rows (see the module docstring); `forward`
    calls the model (the pipelined forward under 'stage')."""
    k = max(grad_accum_steps, 1)
    stages, dp = _size(mesh, 'stage'), _size(mesh, 'data', 'fsdp')
    aux_scale = 1.0 / (k * _size(mesh, 'data', 'fsdp', 'seq') * stages)

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        mc = model.config
        if getattr(mc, 'weight_dtype', 'bf16') == 'int8' and \
                not mc.lora_rank:
            # As the JAX step's jax.grad over an int8 leaf: int8 weights
            # are a serving path (LoRA adapters on an int8 base train).
            raise TypeError(
                'grad requires real- or complex-valued inputs, but got '
                'int8: int8 weights are a serving path; train bf16 '
                'weights, or LoRA adapters on the int8 base')
        inputs, targets, mask, positions, count = _split_batch(
            mesh, *_shift(state, batch), global_batch, k)
        normalizer = 1.0 / count.clamp_min(1.0) / stages
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=inputs.device)
        aux = None
        with mesh_lib.mesh_context(mesh):
            for i in range(k):
                if isinstance(model, FSDPModule):
                    # FSDP2 reduces the accumulated gradients once.
                    model.set_requires_gradient_sync(i == k - 1)
                micro, micro_aux = objective(
                    model, inputs[i], targets[i], mask[i], loss_chunk,
                    normalizer=normalizer, aux_scale=aux_scale,
                    positions=positions, forward=forward)
                # FSDP2 averages over its ranks: scaled by their count,
                # the reduction is the sum of the ranks' contributions.
                (micro * dp).backward()
                loss = loss + micro.detach()
                if micro_aux is not None:
                    aux = micro_aux.detach() + (0.0 if aux is None else aux)
        _sum_grads_over(model, mesh)
        state.optimizer.step()
        state.schedule.step()
        state.step += 1
        totals = _total(mesh, loss, *(() if aux is None else (aux,)))
        metrics = {'loss': totals[0], 'grad_norm': state.optimizer.grad_norm}
        if aux is not None:
            metrics['router_aux_loss'] = totals[1]
        return metrics

    return step


def make_eval_step(loss_chunk: Optional[int] = 128,
                   mesh: Optional[mesh_lib.Mesh] = None,
                   global_batch: Optional[int] = None,
                   forward: Callable = _call
                   ) -> Callable[[TrainState, Batch], torch.Tensor]:
    """Loss-only forward (no grads, no state update) for held-out
    evaluation; the same loss path as training, without the router term
    (the JAX eval step scores the CE alone).  Under a mesh, every rank
    scores its share and gets the global mean."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        inputs, targets, mask, positions, count = _split_batch(
            mesh, *_shift(state, batch), global_batch, 1)
        normalizer = 1.0 / count.clamp_min(1.0) / _size(mesh, 'stage')
        with mesh_lib.mesh_context(mesh):
            loss = objective(state.model, inputs[0], targets[0], mask[0],
                             loss_chunk, normalizer=normalizer,
                             aux_scale=0.0, positions=positions,
                             forward=forward)[0]
        return _total(mesh, loss)[0]

    return eval_step


def synthetic_data(batch_size: int, seq_len: int, vocab_size: int,
                   seed: int = 0, device=None) -> Iterator[Batch]:
    """Deterministic synthetic token stream (benchmarks + tests), made on
    `device` (None means the card) from a seeded ``torch.Generator``.  It
    gives other tokens than the JAX stream of the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield {'tokens': torch.randint(0, vocab_size,
                                       (batch_size, seq_len + 1),
                                       generator=gen, device=device)}


def _check_mesh(cfg: TrainConfig, mc: CausalLMConfig) -> int:
    """The JAX trainer's refusals of a MeshSpec (with its texts), and the
    port's own; returns the pipeline microbatch count (0 without
    'stage')."""
    spec = cfg.mesh
    if not isinstance(spec, mesh_lib.MeshSpec):
        raise TypeError(f'TrainConfig.mesh must be a MeshSpec; got '
                        f'{type(spec).__name__}')
    dp = spec.data * spec.fsdp
    k = max(cfg.grad_accum_steps, 1)
    if cfg.batch_size % (dp * k):
        raise ValueError(
            f'batch_size {cfg.batch_size} not divisible by data * fsdp * '
            f'grad_accum_steps = {dp * k}')
    if cfg.seq_len % spec.seq:
        raise ValueError(f'seq_len {cfg.seq_len} not divisible by the seq '
                         f'axis {spec.seq}')
    heads = (mc.num_heads, mc.num_kv_heads, mc.intermediate_size,
             mc.hidden_size)
    if spec.tensor > 1 and any(n % spec.tensor for n in heads):
        raise ValueError(
            f'tensor {spec.tensor} must divide the heads, kv heads, MLP '
            f'and hidden widths {heads}')
    if spec.tensor > 1 and isinstance(mc, MixtralConfig) and \
            mc.num_experts % spec.tensor:
        raise ValueError(f'tensor {spec.tensor} must divide the '
                         f'{mc.num_experts} experts')
    if spec.stage <= 1:
        return 0
    if spec.tensor > 1 or spec.seq > 1:
        # The stage body would replicate the tensor/seq ranks' work.
        raise ValueError(
            'pipeline parallelism (stage > 1) currently '
            'composes with data/fsdp only; got '
            f'tensor={spec.tensor}, seq={spec.seq}')
    m = cfg.pipeline_microbatches or spec.stage
    step_batch = cfg.batch_size // k
    if m < spec.stage:
        raise ValueError(
            f'pipeline_microbatches {m} must be >= stage count '
            f'{spec.stage} to fill the pipeline')
    if step_batch % m:
        raise ValueError(
            f'per-step batch {step_batch} (batch_size / '
            f'grad_accum_steps) not divisible by '
            f'{m} pipeline microbatches')
    if (step_batch // m) % dp:
        raise ValueError(
            f'pipeline microbatch size {step_batch // m} not '
            f'divisible by the data-sharding degree {dp} '
            '(data * fsdp)')
    return m


def _decoder_layers(model: torch.nn.Module) -> torch.nn.ModuleList:
    return model.h if hasattr(model, 'h') else model.layers


def parallelize(model: torch.nn.Module, mesh: mesh_lib.Mesh) -> None:
    """Place the model on the mesh in place, each parameter by its logical
    axes through the rules (``parallel.mesh``):

    - 'tensor' (when > 1): a decoder ``Linear`` whose weight the rules
      shard on its output dim becomes ``ColwiseParallel``, on its input
      dim ``RowwiseParallel`` (DTensor ``parallelize_module``); every other
      parameter the rules shard over 'tensor' (the embedding, the head)
      becomes a DTensor sharded on that dim, which the model gathers
      where it reads it; Mixtral's experts are sharded on their expert
      dim and stay local (expert parallelism, as the JAX module's
      docstring describes it).
    - 'data' x 'fsdp': FSDP2 ``fully_shard`` on each decoder layer, then
      the root, on the dim the rules map to 'fsdp' (dim 0 when none
      does), gradients averaged over them (the train step scales its
      loss by their count: gloo has no pre-scaled sum)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Partial, Shard, distribute_tensor
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    def dims(name: str, ndim: int, axis: str) -> List[int]:
        logical = mesh_lib.param_logical_axes(name, ndim)
        if axis == 'tensor' and 'expert' in logical:
            # Expert parallelism: each rank holds whole experts (the JAX
            # rules give 'tensor' to the experts' mlp dim; the same
            # numbers either way).
            return [logical.index('expert')]
        axes = mesh_lib.resolve_axes(logical)
        return [i for i, a in enumerate(axes) if axis in a]

    if mesh.size('tensor') > 1:
        tp = mesh['tensor']
        prefix = 'h' if hasattr(model, 'h') else 'layers'
        plan, planned = {}, set()
        if isinstance(model.config, GPT2Config):
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if mesh_lib.is_fused_qkv(name):
                        p.copy_(mesh_lib.group_qkv_by_rank(
                            p, mesh.size('tensor')))
        for lname, layer in enumerate(_decoder_layers(model)):
            for name, mod in layer.named_modules():
                full = f'{prefix}.{lname}.{name}'
                if isinstance(mod, LoRAAdapter):
                    _shard_adapter(mod, tp, row=bool(
                        dims(full + '.lora_a', 2, 'tensor')))
                    planned.update(f'{full}.lora_a', f'{full}.lora_b')
                    continue
                if not isinstance(mod, torch.nn.Linear):
                    continue
                tdims = dims(full + '.weight', 2, 'tensor')
                if not tdims:
                    continue
                owner, _, attr = name.rpartition('.')
                if tdims == [0]:
                    plan[full] = ColwiseParallel()
                elif hasattr(layer.get_submodule(owner), f'{attr}_lora'):
                    # Left a partial sum: the adapter's partial delta joins
                    # it before the one reduction (``llama._proj``).
                    plan[full] = RowwiseParallel(output_layouts=Partial(),
                                                 use_local_output=False)
                else:
                    plan[full] = RowwiseParallel()
                planned.update(f'{full}.{p}' for p, _ in
                               mod.named_parameters())
        parallelize_module(model, tp, plan)
        for name, p in list(model.named_parameters()):
            tdims = dims(name, p.ndim, 'tensor')
            if name in planned or not tdims:
                continue
            owner = model.get_submodule(name.rpartition('.')[0])
            setattr(owner, name.rpartition('.')[2], torch.nn.Parameter(
                distribute_tensor(p.detach(), tp, [Shard(tdims[0])])))
    names = {id(p): n for n, p in model.named_parameters()}

    def placement(p):
        fdims = dims(names[id(p)], p.ndim, 'fsdp')
        return Shard(fdims[0] if fdims else 0)

    dp = mesh['data', 'fsdp']
    for layer in _decoder_layers(model):
        fully_shard(layer, mesh=dp, shard_placement_fn=placement)
    fully_shard(model, mesh=dp, shard_placement_fn=placement)


def _shard_adapter(adapter: LoRAAdapter, tp, row: bool) -> None:
    """Place a LoRA adapter on the 'tensor' sub-mesh `tp` with its
    projection: row-parallel (`row`), ``lora_a`` split on its input rows,
    the input taken as the rank's columns and the delta left a partial
    sum (a DTensor the projection's own partial output is added to);
    column-parallel, ``lora_b`` split on its output columns and the delta
    the rank's columns.  The other leaf is replicated."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_module,
                                          distribute_tensor)
    split = ('lora_a', Shard(0)) if row else ('lora_b', Shard(1))

    def partition(_name, mod, mesh):
        if mod is not adapter:
            return
        for leaf, p in list(mod.named_parameters(recurse=False)):
            place = split[1] if leaf == split[0] else Replicate()
            mod.register_parameter(leaf, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, [place])))

    def inputs(_mod, args, mesh):
        x = DTensor.from_local(args[0], mesh,
                               [Shard(-1) if row else Replicate()],
                               run_check=False)
        return (x, *args[1:])

    def output(_mod, out, _mesh):
        return out if row else out.to_local()

    distribute_module(adapter, tp, partition, inputs, output)


def _regroup_qkv(model_sd: Dict, optim_state: Dict, tensor: int,
                 inverse: bool = False) -> None:
    """GPT-2's fused q/k/v rows, in a full model state dict and in the
    name-keyed optimizer state, from the checkpoint's layout to the
    tensor-sharded model's (``parallel.mesh.group_qkv_by_rank``; back
    with `inverse`), in place; nothing when `tensor` is 0."""
    if not tensor:
        return
    for key in [k for k in model_sd if mesh_lib.is_fused_qkv(k)]:
        model_sd[key] = mesh_lib.group_qkv_by_rank(model_sd[key], tensor,
                                                   inverse)
    for key, moments in optim_state.items():
        if mesh_lib.is_fused_qkv(key):
            for leaf, v in moments.items():
                if torch.is_tensor(v) and v.ndim:
                    moments[leaf] = mesh_lib.group_qkv_by_rank(v, tensor,
                                                               inverse)


def _index_keyed(osd: Dict, names: List[str]) -> Dict:
    """A full optimizer state dict keyed by parameter names -> keyed by
    position, the single-card optimizer's own form."""
    idx = {n: i for i, n in enumerate(names)}
    return {'state': {idx[n]: v for n, v in osd['state'].items()},
            'param_groups': [{**g, 'params': [idx[n] for n in g['params']]}
                             for g in osd['param_groups']]}


def _name_keyed(osd: Dict, names: List[str]) -> Dict:
    return {'state': {names[i]: v for i, v in osd['state'].items()},
            'param_groups': [{**g, 'params': [names[i] for i in g['params']]}
                             for g in osd['param_groups']]}


class Trainer:
    """Drives steps on one card, or on every rank of a mesh; measures
    tokens/sec; checkpoints.

    Checkpoint/resume contract, as the JAX trainer's: with
    ``cfg.checkpoint_dir`` set, every ``checkpoint_every`` steps the state
    (step, model, optimizer, schedule) is saved to
    ``<checkpoint_dir>/step_<n>`` (written under a temporary name, then
    renamed; the newest 3 are kept), and ``setup`` resumes from the
    latest one.  Under a mesh the state is gathered whole and rank 0
    writes it, in the single-card form; rank 0 reads it back and
    broadcasts it, each rank keeping its shards, so any mesh (or none)
    resumes any checkpoint.

    Under a mesh, every rank of the process group constructs a Trainer
    with the same config (``initialize_distributed_from_env`` starts the
    group from torchrun's or the podlet's env; a single process gets a
    one-rank group); `device` None means each rank's card, 'cpu' gloo."""

    def __init__(self, cfg: TrainConfig,
                 model_config: Optional[CausalLMConfig] = None,
                 device=None):
        self.cfg = cfg
        self.model_config = model_config or get_model_config(cfg.model)
        if not is_causal_lm(self.model_config):
            raise ValueError(
                f'{cfg.model!r} is not a causal-LM family; use its '
                'task-specific training loop (see models/bert.py, '
                'models/resnet.py).')
        if cfg.grad_accum_steps > 1 and \
                cfg.batch_size % cfg.grad_accum_steps:
            raise ValueError(
                f'batch_size {cfg.batch_size} not divisible by '
                f'grad_accum_steps {cfg.grad_accum_steps}')
        self.mesh: Optional[mesh_lib.Mesh] = None
        self._pp_microbatches = 0
        if cfg.mesh is not None:
            self._pp_microbatches = _check_mesh(cfg, self.model_config)
            self.device = mesh_lib.ensure_process_group(device)
            self.mesh = mesh_lib.make_mesh(cfg.mesh, self.device.type)
        else:
            self.device = resolve_device(device)
        self.state: Optional[TrainState] = None
        self._step_fn = None
        self._eval_fn = None
        self._forward = _call
        # (step, loss) at every logged step of train().
        self.history: List[Tuple[int, float]] = []

    def setup(self, seed: int = 0,
              params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Build the model with f32 master weights -- ``params`` (a
        state_dict, e.g. from ``convert.state_dict_from_jax``) or random
        ones from a generator seeded with `seed` -- and the optimizer;
        resume from the latest checkpoint if there is one.  With LoRA, a
        base ``params`` (no ``*_lora`` entries; with none given, the base a
        plain trainer draws from `seed`) is grafted under freshly drawn
        adapters, and the optimizer holds the adapters alone
        (``trainable_parameters``)."""
        mc = self.model_config
        model = build_model(mc, device=self.device,
                            param_dtype=torch.float32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        lora_rank = getattr(mc, 'lora_rank', 0)
        if params is None:
            # The base weights a plain trainer (and a serving engine)
            # draws from this seed; adapters are drawn after them.
            params = init_params(dataclasses.replace(mc, lora_rank=0)
                                 if lora_rank else mc, gen)
        if lora_rank and not any(is_lora_path(k) for k in params):
            # A base state_dict: grafted under freshly drawn adapters
            # (drawn one tensor at a time, the rest discarded).
            params = {**params, **{k: v for k, v in iter_params(mc, gen)
                                   if is_lora_path(k)}}
        model.load_state_dict(params)
        if self.mesh is not None:
            parallelize(model, self.mesh)
        if self._pp_microbatches:
            from skypilot_tpu_torch.parallel.pipeline import \
                make_pipelined_apply
            self._forward = make_pipelined_apply(
                mc, self.mesh, num_microbatches=self._pp_microbatches)
        optimizer, schedule = make_optimizer(
            self.cfg, trainable_parameters(model), self.mesh)
        self.state = TrainState(0, model, optimizer, schedule)
        self._step_fn = make_train_step(
            loss_chunk=self.cfg.loss_chunk,
            grad_accum_steps=self.cfg.grad_accum_steps, mesh=self.mesh,
            global_batch=self.cfg.batch_size, forward=self._forward)
        if self.cfg.checkpoint_dir:
            self.maybe_restore()

    def _checkpoints(self) -> List[pathlib.Path]:
        """Finished checkpoint directories, oldest first."""
        root = pathlib.Path(self.cfg.checkpoint_dir)
        if not root.is_dir():
            return []
        found = [(int(m.group(1)), p) for p in root.iterdir()
                 if (m := _CKPT_DIR.match(p.name))]
        return [p for _, p in sorted(found)]

    def maybe_restore(self) -> int:
        """Resume from the latest checkpoint if one exists; returns its
        step (0 if none).

        Under a mesh rank 0 alone lists and reads the checkpoint (memory-
        mapped, on the CPU) and broadcasts it tensor by tensor; each rank
        keeps its shards of each as it arrives, so no rank holds the
        whole state on its card."""
        if self.mesh is None:
            found = self._checkpoints()
            if not found:
                return 0
            ckpt = torch.load(found[-1] / 'state.pt',
                              map_location=self.device, weights_only=True)
            self.state.model.load_state_dict(ckpt['model'])
            self.state.optimizer.load_state_dict(ckpt['optimizer'])
        else:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, set_model_state_dict,
                set_optimizer_state_dict)
            rank0 = dist.get_rank() == 0
            box = [self._checkpoints()[-1:] if rank0 else None]
            dist.broadcast_object_list(box, src=0)
            if not box[0]:
                return 0
            ckpt = {'model': {}, 'optimizer': {}}
            if rank0:
                ckpt = torch.load(box[0][0] / 'state.pt', map_location='cpu',
                                  mmap=True, weights_only=True)
                ckpt['optimizer'] = _name_keyed(ckpt['optimizer'],
                                                self._param_names())
                _regroup_qkv(ckpt['model'], ckpt['optimizer']['state'],
                             self._qkv_groups())
            opts = StateDictOptions(full_state_dict=True,
                                    broadcast_from_rank0=True)
            model = self.state.model
            set_model_state_dict(model, ckpt['model'], options=opts)
            set_optimizer_state_dict(model, self.state.optimizer,
                                     ckpt['optimizer'], options=opts)
            box = [{k: ckpt[k] for k in ('schedule', 'step')} if rank0
                   else None]
            dist.broadcast_object_list(box, src=0)
            ckpt = box[0]
        self.state.schedule.load_state_dict(ckpt['schedule'])
        self.state.step = ckpt['step']
        return self.state.step

    def _param_names(self) -> List[str]:
        """Names of the optimizer's parameters, in its order."""
        return [n for n, p in self.state.model.named_parameters()
                if p.requires_grad]

    def _full_state(self) -> Tuple[Dict, Dict]:
        """(model state_dict, optimizer state_dict) in the single-card
        form; under a mesh gathered whole to rank 0's CPU (every rank
        takes part; the others get empty dicts)."""
        if self.mesh is None:
            return (self.state.model.state_dict(),
                    self.state.optimizer.state_dict())
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict, get_optimizer_state_dict)
        opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
        model = self.state.model
        model_sd = get_model_state_dict(model, options=opts)
        optim_sd = get_optimizer_state_dict(model, self.state.optimizer,
                                            options=opts)
        if optim_sd:
            _regroup_qkv(model_sd, optim_sd['state'], self._qkv_groups(),
                         inverse=True)
            optim_sd = _index_keyed(optim_sd, self._param_names())
        return model_sd, optim_sd

    def _qkv_groups(self) -> int:
        """The tensor degree GPT-2's fused q/k/v rows are grouped by in
        this trainer's model (``parallelize``); 0 when they are not."""
        if self.mesh is None or not isinstance(self.model_config,
                                               GPT2Config):
            return 0
        n = self.mesh.size('tensor')
        return n if n > 1 else 0

    def save(self, step: int) -> None:
        """Checkpoint the state as `step` if checkpointing is on and step
        is a multiple of ``checkpoint_every``."""
        if not self.cfg.checkpoint_dir or step % self.cfg.checkpoint_every:
            return
        model_sd, optim_sd = self._full_state()
        if self.mesh is None or dist.get_rank() == 0:
            root = pathlib.Path(self.cfg.checkpoint_dir)
            root.mkdir(parents=True, exist_ok=True)
            final = root / f'step_{step:08d}'
            tmp = root / f'.tmp_step_{step:08d}.{os.getpid()}'
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save({'step': step, 'model': model_sd,
                        'optimizer': optim_sd,
                        'schedule': self.state.schedule.state_dict()},
                       tmp / 'state.pt')
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._checkpoints()[:-_CKPT_KEEP]:
                shutil.rmtree(old)
        if self.mesh is not None:
            dist.barrier()

    def flush_checkpoints(self) -> None:
        """Saves are synchronous here: nothing is left in flight.  Kept
        for parity with the JAX trainer's orbax flush."""

    def evaluate(self, data: Iterator,
                 num_batches: int = 50) -> Dict[str, float]:
        """Mean held-out loss + perplexity over num_batches."""
        if self.state is None:
            self.setup()
        if self._eval_fn is None:
            self._eval_fn = make_eval_step(
                loss_chunk=self.cfg.loss_chunk, mesh=self.mesh,
                global_batch=self.cfg.batch_size, forward=self._forward)
        losses = []
        for _ in range(num_batches):
            try:
                batch = next(data)
            except StopIteration:   # short iterator: use what we got
                break
            losses.append(float(self._eval_fn(self.state, batch)))
        if not losses:
            # An exhausted iterator must not read as a perfect model.
            return {'eval_loss': float('nan'),
                    'perplexity': float('nan'), 'batches': 0}
        mean = sum(losses) / len(losses)
        return {'eval_loss': mean, 'perplexity': math.exp(mean),
                'batches': len(losses)}

    def _trace(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _stop_trace(self, prof: torch.profiler.profile, first: int) -> None:
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.cfg.profile_dir, f'trace_step{first}.json'))

    def train(self, data: Optional[Iterator] = None,
              num_steps: Optional[int] = None,
              log_every: int = 10) -> Dict[str, float]:
        if self.state is None:
            self.setup()
        cfg = self.cfg
        num_steps = num_steps or cfg.total_steps
        data = data or synthetic_data(cfg.batch_size, cfg.seq_len,
                                      self.model_config.vocab_size,
                                      device=self.device)
        start_step = self.state.step
        tokens_per_step = cfg.batch_size * cfg.seq_len
        t0 = None
        losses = []
        metrics = None
        prof = None
        try:
            for i in range(start_step, start_step + num_steps):
                if cfg.profile_dir and i - start_step == cfg.profile_start:
                    prof = self._trace()
                    prof.start()
                batch = next(data)
                metrics = self._step_fn(self.state, batch)
                if i == start_step:  # exclude warm-up from throughput
                    float(metrics['loss'])   # host transfer = sync
                    t0 = time.perf_counter()
                if prof is not None and i - start_step == \
                        cfg.profile_start + cfg.profile_steps - 1:
                    float(metrics['loss'])   # sync the profiled window
                    self._stop_trace(prof, start_step + cfg.profile_start)
                    prof = None
                if (i + 1) % log_every == 0:
                    losses.append(float(metrics['loss']))
                    self.history.append((i + 1, losses[-1]))
                self.save(i + 1)
        finally:
            if prof is not None:   # run ended inside the window
                self._stop_trace(prof, start_step + cfg.profile_start)
        float(metrics['loss'])  # sync the enqueued steps before timing
        elapsed = time.perf_counter() - (t0 or time.perf_counter())
        self.flush_checkpoints()
        steps_timed = max(num_steps - 1, 1)
        tps = tokens_per_step * steps_timed / max(elapsed, 1e-9)
        devices = 1 if self.mesh is None else self.mesh.spec.num_devices
        return {
            'steps': num_steps,
            'final_loss': losses[-1] if losses else float(metrics['loss']),
            'tokens_per_second': tps,
            'tokens_per_second_per_device': tps / devices,
        }
