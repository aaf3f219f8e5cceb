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

Not ported here: a mesh and pipeline parallelism (ROADMAP.md A9); each
raises ``NotImplementedError``.  BERT and ResNet are no causal LMs: their
task loops are ``train.tasks``, and the trainer refuses them with the JAX
trainer's ``ValueError``.
Checkpoints use the port's own format (``torch.save``; there is no
orbax).
"""
import dataclasses
import math
import os
import pathlib
import re
import shutil
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional
from typing import Tuple

import torch
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.convert import init_params, iter_params
from skypilot_tpu_torch.models.mixtral import MixtralConfig
from skypilot_tpu_torch.models.registry import (CausalLMConfig, build_model,
                                                get_model_config,
                                                is_causal_lm)
from skypilot_tpu_torch.train.lora import is_lora_path

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
    # A device mesh (multi-GPU): not ported yet, must stay None.
    mesh: Optional[Any] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    # Fused-loss sequence chunk (tokens); None = full-logits path.
    loss_chunk: Optional[int] = 128
    # Split each global batch into K sequential microbatches, accumulating
    # gradients in masked-sum form: the same update as one pass.
    grad_accum_steps: int = 1
    # Pipeline parallelism: not ported yet, must stay None.
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


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32
    (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(...))``: each
    step first scales every gradient by min(1, max_norm / ||g||), written
    by hand as optax does (``clip_grad_norm_`` adds 1e-6 to the norm),
    then takes the AdamW step.  AdamW's decoupled decay
    p * (1 - lr * wd) equals optax's lr * wd * p term.  ``grad_norm`` holds
    the last step's norm before clipping (the train step's metric)."""

    def __init__(self, params: Iterable[torch.Tensor], max_norm: float,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.max_norm = max_norm
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group['params'] if p.grad is not None]
        if grads:
            self.grad_norm = global_norm(grads)
            scale = (self.max_norm / self.grad_norm).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
        return super().step(closure)


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]
                   ) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer of ``make_optimizer`` (clip by global norm, AdamW b1
    0.9, b2 0.95, eps 1e-8, weight decay on every parameter in one group,
    as optax's adamw masks nothing) and its warmup-cosine LR schedule.

    The schedule's ``step()`` follows the optimizer's, so the k-th update
    uses lr(k - 1) -- optax reads its schedule at the update count before
    the increment, and the first step takes lr(0) = 0."""
    optimizer = ClippedAdamW(params, cfg.grad_clip, lr=1.0,
                             betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=cfg.weight_decay)
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
    if getattr(model, 'lm_head', None) is not None:
        return model.lm_head.weight.T
    return (model.wte if hasattr(model, 'wte') else model.embedding).T


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


def objective(model: torch.nn.Module, inputs: torch.Tensor,
              targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
              loss_chunk: Optional[int] = 128,
              normalizer: Optional[torch.Tensor] = None,
              aux_scale: float = 1.0
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The train step's objective on one (micro)batch and its router term:
    the fused chunked loss over the final hidden states, or with
    loss_chunk None the CE of the full logits, plus for Mixtral
    aux_scale times the routers' weighted load-balance losses summed over
    layers.  Returns (objective, the router term as added; None for the
    dense families)."""
    if isinstance(model.config, MixtralConfig):
        out, aux = model(inputs, hidden_only=bool(loss_chunk),
                         return_aux=True)
    else:
        out, aux = model(inputs, hidden_only=bool(loss_chunk)), None
    if loss_chunk:
        loss = chunked_cross_entropy(out, output_projection(model), targets,
                                     mask, chunk_t=loss_chunk,
                                     normalizer=normalizer)
    else:
        loss = cross_entropy_loss(out, targets, mask, normalizer=normalizer)
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


def make_train_step(loss_chunk: Optional[int] = 128,
                    grad_accum_steps: int = 1
                    ) -> Callable[[TrainState, Batch],
                                  Dict[str, torch.Tensor]]:
    """The train step: next-token loss, gradients, clip + AdamW update of
    ``state`` in place.  Returns {'loss', 'grad_norm'} as device scalars
    (grad_norm before clipping; the loss includes Mixtral's router term,
    which is also returned alone as 'router_aux_loss').

    grad_accum_steps: K > 1 runs K sequential microbatches of backward()
    with each CE in masked-sum form scaled by 1/global token count, so
    the K losses and gradients add up to the full-batch mean exactly,
    even when the microbatches' mask counts differ; then steps once."""

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        inputs, targets, mask = _shift(state, batch)
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
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps <= 1:
            loss, aux = objective(model, inputs, targets, mask, loss_chunk)
            loss.backward()
            loss = loss.detach()
        else:
            b = inputs.shape[0]
            if b % grad_accum_steps:
                raise ValueError(
                    f'batch {b} not divisible by grad_accum_steps '
                    f'{grad_accum_steps}')
            if mask is None:   # all-ones mask == unmasked mean loss
                mask = torch.ones(targets.shape, device=targets.device)
            inv_total = 1.0 / mask.float().sum().clamp_min(1.0)
            loss = torch.zeros((), device=inputs.device)
            aux = None
            for mi, mt, mm in zip(inputs.chunk(grad_accum_steps),
                                  targets.chunk(grad_accum_steps),
                                  mask.chunk(grad_accum_steps)):
                micro, micro_aux = objective(
                    model, mi, mt, mm, loss_chunk, normalizer=inv_total,
                    aux_scale=1.0 / grad_accum_steps)
                micro.backward()
                loss = loss + micro.detach()
                if micro_aux is not None:
                    aux = micro_aux.detach() + (0.0 if aux is None else aux)
        state.optimizer.step()
        state.schedule.step()
        state.step += 1
        metrics = {'loss': loss, 'grad_norm': state.optimizer.grad_norm}
        if aux is not None:
            metrics['router_aux_loss'] = aux.detach()
        return metrics

    return step


def make_eval_step(loss_chunk: Optional[int] = 128
                   ) -> Callable[[TrainState, Batch], torch.Tensor]:
    """Loss-only forward (no grads, no state update) for held-out
    evaluation; the same loss path as training, without the router term
    (the JAX eval step scores the CE alone)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        inputs, targets, mask = _shift(state, batch)
        return objective(state.model, inputs, targets, mask, loss_chunk,
                         aux_scale=0.0)[0]

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


class Trainer:
    """Drives steps on one card; measures tokens/sec; checkpoints.

    Checkpoint/resume contract, as the JAX trainer's: with
    ``cfg.checkpoint_dir`` set, every ``checkpoint_every`` steps the state
    (step, model, optimizer, schedule) is saved to
    ``<checkpoint_dir>/step_<n>`` (written under a temporary name, then
    renamed; the newest 3 are kept), and ``setup`` resumes from the
    latest one."""

    def __init__(self, cfg: TrainConfig,
                 model_config: Optional[CausalLMConfig] = None,
                 device=None):
        if cfg.mesh is not None or cfg.pipeline_microbatches is not None:
            raise NotImplementedError(
                'mesh and pipeline_microbatches (multi-GPU training) are '
                'not ported yet (ROADMAP.md A9, multi-GPU)')
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
        self.device = resolve_device(device)
        self.state: Optional[TrainState] = None
        self._step_fn = None
        self._eval_fn = None
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
        optimizer, schedule = make_optimizer(self.cfg,
                                             trainable_parameters(model))
        self.state = TrainState(0, model, optimizer, schedule)
        self._step_fn = make_train_step(
            loss_chunk=self.cfg.loss_chunk,
            grad_accum_steps=self.cfg.grad_accum_steps)
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
        step (0 if none)."""
        found = self._checkpoints()
        if not found:
            return 0
        ckpt = torch.load(found[-1] / 'state.pt', map_location=self.device,
                          weights_only=True)
        self.state.model.load_state_dict(ckpt['model'])
        self.state.optimizer.load_state_dict(ckpt['optimizer'])
        self.state.schedule.load_state_dict(ckpt['schedule'])
        self.state.step = ckpt['step']
        return self.state.step

    def save(self, step: int) -> None:
        """Checkpoint the state as `step` if checkpointing is on and step
        is a multiple of ``checkpoint_every``."""
        if not self.cfg.checkpoint_dir or step % self.cfg.checkpoint_every:
            return
        root = pathlib.Path(self.cfg.checkpoint_dir)
        root.mkdir(parents=True, exist_ok=True)
        final = root / f'step_{step:08d}'
        tmp = root / f'.tmp_step_{step:08d}.{os.getpid()}'
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({'step': step,
                    'model': self.state.model.state_dict(),
                    'optimizer': self.state.optimizer.state_dict(),
                    'schedule': self.state.schedule.state_dict()},
                   tmp / 'state.pt')
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._checkpoints()[:-_CKPT_KEEP]:
            shutil.rmtree(old)

    def flush_checkpoints(self) -> None:
        """Saves are synchronous here: nothing is left in flight.  Kept
        for parity with the JAX trainer's orbax flush."""

    def evaluate(self, data: Iterator,
                 num_batches: int = 50) -> Dict[str, float]:
        """Mean held-out loss + perplexity over num_batches."""
        if self.state is None:
            self.setup()
        if self._eval_fn is None:
            self._eval_fn = make_eval_step(loss_chunk=self.cfg.loss_chunk)
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
        return {
            'steps': num_steps,
            'final_loss': losses[-1] if losses else float(metrics['loss']),
            'tokens_per_second': tps,
            'tokens_per_second_per_device': tps,
        }
