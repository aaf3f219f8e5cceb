"""Task loops of the encoder and vision families: BERT sequence
classification and ResNet image classification on one card -- the
counterparts of the JAX package's ``examples/finetune_bert.py`` and
``examples/train_resnet.py``, which the example twins
(``examples/finetune_bert_torch.py``, ``examples/train_resnet_torch.py``)
and ``chip_smoke.py`` call.

Neither family goes through the causal-LM trainer; each example has its
own step, copied here:

- BERT: ``BertForSequenceClassification`` with f32 master weights and
  ``config.dtype`` compute, mean softmax cross-entropy on integer labels
  and accuracy; AdamW at ``lr`` with weight decay 0.01 on every parameter
  (``optax.adamw(lr, weight_decay=0.01)``: b1 0.9, b2 0.999, eps 1e-8
  outside the square root; torch's decoupled decay p * (1 - lr * wd) is
  optax's lr * wd * p term).
- ResNet: ``ResNet(train=True)``, the same loss, the BatchNorm running
  statistics carried to the next step (buffers updated by the forward);
  SGD with Nesterov momentum and ``optax.cosine_decay_schedule(lr,
  steps)``: update t (0-based) runs at lr * 0.5 * (1 + cos(pi * t /
  steps)), so the first runs at the full rate.  torch's Nesterov SGD
  (buf = m * buf + g, step g + m * buf) is optax's ``trace(nesterov=
  True)``.

The data generators are copies of the examples' (the same numpy streams
from the same seed).  As the JAX examples shard the batch over a
data-parallel mesh across processes, the loops run data-parallel over the
process group (started from torchrun's or the podlet's env, or already
up): a ``MeshSpec(data=world)`` mesh, each rank drawing its
``batch_size / world`` rows from its own stream (the examples' per-process
seeds), the parameters replicated under ``DistributedDataParallel``, the
gradients and the printed loss and accuracy averaged over the ranks --
the global batch's mean, as the JAX step computes it.  ResNet's BatchNorm takes its statistics over the
global batch (one-pass sums all-reduced across the ranks), as flax's does
under a data-sharded jit.
"""
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import distributed as dist
from torch.nn import functional as F

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.bert import (BertConfig,
                                            BertForSequenceClassification)
from skypilot_tpu_torch.models.convert import init_params
from skypilot_tpu_torch.models.registry import get_model_config
from skypilot_tpu_torch.models.resnet import ResNet, ResNetConfig
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Batch = Dict[str, Any]


def data_mesh(device=None) -> Optional[mesh_lib.Mesh]:
    """The examples' ``MeshSpec(data=world)`` over the process group (the
    env's, started here, or one already up); None for a single
    process."""
    mesh_lib.initialize_distributed_from_env(device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return mesh_lib.make_mesh(mesh_lib.MeshSpec(data=dist.get_world_size()),
                              resolve_device(device).type)


# ------------------------------------------------------------------ data


def synthetic_bert_batches(rng: np.random.Generator, vocab_size: int,
                           batch_size: int, seq_len: int, num_classes: int
                           ) -> Iterator[Batch]:
    """Class-conditioned token streams: class c favors the c-th slice of
    the vocabulary 3:1, so a linear probe over a [CLS] encoding can
    separate the classes -- loss must fall and accuracy must rise."""
    bucket = max(vocab_size // num_classes, 1)
    while True:
        labels = rng.integers(0, num_classes, size=batch_size)
        favored = rng.integers(0, bucket, size=(batch_size, seq_len)) + \
            (labels[:, None] * bucket)
        uniform = rng.integers(0, vocab_size, size=(batch_size, seq_len))
        pick = rng.random((batch_size, seq_len)) < 0.75
        tokens = np.where(pick, favored, uniform)
        yield {'tokens': tokens.astype(np.int32),
               'labels': labels.astype(np.int32)}


def imdb_batches(batch_size: int, seq_len: int) -> Iterator[Batch]:
    """Real IMDB via `datasets` (needs the data installed locally)."""
    try:
        import datasets  # type: ignore
        import transformers
    except ImportError as e:
        raise SystemExit(
            f'--dataset imdb needs the `datasets` package ({e}); '
            'use --dataset synthetic for a hermetic run') from e
    ds = datasets.load_dataset('imdb', split='train').shuffle(seed=0)
    tok = transformers.AutoTokenizer.from_pretrained('bert-base-uncased')
    while True:
        for i in range(0, len(ds) - batch_size, batch_size):
            rows = ds[i:i + batch_size]
            enc = tok(rows['text'], truncation=True, padding='max_length',
                      max_length=seq_len, return_tensors='np')
            yield {'tokens': enc['input_ids'].astype(np.int32),
                   'labels': np.asarray(rows['label'], np.int32)}


def synthetic_resnet_batches(seed: int, proc_seed: int, batch_size: int,
                             image_size: int, num_classes: int
                             ) -> Iterator[Batch]:
    """Class-conditioned images: a fixed mean image per class (from `seed`
    alone) plus gaussian noise from a stream offset by `proc_seed`."""
    means = np.random.default_rng(seed).normal(
        0.0, 1.0, size=(num_classes, image_size, image_size, 3))
    rng = np.random.default_rng(seed * 1000 + proc_seed + 1)
    while True:
        labels = rng.integers(0, num_classes, size=batch_size)
        images = means[labels] + rng.normal(
            0.0, 0.8, size=(batch_size, image_size, image_size, 3))
        yield {'images': images.astype(np.float32),
               'labels': labels.astype(np.int32)}


def cifar_batches(data_dir: str, batch_size: int,
                  proc_seed: int = 0) -> Iterator[Batch]:
    """CIFAR-10 python-pickle batches (the reference recipe's dataset)."""
    import glob
    import pickle
    files = sorted(glob.glob(f'{data_dir}/data_batch_*'))
    if not files:
        raise SystemExit(f'no CIFAR data_batch_* under {data_dir}')
    xs, ys = [], []
    for f in files:
        with open(f, 'rb') as fh:
            d = pickle.load(fh, encoding='bytes')
        xs.append(np.asarray(d[b'data'], np.float32).reshape(
            -1, 3, 32, 32).transpose(0, 2, 3, 1) / 127.5 - 1.0)
        ys.append(np.asarray(d[b'labels'], np.int32))
    x, y = np.concatenate(xs), np.concatenate(ys)
    rng = np.random.default_rng(proc_seed)
    while True:
        order = rng.permutation(len(x))
        for i in range(0, len(order) - batch_size, batch_size):
            idx = order[i:i + batch_size]
            yield {'images': x[idx], 'labels': y[idx]}


# ---------------------------------------------------------------- a step


@dataclasses.dataclass
class TaskState:
    """A task loop's model, optimizer and (ResNet) LR schedule, the
    data-parallel mesh (None on one process) and the module a step calls
    (``data_parallel``'s); a step updates them in place."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    mesh: Optional[mesh_lib.Mesh] = None
    forward: Optional[torch.nn.Module] = None


def data_parallel(model: torch.nn.Module,
                  mesh: Optional[mesh_lib.Mesh]) -> torch.nn.Module:
    """The module a step calls: under a data mesh the model wrapped in
    ``DistributedDataParallel`` over the 'data' group, which averages the
    gradients over the ranks in buckets while the backward runs (the
    buffers are not broadcast: ResNet's BatchNorm keeps them equal on
    every rank itself); the model itself with no mesh."""
    if mesh is None:
        return model
    from torch.nn.parallel import DistributedDataParallel
    dev = mesh_lib.rank_device(mesh)
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == 'cuda' else None,
        process_group=mesh.group('data'), broadcast_buffers=False)


def _on(state: TaskState, x) -> torch.Tensor:
    dev = next(state.model.parameters()).device
    return torch.as_tensor(x).to(dev, non_blocking=True)


def classify_step(state: TaskState, inputs: torch.Tensor,
                  labels: torch.Tensor, **forward_kw) -> tuple:
    """One update: mean softmax cross-entropy of the model's f32 logits on
    integer labels, backward, the optimizer (and schedule) step.  Returns
    (loss, accuracy) as device scalars, before the update.  Under a data
    mesh the inputs are this rank's rows; the gradients (averaged by
    ``data_parallel``'s wrapper), the loss and the accuracy are averaged
    over the ranks (equal rows on each: the global batch's mean)."""
    with mesh_lib.mesh_context(state.mesh):
        logits = (state.forward or state.model)(inputs, **forward_kw)
        labels = labels.long()
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if state.mesh is not None:
        group, n = state.mesh.group('data'), state.mesh.size('data')
        metrics = torch.stack([loss.detach(), acc])
        dist.all_reduce(metrics, group=group)
        loss, acc = metrics / n
    state.optimizer.step()
    if state.schedule is not None:
        state.schedule.step()
    return loss.detach(), acc


def bert_setup(config: BertConfig, lr: float, seed: int = 0, device=None,
               params: Optional[Dict[str, torch.Tensor]] = None,
               mesh: Optional[mesh_lib.Mesh] = None) -> TaskState:
    """The example's state: the classifier with f32 master weights (random
    from `seed`, or ``params``; the same on every rank of `mesh`) and
    AdamW(lr, weight decay 0.01)."""
    device = (resolve_device(device) if mesh is None
              else mesh_lib.rank_device(mesh))
    model = BertForSequenceClassification(config, device=device,
                                          param_dtype=torch.float32)
    if params is None:
        params = init_params(config, torch.Generator(
            device=device).manual_seed(seed), head='classify')
    model.load_state_dict(params)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    return TaskState(model, optimizer, mesh=mesh,
                     forward=data_parallel(model, mesh))


def bert_step(state: TaskState, batch: Batch) -> tuple:
    return classify_step(state, _on(state, batch['tokens']).long(),
                         _on(state, batch['labels']))


def cosine_decay(steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(1, steps)`` at update count t."""
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))


def resnet_setup(config: ResNetConfig, lr: float, momentum: float,
                 steps: int, seed: int = 0, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 mesh: Optional[mesh_lib.Mesh] = None) -> TaskState:
    """The example's state: the ResNet with f32 master weights (random
    from `seed`, or ``params`` with the running statistics; the same on
    every rank of `mesh`) and Nesterov SGD under the cosine decay over
    `steps`."""
    device = (resolve_device(device) if mesh is None
              else mesh_lib.rank_device(mesh))
    model = ResNet(config, device=device, param_dtype=torch.float32)
    if params is None:
        params = init_params(config, torch.Generator(
            device=device).manual_seed(seed))
    model.load_state_dict(params)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr,
                                momentum=momentum, nesterov=True)
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                 cosine_decay(steps))
    return TaskState(model, optimizer, schedule, mesh,
                     data_parallel(model, mesh))


def resnet_step(state: TaskState, batch: Batch) -> tuple:
    return classify_step(state, _on(state, batch['images']),
                         _on(state, batch['labels']), train=True)


# ----------------------------------------------------------- the loops


def _local_batch(mesh: Optional[mesh_lib.Mesh], batch_size: int):
    """(this rank, its rows of the global batch), with the examples'
    refusal of a batch that does not split."""
    n = 1 if mesh is None else mesh.size('data')
    if batch_size % n:
        raise SystemExit(f'--batch-size {batch_size} must divide '
                         f'across {n} processes')
    return (0 if mesh is None else mesh.coord('data')), batch_size // n


def _loop(state: TaskState, step: Callable, data: Iterator[Batch],
          steps: int, log: Callable[[str], None]) -> Dict[str, Any]:
    """`steps` steps, the loss and accuracy read (a sync) every 10th and at
    the last, printed as the examples print them; the wall time from the
    first step on, as theirs."""
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss, acc = step(state, next(data))
        if i % 10 == 0 or i == steps - 1:
            history.append((i, float(loss), float(acc)))
            log(f'step {i}: loss {history[-1][1]:.4f} '
                f'acc {history[-1][2]:.3f}')
    return {'history': history, 'first_loss': history[0][1],
            'final_acc': history[-1][2],
            'seconds': time.perf_counter() - t0, 'state': state}


def finetune_bert(model: str = 'bert-base', dataset: str = 'synthetic',
                  steps: int = 200, batch_size: int = 32,
                  seq_len: int = 128, lr: float = 2e-5, seed: int = 0,
                  device=None, data: Optional[Iterator[Batch]] = None,
                  log: Callable[[str], None] = print) -> Dict[str, Any]:
    """``examples/finetune_bert.py``'s run on one card (`device` None) or
    the CPU, data-parallel over the process group when there is one:
    returns the logged (step, loss, accuracy) history, ``first_loss``,
    ``final_acc``, ``seconds``, ``sequences_per_s`` and the final
    ``state``.  `data` replaces the dataset's batches (this rank's
    rows)."""
    mesh = data_mesh(device)
    rank, local_bs = _local_batch(mesh, batch_size)
    cfg = get_model_config(model)
    state = bert_setup(cfg, lr, seed, device, mesh=mesh)
    if data is None:
        data = (synthetic_bert_batches(
            np.random.default_rng(seed * 1000 + rank), cfg.vocab_size,
            local_bs, seq_len, cfg.num_classes) if dataset == 'synthetic'
            else imdb_batches(local_bs, seq_len))
    out = _loop(state, bert_step, data, steps, log)
    out['sequences_per_s'] = steps * batch_size / out['seconds']
    log(f'done: {out["sequences_per_s"]:.1f} sequences/s, final acc '
        f'{out["final_acc"]:.3f} (first loss {out["first_loss"]:.4f})')
    return out


def train_resnet(model: str = 'resnet50', steps: int = 200,
                 batch_size: int = 256, image_size: int = 32,
                 num_classes: int = 10, lr: float = 0.1,
                 momentum: float = 0.9, data_dir: Optional[str] = None,
                 seed: int = 0, device=None,
                 data: Optional[Iterator[Batch]] = None,
                 log: Callable[[str], None] = print) -> Dict[str, Any]:
    """``examples/train_resnet.py``'s run on one card (`device` None) or
    the CPU, data-parallel over the process group when there is one: as
    ``finetune_bert``, with ``images_per_s``."""
    mesh = data_mesh(device)
    rank, local_bs = _local_batch(mesh, batch_size)
    cfg = dataclasses.replace(get_model_config(model),
                              num_classes=num_classes)
    state = resnet_setup(cfg, lr, momentum, steps, seed, device, mesh=mesh)
    if data is None:
        data = (cifar_batches(data_dir, local_bs, rank) if data_dir else
                synthetic_resnet_batches(seed, rank, local_bs, image_size,
                                         num_classes))
    out = _loop(state, resnet_step, data, steps, log)
    out['images_per_s'] = steps * batch_size / out['seconds']
    log(f'done: {out["images_per_s"]:.1f} images/s, final acc '
        f'{out["final_acc"]:.3f}')
    return out
