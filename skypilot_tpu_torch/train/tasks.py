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
from the same seed).  The JAX examples shard the batch over a
data-parallel mesh across processes; that is ROADMAP.md A9 here, and more
than one process raises.
"""
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.nn import functional as F

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.bert import (BertConfig,
                                            BertForSequenceClassification)
from skypilot_tpu_torch.models.convert import init_params
from skypilot_tpu_torch.models.registry import get_model_config
from skypilot_tpu_torch.models.resnet import ResNet, ResNetConfig

Batch = Dict[str, Any]


def check_single_process() -> None:
    """Raise if the environment starts more than one process (torchrun's
    WORLD_SIZE, or the framework's multi-host SKYTPU_NUM_PROCESSES): the
    examples' data-parallel mesh is not ported."""
    procs = max(int(os.environ.get('WORLD_SIZE', '1')),
                int(os.environ.get('SKYTPU_NUM_PROCESSES', '1')))
    if procs > 1:
        raise NotImplementedError(
            f'{procs} processes: data-parallel training over processes is '
            'not ported yet (ROADMAP.md A9, multi-GPU)')


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
    """A task loop's model, optimizer and (ResNet) LR schedule; a step
    updates them in place."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LambdaLR] = None


def _on(state: TaskState, x) -> torch.Tensor:
    dev = next(state.model.parameters()).device
    return torch.as_tensor(x).to(dev, non_blocking=True)


def classify_step(state: TaskState, inputs: torch.Tensor,
                  labels: torch.Tensor, **forward_kw) -> tuple:
    """One update: mean softmax cross-entropy of the model's f32 logits on
    integer labels, backward, the optimizer (and schedule) step.  Returns
    (loss, accuracy) as device scalars, before the update."""
    logits = state.model(inputs, **forward_kw)
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    if state.schedule is not None:
        state.schedule.step()
    return loss.detach(), acc


def bert_setup(config: BertConfig, lr: float, seed: int = 0, device=None,
               params: Optional[Dict[str, torch.Tensor]] = None
               ) -> TaskState:
    """The example's state: the classifier with f32 master weights (random
    from `seed`, or ``params``) and AdamW(lr, weight decay 0.01)."""
    device = resolve_device(device)
    model = BertForSequenceClassification(config, device=device,
                                          param_dtype=torch.float32)
    if params is None:
        params = init_params(config, torch.Generator(
            device=device).manual_seed(seed), head='classify')
    model.load_state_dict(params)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    return TaskState(model, optimizer)


def bert_step(state: TaskState, batch: Batch) -> tuple:
    return classify_step(state, _on(state, batch['tokens']).long(),
                         _on(state, batch['labels']))


def cosine_decay(steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(1, steps)`` at update count t."""
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))


def resnet_setup(config: ResNetConfig, lr: float, momentum: float,
                 steps: int, seed: int = 0, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> TaskState:
    """The example's state: the ResNet with f32 master weights (random
    from `seed`, or ``params`` with the running statistics) and Nesterov
    SGD under the cosine decay over `steps`."""
    device = resolve_device(device)
    model = ResNet(config, device=device, param_dtype=torch.float32)
    if params is None:
        params = init_params(config, torch.Generator(
            device=device).manual_seed(seed))
    model.load_state_dict(params)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr,
                                momentum=momentum, nesterov=True)
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                 cosine_decay(steps))
    return TaskState(model, optimizer, schedule)


def resnet_step(state: TaskState, batch: Batch) -> tuple:
    return classify_step(state, _on(state, batch['images']),
                         _on(state, batch['labels']), train=True)


# ----------------------------------------------------------- the loops


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
    the CPU: returns the logged (step, loss, accuracy) history,
    ``first_loss``, ``final_acc``, ``seconds``, ``sequences_per_s`` and the
    final ``state``.  `data` replaces the dataset's batches."""
    check_single_process()
    cfg = get_model_config(model)
    state = bert_setup(cfg, lr, seed, device)
    if data is None:
        data = (synthetic_bert_batches(
            np.random.default_rng(seed * 1000), cfg.vocab_size, batch_size,
            seq_len, cfg.num_classes) if dataset == 'synthetic'
            else imdb_batches(batch_size, seq_len))
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
    the CPU: as ``finetune_bert``, with ``images_per_s``."""
    check_single_process()
    cfg = dataclasses.replace(get_model_config(model),
                              num_classes=num_classes)
    state = resnet_setup(cfg, lr, momentum, steps, seed, device)
    if data is None:
        data = (cifar_batches(data_dir, batch_size) if data_dir else
                synthetic_resnet_batches(seed, 0, batch_size, image_size,
                                         num_classes))
    out = _loop(state, resnet_step, data, steps, log)
    out['images_per_s'] = steps * batch_size / out['seconds']
    log(f'done: {out["images_per_s"]:.1f} images/s, final acc '
        f'{out["final_acc"]:.3f}')
    return out
