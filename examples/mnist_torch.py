"""Minimal MNIST-style training on the port's stack -- the PyTorch twin of
examples/mnist_jax.py, the 'hello world' recipe.

The same small convnet on the same synthetic 28x28 batches (numpy's
RandomState stream of the reference, so both scripts see the same
images), trained with Adam; the printed lines are the reference's.
Data-parallel over the local ranks: launched with torchrun, each rank
takes its share of every global batch and the gradients are averaged
across ranks (DistributedDataParallel); a plain ``python`` run is one
rank on one card.

Examples:
  python examples/mnist_torch.py --steps 200
  torchrun --nproc-per-node 2 examples/mnist_torch.py --device cpu --steps 4
"""
import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import distributed as dist
from torch import nn


class ConvNet(nn.Module):
    """flax's ConvNet of the reference: 3x3 'SAME' convolutions, 2x2 average
    pooling, two dense layers; the features flattened in NHWC order, as
    flax flattens them."""

    def __init__(self, hidden: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(1, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, hidden * 2, 3, padding=1)
        self.dense1 = nn.Linear(14 * 14 * hidden * 2, 128)
        self.dense2 = nn.Linear(128, 10)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: images [B, 28, 28, 1] (NHWC, the reference's layout)."""
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = F.relu(self.conv2(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense2(F.relu(self.dense1(x)))


def lecun_normal_(w: torch.Tensor) -> None:
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (its scale corrected for the cut)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def synthetic_batches(batch_size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    while True:
        x = rng.rand(batch_size, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, size=(batch_size,))
        yield x, y


def make_step(model: nn.Module, opt: torch.optim.Optimizer):
    """One Adam step on a batch; returns the mean cross-entropy (a device
    scalar)."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = F.cross_entropy(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=512)
    parser.add_argument('--hidden', type=int, default=32)
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA cards (raises without '
                             'one); cpu runs the ranks over gloo')
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    device = mesh_lib.ensure_process_group(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if args.batch_size % world:
        raise ValueError(f'--batch-size {args.batch_size} not divisible by '
                         f'the {world} ranks')
    torch.manual_seed(0)            # every rank starts from one init
    model = ConvNet(hidden=args.hidden).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    if world > 1:
        model = nn.parallel.DistributedDataParallel(model)
    step = make_step(model, opt)
    share = args.batch_size // world
    data = synthetic_batches(args.batch_size)
    t0 = None
    for i in range(args.steps):
        x, y = next(data)
        x = torch.from_numpy(x[rank * share:(rank + 1) * share]).to(device)
        y = torch.from_numpy(y[rank * share:(rank + 1) * share]).to(device)
        loss = step(x, y)
        if world > 1:               # the global batch's mean
            dist.all_reduce(loss)
            loss = loss / world
        if i == 0:
            float(loss)             # sync: the first step is warm-up
            t0 = time.time()
        if (i + 1) % 50 == 0 or i == args.steps - 1:
            if rank == 0:
                print(f'step {i + 1}: loss {float(loss):.4f}')
    float(loss)
    elapsed = time.time() - t0
    rate = args.batch_size * max(args.steps - 1, 1) / max(elapsed, 1e-9)
    if rank == 0:
        print(f'throughput: {rate:,.0f} images/s on {world} device(s)')
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
