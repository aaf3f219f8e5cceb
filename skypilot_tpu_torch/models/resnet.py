"""ResNet family (v1.5 bottleneck) -- the PyTorch twin of
``skypilot_tpu/models/resnet.py``.

The entry takes NHWC images ``[B, H, W, 3]``, as the JAX module does, and
computes in NCHW inside.  The JAX module's convolutions, BatchNorm and
pooling are XLA, not Pallas; here they are ``F.conv2d`` (cuDNN on the
card) and plain tensor ops.  Numerics follow flax, not torch's defaults:

- SAME padding as lax computes it: for an input of n, stride s and a
  kernel of k, a total of max((ceil(n/s) - 1)*s + k - n, 0) split low
  ``total // 2``, high the rest -- asymmetric (0, 1) for the 3x3
  stride-2 ``conv2`` and the 3x3 stride-2 max pool (padded with -inf) on
  even sizes, where torch's ``padding=1`` is symmetric.  The 7x7 stem
  pads (3, 3) explicitly, as the JAX module does;
- flax BatchNorm (``BatchNorm`` below): momentum 0.9, epsilon 1e-5,
  statistics in f32, the batch variance the biased one-pass
  E[x^2] - E[x]^2 clipped at 0 for both the normalisation and the
  running update ``ra = 0.9*ra + 0.1*batch`` (``nn.BatchNorm2d`` keeps
  the unbiased variance); ``train=False`` normalises with the running
  statistics, which are buffers (flax's ``batch_stats``).  ``bn3``'s
  scale starts at zero;
- the convolutions compute in ``config.dtype`` with weights stored in
  ``param_dtype`` (default ``config.dtype``), OIHW (flax stores HWIO;
  ``models.convert`` transposes); the spatial mean runs in the compute
  dtype and the head in f32.

Module names mirror the flax tree (``conv_init``, ``bn_init``,
``stage{i}_block{j}`` with ``conv1``..``conv3``, ``bn1``..``bn3``,
``proj``, ``bn_proj``; ``head``).
"""
import dataclasses
import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from skypilot_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    stage_sizes: Sequence[int] = (3, 4, 6, 3)     # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """lax's 'SAME' padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """x [B, C, H, W] padded for a SAME window of `kernel` at `stride`."""
    (top, bottom), (left, right) = (same_padding(n, kernel, stride)
                                    for n in x.shape[2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


class Conv(nn.Module):
    """A bias-free 2-D convolution, SAME-padded as lax pads it (or
    `padding` explicitly): ``weight`` OIHW in ``param_dtype``, cast to
    ``dtype`` with the input at every call."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 padding=None, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            n_out, n_in, kernel, kernel, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding is None:
            x = _pad_same(x, self.kernel, self.stride)
            return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=self.padding)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the channels of [B, C, H, W]: f32 out; f32 ``scale`` (init
    `scale_init`) and ``bias`` (0); ``running_mean`` (0) and
    ``running_var`` (1) buffers, updated in place by a train forward.
    Under a data-parallel mesh (``parallel.mesh.mesh_context``) a train
    forward's statistics are the global batch's: the one-pass sums are
    all-reduced over the ('data', 'fsdp') ranks, differentiably."""

    def __init__(self, channels: int, scale_init: float = 1.0,
                 momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.full((channels,), scale_init,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer('running_mean',
                             torch.zeros(channels, device=device))
        self.register_buffer('running_var',
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        mesh = active_mesh()
        if train and mesh is not None and mesh.size('data', 'fsdp') > 1:
            # The global batch's statistics, as flax's under a
            # data-sharded jit: the one-pass sums over every rank.
            group = mesh.group('data', 'fsdp')
            n = x32.numel() // x32.shape[1] * mesh.size('data', 'fsdp')
            mean = all_reduce_sum(x32.sum((0, 2, 3)), group) / n
            var = (all_reduce_sum((x32 * x32).sum((0, 2, 3)), group) / n
                   - mean * mean).clamp_min(0.0)
        elif train:
            mean = x32.mean((0, 2, 3))
            var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        if train:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BottleneckBlock(nn.Module):

    def __init__(self, n_in: int, filters: int, stride: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype

        def conv(a, b, k, s=1):
            return Conv(a, b, k, s, dtype, param_dtype, device=device)

        self.conv1 = conv(n_in, filters, 1)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters, device=device)
        self.conv3 = conv(filters, 4 * filters, 1)
        self.bn3 = BatchNorm(4 * filters, scale_init=0.0, device=device)
        # The JAX block projects wherever the residual's shape differs
        # from the output's: a change of channels or a stride.
        self.proj = self.bn_proj = None
        if n_in != 4 * filters or stride != 1:
            self.proj = conv(n_in, 4 * filters, 1, stride)
            self.bn_proj = BatchNorm(4 * filters, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(self.conv1(x), train).to(dt))
        y = F.relu(self.bn2(self.conv2(y), train).to(dt))
        y = self.bn3(self.conv3(y), train)
        residual = x
        if self.proj is not None:
            residual = self.bn_proj(self.proj(x), train)
        return F.relu((y + residual).to(dt))


class ResNet(nn.Module):
    """images [B, H, W, 3] -> logits [B, num_classes] (f32).  With
    ``train=True`` each BatchNorm normalises with the batch statistics
    and updates its running ones (the JAX module's mutable
    ``batch_stats``)."""

    def __init__(self, config: ResNetConfig, device=None,
                 param_dtype=None):
        super().__init__()
        cfg = self.config = config
        pd = param_dtype or cfg.dtype
        self.conv_init = Conv(3, cfg.width, 7, 2, cfg.dtype, pd,
                              padding=3, device=device)
        self.bn_init = BatchNorm(cfg.width, device=device)
        self.block_names = []
        n_in = cfg.width
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                filters = cfg.width * 2 ** i
                name = f'stage{i}_block{j}'
                self.add_module(name, BottleneckBlock(
                    n_in, filters, 2 if i > 0 and j == 0 else 1, cfg.dtype,
                    pd, device))
                self.block_names.append(name)
                n_in = 4 * filters
        self.head = nn.Linear(n_in, cfg.num_classes, dtype=torch.float32,
                              device=device)

    def forward(self, images: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        cfg = self.config
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), train).to(cfg.dtype))
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(x.mean((2, 3)).float())
