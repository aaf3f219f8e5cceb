"""GPT-2 family: learned positions, pre-LN blocks, tanh-GELU MLP, full
multi-head attention, head tied to the token embedding -- the PyTorch
twin of ``skypilot_tpu/models/gpt2.py``.

Numerics follow the JAX module: the blocks compute in ``config.dtype``;
``ln_1``, ``ln_2`` and ``ln_f`` are LayerNorms computed in f32 (flax's
``LayerNorm(dtype=float32)``, its one-pass variance E[x^2] - E[x]^2
clipped at 0) whose output is cast back to the compute dtype inside the
blocks, and the logits are the f32 ``ln_f`` output times the f32 ``wte``.

``c_attn`` is one ``[3*H, H]`` linear whose output splits as the flax
kernel's ``[H, 3, heads, D]`` features do (q, k, v, then heads, then
head dims); ``c_proj`` takes the heads' outputs flattened ``[heads*D]``.
The no-cache forward attends through
``ops.ring_attention.sequence_parallel_attention`` (``ops.flash_attention``,
the Hopper kernel on a CUDA tensor, without a 'seq' mesh), as the JAX
module does; the cached forward
uses the llama module's ``write_kv_and_attend``, so the engine's
``[B, H, M, D]`` caches (``llama.init_cache``; ``num_kv_heads`` is the
head count) serve GPT-2 unchanged.  Positions index ``wpe`` as the JAX
gather does: a negative position wraps once and the result clamps into
the table, so a dead engine lane past ``max_seq_len`` reads the last row
instead of faulting the card.

Tensor parallelism slices ``c_attn`` by heads within each of q, k and v
(the JAX kernel's ``heads`` shard): the trainer reorders its rows to
``[tensor, 3, H / tensor * D]`` before a contiguous DTensor split
(``parallel.mesh.group_qkv_by_rank``), and serving hands each rank those
rows (``parallel.mesh.shard_tensor``), so either way a rank's ``c_attn``
output views as ``(3, H / tensor, D)``.  Built from a ``GPT2RankConfig``
with ``tensor_parallel`` = N > 1 the model is one rank's share
(serving): H / N heads, 4H / N MLP columns and hidden / N ``wte``
columns; the attention's and the MLP's ``c_proj`` sum their partial
products over the 'tensor' group before adding their bias, the looked-up
``wte`` rows are gathered whole and the tied head sums its hidden
slice's partial logits.
"""
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from skypilot_tpu_torch.models.llama import (KVCache, Linear, _remat,
                                             embed_rows, tensor_degree,
                                             tied_logits,
                                             write_kv_and_attend)
from skypilot_tpu_torch.ops.ring_attention import \
    sequence_parallel_attention
from skypilot_tpu_torch.parallel.mesh import (gathered, reduce_from_group,
                                              split, tensor_group)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    name: str
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    dropout: float = 0.0          # kept 0 for deterministic training
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        """Full MHA: as many K/V heads as query heads (the engine sizes
        its cache from this)."""
        return self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def num_params(self) -> int:
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        per_layer = 4 * h * h + 2 * h * self.intermediate_size + 13 * h
        return l * per_layer + v * h + self.max_seq_len * h + 2 * h

    def flops_per_token(self, seq_len: int) -> float:
        attn_flops = 12 * self.num_layers * self.num_heads * \
            self.head_dim_ * seq_len
        return 6 * self.num_params + attn_flops


@dataclasses.dataclass(frozen=True)
class GPT2RankConfig(GPT2Config):
    """A GPT-2 config as one rank of a tensor-parallel split of degree
    ``tensor_parallel`` (serving; see the module docstring)."""
    tensor_parallel: int = 1


def _row_parallel(proj: Linear, x: torch.Tensor, tp: int) -> torch.Tensor:
    """A row-parallel projection: on a rank of a split (tp > 1) its
    partial product summed over the 'tensor' group, then its bias added
    once; else the projection."""
    if tp == 1:
        return proj(x)
    dt = proj.compute_dtype
    y = reduce_from_group(F.linear(x, proj.weight.to(dt)),
                          tensor_group()[0])
    return y + proj.bias.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` over the last axis, f32 out:
    mean and E[x^2] of the f32 input, var = max(0, E[x^2] - mean^2), then
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x32 - mean) * (torch.rsqrt(var + eps) * scale) + bias


class LayerNorm(nn.Module):
    """f32 ``scale`` (init 1) and ``bias`` (init 0), as flax stores them."""

    def __init__(self, size: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class GPT2Attention(nn.Module):

    def __init__(self, config: GPT2Config, device=None, param_dtype=None):
        super().__init__()
        cfg = self.config = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        self.tp = tensor_degree(cfg)
        if cfg.num_heads % self.tp:
            raise ValueError(f'num_kv_heads {cfg.num_heads} not divisible '
                             f'by tensor degree {self.tp}')
        local = h // self.tp
        self.c_attn = Linear(h, 3 * local, True, cfg.dtype, pd, device)
        self.c_proj = Linear(local, h, True, cfg.dtype, pd, device)

    def forward(self, x, positions=None, kv_cache=None):
        cfg = self.config
        b, s, _ = x.shape
        qkv = self.c_attn(x).view(b, s, 3, -1, cfg.head_dim_)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if kv_cache is not None:
            out, new_cache = write_kv_and_attend(kv_cache, k, v, q, positions)
        else:
            out = sequence_parallel_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
            new_cache = None
        out = _row_parallel(self.c_proj,
                            out.transpose(1, 2).reshape(b, s, -1), self.tp)
        return out, new_cache


class GPT2MLP(nn.Module):

    def __init__(self, config: GPT2Config, device=None, param_dtype=None):
        super().__init__()
        cfg = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        i = split(cfg.intermediate_size, tensor_degree(cfg))
        # A width the degree does not divide is whole on every rank.
        self.tp = cfg.intermediate_size // i
        self.c_fc = Linear(h, i, True, cfg.dtype, pd, device)
        self.c_proj = Linear(i, h, True, cfg.dtype, pd, device)

    def forward(self, x):
        return _row_parallel(
            self.c_proj, F.gelu(self.c_fc(x), approximate='tanh'), self.tp)


class GPT2Block(nn.Module):

    def __init__(self, config: GPT2Config, device=None, param_dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.norm_eps
        self.ln_1 = LayerNorm(h, eps, device)
        self.attn = GPT2Attention(config, device, param_dtype)
        self.ln_2 = LayerNorm(h, eps, device)
        self.mlp = GPT2MLP(config, device, param_dtype)

    def forward(self, x, positions=None, kv_cache=None):
        dt = x.dtype
        attn_out, new_cache = self.attn(self.ln_1(x).to(dt), positions,
                                        kv_cache)
        h = x + attn_out
        out = h + self.mlp(self.ln_2(h).to(dt))
        if kv_cache is not None:
            return out, new_cache
        return out


class GPT2(nn.Module):
    """Decoder-only LM, GPT-2 architecture.  forward(tokens [B, S]) ->
    logits [B, S, V] f32 (the head tied to ``wte``).

    Parameter names mirror the flax tree (``h.{i}`` for ``h_{i}``);
    ``models.convert`` maps one onto the other.  ``param_dtype`` stores the
    projection weights and biases (default ``config.dtype``); ``wte``,
    ``wpe`` and the LayerNorms are f32."""

    def __init__(self, config: GPT2Config, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = nn.Parameter(torch.empty(
            config.vocab_size, split(h, tensor_degree(config)),
            dtype=torch.float32, device=device))
        self.wpe = nn.Parameter(torch.empty(
            config.max_seq_len, h, dtype=torch.float32, device=device))
        self.h = nn.ModuleList(GPT2Block(config, device, param_dtype)
                               for _ in range(config.num_layers))
        self.ln_f = LayerNorm(h, config.norm_eps, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, hidden_only: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                head: Optional[Callable] = None):
        """Scoring and training: forward(tokens) -> logits; hidden_only
        returns the f32 ``ln_f`` output [B, S, H]; ``head`` is the llama
        module's (the trainer's chunked loss under a mesh).  Incremental
        inference:
        forward(tokens, positions, cache) -> (logits, cache), the llama
        module's cache contract.  A sequence longer than ``max_seq_len``
        raises the JAX module's ValueError.  Token ids and positions map
        as the JAX gather does (see the module docstring).  adapter_ids
        must be None: multi-LoRA serves the llama family only."""
        cfg = self.config
        if adapter_ids is not None:
            raise TypeError('multi-LoRA serving supports the llama family; '
                            'got GPT2Config')
        if tokens.shape[1] > cfg.max_seq_len:
            raise ValueError(
                f'sequence length {tokens.shape[1]} exceeds max_seq_len '
                f'{cfg.max_seq_len}')
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = (embed_rows(self.wte, _gather_index(tokens, cfg.vocab_size),
                        cfg.hidden_size).to(cfg.dtype) +
             self.wpe[_gather_index(positions, cfg.max_seq_len)
                      ].to(cfg.dtype))
        new_cache = []
        # Every block checkpointed under grad, as the JAX module's nn.remat.
        remat = None if cache is not None else _remat('full')
        for i, block in enumerate(self.h):
            if cache is not None:
                x, layer_cache = block(x, positions, cache[i])
                new_cache.append(layer_cache)
            elif remat is not None:
                x = remat(block, x)
            else:
                x = block(x)
        x = self.ln_f(x)
        if head is not None:
            return head(x, self.output_projection())
        if hidden_only:
            return x
        logits = tied_logits(self.wte, x, cfg.hidden_size)
        if cache is not None:
            return logits, new_cache
        return logits

    def output_projection(self) -> torch.Tensor:
        """The [H, V] head matrix: the tied ``wte`` transposed."""
        return gathered(self.wte).T


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row a JAX gather of ``table[idx]`` reads from an n-row table: a
    negative index wraps once, then the result clamps to [0, n - 1]."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)

