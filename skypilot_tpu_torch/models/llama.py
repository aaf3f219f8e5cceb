"""Llama-family decoder (Llama 2/3, Qwen2, Mistral, Gemma geometry):
RMSNorm, RoPE, GQA, gated MLP -- the PyTorch twin of
``skypilot_tpu/models/llama.py``.

Numerics follow the JAX module: compute in ``config.dtype`` with f32
RMSNorm statistics, f32 RoPE angles and f32 logits.  Norm scales, the
embedding table and ``lm_head`` are stored in f32.  Projection weights
and biases are stored in ``param_dtype`` (the counterpart of flax's
``param_dtype``) and cast to ``config.dtype`` at every use, as the flax
``DenseGeneral(dtype=cfg.dtype)`` does; ``param_dtype`` defaults to
``config.dtype``, which stores them as serving uses them, and the trainer
passes ``torch.float32`` for f32 master weights.

The no-cache forward attends through
``ops.ring_attention.sequence_parallel_attention`` -- ``ops.flash_attention``
(the Hopper kernels on a CUDA tensor) unless the active mesh has a 'seq'
axis, where ring attention spans the sequence shards, as the JAX module
does -- and, with grad enabled, checkpoints each
decoder layer by ``config.remat_policy``; the cached forward writes K/V
in place into a per-layer ``[B, Hkv, M, D]`` cache and attends with
``decode_attention``, as the JAX serving path does; the block-paged
forward (``paged_tables``) scatters them into a per-layer
``[num_blocks, Hkv, block_size, D]`` pool and attends over the gathered
blocks (``paged_write_kv_and_attend``).

An fp8 (e4m3) cache takes its rows through ``cast_rows``, which gives the
bytes the JAX package's cast gives on every device (NaN past the format's
range, where torch's own cast saturates on the CPU), and every move of cache rows -- the writes'
scatters, the paged gather, the engine's block copies, spills and wire
rows -- runs on the rows' uint8 view (``as_bytes``): only the cast and
``decode_attention``'s f32 read see the fp8 dtype.

With ``weight_dtype='int8'`` every decoder projection is a ``QuantLinear``
(the counterpart of the JAX module's ``QuantDenseGeneral``): an int8
weight with an f32 scale per output channel, dequantized inside the
product in the compute dtype.  ``models.quantize`` converts float weights;
``models.convert.iter_params`` draws random int8 ones.

With ``lora_rank`` > 0 each projection named in ``lora_targets`` gets a
sibling ``<name>_lora`` adapter (``train.lora.LoRAAdapter``, f32
parameters) whose delta is added to the projection's output in the
compute dtype; ``lora_num_adapters`` > 0 stacks that many per target and
every forward path takes ``adapter_ids [B]`` (multi-LoRA serving).

Built from a ``RankConfig`` with ``tensor_parallel`` = N > 1 the model is
one rank's share of a tensor-parallel split (serving, ``infer.engine``
over a 'tensor' mesh): the config keeps the full widths and each module
builds its own slice by
the rules table (``parallel.mesh.split``): num_heads / N q heads and
num_kv_heads / N kv heads (so the cache and the attention kernel follow
the local head counts), intermediate_size / N MLP columns, hidden / N
embedding columns and vocab / N head rows (a width N does not divide is
whole).  The attention and MLP outputs are summed over the active mesh's
'tensor' group, the looked-up embedding rows and the head's logits are
gathered whole, and a tied head sums its hidden slices' partial logits.
"""
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.ops.ring_attention import \
    sequence_parallel_attention
from skypilot_tpu_torch.parallel.mesh import (all_gather_cat, gathered,
                                              recompute_in_active_mesh,
                                              reduce_from_group, split,
                                              tensor_group)

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    # Llama-3.1 RoPE frequency scaling (HF rope_type='llama3'); enabled
    # when factor and original_max_len are both set.
    rope_scaling_factor: Optional[float] = None
    rope_scaling_low_freq: float = 1.0
    rope_scaling_high_freq: float = 4.0
    rope_scaling_original_max_len: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_bias: bool = False
    # Banded causal attention: query i attends keys j with
    # 0 <= i-j < sliding_window.  None = full causal.
    sliding_window: Optional[int] = None
    hidden_act: str = 'silu'         # 'silu' | 'gelu' | 'gelu_tanh'
    # Gemma: embeddings scaled by sqrt(hidden_size), cast to dtype first.
    scale_embeddings: bool = False
    # HF-checkpoint norm convention (consumed by weight importers only).
    hf_norm_zero_centered: bool = False
    dtype: torch.dtype = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ('q_proj', 'k_proj', 'v_proj',
                                     'o_proj')
    lora_num_adapters: int = 0
    # Activation checkpointing of each decoder layer in the no-cache
    # forward with grad enabled: 'full' | 'dots' | 'none'.
    remat_policy: str = 'full'
    weight_dtype: str = 'bf16'

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_scaling_(self) -> Optional[Tuple[float, float, float, int]]:
        """(factor, low_freq, high_freq, original_max_len) or None."""
        if (self.rope_scaling_factor is None or
                self.rope_scaling_original_max_len is None):
            return None
        return (self.rope_scaling_factor, self.rope_scaling_low_freq,
                self.rope_scaling_high_freq,
                self.rope_scaling_original_max_len)

    @property
    def num_params(self) -> int:
        """Approximate parameter count (for MFU math)."""
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        d = self.head_dim_
        attn = h * d * (self.num_heads * 2 + self.num_kv_heads * 2)
        mlp = 3 * h * self.intermediate_size
        norms = 2 * h
        embed = v * h * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp + norms) + embed + h

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token: 6*N + attention term (12*L*d_head*H*S)."""
        attn_flops = 12 * self.num_layers * self.num_heads * \
            self.head_dim_ * seq_len
        return 6 * self.num_params + attn_flops


@dataclasses.dataclass(frozen=True)
class RankConfig(LlamaConfig):
    """A llama config as one rank of a tensor-parallel split of degree
    ``tensor_parallel`` (see the module docstring): the full config's
    fields, which stay the JAX config's, and the degree."""
    tensor_parallel: int = 1


def tensor_degree(config) -> int:
    """The tensor-parallel degree a config's model is one rank of (1 for
    a whole model)."""
    return getattr(config, 'tensor_parallel', 1)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


class RMSNorm(nn.Module):
    """Weight stored as (w - 1), f32, so zero-init is the identity."""

    def __init__(self, size: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.zeros(size, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def rope_frequencies(head_dim: int, theta: float,
                     scaling: Optional[Tuple[float, float, float, int]] = None,
                     device=None) -> torch.Tensor:
    """Inverse RoPE frequencies [head_dim//2] in f32, with optional
    Llama-3.1 scaling (low frequencies slowed by `factor`, high ones
    kept, a smooth ramp between)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    if scaling is None:
        return freqs
    factor, low_f, high_f, orig_len = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wavelen = orig_len / low_f
    high_wavelen = orig_len / high_f
    smooth = (orig_len / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
    scaled = torch.where(wavelen > low_wavelen, freqs / factor, freqs)
    is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[Tuple[float, float, float, int]] = None
         ) -> torch.Tensor:
    """Rotary embeddings, half-split.  x: [B, H, S, D]; positions: [B, S].
    The rotation runs in f32 (bf16 x promotes against f32 cos/sin)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, scaling, x.device)
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


FP8 = torch.float8_e4m3fn
# The largest magnitude e4m3 rounds to a finite value: 448 is the largest
# finite, 480 (the next step) is the NaN encoding, and 464, halfway, rounds
# to even, which is 448.
_FP8_ROUNDS_FINITE = 464.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x in e4m3 with the JAX package's (ml_dtypes') bytes: round to
    nearest even in range, as torch's own cast does, and NaN with x's sign
    (byte 0x7F or 0xFF) for |x| > 464, +-inf and NaN, where torch's cast
    saturates to +-448 on the CPU (and gives NaN on an H100): the mask
    makes every device give the same bytes."""
    out = x.to(FP8).view(torch.uint8)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    out = torch.where(x.abs() <= _FP8_ROUNDS_FINITE, out, nan)
    return out.view(FP8)


def cast_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K/V rows into the cache dtype (fp8 through ``to_fp8``)."""
    return to_fp8(x) if dtype == FP8 else x.to(dtype)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor's uint8 view, for moving its rows (index_put, gather,
    copies, stacks): the byte ops are covered on every device, some fp8
    ones are not.  Other dtypes as they are."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def write_kv_and_attend(kv_cache: Tuple[torch.Tensor, torch.Tensor],
                        k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                        positions: torch.Tensor,
                        window: Optional[int] = None):
    """Incremental-decode cache step: write the T new K/V rows of each
    sequence at its absolute positions -- in place, where the JAX package
    donates the buffers -- then attend over the whole cache.

    Positions within one call are contiguous.  As the JAX package's
    vmapped dynamic_update_slice places them, a negative start row wraps
    once (+ M) and the start is clamped to [0, M - T], so a dead
    speculative step past the cache end rewrites the last rows instead of
    indexing out of bounds."""
    k_cache, v_cache = kv_cache
    t, m = k.shape[2], k_cache.shape[2]
    start = positions[:, 0]
    start = torch.where(start < 0, start + m, start).clamp(0, m - t)
    rows = start[:, None] + torch.arange(t, device=k.device)     # [B, T]
    batch = torch.arange(k.shape[0], device=k.device)[:, None]   # [B, 1]
    # Advanced indices around the head slice: value shape [B, T, Hkv, D].
    dt = k_cache.dtype
    as_bytes(k_cache)[batch, :, rows] = as_bytes(
        cast_rows(k.transpose(1, 2), dt))
    as_bytes(v_cache)[batch, :, rows] = as_bytes(
        cast_rows(v.transpose(1, 2), dt))
    out = decode_attention(q, k_cache, v_cache, positions, window=window)
    return out, (k_cache, v_cache)


def paged_write_kv_and_attend(kv_pool: Tuple[torch.Tensor, torch.Tensor],
                              k: torch.Tensor, v: torch.Tensor,
                              q: torch.Tensor, positions: torch.Tensor,
                              tables: torch.Tensor, block_size: int,
                              window: Optional[int] = None):
    """Block-paged twin of write_kv_and_attend: the cache is one
    [num_blocks, Hkv, block_size, D] pool per layer shared by every
    sequence, and `tables` [B, NB] maps each sequence's logical block
    index to a pool block id (the engine's host-side allocator owns the
    mapping; block 0 is the dump block that absorbs writes past a
    sequence's allocated region).

    The T new K/V rows of each sequence are written in place at
    (tables[b, pos // bs], pos % bs); attention gathers the NB table
    blocks into a [B, Hkv, NB*bs, D] view whose row r IS absolute
    position r, so decode_attention's mask applies unchanged (rows of
    unallocated entries lie past every query and are masked).

    A position past the table's range clamps to the last entry, as the
    JAX package's gather does (the engine relies on it for dead lanes);
    the clamp is explicit here because torch's gather raises instead.
    Duplicate (block, offset) targets within a call carry identical rows
    (pad lanes) or land in the dump block, so the plain index_put_
    (no accumulate) is safe."""
    k_pool, v_pool = kv_pool
    b, nb = tables.shape
    idx = (positions // block_size).clamp_max(nb - 1)
    blk = torch.gather(tables, 1, idx)                          # [B, T]
    off = positions % block_size                                # [B, T]
    # Advanced indices around the head slice: value shape [B, T, Hkv, D].
    dt = k_pool.dtype
    as_bytes(k_pool)[blk, :, off] = as_bytes(cast_rows(k.transpose(1, 2), dt))
    as_bytes(v_pool)[blk, :, off] = as_bytes(cast_rows(v.transpose(1, 2), dt))

    def view(pool):
        g = as_bytes(pool)[tables].transpose(1, 2)   # [B, Hkv, NB, bs, D]
        g = g.reshape(b, g.shape[1], nb * block_size, g.shape[-1])
        return g.view(pool.dtype)

    out = decode_attention(q, view(k_pool), view(v_pool), positions,
                           window=window)
    return out, (k_pool, v_pool)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_positions: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of T new queries over a [B, Hkv, M, D] KV cache, in f32.

    q: [B, Hq, T, D]; q_positions: [B, T] absolute positions (== cache
    indices).  Cache entry j is visible to query i iff j <= position_i,
    and position_i - j < window for sliding-window models."""
    b, hq, t, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qr = q.reshape(b, hkv, group, t, d).float()
    scores = torch.einsum('bhgtd,bhmd->bhgtm', qr * scale, k_cache.float())
    cache_idx = torch.arange(m, device=q.device)
    mask = cache_idx[None, None, :] <= q_positions[:, :, None]   # [B, T, M]
    if window is not None:
        mask &= (q_positions[:, :, None] - cache_idx[None, None]) < window
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bhgtm,bhmd->bhgtd', probs, v_cache.float())
    return out.reshape(b, hq, t, d).to(q.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are stored in ``param_dtype`` and
    cast to ``compute_dtype`` at every use (a no-op when the two match)."""

    def __init__(self, n_in: int, n_out: int, bias: bool,
                 compute_dtype: torch.dtype, param_dtype: torch.dtype,
                 device=None):
        super().__init__(n_in, n_out, bias=bias, dtype=param_dtype,
                         device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x, self.weight.to(self.compute_dtype), bias)


class QuantLinear(nn.Module):
    """A projection with int8 weight storage, per output channel: the
    counterpart of the JAX module's ``QuantDenseGeneral``.  Holds
    ``weight_q`` int8 ``[out, in]`` and ``scale`` f32 ``[out]`` (buffers:
    nothing trains them) and an optional ``bias`` in ``param_dtype``.
    The forward follows the reference's order: the product in the compute
    dtype with the weight cast from int8, then ``* scale`` in the compute
    dtype, then ``+ bias``.  In eager PyTorch the cast materialises a
    compute-dtype copy of the weight at each call; a fused dequantizing
    GEMM is speed work (ROADMAP.md)."""

    def __init__(self, n_in: int, n_out: int, bias: bool,
                 compute_dtype: torch.dtype, param_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = n_in, n_out
        self.compute_dtype = compute_dtype
        self.register_buffer('weight_q', torch.zeros(
            n_out, n_in, dtype=torch.int8, device=device))
        self.register_buffer('scale', torch.ones(
            n_out, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(n_out, dtype=param_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight_q.to(dt))
        y = y * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def _add_proj(owner: nn.Module, name: str, n_in: int, n_out: int,
              bias: bool, param_dtype: torch.dtype, device) -> None:
    """Register projection `name` on its owning module (a ``QuantLinear``
    with int8 weights) and, when `name` is a configured LoRA target, its
    sibling '<name>_lora' adapter (f32 parameters, stacked when
    ``lora_num_adapters`` > 0) -- the counterpart of the JAX module's
    ``_proj``, the single wiring point of every adapted projection."""
    cfg = owner.config
    cls = QuantLinear if cfg.weight_dtype == 'int8' else Linear
    setattr(owner, name, cls(n_in, n_out, bias, cfg.dtype, param_dtype,
                             device))
    if cfg.lora_rank and name in cfg.lora_targets:
        # Imported here: the train package imports this module.
        from skypilot_tpu_torch.train.lora import LoRAAdapter
        setattr(owner, f'{name}_lora', LoRAAdapter(
            n_in, n_out, cfg.lora_rank, cfg.lora_alpha, cfg.dtype,
            cfg.lora_num_adapters, device))


def _proj(owner: nn.Module, name: str, x: torch.Tensor,
          adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """base(x), plus the adapter's delta where `name` has one, added in
    the compute dtype.  Under the trainer's 'tensor' placement a
    row-parallel projection and its adapter return partial sums
    (DTensors): their sum is reduced once, here."""
    y = getattr(owner, name)(x)
    adapter = getattr(owner, f'{name}_lora', None)
    if adapter is None:
        return y
    return gathered(y + adapter(x, adapter_ids))


class Attention(nn.Module):

    def __init__(self, config: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        cfg = self.config = config
        d, h = cfg.head_dim_, cfg.hidden_size
        bias = cfg.attention_bias
        pd = param_dtype or cfg.dtype
        tp = tensor_degree(cfg)
        if cfg.num_kv_heads % tp:
            raise ValueError(f'num_kv_heads {cfg.num_kv_heads} not '
                             f'divisible by tensor degree {tp}')
        hq, hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        _add_proj(self, 'q_proj', h, hq * d, bias, pd, device)
        _add_proj(self, 'k_proj', h, hkv * d, bias, pd, device)
        _add_proj(self, 'v_proj', h, hkv * d, bias, pd, device)
        _add_proj(self, 'o_proj', hq * d, h, False, pd, device)

    def forward(self, x, positions, kv_cache=None, paged_tables=None,
                paged_block_size=None, adapter_ids=None):
        cfg = self.config
        b, s, _ = x.shape
        d = cfg.head_dim_

        def proj(name, inp):
            return _proj(self, name, inp, adapter_ids)

        # [B, S, H*D] -> [B, H, S, D]; under tensor parallelism the
        # column-parallel projections give this rank heads / tensor heads.
        q = proj('q_proj', x).view(b, s, -1, d).transpose(1, 2)
        k = proj('k_proj', x).view(b, s, -1, d).transpose(1, 2)
        v = proj('v_proj', x).view(b, s, -1, d).transpose(1, 2)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling_)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling_)
        new_cache = None
        if kv_cache is not None and paged_tables is not None:
            out, new_cache = paged_write_kv_and_attend(
                kv_cache, k, v, q, positions, paged_tables,
                paged_block_size, window=cfg.sliding_window)
        elif kv_cache is not None:
            out, new_cache = write_kv_and_attend(kv_cache, k, v, q, positions,
                                                 window=cfg.sliding_window)
        else:
            out = sequence_parallel_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                window=cfg.sliding_window)
        out = proj('o_proj', out.transpose(1, 2).reshape(b, s, -1))
        if tensor_degree(cfg) > 1:
            out = reduce_from_group(out, tensor_group()[0])
        if kv_cache is not None:
            return out, new_cache
        return out


class MLP(nn.Module):

    def __init__(self, config: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        cfg = self.config = config
        if cfg.hidden_act not in ('silu', 'gelu', 'gelu_tanh'):
            raise ValueError(
                f'Unknown hidden_act {cfg.hidden_act!r}; '
                "expected 'silu', 'gelu' or 'gelu_tanh'.")
        h = cfg.hidden_size
        i = split(cfg.intermediate_size, tensor_degree(cfg))
        pd = param_dtype or cfg.dtype
        _add_proj(self, 'gate_proj', h, i, False, pd, device)
        _add_proj(self, 'up_proj', h, i, False, pd, device)
        _add_proj(self, 'down_proj', i, h, False, pd, device)

    def forward(self, x, adapter_ids=None):
        gate = _proj(self, 'gate_proj', x, adapter_ids)
        up = _proj(self, 'up_proj', x, adapter_ids)
        act = self.config.hidden_act
        if act == 'gelu_tanh':          # Gemma GeGLU
            h = F.gelu(gate, approximate='tanh') * up
        elif act == 'gelu':             # exact (erf) GELU
            h = F.gelu(gate) * up
        else:
            h = F.silu(gate) * up
        out = _proj(self, 'down_proj', h, adapter_ids)
        if self.down_proj.in_features < self.config.intermediate_size:
            out = reduce_from_group(out, tensor_group()[0])
        return out


class DecoderLayer(nn.Module):

    def __init__(self, config: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        self.input_norm = RMSNorm(config.hidden_size, config.norm_eps, device)
        self.attn = Attention(config, device, param_dtype)
        self.post_attn_norm = RMSNorm(config.hidden_size, config.norm_eps,
                                      device)
        self.mlp = MLP(config, device, param_dtype)

    def forward(self, x, positions, kv_cache=None, paged_tables=None,
                paged_block_size=None, adapter_ids=None):
        attn_in = self.input_norm(x)
        if kv_cache is not None:
            attn_out, new_cache = self.attn(attn_in, positions, kv_cache,
                                            paged_tables, paged_block_size,
                                            adapter_ids)
        else:
            attn_out = self.attn(attn_in, positions,
                                 adapter_ids=adapter_ids)
            new_cache = None
        h = x + attn_out
        out = h + self.mlp(self.post_attn_norm(h), adapter_ids)
        if kv_cache is not None:
            return out, new_cache
        return out


# The 'dots' remat policy, the counterpart of JAX's
# dots_with_no_batch_dims_saveable: keep the outputs of the plain matrix
# products of a layer, recompute everything else.
_save_matmuls = functools.partial(
    torch_checkpoint.create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _remat(policy: str) -> Optional[Callable]:
    """How the no-cache forward calls each decoder layer under grad:
    None for a plain call, else a checkpointing wrapper (the counterpart
    of the JAX module's nn.remat).  Raises on an unknown policy."""
    if policy == 'none':
        return None
    if policy not in ('full', 'dots'):
        raise ValueError(f'Unknown remat_policy {policy!r}; '
                         "expected 'full', 'dots', or 'none'.")
    if not torch.is_grad_enabled():
        return None
    context_fn = recompute_in_active_mesh(
        _save_matmuls if policy == 'dots' else None)
    kwargs = {} if context_fn is None else {'context_fn': context_fn}
    return functools.partial(torch_checkpoint.checkpoint,
                             use_reentrant=False, **kwargs)


class Llama(nn.Module):
    """Decoder-only LM.  forward(tokens [B, S]) -> logits [B, S, V] f32.

    Parameter names mirror the flax tree (``layers.{i}`` for
    ``layer_{i}``); ``models.convert`` maps one onto the other.
    ``param_dtype`` stores the projection weights (default
    ``config.dtype``; the trainer passes ``torch.float32``)."""

    def __init__(self, config: LlamaConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if config.weight_dtype not in ('bf16', 'int8'):
            raise ValueError(f"weight_dtype must be 'bf16' or 'int8'; got "
                             f'{config.weight_dtype!r}')
        self.config = config
        h = config.hidden_size
        _embed_and_head(self, config, device)
        self.layers = nn.ModuleList(
            DecoderLayer(config, device, param_dtype)
            for _ in range(config.num_layers))
        self.final_norm = RMSNorm(h, config.norm_eps, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, hidden_only: bool = False,
                paged_tables: Optional[torch.Tensor] = None,
                paged_block_size: Optional[int] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                head: Optional[Callable] = None,
                layer_stack: Optional[Callable] = None):
        """Scoring: forward(tokens) -> logits.  hidden_only=True returns the
        final-norm hidden states [B, S, H] instead.

        Training under a mesh: ``head(hidden, proj)`` replaces the logits
        with its value on the final-norm hidden states and the [H, V]
        output projection (the trainer's chunked loss), so the head's
        parameters are read inside the forward, where FSDP2 has them
        gathered; ``layer_stack(x, positions)`` replaces the loop over
        the decoder layers (the pipeline's).  A tensor-sharded embedding
        or head is gathered over the 'tensor' group where it is used.

        Multi-LoRA (``lora_num_adapters`` > 0): adapter_ids [B] selects one
        stacked adapter per sequence (< 0: the base model) on every path;
        with the ids given the no-cache forward calls its layers without
        checkpointing, as the JAX module's multi-LoRA scoring does.

        Incremental inference: forward(tokens, positions, cache) ->
        (logits, cache), where `cache` is the per-layer list of (k, v)
        [B, Hkv, M, D] pairs from init_cache, updated in place, and
        `positions` [B, T] are the absolute cache positions of `tokens`.

        Block-paged inference: also pass paged_tables [B, NB] (pool block
        ids per sequence, int64) and paged_block_size; `cache` is then the
        per-layer [(k_pool, v_pool)] block pools from init_paged_cache.

        Token ids map as the JAX module's gather does: a negative id wraps
        once (id + V) and the result clamps to [0, V - 1], so an id out of
        range costs its own request its answer, never the batch's.
        """
        cfg = self.config
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        vocab = cfg.vocab_size
        tokens = torch.where(tokens < 0, tokens + vocab,
                             tokens).clamp(0, vocab - 1)
        x = embed(self, tokens).to(cfg.dtype)
        if cfg.scale_embeddings:
            # Normalizer cast to dtype BEFORE the multiply, as HF Gemma.
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype,
                                 device=x.device)
        new_cache = []
        remat = None if cache is not None else _remat(cfg.remat_policy)
        for i, layer in enumerate(self.layers):
            if layer_stack is not None:
                x = layer_stack(x, positions)
                break
            if cache is not None:
                x, layer_cache = layer(x, positions, cache[i],
                                       paged_tables, paged_block_size,
                                       adapter_ids)
                new_cache.append(layer_cache)
            elif adapter_ids is not None:
                x = layer(x, positions, adapter_ids=adapter_ids)
            elif remat is not None:
                x = remat(layer, x, positions)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        if head is not None:
            return head(x, self.output_projection())
        if hidden_only:
            return x
        logits = head_logits(self, x)
        if cache is not None:
            return logits, new_cache
        return logits

    def output_projection(self) -> torch.Tensor:
        """The [H, V] head matrix: ``lm_head``'s, or the tied embedding
        transposed, gathered if it is tensor-sharded."""
        if self.lm_head is not None:
            return gathered(self.lm_head.weight).T
        return gathered(self.embedding).T


def _embed_and_head(model: nn.Module, config, device) -> None:
    """The f32 embedding table [V, H] and, untied, ``lm_head`` [V, H] of
    a decoder LM (llama, Mixtral); a rank's slices of them under
    ``tensor_parallel`` (hidden columns of the table, vocab rows of the
    head, by the rules table)."""
    h, v, tp = config.hidden_size, config.vocab_size, tensor_degree(config)
    model.embedding = nn.Parameter(torch.empty(
        v, split(h, tp), dtype=torch.float32, device=device))
    model.lm_head = (None if config.tie_embeddings else nn.Linear(
        h, split(v, tp), bias=False, dtype=torch.float32, device=device))


def embed(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """The f32 embedding rows of in-range `tokens` (``embed_rows``)."""
    return embed_rows(model.embedding, tokens, model.config.hidden_size)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               hidden: int) -> torch.Tensor:
    """`table`'s rows of in-range `tokens`: a hidden-sharded table's rows
    gathered whole over the 'tensor' group."""
    table = gathered(table)
    x = table[tokens]
    if table.shape[1] < hidden:
        x = all_gather_cat(x, tensor_group()[0], -1)
    return x


def head_logits(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., V] of final-norm hidden states `x`.  A rank of a
    tensor-parallel split gathers its vocab-sharded head's logits whole,
    or, with a tied hidden-sharded table, sums its hidden slice's partial
    logits over the group."""
    cfg = model.config
    if model.lm_head is not None:
        w = gathered(model.lm_head.weight)
        logits = x.float() @ w.float().T
        if w.shape[0] < cfg.vocab_size:
            logits = all_gather_cat(logits, tensor_group()[0], -1)
        return logits
    return tied_logits(model.embedding, x, cfg.hidden_size)


def tied_logits(table: torch.Tensor, x: torch.Tensor,
                hidden: int) -> torch.Tensor:
    """f32 logits of hidden states `x` through the tied [V, H] `table`; a
    rank's hidden-sharded table sums its hidden slice's partial logits
    over the 'tensor' group."""
    table = gathered(table)
    width = table.shape[1]
    if width == hidden:
        return x.float() @ table.float().T
    group, rank = tensor_group()
    part = x[..., rank * width:(rank + 1) * width].float() @ table.float().T
    return reduce_from_group(part, group)


def init_cache(config: LlamaConfig, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """Per-layer [(k, v)] KV cache, each [B, Hkv, max_len, head_dim]
    (Hkv: the rank's kv heads under ``tensor_parallel``)."""
    hkv = config.num_kv_heads // tensor_degree(config)
    shape = (batch_size, hkv, max_len, config.head_dim_)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_layers)]


def init_paged_cache(config: LlamaConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> KVCache:
    """Per-layer [(k_pool, v_pool)] block-paged KV cache, each
    [num_blocks, Hkv, block_size, head_dim].  Block 0 is the dump block
    the engine's allocator reserves (it absorbs dead-lane and overrun
    writes); sequences map logical blocks to pool blocks through the
    tables passed to paged_write_kv_and_attend.  Hkv: the rank's kv heads
    under ``tensor_parallel``."""
    hkv = config.num_kv_heads // tensor_degree(config)
    shape = (num_blocks, hkv, block_size, config.head_dim_)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_layers)]
