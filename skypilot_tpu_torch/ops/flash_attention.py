"""Flash attention: the dispatcher, its plain PyTorch versions and the
wrapper of the hand-written Hopper kernel (``csrc/flash_attention_fwd.cu``).

Counterpart of ``skypilot_tpu/ops/flash_attention.py``.  The layout at
every public function is the JAX package's: q ``[B, Hq, S, D]``, k/v
``[B, Hkv, S, D]`` with ``Hq`` a multiple of ``Hkv`` (GQA).

``flash_attention`` picks the path by the device of its inputs: a CPU
tensor takes ``reference_attention``; a CUDA tensor launches the kernel
(``flash_attention_fwd``) or raises -- nothing falls back.  The backward
kernels come with the trainer; until then the CUDA path refuses inputs
that require grad.
"""
import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

# TPU tile sizes of the JAX kernel, kept for signature parity: the Hopper
# kernel's tiles are fixed in its source (64 q rows x 64 kv rows).
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512
KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30

# Launches of the forward kernel in this process (read and reset by
# chip_smoke.py to show the main path went through the kernel).
flash_fwd_launches = 0


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Ground-truth O(S^2) attention, the twin of the JAX package's
    ``reference_attention``: scores in the input dtype, softmax in f32,
    probabilities cast back to v's dtype.  window: query i sees keys j
    with 0 <= i-j < window; requires causal."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qr = q.reshape(b, hkv, group, s, d)
    scores = torch.einsum('bhgqd,bhkd->bhgqk', qr * scale, k)
    if window is not None and not causal:
        raise ValueError('window requires causal attention')
    if causal:
        scores = scores.masked_fill(~_band_mask(s, window, q.device),
                                    _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum('bhgqk,bhkd->bhgqd', probs.to(v.dtype), v)
    return out.reshape(b, hq, s, d)


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool, scale: float,
                            window: Optional[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: every product in f32, returns
    (O in q's dtype, LSE f32 [B, Hq, S]).  The backward kernels read the
    LSE."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qr = q.reshape(b, hkv, hq // hkv, s, d).float()
    scores = torch.einsum('bhgqd,bhkd->bhgqk', qr, k.float()) * scale
    if causal or window is not None:
        if not causal:
            raise ValueError('window requires causal attention')
        scores = scores.masked_fill(~_band_mask(s, window, q.device),
                                    _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum('bhgqk,bhkd->bhgqd', probs, v.float())
    return (out.reshape(b, hq, s, d).to(q.dtype),
            lse.reshape(b, hq, s))


def _band_mask(s: int, window: Optional[int],
               device: torch.device) -> torch.Tensor:
    """[S, S] bool: key j visible to query i (causal, optionally banded)."""
    idx = torch.arange(s, device=device)
    rel = idx[:, None] - idx[None, :]
    keep = rel >= 0
    if window is not None:
        keep &= rel < window
    return keep


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, window: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward kernel: returns (O in q's dtype, LSE f32
    [B, Hq, S]).  CUDA tensors only; raises on anything the kernel does
    not take."""
    global flash_fwd_launches
    _check_kernel_inputs(q, k, v)
    if window is not None and (not causal or window < 1):
        raise ValueError('window requires causal attention and must be >= 1')
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], s, d, int(causal),
            window or 0, float(scale), int(q.dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError('flash_attention_fwd launch failed: '
                           + lib.flash_attention_error_string(rc).decode())
    flash_fwd_launches += 1
    return out, lse


def _check_kernel_inputs(q, k, v) -> None:
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor (got {t.device})')
        if t.dim() != 4:
            raise ValueError(
                f'{name} must be [B, H, S, D] (got {tuple(t.shape)})')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'kernel takes bfloat16 or float32 (got {q.dtype})')
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError('q, k and v must share one dtype')
    if not (q.device == k.device == v.device):
        raise ValueError('q, k and v must be on one device')
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f'k/v shape {tuple(k.shape)} does not match q '
                         f'{tuple(q.shape)}')
    if hq % k.shape[1]:
        raise ValueError(f'num q heads {hq} must be a multiple of num kv '
                         f'heads {k.shape[1]}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'head_dim {d} not supported by the kernel '
                         f'(supported: {KERNEL_HEAD_DIMS})')
    if b * hq > 65535:
        raise ValueError(f'batch * q heads = {b * hq} exceeds the grid limit')
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise NotImplementedError(
            'the flash-attention backward kernels are not ported yet '
            '(ROADMAP.md A4, training): the CUDA path is forward-only')


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load('flash_attention_fwd')
    if lib.flash_attention_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [
            ctypes.c_float, i32, ptr]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    use_kernel: Optional[bool] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention, flash-style, with the JAX dispatcher's rules.

    Args:
      q: [batch, num_q_heads, seq, head_dim]
      k, v: [batch, num_kv_heads, seq, head_dim] (GQA when fewer kv heads)
      block_q, block_kv: the TPU kernel's tile sizes; accepted for
        signature parity and not used (the Hopper tiles are fixed).
      use_kernel: None picks by device (CUDA: kernel, CPU: reference);
        True on a CPU tensor or False on a CUDA tensor raises.
      window: sliding-window (banded causal) attention -- query i attends
        keys j with 0 <= i-j < window.  Requires causal=True.
    """
    del block_q, block_kv
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None:
        if not causal:
            raise ValueError('window requires causal attention')
        if window < 1:
            raise ValueError(f'window must be >= 1 (got {window})')
        if window >= q.shape[2]:
            window = None   # band covers everything: plain causal
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel != q.is_cuda:
        raise ValueError(
            f'use_kernel={use_kernel} with a tensor on {q.device}: the '
            'kernel takes CUDA tensors and the plain version CPU tensors')
    if not use_kernel:
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
