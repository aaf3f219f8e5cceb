"""Flash attention: the dispatcher, its plain PyTorch versions, the
wrappers of the hand-written Hopper kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd_dq.cu``, ``csrc/flash_attention_bwd_dkv.cu``)
and the autograd Function that joins them.

Counterpart of ``skypilot_tpu/ops/flash_attention.py``.  The layout at
every public function is the JAX package's: q ``[B, Hq, S, D]``, k/v
``[B, Hkv, S, D]`` with ``Hq`` a multiple of ``Hkv`` (GQA).

``flash_attention`` picks the path by the device of its inputs: a CPU
tensor takes ``reference_attention`` (differentiated by autograd, as the
JAX dispatcher does off the TPU); a CUDA tensor goes through
``FlashAttentionFunction``, whose forward and backward launch the kernels
or raise -- nothing falls back.
"""
import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

# TPU tile sizes of the JAX kernel, kept for signature parity: the Hopper
# kernels' tiles are fixed in their sources (bf16 up to head_dim 128: the
# forward and dQ 128 q rows x 128 kv rows, dK/dV 128 kv rows x 64 q rows;
# above it: the forward 128 q x 64 kv, dQ 64 x 64, dK/dV 64 x 64).
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512
# The kernels take every head dim d from 1 to MAX_HEAD_DIM: each is built
# at the tile widths KERNEL_TILE_DIMS and launched at the smallest that
# holds d, whose columns past d are zeros.  Above 256 is ROADMAP.md B2.
KERNEL_TILE_DIMS = (64, 128, 256)
MAX_HEAD_DIM = 256
# bf16 rows are read by TMA, whose row stride is a multiple of 16 bytes:
# a bf16 head dim that is not a multiple of this is zero-padded to one
# around the launch (the f32 paths read without TMA and take any d).
BF16_ROW_MULTIPLE = 8
_NEG_INF = -1e30

# Launches of each kernel in this process (read and reset by
# chip_smoke.py to show the main path went through the kernels).
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


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


def attention_fwd_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, window: Optional[int],
                        ref_out: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |O_kernel - O_plain| for the forward kernel on
    the same inputs, ref_out being the plain version's O.  f32: the same
    math in another order, 1e-4.  bf16: both round O to bf16, which may
    part them by one ulp of the element, at most 2**-7 * |O|; the kernel
    also rounds P to bf16 (relative error <= 2**-9 per key) before P*V,
    which moves an element by at most 2**-9 * sum_j p_j |v_j| -- the
    attention of |V|, computed here by the plain version -- and the bound
    allows twice that."""
    if q.dtype == torch.float32:
        return torch.full_like(ref_out, 1e-4, dtype=torch.float32)
    p_abs_v, _ = attention_fwd_reference(q.float(), k.float(),
                                         v.float().abs(), causal, scale,
                                         window)
    return 2.0 ** -7 * ref_out.float().abs() + 2.0 ** -8 * p_abs_v


def attention_bwd_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool, scale: float,
                        window: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P and dS of the backward, f32 ``[B, Hkv, Hq/Hkv, S_q, S_kv]``,
    recomputed from the saved LSE as both backward kernels do:
    P = exp(s - lse) over the visible pairs, dS = P * (dO V^T - delta) *
    scale, with s = scale * Q K^T and delta = rowsum(dO * O)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scores = torch.einsum('bhgqd,bhkd->bhgqk',
                          q.reshape(b, hkv, group, s, d).float() * scale,
                          k.float())
    if causal or window is not None:
        if not causal:
            raise ValueError('window requires causal attention')
        scores = scores.masked_fill(~_band_mask(s, window, q.device),
                                    _NEG_INF)
    p = torch.exp(scores - lse.reshape(b, hkv, group, s, 1))
    dp = torch.einsum('bhgqd,bhkd->bhgqk',
                      do.reshape(b, hkv, group, s, d).float(), v.float())
    ds = p * (dp - delta.reshape(b, hkv, group, s, 1)) * scale
    return p, ds


def attention_bwd_dq_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, do: torch.Tensor,
                               lse: torch.Tensor, delta: torch.Tensor,
                               causal: bool, scale: float,
                               window: Optional[int]) -> torch.Tensor:
    """Plain version of the dQ kernel (the twin of ``_bwd_dq_kernel``):
    dQ = dS K in f32, returned in q's dtype."""
    _, ds = attention_bwd_probs(q, k, v, do, lse, delta, causal, scale,
                                window)
    dq = torch.einsum('bhgqk,bhkd->bhgqd', ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def attention_bwd_dkv_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                causal: bool, scale: float,
                                window: Optional[int]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel (the twin of ``_bwd_dkv_kernel``
    and the GQA fold after it): dV = P^T dO and dK = dS^T Q in f32 per q
    head, summed over the q heads of each kv head, cast to k's and v's
    dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    p, ds = attention_bwd_probs(q, k, v, do, lse, delta, causal, scale,
                                window)
    dv = torch.einsum('bhgqk,bhgqd->bhgkd', p,
                      do.reshape(b, hkv, group, s, d).float())
    dk = torch.einsum('bhgqk,bhgqd->bhgkd', ds,
                      q.reshape(b, hkv, group, s, d).float())
    return dk.sum(2).to(k.dtype), dv.sum(2).to(v.dtype)


def attention_bwd_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool, scale: float,
                        window: Optional[int],
                        ref: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-element bounds on |kernel - plain| for (dQ, dK, dV) from the
    two backward kernels on the same inputs, ref being the plain versions'
    (dQ, dK, dV).  f32: the same math in another order, 1e-4.  bf16, three
    terms:
    (1) both sides round the output to bf16, which may part them by one
    ulp of the element, at most 2**-7 * |x|;
    (2) the kernels round the A operand of each second product to bf16
    (relative error <= 2**-9 per entry): dS before dQ = dS K and
    dK = dS^T Q, P before dV = P^T dO.  That moves an element by at most
    2**-9 times |dS| |K|, |dS|^T |Q| or P^T |dO|, and the bound allows
    twice that;
    (3) dS = P (dP - delta) * scale can cancel (a query that sees one key
    has dP = delta up to round-off), so the f32 round-off of dP and delta
    is not relative to dS: each sums D products on each side, with an
    error of at most D * 2**-23 of its sum of magnitudes M = |dO| |V|^T
    (plus P M for delta) per side, 2**-22 * D for both.  dQ and dK carry
    it through |K| and |Q| as they carry dS.
    S and P differ by f32 round-off relative to themselves, far inside
    (2)."""
    if q.dtype == torch.float32:
        return tuple(torch.full_like(r, 1e-4, dtype=torch.float32)
                     for r in ref)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    grouped = (b, hkv, hq // hkv, s, d)
    qa = q.reshape(grouped).float().abs()
    doa = do.reshape(grouped).float().abs()
    ka, va = k.float().abs(), v.float().abs()
    p, ds = attention_bwd_probs(q, k, v, do, lse, delta, causal, scale,
                                window)
    ds.abs_()
    m = torch.einsum('bhgqd,bhkd->bhgqk', doa, va)        # |dO| |V|^T
    m += (p * m).sum(-1, keepdim=True)                    # + delta's
    m.mul_(p).mul_(scale * d * 2.0 ** -22)                # (3) in dS
    ds.mul_(2.0 ** -8).add_(m)                            # (2) + (3)
    terms = (torch.einsum('bhgqk,bhkd->bhgqd', ds, ka).reshape(q.shape),
             torch.einsum('bhgqk,bhgqd->bhkd', ds, qa),
             2.0 ** -8 * torch.einsum('bhgqk,bhgqd->bhkd', p, doa))
    return tuple(2.0 ** -7 * r.float().abs() + t
                 for r, t in zip(ref, terms))


def _band_mask(s: int, window: Optional[int],
               device: torch.device) -> torch.Tensor:
    """[S, S] bool: key j visible to query i (causal, optionally banded)."""
    idx = torch.arange(s, device=device)
    rel = idx[:, None] - idx[None, :]
    keep = rel >= 0
    if window is not None:
        keep &= rel < window
    return keep


def kernel_tile_dim(d: int) -> int:
    """The tile width the kernels run head dim d in."""
    return next(t for t in KERNEL_TILE_DIMS if d <= t)


def row_width(d: int, dtype: torch.dtype) -> int:
    """The head dim a kernel is launched at for rows of d columns: d, or
    for bf16 d rounded up to BF16_ROW_MULTIPLE (the rows TMA can read)."""
    if dtype == torch.float32:
        return d
    return -(-d // BF16_ROW_MULTIPLE) * BF16_ROW_MULTIPLE


def pad_rows(width: int, *tensors: torch.Tensor) -> tuple:
    """Each tensor with its last dim zero-padded to `width` (a new
    contiguous tensor; the tensor itself where it is that wide already)."""
    return tuple(t if t.shape[-1] == width
                 else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of t, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, window: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward kernel: returns (O in q's dtype, LSE f32
    [B, Hq, S]).  CUDA tensors only; raises on anything the kernel does
    not take.  `scale` is the caller's (d ** -0.5 of the real head dim
    in attention), also where the rows are launched padded."""
    global flash_fwd_launches
    if not scale > 0:   # the kernel takes the row max before scaling
        raise ValueError(f'the kernel needs a positive scale (got {scale})')
    _check_kernel_inputs(q, k, v, causal, window)
    b, hq, s, d = q.shape
    q, k, v = pad_rows(row_width(d, q.dtype), q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _kernel_lib('flash_attention_fwd', 5)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_launch_args(q, k, causal, window, scale))
    _raise_on(lib, 'flash_attention_fwd', rc)
    flash_fwd_launches += 1
    return _unpad(out, d), lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool, scale: float, window: Optional[int]
                           ) -> torch.Tensor:
    """Launch the Hopper dQ kernel: returns dQ in q's dtype.  lse and
    delta are f32 [B, Hq, S].  CUDA tensors only; rows padded as the
    forward's."""
    global flash_bwd_dq_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, causal, window)
    d = q.shape[-1]
    q, k, v, do = pad_rows(row_width(d, q.dtype), q, k, v, do)
    dq = torch.empty_like(q)
    lib = _kernel_lib('flash_attention_bwd_dq', 7)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_launch_args(q, k, causal, window, scale))
    _raise_on(lib, 'flash_attention_bwd_dq', rc)
    flash_bwd_dq_launches += 1
    return _unpad(dq, d)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool, scale: float, window: Optional[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper dK/dV kernel (GQA folded inside): returns
    (dK, dV) in k's and v's dtype.  CUDA tensors only; rows padded as the
    forward's."""
    global flash_bwd_dkv_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, causal, window)
    d = q.shape[-1]
    q, k, v, do = pad_rows(row_width(d, q.dtype), q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib('flash_attention_bwd_dkv', 8)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_launch_args(q, k, causal, window, scale))
    _raise_on(lib, 'flash_attention_bwd_dkv', rc)
    flash_bwd_dkv_launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def _launch_args(q, k, causal, window, scale) -> tuple:
    """The trailing arguments every kernel's C entry point takes."""
    b, hq, s, d = q.shape
    return (b, hq, k.shape[1], s, d, int(causal), window or 0, float(scale),
            int(q.dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream)


def _check_kernel_inputs(q, k, v, causal, window) -> None:
    """Raise on anything the kernels do not take; the device comes last,
    so that the CPU tests reach every other rule."""
    _check_qkv(q, k, v, causal, window)
    _check_on_card(q=q, k=k, v=v)


def _check_bwd_inputs(q, k, v, do, lse, delta, causal, window) -> None:
    """_check_kernel_inputs for the backward kernels, with their rules for
    dO (read by TMA, as q is), the LSE and delta; the device comes
    last."""
    _check_qkv(q, k, v, causal, window)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f'do must match q: {tuple(do.shape)} {do.dtype} vs '
                         f'{tuple(q.shape)} {q.dtype}')
    for name, t in (('lse', lse), ('delta', delta)):
        if t.dtype != torch.float32 or t.shape != q.shape[:3]:
            raise ValueError(f'{name} must be float32 {tuple(q.shape[:3])} '
                             f'(got {t.dtype} {tuple(t.shape)})')
    for name, t in (('do', do), ('lse', lse), ('delta', delta)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if do.data_ptr() % 16:
        raise ValueError('do must be 16-byte aligned')
    _check_on_card(q=q, k=k, v=v, do=do, lse=lse, delta=delta)


def _check_qkv(q, k, v, causal, window) -> None:
    """Every rule of the kernels on q, k and v but the device's."""
    for name, t in (('q', q), ('k', k), ('v', v)):
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
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f'k/v shape {tuple(k.shape)} does not match q '
                         f'{tuple(q.shape)}')
    if hq % k.shape[1]:
        raise ValueError(f'num q heads {hq} must be a multiple of num kv '
                         f'heads {k.shape[1]}')
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f'head_dim {d} is outside the kernels\' 1 to '
                         f'{MAX_HEAD_DIM} (ROADMAP.md B2)')
    # Every kernel puts batch x heads on gridDim.x and its row tiles, 16
    # rows at the least (the f32 paths), on gridDim.y (at most 65,535);
    # rows are indexed in 32 bits (the tensor maps' coordinates).
    if -(-s // 16) > 65535:
        raise ValueError(f'seq {s} exceeds the grid limit '
                         f'({65535 * 16} rows)')
    if b * hq * s > 2 ** 31 - 1:
        raise ValueError(f'batch x q heads x seq = {b * hq * s} exceeds '
                         'the 32-bit row index')
    if window is not None and (not causal or window < 1):
        raise ValueError('window requires causal attention and must be >= 1')


def _check_on_card(**tensors) -> None:
    """The device rule, checked last: every tensor a CUDA tensor, all on
    one card."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor (got {t.device})')
    if len({t.device for t in tensors.values()}) > 1:
        raise ValueError(f'{", ".join(tensors)} must be on one device')


def _kernel_lib(name: str, n_ptrs: int) -> ctypes.CDLL:
    """The kernel library `name`, built on first use, with the argument
    types of its entry point (n_ptrs tensor pointers, then the
    _launch_args) and of its error-string function set."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * n_ptrs + [i32] * 7 + [ctypes.c_float, i32,
                                                     ptr]
        fn.restype = i32
        err = getattr(lib, name + '_error_string')
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: '
                           + getattr(lib, name + '_error_string')(rc).decode())


def _attention_fwd(q, k, v, causal, scale, window):
    """The forward kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    fn = flash_attention_fwd if q.is_cuda else attention_fwd_reference
    return fn(q, k, v, causal, scale, window)


def _attention_bwd(q, k, v, do, lse, delta, causal, scale, window):
    """(dQ, dK, dV): the two backward kernels on CUDA tensors, their plain
    versions on CPU tensors."""
    if q.is_cuda:
        dq_fn, dkv_fn = flash_attention_bwd_dq, flash_attention_bwd_dkv
    else:
        dq_fn, dkv_fn = attention_bwd_dq_reference, attention_bwd_dkv_reference
    args = (q, k, v, do, lse, delta, causal, scale, window)
    return (dq_fn(*args), *dkv_fn(*args))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient, the counterpart of ``_flash`` and
    its ``custom_vjp``: the forward saves q, k, v, O and the LSE; the
    backward computes delta = rowsum(dO * O) in f32 (outside the kernels,
    as the JAX package does) and runs the dQ and dK/dV kernels.  Each
    piece runs the kernel for a CUDA tensor and its plain version for a
    CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                window: Optional[int]):
        out, lse = _attention_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = _attention_bwd(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    use_kernel: Optional[bool] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention, flash-style, with the JAX dispatcher's rules;
    on CUDA tensors the kernels, at any head_dim from 1 to MAX_HEAD_DIM.

    Args:
      q: [batch, num_q_heads, seq, head_dim]
      k, v: [batch, num_kv_heads, seq, head_dim] (GQA when fewer kv heads)
      block_q, block_kv: the TPU kernel's tile sizes; accepted for
        signature parity and not used (the Hopper tiles are fixed).
      use_kernel: None picks by device (CUDA: kernels, CPU: reference);
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
    return FlashAttentionFunction.apply(q, k, v, causal, scale, window)
