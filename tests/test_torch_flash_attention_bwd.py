"""The port's flash-attention backward (skypilot_tpu_torch.ops.flash_attention)
held against the JAX package's: the plain versions of the dQ and dK/dV
kernels against ``_flash_bwd``, which runs both Pallas backward kernels in
interpret mode, and the autograd Function on CPU tensors against autograd
through ``reference_attention`` and against ``jax.grad`` of the JAX
``flash_attention``.  Inputs are made with numpy from a seed and fed to
both.  Everything here runs on the CPU, in f32; the Hopper kernels
themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_card.py."""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
from skypilot_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from skypilot_tpu_torch.ops import flash_attention as fa

# f32 on the CPU: the same math in another summation order.
TOL = 1e-4


def _inputs(b, hq, hkv, s, d, seed):
    """q, k, v and the output cotangent dO, standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d),
                               (b, hkv, s, d), (b, hq, s, d)))


# (b, hq, hkv, s, d, causal, window, block)
CASES = {
    'causal': (2, 4, 4, 128, 64, True, None, 64),
    'non_causal': (1, 4, 4, 128, 64, False, None, 64),
    'gqa_8_2': (1, 8, 2, 128, 64, True, None, 64),
    'window_48': (1, 4, 2, 128, 64, True, 48, 64),
    'head_dim_32': (1, 4, 2, 128, 32, True, None, 64),
    'head_dim_64_gqa_non_causal': (1, 8, 2, 64, 64, False, None, 32),
    # head_dim 256 (Gemma): GQA, MQA with a window, non-causal.
    'head_dim_256': (1, 4, 2, 128, 256, True, None, 64),
    'head_dim_256_mqa_window': (1, 4, 1, 128, 256, True, 48, 64),
    'head_dim_256_non_causal': (1, 2, 2, 128, 256, False, None, 64),
}


def _jax_bwd(q, k, v, do, causal, window, block):
    """(out, lse, dq, dk, dv) from the Pallas kernels in interpret mode."""
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = _flash_fwd(jq, jk, jv, causal=causal, scale=scale,
                          block_q=block, block_kv=block, window=window)
    dq, dk, dv = _flash_bwd(jq, jk, jv, out, lse, jdo, causal=causal,
                            scale=scale, block_q=block, block_kv=block,
                            window=window)
    # Owned copies once every output is ready: np.asarray of a CPU jax
    # Array can be a view of the runtime's buffer.
    return tuple(np.array(x) for x in jax.block_until_ready(
        (out, lse, dq, dk, dv)))


def _plain_bwd(q, k, v, do, out, lse, causal, window):
    """(dq, dk, dv) from the plain versions, as numpy."""
    tq, tk, tv, tdo, tout, tlse = map(torch.from_numpy,
                                      (q, k, v, do, out, lse))
    delta = (tdo * tout).sum(-1)
    args = (tq, tk, tv, tdo, tlse, delta, causal, q.shape[-1] ** -0.5,
            window)
    dq = fa.attention_bwd_dq_reference(*args)
    dk, dv = fa.attention_bwd_dkv_reference(*args)
    return dq.numpy(), dk.numpy(), dv.numpy()


def _digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def _numeric_state() -> dict:
    """The torch, JAX and process settings a CPU f32 result can hang on."""
    return {
        'torch_threads': torch.get_num_threads(),
        'torch_interop_threads': torch.get_num_interop_threads(),
        'torch_f32_matmul_precision': torch.get_float32_matmul_precision(),
        'torch_cpu_capability': torch.backends.cpu.get_cpu_capability(),
        'torch_mkldnn': torch.backends.mkldnn.enabled,
        'torch_default_dtype': str(torch.get_default_dtype()),
        'torch_deterministic': torch.are_deterministic_algorithms_enabled(),
        'jax_default_matmul_precision':
            jax.config.jax_default_matmul_precision,
        'jax_enable_x64': jax.config.jax_enable_x64,
        'jax_backend': jax.default_backend(),
        'env': {k: os.environ.get(k) for k in (
            'XLA_FLAGS', 'OMP_NUM_THREADS', 'MKL_NUM_THREADS',
            'JAX_PLATFORMS', 'PYTEST_XDIST_WORKER')},
        'cpus': len(os.sched_getaffinity(0))}


def _failure_report(inputs, jax_outs, plain, tmp_path, causal, window,
                    block) -> str:
    """What a failure of the comparison below leaves behind: every array
    in an .npz under tmp_path, and in the message the digests of the
    inputs and of both sides' outputs, the worst element of each
    gradient, whether a second run of each side gives its first run's
    bytes, and the numeric state of the process."""
    q, k, v, do = inputs
    jax_again = _jax_bwd(q, k, v, do, causal, window, block)
    plain_again = _plain_bwd(q, k, v, do, *jax_outs[:2], causal, window)
    worst = {}
    for name, got, want in zip(('dq', 'dk', 'dv'), plain, jax_outs[2:]):
        err = np.abs(got - want)
        i = np.unravel_index(np.nanargmax(err), err.shape)
        worst[name] = {'max_abs_err': float(err[i]), 'at': list(map(int, i)),
                       'plain': float(got[i]), 'jax': float(want[i]),
                       'nan': int(np.isnan(got).sum() + np.isnan(want).sum())}
    path = tmp_path / 'flash_bwd_failure.npz'
    np.savez(path, q=q, k=k, v=v, do=do,
             **dict(zip(('out', 'lse', 'jdq', 'jdk', 'jdv'), jax_outs)),
             **dict(zip(('dq', 'dk', 'dv'), plain)))
    return json.dumps({
        'arrays': str(path),
        'inputs': [_digest(x) for x in inputs],
        'jax_out_lse_dq_dk_dv': [_digest(x) for x in jax_outs],
        'plain_dq_dk_dv': [_digest(x) for x in plain],
        'jax_rerun_same_bytes': [bool(np.array_equal(a, b, equal_nan=True))
                                 for a, b in zip(jax_outs, jax_again)],
        'plain_rerun_same_bytes': [
            bool(np.array_equal(a, b, equal_nan=True))
            for a, b in zip(plain, plain_again)],
        'worst': worst, 'state': _numeric_state()})


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_plain_versions_match_pallas_kernels(case, tmp_path):
    """attention_bwd_dq_reference and attention_bwd_dkv_reference (the
    kernels' plain versions) against _flash_bwd, from the same O and LSE
    and with delta = rowsum(dO * O) in f32 as the JAX package forms it.
    A failure names its cause's evidence (_failure_report)."""
    b, hq, hkv, s, d, causal, window, block = CASES[case]
    inputs = _inputs(b, hq, hkv, s, d, seed=len(case))
    jax_outs = _jax_bwd(*inputs, causal, window, block)
    plain = _plain_bwd(*inputs, *jax_outs[:2], causal, window)
    assert plain[0].shape == inputs[0].shape
    assert plain[1].shape == plain[2].shape == inputs[1].shape
    report = ''
    if not all(np.abs(got - want).max() <= TOL
               for got, want in zip(plain, jax_outs[2:])):
        report = _failure_report(inputs, jax_outs, plain, tmp_path, causal,
                                 window, block)
    for got, want in zip(plain, jax_outs[2:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=report)


@pytest.mark.parametrize('case', ['causal', 'gqa_8_2', 'window_48',
                                  'head_dim_64_gqa_non_causal',
                                  'head_dim_256_mqa_window'])
def test_function_gradients_match_autograd_and_jax(case):
    """FlashAttentionFunction on CPU tensors (the plain forward and both
    plain backward versions) against autograd through
    reference_attention, and against jax.grad of the JAX flash_attention
    with the Pallas kernels (interpret mode) and their custom_vjp."""
    b, hq, hkv, s, d, causal, window, block = CASES[case]
    q, k, v, do = _inputs(b, hq, hkv, s, d, seed=len(case) + 50)
    scale = d ** -0.5

    def torch_grads(fn):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = fn(tq, tk, tv)
        return out.detach(), torch.autograd.grad(
            out, (tq, tk, tv), torch.from_numpy(do))

    out, grads = torch_grads(lambda a, b_, c: fa.FlashAttentionFunction.apply(
        a, b_, c, causal, scale, window))
    ref_out, ref_grads = torch_grads(lambda a, b_, c: fa.reference_attention(
        a, b_, c, causal=causal, scale=scale, window=window))
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=TOL)

    def jax_loss(jq, jk, jv):
        o = jax_flash_attention(jq, jk, jv, causal=causal, scale=scale,
                                block_q=block, block_kv=block,
                                use_pallas=True, window=window)
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref, jref in zip(grads, ref_grads, jgrads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=0,
                                   atol=TOL)


def test_dispatcher_differentiates_on_cpu():
    """flash_attention on CPU tensors keeps the JAX dispatcher's CPU rule
    (reference_attention, differentiated by autograd) and its gradient
    equals the Function's."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 4, 2, 64, 32, seed=9))
    q.requires_grad_(True)
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    (dq,) = torch.autograd.grad(fa.flash_attention(q, k, v, window=16), q,
                                do)
    (dq_fn,) = torch.autograd.grad(fa.FlashAttentionFunction.apply(
        q, k, v, True, 32 ** -0.5, 16), q, do)
    np.testing.assert_allclose(dq.numpy(), dq_fn.numpy(), atol=TOL)
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == before


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never compute on a CPU tensor: they raise
    before any build or launch."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 2, 2, 64, 64, seed=7))
    lse = torch.zeros(q.shape[:3])
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match='CUDA'):
            fn(q, k, v, do, lse, lse, True, 0.125, None)
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == before


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (what is wrong, the edit of the arguments, the message the wrapper
# raises).  Every input is on the CPU, so each case reaches its rule only
# because the device is checked last.
BAD_BWD_INPUTS = {
    'head_dim_96': (dict(d=96), 'head_dim 96'),
    # a head_dim the kernels take: only the device rule is left to fail
    'head_dim_256_cpu': (dict(d=256), 'CUDA'),
    'window_not_causal': (dict(causal=False, window=16), 'window'),
    'do_shape': (dict(do=lambda do: do[:, :, :32]), 'do must match q'),
    'do_dtype': (dict(do=lambda do: do.float()), 'do must match q'),
    'do_not_contiguous': (dict(do=lambda do: do.transpose(2, 3).contiguous()
                               .transpose(2, 3)), 'do must be contiguous'),
    'do_misaligned': (dict(do=_misaligned), 'do must be 16-byte aligned'),
    'lse_dtype': (dict(lse=lambda x: x.bfloat16()), 'lse must be float32'),
    'lse_shape': (dict(lse=lambda x: x[..., :32]), 'lse must be float32'),
    'delta_not_contiguous': (dict(delta=lambda x: x.transpose(1, 2)
                                  .contiguous().transpose(1, 2)),
                             'delta must be contiguous'),
}
BWD_WRAPPERS = {'dq': 'flash_attention_bwd_dq',
                'dkv': 'flash_attention_bwd_dkv'}


@pytest.mark.parametrize('wrapper', list(BWD_WRAPPERS))
@pytest.mark.parametrize('case', list(BAD_BWD_INPUTS),
                         ids=list(BAD_BWD_INPUTS))
def test_backward_kernel_wrappers_raise_before_launch(case, wrapper):
    """Every rule of the backward kernels' wrappers raises before any
    build or launch, and no launch counter moves; the CPU tensors here
    reach every rule but the device's, which is checked last."""
    edit, message = BAD_BWD_INPUTS[case]
    d = edit.get('d', 64)
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(1, 4, 2, 64, d, seed=12))
    lse = torch.zeros(q.shape[:3])
    delta = torch.zeros(q.shape[:3])
    if 'do' in edit:
        do = edit['do'](do)
    if 'lse' in edit:
        lse = edit['lse'](lse)
    if 'delta' in edit:
        delta = edit['delta'](delta)
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    with pytest.raises((ValueError, TypeError), match=message):
        getattr(fa, BWD_WRAPPERS[wrapper])(
            q, k, v, do, lse, delta, edit.get('causal', True), 0.125,
            edit.get('window'))
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == before


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_backward_bound_is_positive_and_finite(dtype):
    """attention_bwd_bound, the per-element bound chip_smoke.py and the
    card tests hold the backward kernels to, on a small GQA window case:
    positive and finite everywhere, shaped like dQ, dK and dV."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(1, 4, 2, 64, 32, seed=13))
    scale = 32 ** -0.5
    out, lse = fa.attention_fwd_reference(q, k, v, True, scale, 16)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale, 16)
    ref = (fa.attention_bwd_dq_reference(*args),
           *fa.attention_bwd_dkv_reference(*args))
    bounds = fa.attention_bwd_bound(*args, ref)
    for bound, r in zip(bounds, ref):
        assert bound.shape == r.shape and bound.dtype == torch.float32
        assert bool(torch.isfinite(bound).all() and (bound > 0).all())
