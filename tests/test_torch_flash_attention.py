"""The port's flash attention (skypilot_tpu_torch.ops.flash_attention) held
against the JAX package's: the Pallas forward kernel in interpret mode
(O and LSE) and the JAX reference_attention.  Inputs are made with numpy
from a seed and fed to both.  Everything here runs on the CPU, in f32;
the Hopper kernel itself is held against its plain version on the card
by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.flash_attention import _flash_fwd
from skypilot_tpu.ops.flash_attention import \
    reference_attention as jax_reference_attention
from skypilot_tpu_torch.ops import flash_attention as fa

# f32 on the CPU: the same math in another summation order.
TOL_REFERENCE = 5e-5     # max abs error against JAX reference_attention
TOL_KERNEL = 1e-4        # max abs error on O and LSE against the Pallas kernel


def _inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


# (b, hq, hkv, s, d, causal, window, block_q, block_kv)
CASES = {
    'causal': (2, 4, 4, 256, 64, True, None, 128, 128),
    'non_causal': (2, 4, 4, 256, 64, False, None, 128, 128),
    'gqa_8_2': (2, 8, 2, 128, 64, True, None, 128, 128),
    'gqa_8_2_non_causal': (1, 8, 2, 128, 64, False, None, 64, 64),
    'uneven_blocks_128_64': (1, 2, 2, 256, 64, True, None, 128, 64),
    'window_48': (2, 8, 2, 128, 64, True, 48, 64, 64),
    'window_48_uneven_blocks': (1, 4, 2, 256, 64, True, 48, 128, 64),
    'window_covers_seq': (1, 2, 2, 128, 32, True, 128, 64, 64),
    'head_dim_32': (1, 4, 2, 128, 32, True, None, 64, 64),
    'head_dim_32_window': (1, 4, 1, 128, 32, True, 48, 64, 64),
    # head_dim 256 (Gemma), which the Hopper kernels take since they tile
    # it by 64 kv rows: GQA, MQA with a window, non-causal.
    'head_dim_256': (1, 4, 2, 128, 256, True, None, 64, 64),
    'head_dim_256_mqa_window': (1, 4, 1, 128, 256, True, 48, 64, 64),
    'head_dim_256_non_causal': (1, 2, 2, 128, 256, False, None, 64, 64),
    # Head dims the Hopper kernels run in a wider tile, zeros past d:
    # llama-debug's 16, danube-1.8b's 80 with a window, danube3-500m's 96
    # with GQA, open_llama_3b's 100 (a bf16 row TMA cannot read: padded).
    'head_dim_16': (1, 4, 2, 128, 16, True, None, 64, 64),
    'head_dim_80_window': (1, 4, 1, 128, 80, True, 48, 64, 64),
    'head_dim_96_gqa': (1, 8, 2, 128, 96, True, None, 64, 64),
    'head_dim_100_non_causal': (1, 2, 2, 128, 100, False, None, 64, 64),
}


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_plain_version_matches_pallas_kernel(case):
    """attention_fwd_reference (the kernel's plain version): O and LSE
    against the Pallas forward in interpret mode."""
    b, hq, hkv, s, d, causal, window, bq, bkv = CASES[case]
    q, k, v = _inputs(b, hq, hkv, s, d, seed=len(case))
    scale = d ** -0.5
    jwindow = None if window is not None and window >= s else window
    jout, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, scale=scale, block_q=bq,
                            block_kv=bkv, window=jwindow)
    out, lse = fa.attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, jwindow)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL_KERNEL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=TOL_KERNEL)


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_flash_attention_matches_jax_reference(case):
    """The dispatcher on CPU tensors (reference_attention) and the plain
    kernel version, both against JAX reference_attention."""
    b, hq, hkv, s, d, causal, window, bq, bkv = CASES[case]
    q, k, v = _inputs(b, hq, hkv, s, d, seed=len(case) + 100)
    ref = np.asarray(jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_kv=bkv, window=window)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_REFERENCE)
    plain, _ = fa.attention_fwd_reference(
        tq, tk, tv, causal, d ** -0.5,
        None if window is not None and window >= s else window)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0,
                               atol=TOL_REFERENCE)


def test_window_covering_sequence_equals_causal():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 32, seed=5))
    banded = fa.flash_attention(q, k, v, window=64)
    plain = fa.flash_attention(q, k, v)
    assert torch.equal(banded, plain)


def test_dispatcher_errors():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 32, seed=6))
    with pytest.raises(ValueError, match='causal'):
        fa.flash_attention(q, k, v, causal=False, window=16)
    with pytest.raises(ValueError, match='>= 1'):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match='use_kernel'):
        fa.flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError, match='causal'):
        fa.reference_attention(q, k, v, causal=False, window=8)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on a CPU tensor: it raises
    before any build or launch."""
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 64, seed=7))
    before = fa.flash_fwd_launches
    with pytest.raises(ValueError, match='CUDA'):
        fa.flash_attention_fwd(q, k, v, True, 0.125, None)
    assert fa.flash_fwd_launches == before


# (what is wrong, the arguments' edit, the message the wrapper raises)
BAD_KERNEL_INPUTS = {
    'scale_zero': (dict(scale=0.0), 'positive scale'),
    'scale_negative': (dict(scale=-0.125), 'positive scale'),
    'head_dim_264': (dict(d=264), 'head_dim 264'),
    # head_dims the kernels take: only the device rule is left to fail
    'head_dim_96_cpu': (dict(d=96), 'CUDA'),
    'head_dim_256_cpu': (dict(d=256), 'CUDA'),
    'float16': (dict(dtype=torch.float16), 'bfloat16 or float32'),
    'gqa_3_over_2': (dict(hq=3), 'multiple'),
    'window_not_causal': (dict(causal=False, window=16), 'window'),
    'window_zero': (dict(window=0), 'window'),
    'not_contiguous': (dict(transpose=True), 'contiguous'),
    'k_v_shapes_differ': (dict(s_v=32), 'does not match'),
}


@pytest.mark.parametrize('case', list(BAD_KERNEL_INPUTS),
                         ids=list(BAD_KERNEL_INPUTS))
def test_kernel_wrapper_raises_before_launch(case):
    """Every rule of the forward kernel's wrapper raises before any build
    or launch; the CPU tensors here reach every rule but the device's,
    which is checked last."""
    edit, message = BAD_KERNEL_INPUTS[case]
    args = {**dict(hq=4, d=64, s_v=64, dtype=torch.bfloat16, causal=True,
                   window=None, scale=0.125, transpose=False), **edit}
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(args['dtype'])
        for shape in ((1, args['hq'], 64, args['d']), (1, 2, 64, args['d']),
                      (1, 2, args['s_v'], args['d'])))
    if args['transpose']:
        q = q.transpose(2, 3)
    before = fa.flash_fwd_launches
    with pytest.raises((ValueError, TypeError), match=message):
        fa.flash_attention_fwd(q, k, v, args['causal'], args['scale'],
                               args['window'])
    assert fa.flash_fwd_launches == before
