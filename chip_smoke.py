"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
main path -- the llama-1b no-cache forward (tokens [1, 1024]) and
offline serving through the dense-cache engine -- at full width with
random weights from a seed, and checks what comes out.  Every phase
prints one JSON line; any failed check raises, so the script exits
non-zero and the closing line is never printed.  The last two lines are
the kernels line and {"ok": true, "device": {...}}.

Needs a CUDA card (exits non-zero without one) and imports nothing of
JAX or of the JAX package.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from skypilot_tpu_torch.entry import entry
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request)
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its operations over the peak rate of their type and
# its bytes (each input read once, each output written once) over HBM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, hq, hkv, s, d, dtype, causal, window):
    """Least time (ms) for the attention forward on these inputs, and what
    sets it: visible (query, key) pairs x 4*D FLOPs (QK^T and PV) at the
    peak rate of the dtype, against Q, K, V read once and O, LSE written
    once at the HBM rate."""
    i = np.arange(s)
    if causal:
        lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
        pairs = int(np.sum(i - lo + 1))
    else:
        pairs = s * s
    ops_ms = 1e3 * 4.0 * b * hq * d * pairs / PEAK_FLOPS[dtype]
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * b * hq * s * d + 2 * b * hkv * s * d)
              + 4 * b * hq * s)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms
                                   else 'bytes')


def phase_env() -> dict:
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {'phase': 'env', 'nvidia_smi': smi, 'torch': torch.__version__,
           'cuda': torch.version.cuda,
           'device': torch.cuda.get_device_name(0),
           'count': torch.cuda.device_count()}
    emit(env)
    return env


def phase_build() -> None:
    t0 = time.perf_counter()
    secs = _build.build(['flash_attention_fwd'])
    log = _build.library_path('flash_attention_fwd').with_suffix('.log')
    print(log.read_text(), file=sys.stderr, flush=True)   # ptxas report
    emit({'phase': 'build', 'nvcc_s': secs,
          'wall_s': time.perf_counter() - t0})


# (name, b, hq, hkv, s, d, dtype, causal, window); the first is the shape
# the llama-1b forward gives the kernel, and the one timed.
KERNEL_CASES = [
    ('llama-1b', 1, 16, 8, 1024, 128, torch.bfloat16, True, None),
    ('non_causal', 1, 16, 8, 1024, 128, torch.bfloat16, False, None),
    ('window_48', 2, 8, 2, 256, 128, torch.bfloat16, True, 48),
    ('head_dim_64', 2, 8, 2, 256, 64, torch.bfloat16, True, None),
    ('ragged_200', 1, 4, 2, 200, 128, torch.bfloat16, True, None),
    ('f32', 1, 8, 4, 200, 128, torch.float32, True, None),
    ('f32_window_d64', 2, 8, 2, 256, 64, torch.float32, True, 48),
]


# Agreement of the kernel with its plain version (same inputs; the plain
# version computes in f32).  The LSE is f32 on both sides: 1e-4.  O is
# held element by element.  f32: the same math in another order, 1e-4.
# bf16: both round O to bf16, which may part them by one ulp of the
# element, at most 2**-7 * |O|; the kernel also rounds P to bf16 (relative
# error <= 2**-9 per key) before P*V, which moves an element by at most
# 2**-9 * sum_j p_j |v_j| -- the attention of |V|, computed by the plain
# version -- and the bound allows twice that.
BOUND_LSE = 1e-4
BOUND_O_F32 = 1e-4


def o_bound(q, k, v, causal, scale, window, ref_out) -> torch.Tensor:
    """Per-element bound on |O_kernel - O_plain| (see above)."""
    if q.dtype == torch.float32:
        return torch.full_like(ref_out, BOUND_O_F32)
    p_abs_v, _ = fa.attention_fwd_reference(q.float(), k.float(),
                                            v.float().abs(), causal, scale,
                                            window)
    return 2.0 ** -7 * ref_out.float().abs() + 2.0 ** -8 * p_abs_v


def phase_kernel() -> dict:
    gen = torch.Generator(device='cuda').manual_seed(0)
    failures, main = [], None
    for name, b, hq, hkv, s, d, dtype, causal, window in KERNEL_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen,
                               device='cuda').to(dtype)
                   for h in (hq, hkv, hkv))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.attention_fwd_reference(q, k, v, causal, scale,
                                                      window)
        diff = (out.float() - ref_out.float()).abs()
        err_o = diff.max().item()
        err_over_bound = (diff / o_bound(q, k, v, causal, scale, window,
                                         ref_out)).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        row = {'phase': 'kernel', 'case': name, 'shape': [b, hq, hkv, s, d],
               'dtype': str(dtype), 'causal': causal, 'window': window,
               'max_abs_err_o': err_o, 'mean_abs_err_o': diff.mean().item(),
               'mean_abs_o': ref_out.float().abs().mean().item(),
               'max_abs_o': ref_out.float().abs().max().item(),
               'max_err_over_bound_o': err_over_bound,
               'max_abs_err_lse': err_lse, 'bound_lse': BOUND_LSE}
        if not (err_over_bound <= 1.0 and err_lse <= BOUND_LSE):
            failures.append(name)
        if main is None:
            bound_ms, bound_by = attention_bound(b, hq, hkv, s, d, dtype,
                                                 causal, window)
            main = {'max_abs_err': err_o, 'ms': cuda_ms(
                        lambda: fa.flash_attention_fwd(q, k, v, causal, scale,
                                                       window)),
                    'plain_ms': cuda_ms(lambda: fa.attention_fwd_reference(
                        q, k, v, causal, scale, window)),
                    'library_ms': cuda_ms(
                        lambda: torch.nn.functional.
                        scaled_dot_product_attention(
                            q, k, v, is_causal=causal, enable_gqa=True)),
                    'bound_ms': bound_ms, 'bound_by': bound_by}
            row.update(main)
        emit(row)
    check(not failures, f'kernel disagrees with its plain version: {failures}')
    return main


def profile_device(fn, top: int = 8) -> dict:
    """One call of fn under torch.profiler: the device time of every
    kernel it ran (device-side events only), the top kernels,
    and the device's idle share of the wall time of one call of fn
    without the profiler (which adds host time of its own)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) if rows else None  # not traced
    return {'wall_ms': wall_ms, 'device_ms': device_ms,
            'idle_share': (None if device_ms is None
                           else max(0.0, 1.0 - device_ms / wall_ms)),
            'top': [{'name': n[:80], 'ms': ms, 'count': c}
                    for n, ms, c in rows[:top]]}


def phase_forward():
    forward, (model, tokens) = entry()
    torch.cuda.synchronize()
    fa.flash_fwd_launches = 0
    logits = forward(model, tokens)
    torch.cuda.synchronize()
    launches = fa.flash_fwd_launches
    check(launches == model.config.num_layers,
          f'forward launched the kernel {launches} times, expected '
          f'{model.config.num_layers}')
    check(tuple(logits.shape) == (1, 1024, model.config.vocab_size),
          f'logits shape {tuple(logits.shape)}')
    check(bool(torch.isfinite(logits).all()), 'non-finite logits')
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        forward(model, tokens)
    torch.cuda.synchronize()
    forward_ms = 1e3 * (time.perf_counter() - t0) / reps
    profile = profile_device(lambda: forward(model, tokens))

    # The same weights at depth 2 in f32: the card (the kernel's f32 path
    # and cuBLAS f32) against the CPU (the plain version).  Bound: f32
    # sums in another order over a 2048-wide residual stream and a
    # 32000-way f32 logit product.
    cfg2 = dataclasses.replace(model.config, num_layers=2,
                               dtype=torch.float32)
    sd = {k: v.float() for k, v in model.state_dict().items()
          if not k.startswith('layers.') or k.split('.')[1] in ('0', '1')}
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg2.vocab_size, (1, 256)))
    outs = {}
    for dev in ('cuda', 'cpu'):
        m2 = llama.Llama(cfg2, device=dev).eval()
        m2.load_state_dict(sd)
        with torch.inference_mode():
            outs[dev] = m2(toks.to(dev)).float().cpu()
        del m2
    err2 = (outs['cuda'] - outs['cpu']).abs().max().item()
    check(err2 <= 2e-3, f'2-layer f32 card vs CPU logits differ by {err2}')
    emit({'phase': 'forward', 'model': 'llama-1b', 'tokens': [1, 1024],
          'flash_fwd_launches': launches, 'forward_ms': forward_ms,
          'logits_finite': True, 'depth2_f32_card_vs_cpu_max_abs_err': err2,
          'depth2_bound': 2e-3, 'profile': profile})
    return model, launches


def teacher_forced_err(model, results, use_cache: bool = False) -> float:
    """Max |logprob| gap between what the engine reported for each
    generated token and a forward over prompt + output: the no-cache
    forward (flash kernel) or, with use_cache, the cached forward (the
    engine's own attention path) over a fresh cache."""
    dev = model.embedding.device
    err = 0.0
    for r in results:
        toks = r.prompt_tokens + r.output_tokens[:-1]
        seq = torch.tensor([toks], device=dev)
        with torch.inference_mode():
            if use_cache:
                cache = llama.init_cache(model.config, 1, len(toks),
                                         model.config.dtype, dev)
                pos = torch.arange(len(toks), device=dev)[None]
                logits = model(seq, pos, cache)[0]
            else:
                logits = model(seq)
            lp = torch.log_softmax(logits[0], dim=-1)
        n = len(r.prompt_tokens)
        pos = torch.arange(n - 1, n - 1 + len(r.output_tokens), device=dev)
        ref = lp[pos, torch.tensor(r.output_tokens, device=dev)].cpu()
        err = max(err, (ref - torch.tensor(r.logprobs)).abs().max().item())
    return err


def phase_serve(model, card: str) -> None:
    cfg = InferConfig(model='llama-1b', num_slots=8, max_cache_len=1024,
                      prefill_buckets=(64, 128, 256), decode_steps=8,
                      max_new_tokens=32)
    engine = InferenceEngine(model.config, cfg, params=model.state_dict(),
                             generator=torch.Generator(
                                 device='cuda').manual_seed(1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size,
                            int(rng.integers(20, 251))).tolist()
               for _ in range(12)]
    temps = [0.0] * 10 + [0.8] * 2

    def run():
        reqs = [Request(tokens=p, temperature=t, request_id=str(i))
                for i, (p, t) in enumerate(zip(prompts, temps))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(reqs)
        return res, time.perf_counter() - t0

    fa.flash_fwd_launches = 0
    first, first_wall = run()
    second, wall = run()
    serve_launches = fa.flash_fwd_launches
    for r in first + second:
        check(r.finish_reason == 'length' and len(r.output_tokens) == 32,
              f'request {r.request_id}: {r.finish_reason} after '
              f'{len(r.output_tokens)} tokens ({r.error})')
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    check(all(first[i].output_tokens == second[i].output_tokens
              for i in greedy), 'greedy tokens differ between two runs')

    # Teacher-forced, bf16: the no-cache forward (flash kernel) over
    # prompt + output gives each generated token the engine's logprob.
    # Bound: bf16 activations through 22 layers on two attention paths
    # that round differently (the engine's decode_attention keeps scores
    # and P in f32 over a bf16 cache, the kernel rounds P to bf16 before
    # P*V), compared in nats.  The same comparison through the engine's
    # own attention path (cache_path_max_abs_err) and the f32 check below
    # separate that rounding from a fault.
    tf_bound = 0.25
    tf_err = teacher_forced_err(engine.model, [first[i] for i in greedy])
    cache_err = teacher_forced_err(engine.model, [first[i] for i in greedy],
                                   use_cache=True)
    check(tf_err <= tf_bound, f'teacher-forced logprobs differ by {tf_err}')

    # Where a decode window's time goes: one 8-step window over all 8
    # slots at cache position 256 (rows past every request's end).
    n_slots = cfg.num_slots
    window_profile = profile_device(lambda: engine._decode(
        torch.zeros(n_slots, dtype=torch.long, device='cuda'),
        torch.full((n_slots,), 256, dtype=torch.long, device='cuda'),
        torch.zeros(n_slots, device='cuda'), cfg.decode_steps))

    # The same in f32 (engine, cache and forward): only summation order
    # differs, so the bound is tight.
    tf32_bound = 2e-3
    cfg32 = dataclasses.replace(model.config, dtype=torch.float32)
    engine32 = InferenceEngine(
        cfg32, InferConfig(model='llama-1b', num_slots=4, max_cache_len=512,
                           prefill_buckets=(64, 128, 256), decode_steps=8,
                           max_new_tokens=16, cache_dtype=torch.float32),
        params=model.state_dict())
    res32 = engine32.generate([Request(tokens=p) for p in prompts[:4]])
    tf32_err = teacher_forced_err(engine32.model, res32)
    check(tf32_err <= tf32_bound,
          f'f32 teacher-forced logprobs differ by {tf32_err}')
    del engine32

    n_tok = sum(len(r.output_tokens) for r in second)
    emit({'phase': 'serve', 'model': 'llama-1b', 'device': card,
          'requests': len(second), 'greedy': len(greedy),
          'prompt_lens': [len(p) for p in prompts],
          'new_tokens': n_tok, 'first_run_wall_s': first_wall,
          # The engine attends through decode_attention, as the JAX
          # engine does: no flash launches are expected here.
          'flash_fwd_launches': serve_launches,
          'wall_s': wall, 'tok_per_s': n_tok / wall,
          'ttft_s_mean': float(np.mean([r.ttft_s for r in second])),
          'ttft_s_max': float(np.max([r.ttft_s for r in second])),
          'teacher_forced_max_abs_err': tf_err,
          'teacher_forced_bound': tf_bound,
          'cache_path_max_abs_err': cache_err,
          'f32_teacher_forced_max_abs_err': tf32_err,
          'f32_teacher_forced_bound': tf32_bound,
          'decode_window_profile': window_profile})


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = phase_env()
    phase_build()
    main_kernel = phase_kernel()
    model, launches = phase_forward()
    phase_serve(model, env['device'])
    print(json.dumps({'kernels': [dict(
        name='flash_attention_fwd', route='cuda',
        source='skypilot_tpu_torch/ops/csrc/flash_attention_fwd.cu',
        replaces='skypilot_tpu/ops/flash_attention.py:146',
        launches=launches, **main_kernel)]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
