"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --kernels        # the kernel checks and times only
    python3 chip_smoke.py --planted-faults # the bounds' planted-fault check

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card and times all three
at bench_torch.py's headline shape (seq 8192), drives the port's main
paths -- bench_torch.py whole (llama-800m training at seq 8192 and 2048,
in a subprocess), the llama-1b no-cache forward (tokens [1, 1024]),
offline serving through the dense-cache engine, the HTTP server (16
concurrent requests through /generate, its SSE stream and
/v1/completions, again with decode lookahead and the adaptive window on,
then a drain), the block-paged KV pool (against the dense engine, the
radix prefix cache on and off, a tight pool with the host tier, the
hot-prefix handoff between two servers), chunked prefill (prompts past
the largest bucket offline, and long prompts arriving while streams
decode, chunking off and on), prompt scoring (against the no-cache
forward, and the lm-eval loglikelihood pattern over HTTP), the fp8 KV
cache (the card's cast against the CPU's bytes, dense and paged serving,
an fp8 handoff), registered prefixes (/cache_prefix over HTTP,
--auto-prefix, a paged prefix with a tail block, the tight-pool
force-admit, a pinned radix prefix), prompt-lookup speculative decoding
(dense and paged, lookup and oracle drafts), QoS (weighted-fair
queueing across two tenants, chunk-boundary preemption of batch prompts
by interactive arrivals, the typed deadline sheds), training of
llama-1b at batch 8 x 2048 through the Trainer, LoRA (frozen-base
rank-16 adapter training of llama-1b through the Trainer, then
multi-LoRA serving of the trained adapter and two random ones beside the
base through server.run() and POST /load_adapter, and a paged radix
pool keyed by adapter), then Gemma at head_dim
256 (the gemma-7b no-cache forward and greedy requests through the
dense engine, gemma-2b training at batch 8 x 2048), and llama2-7b from an
HF-named state dict through the HF import, quantized to int8 on the card
and served with the fp8 cache at examples/serve_llama2_7b_int8.yaml's
flags, then GPT-2 (gpt2 trained at examples/gpt2_managed_spot.yaml's batch
16 x 1024 and resumed from a checkpoint bit for bit, gpt2-large served
through server.run() over HTTP) and Mixtral (mixtral-8x7b at 16 of 32
layers served at examples/serve_mixtral.yaml's engine flags over the fp8
and a bf16 cache against a drop-free scorer, and trained at depth 2),
then BERT and ResNet through their task loops (bert-base fine-tuned at
examples/bert_imdb.yaml's settings with its masked path and its HF
import, resnet50 trained at examples/resnet.yaml's) and frozen-base LoRA
on Mixtral at depth 2, then the mesh trainer on a one-rank NCCL group
(llama3-8b at 4 layers, then LoRA under the mesh at
examples/finetune_llama31.yaml's rank 16), the multi-chip dryrun, and
tensor-parallel serving on two gloo ranks sharing the card (llama2-7b,
Mixtral, multi-LoRA with int8 weights and the fp8 cache, gpt2-large) --
at full width with random weights from a seed, and checks what comes
out.  Every phase prints one JSON line; any failed
check raises, so the script exits non-zero and the closing line is never
printed.  The last two lines are the kernels line
and {"ok": true, "device": {...}}.

--kernels runs only the kernel checks and their timings.
--planted-faults builds copies of the three kernels, each with one
deliberate fault (forward: O's rescale skipped, V read from the wrong ring
stage, the diagonal tile's mask skipped, one 16-key slice of P dropped
from P V; each backward kernel: delta dropped, one K tile shifted by a
row, the diagonal tile's mask skipped, and K (dQ) or dO (dK/dV) read from
the wrong ring stage) and, at head_dim 256, one more each (the upper half
of P V or dS K reading the lower half's columns, dK/dV's second
warpgroup taking P^T of the next kv row), under build/planted_faults/,
and shows that each copy fails the bound the smoke run holds the sound
kernels to.

Needs a CUDA card (exits non-zero without one) and imports nothing of
JAX or of the JAX package.
"""
import base64
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import os
import pathlib
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from http.client import HTTPConnection
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from skypilot_tpu_torch.analysis import sanitizers
from skypilot_tpu_torch.entry import entry
from skypilot_tpu_torch.infer import engine as engine_mod
from skypilot_tpu_torch.infer import server
from skypilot_tpu_torch.infer.chaos import (DegradedReplica, KillableReplica,
                                            free_port)
from skypilot_tpu_torch.infer.faults import FaultPlan, FaultSpec
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request)
from skypilot_tpu_torch.models import hf_import, llama
from skypilot_tpu_torch.models.convert import init_params, iter_params
from skypilot_tpu_torch.models.mixtral import MixtralConfig
from skypilot_tpu_torch.models.registry import build_model, get_model_config
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.train import lora, tasks
from skypilot_tpu_torch.train import trainer as train_lib

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its operations over the peak rate of their type and
# its bytes (each input read once, each output written once) over HBM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


# The serving phases (serve through chaos) run llama-1b at SERVE_LAYERS of
# its 22 layers: the whole run has 1,200 s, the serve_tp phase came to it,
# and a slow host stretched every host-bound phase by up to a quarter.
# Their checks count launches by the model's own depth and their
# teacher-forced bounds were set at the full depth, which only loosens
# them at less.
SERVE_LAYERS = 4
SERVE_PHASES = ('serve', 'server', 'paged', 'chunked', 'prompt_logprobs',
                'fp8', 'prefix', 'spec', 'qos', 'chaos')


def emit(obj) -> None:
    if obj.get('phase') in SERVE_PHASES:
        obj = {**obj, 'reduced': f'llama-1b depth 22 -> {SERVE_LAYERS} '
                                 '(the run\'s 1,200 s)'}
    print(json.dumps(obj), flush=True)


def shallower(model, num_layers: int):
    """`model`'s first `num_layers` decoder layers under its embedding,
    final norm and head: the same tensors, a new module."""
    cfg = dataclasses.replace(model.config, num_layers=num_layers)
    out = llama.Llama(cfg, device='cuda').eval()
    out.load_state_dict({k: v for k, v in model.state_dict().items()
                         if not k.startswith('layers.')
                         or int(k.split('.')[1]) < num_layers})
    return out


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


def in_turns(fns, timer=cuda_ms) -> tuple:
    """Times of each fn by `timer`, taken in turns -- the fns in order,
    then in reverse (kernel, library, library, kernel for two) -- so that
    a drift of the card's clocks falls on all.  Returns (the mean of each
    fn's two readings, every reading in the order taken)."""
    order = [*range(len(fns)), *reversed(range(len(fns)))]
    turns = [timer(fns[i]) for i in order]
    return ([(turns[i] + turns[len(order) - 1 - i]) / 2
             for i in range(len(fns))], turns)


def visible_pairs(s, causal, window) -> int:
    """The (query, key) pairs of one head that attention computes."""
    i = np.arange(s)
    if not causal:
        return s * s
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.sum(i - lo + 1))


def attention_bound(b, hq, hkv, s, d, dtype, causal, window,
                    ops_per_pair_d=4, n_q=2, n_kv=2, n_rows=1):
    """Least time (ms) for one attention kernel on these inputs, and what
    sets it: visible (query, key) pairs x ops_per_pair_d * D FLOPs at the
    peak rate of the dtype, against the bytes it must move at the HBM
    rate -- n_q tensors shaped like q, n_kv like k and n_rows f32 [B, Hq,
    S] rows, each read or written once.  The forward: 4*D (Q K^T, P V),
    Q and O, K and V, LSE."""
    pairs = visible_pairs(s, causal, window)
    ops_ms = 1e3 * ops_per_pair_d * b * hq * d * pairs / PEAK_FLOPS[dtype]
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (n_q * b * hq * s * d + n_kv * b * hkv * s * d)
              + 4 * n_rows * b * hq * s)
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


KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dkv')


def phase_build() -> None:
    t0 = time.perf_counter()
    secs = _build.build(KERNELS)   # one nvcc per source, all at once
    for name in KERNELS:            # ptxas register / spill reports
        log = _build.library_path(name).with_suffix('.log')
        print(log.read_text(), file=sys.stderr, flush=True)
    emit({'phase': 'build', 'nvcc_s': secs,
          'wall_s': time.perf_counter() - t0})


# The training shape: llama-1b at TrainConfig() (batch 8, seq 2048), what
# the train step gives all three kernels; every kernel is timed there.
TRAIN_CASE = ('llama-1b-train', 8, 16, 8, 2048, 128, torch.bfloat16, True,
              None)
# The head_dim-256 shapes: the gemma-7b forward (tokens [1, 1024], MHA)
# and the gemma-2b train step (batch 8 x 2048, MQA: one kv head for 8 q
# heads, folded inside the dK/dV kernel); every kernel is timed at the
# second, the forward at both.
GEMMA_FWD_CASE = ('gemma-7b', 1, 16, 16, 1024, 256, torch.bfloat16, True,
                  None)
GEMMA_TRAIN_CASE = ('gemma-2b-train', 8, 8, 1, 2048, 256, torch.bfloat16,
                    True, None)
# The int8 llama2-7b no-cache forward (int8_hf's teacher-forced
# reference): MHA 32:32 at head_dim 128 over prompt + output, at most
# 250 + 31 = 281 tokens, which leaves the last 128-row tiles ragged.
INT8_FWD_CASE = ('llama2-7b', 1, 32, 32, 281, 128, torch.bfloat16, True,
                 None)
# The twelfth slice's shapes.  gpt2 at examples/gpt2_managed_spot.yaml's
# batch 16 x seq 1024: MHA at head_dim 64 (the dK/dV group fold is 1).
# The gpt2-large teacher-forced reference: MHA 20:20 at head_dim 64 over
# prompt + output, at most 250 + 31 = 281 tokens (ragged last tiles).
# mixtral-8x7b's train step at depth 2, batch 4 x 2048: GQA 32:8.
GPT2_TRAIN_CASE = ('gpt2-train', 16, 12, 12, 1024, 64, torch.bfloat16, True,
                   None)
GPT2_LARGE_FWD_CASE = ('gpt2-large', 1, 20, 20, 281, 64, torch.bfloat16,
                       True, None)
MIXTRAL_TRAIN_CASE = ('mixtral-train', 4, 32, 8, 2048, 128, torch.bfloat16,
                      True, None)
SLICE12_FWD = (GPT2_TRAIN_CASE[0], GPT2_LARGE_FWD_CASE[0],
               MIXTRAL_TRAIN_CASE[0])
SLICE12_BWD = (GPT2_TRAIN_CASE[0], MIXTRAL_TRAIN_CASE[0])
# BERT's self-attention: non-causal MHA at head_dim 64 -- bert-base
# fine-tuned at examples/bert_imdb.yaml's batch 32 x seq 128 (one full
# 128-row tile each way, b*hq = 384), and batch 8 at max_seq_len 512.
# Mixtral's LoRA step runs MIXTRAL_TRAIN_CASE.
BERT_TRAIN_CASE = ('bert-base-train', 32, 12, 12, 128, 64, torch.bfloat16,
                   False, None)
BERT_MAX_LEN_CASE = ('bert-base-512', 8, 12, 12, 512, 64, torch.bfloat16,
                     False, None)
BERT_SHAPES = (BERT_TRAIN_CASE[0], BERT_MAX_LEN_CASE[0])
# Tensor-parallel serving (serve_tp): llama2-7b's no-cache forward on one
# of two ranks, 16 of its 32 heads over prompt + output (at most 281
# tokens).  Past the old grid limit: batch 4,097 x 16 q heads = 65,552
# (batch x heads) blocks on gridDim.x, beyond y's 65,535.
TP_FWD_CASE = ('llama2-7b-tp2', 1, 16, 16, 281, 128, torch.bfloat16, True,
               None)
GRID_CASE = ('grid_4097x16', 4097, 16, 8, 128, 64, torch.bfloat16, True,
             None)
# The sixteenth slice's shapes: gpt2 trained at tensor=2
# (examples/gpt2_managed_spot.yaml's 16 x 1024, 6 of 12 heads a rank: the
# kernel phases only, since DTensor's collectives do not run over gloo on
# CUDA tensors and NCCL refuses two ranks on the one card) and
# gpt2-large's teacher-forced scorer at tp=2 (serve_tp: 10 of 20 heads
# over prompt + output, at most 281 tokens).
GPT2_TP_TRAIN_CASE = ('gpt2-train-tp2', 16, 6, 6, 1024, 64, torch.bfloat16,
                      True, None)
GPT2_LARGE_TP_FWD_CASE = ('gpt2-large-tp2', 1, 10, 10, 281, 64,
                          torch.bfloat16, True, None)
SLICE16_FWD = (GPT2_TP_TRAIN_CASE[0], GPT2_LARGE_TP_FWD_CASE[0])
SLICE16_BWD = (GPT2_TP_TRAIN_CASE[0],)
# (name, b, hq, hkv, s, d, dtype, causal, window); the first is the shape
# the llama-1b forward gives the kernel, timed as well.  The bf16 kernel
# works in 128-row tiles up to head_dim 128: ragged_1088 and
# non_causal_1088 leave the last q and kv tiles half full at full width,
# window_300 starts the kv loop past tile 0.  At head_dim 256 the kv tiles
# (and dQ's q tiles) have 64 rows: S 200 leaves every last tile ragged,
# S 1088 the forward's last 128-row q tile half full.
KERNEL_CASES = [
    ('llama-1b', 1, 16, 8, 1024, 128, torch.bfloat16, True, None),
    TRAIN_CASE,
    ('non_causal', 1, 16, 8, 1024, 128, torch.bfloat16, False, None),
    ('window_48', 2, 8, 2, 256, 128, torch.bfloat16, True, 48),
    ('head_dim_64', 2, 8, 2, 256, 64, torch.bfloat16, True, None),
    ('ragged_200', 1, 4, 2, 200, 128, torch.bfloat16, True, None),
    ('ragged_1088', 1, 16, 8, 1088, 128, torch.bfloat16, True, None),
    ('window_300_d64', 1, 8, 2, 1088, 64, torch.bfloat16, True, 300),
    ('non_causal_1088', 1, 16, 8, 1088, 128, torch.bfloat16, False, None),
    INT8_FWD_CASE,
    ('f32', 1, 8, 4, 200, 128, torch.float32, True, None),
    ('f32_window_d64', 2, 8, 2, 256, 64, torch.float32, True, 48),
    GEMMA_FWD_CASE,
    GEMMA_TRAIN_CASE,
    ('ragged_200_d256', 1, 4, 2, 200, 256, torch.bfloat16, True, None),
    ('ragged_1088_d256_mqa', 1, 8, 1, 1088, 256, torch.bfloat16, True, None),
    ('window_300_d256_mqa', 1, 8, 1, 1088, 256, torch.bfloat16, True, 300),
    ('non_causal_1088_d256', 1, 16, 16, 1088, 256, torch.bfloat16, False,
     None),
    ('f32_mqa_d256', 1, 8, 1, 200, 256, torch.float32, True, None),
    ('f32_window_d256', 1, 4, 2, 256, 256, torch.float32, True, 48),
    GPT2_TRAIN_CASE,
    GPT2_LARGE_FWD_CASE,
    MIXTRAL_TRAIN_CASE,
    BERT_TRAIN_CASE,
    BERT_MAX_LEN_CASE,
    TP_FWD_CASE,
    GRID_CASE,
    GPT2_TP_TRAIN_CASE,
    GPT2_LARGE_TP_FWD_CASE,
]
# The forward is timed at these shapes.
TIMED_FWD = (KERNEL_CASES[0][0], TRAIN_CASE[0], GEMMA_FWD_CASE[0],
             GEMMA_TRAIN_CASE[0], *SLICE12_FWD, *BERT_SHAPES, TP_FWD_CASE[0],
             GRID_CASE[0], *SLICE16_FWD)


# Agreement of the forward kernel with its plain version (same inputs; the
# plain version computes in f32): O element by element within
# fa.attention_fwd_bound (its docstring has the reasons), the LSE -- f32
# on both sides -- within 1e-4.
BOUND_LSE = 1e-4


def fwd_errors(q, k, v, causal, scale, window, ref) -> dict:
    """The forward kernel's errors against the plain version's (O, LSE)
    `ref`; `max_err_over_bound` is the worst element of |O error| over its
    bound."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
    torch.cuda.synchronize()
    diff = (out.float() - ref[0].float()).abs()
    return {'max_abs_err': diff.max().item(),
            'mean_abs_err': diff.mean().item(),
            'max_err_over_bound': (diff / fa.attention_fwd_bound(
                q, k, v, causal, scale, window, ref[0])).max().item(),
            'max_abs_err_lse': (lse - ref[1]).abs().max().item()}


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of fn: the kernels it runs, summed by
    torch.profiler over `reps` calls.  At small shapes the CUDA-event time
    of back-to-back calls is the host's launch rate, not the device's."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def time_fwd(q, k, v, causal, scale, window) -> dict:
    """The forward kernel and scaled_dot_product_attention's forward in
    turns, by CUDA events and by the profiler's device time; the plain
    version; the bound and the kernel's rate (from the CUDA-event time)."""
    b, hq, s, d = q.shape
    args = (q, k, v, causal, scale, window)

    def kernel():
        return fa.flash_attention_fwd(*args)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    with torch.no_grad():
        (ms, library_ms), turns = in_turns((kernel, library))
        (dev_ms, library_dev_ms), dev = in_turns((kernel, library),
                                                 device_ms)
    bound_ms, bound_by = attention_bound(b, hq, k.shape[1], s, d, q.dtype,
                                         causal, window)
    flops = 4 * b * hq * d * visible_pairs(s, causal, window)
    return {'ms': ms, 'library_ms': library_ms,
            'turns_kernel_library_library_kernel': turns,
            'device_ms': dev_ms, 'library_device_ms': library_dev_ms,
            'device_turns': dev,
            'plain_ms': cuda_ms(lambda: fa.attention_fwd_reference(*args),
                                iters=3, warmup=1),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'tflop_per_s': flops / (ms * 1e9),
            'share_of_bound': bound_ms / ms}


def phase_kernel() -> dict:
    """The forward kernel against its plain version at every KERNEL_CASES
    shape, timed at the TIMED_FWD shapes.  Returns their errors and times
    by case name."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    failures, timed = [], {}
    for name, b, hq, hkv, s, d, dtype, causal, window in KERNEL_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen,
                               device='cuda').to(dtype)
                   for h in (hq, hkv, hkv))
        scale = d ** -0.5
        ref = fa.attention_fwd_reference(q, k, v, causal, scale, window)
        errs = fwd_errors(q, k, v, causal, scale, window, ref)
        row = {'phase': 'kernel', 'case': name, 'shape': [b, hq, hkv, s, d],
               'dtype': str(dtype), 'causal': causal, 'window': window,
               **errs, 'mean_abs_o': ref[0].float().abs().mean().item(),
               'max_abs_o': ref[0].float().abs().max().item(),
               'bound_lse': BOUND_LSE}
        if not (errs['max_err_over_bound'] <= 1.0
                and errs['max_abs_err_lse'] <= BOUND_LSE):
            failures.append(name)
        if name in TIMED_FWD:
            timed[name] = {**errs, **time_fwd(q, k, v, causal, scale,
                                               window)}
            row['timing'] = timed[name]
        emit(row)
        del q, k, v, ref
        torch.cuda.empty_cache()
    check(not failures, f'kernel disagrees with its plain version: {failures}')
    return timed


# The training shape, then the forward's other KERNEL_CASES: the bf16
# backward kernels work in 128-row tiles too up to head_dim 128 (dK/dV:
# KV tiles, dQ: q tiles), which the 1088 cases leave half full, and in
# 64-row tiles at head_dim 256.  Both kernels are timed at both training
# shapes.
BWD_CASES = [TRAIN_CASE] + KERNEL_CASES[2:]
TIMED_BWD = (TRAIN_CASE[0], GEMMA_TRAIN_CASE[0], *SLICE12_BWD,
             *BERT_SHAPES, *SLICE16_BWD)

# Agreement of the backward kernels with their plain versions (same q, k,
# v, dO, LSE and delta; the plain versions compute in f32): dQ, dK and dV
# element by element within fa.attention_bwd_bound (its docstring has the
# reasons).


def bwd_inputs(gen, b, hq, hkv, s, d, dtype, causal, window) -> tuple:
    """The arguments of both backward kernels and their plain versions:
    random q, k, v, dO; O and LSE from the plain forward; delta =
    rowsum(dO * O) in f32, as the autograd Function forms it."""
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                               device='cuda').to(dtype)
                   for h in (hq, hkv, hkv, hq))
    scale = d ** -0.5
    out, lse = fa.attention_fwd_reference(q, k, v, causal, scale, window)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, causal, scale, window


def run_bwd(args) -> tuple:
    """(dQ, dK, dV) from the two kernels."""
    return (fa.flash_attention_bwd_dq(*args),
            *fa.flash_attention_bwd_dkv(*args))


def plain_bwd(args) -> tuple:
    return (fa.attention_bwd_dq_reference(*args),
            *fa.attention_bwd_dkv_reference(*args))


def bwd_errors(got, ref, bounds) -> dict:
    """Max abs error and max error over the bound, for dq, dk and dv."""
    out = {}
    for name, g, r, bd in zip(('dq', 'dk', 'dv'), got, ref, bounds):
        diff = (g.float() - r.float()).abs()
        out[name] = {'max_abs_err': diff.max().item(),
                     'max_abs': r.float().abs().max().item(),
                     'max_err_over_bound':
                         (diff / bd.clamp_min(1e-30)).max().item()}
    return out


def time_bwd(args) -> dict:
    """Times at the training shape: the dQ kernel, the dK/dV kernel and
    their yardstick, scaled_dot_product_attention's backward alone (one
    call computes dQ, dK and dV), in turns (dQ, dK/dV, SDPA, SDPA, dK/dV,
    dQ) by CUDA events and by the profiler's device time; the plain
    versions; each kernel's bound, rate and share of its bound (from the
    CUDA-event time); and the pair's sums."""
    q, k, v, do, lse, delta, causal, scale, window = args
    b, hq, s, d = q.shape
    shape = (b, hq, k.shape[1], s, d, q.dtype, causal, window)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=causal, enable_gqa=True)
    fns = (lambda: fa.flash_attention_bwd_dq(*args),
           lambda: fa.flash_attention_bwd_dkv(*args),
           lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                       retain_graph=True))
    ms, turns = in_turns(fns)
    dev, dev_turns = in_turns(fns, device_ms)
    del out
    pairs = visible_pairs(s, causal, window)
    timing = {'pair': {
        'ms': ms[0] + ms[1], 'device_ms': dev[0] + dev[1],
        'library_ms': ms[2], 'library_device_ms': dev[2],
        'turns_dq_dkv_library_library_dkv_dq': turns,
        'device_turns': dev_turns}}
    for i, (name, plain, bound_args) in enumerate((
            ('dq', fa.attention_bwd_dq_reference, (6, 3, 2, 2)),
            ('dkv', fa.attention_bwd_dkv_reference, (8, 2, 4, 2)))):
        bound_ms, bound_by = attention_bound(*shape, *bound_args)
        flops = bound_args[0] * b * hq * d * pairs
        timing[name] = {'ms': ms[i], 'device_ms': dev[i],
                        'plain_ms': cuda_ms(lambda: plain(*args), iters=3,
                                            warmup=1),
                        'bound_ms': bound_ms, 'bound_by': bound_by,
                        'library_ms': ms[2], 'library_device_ms': dev[2],
                        'tflop_per_s': flops / (ms[i] * 1e9),
                        'share_of_bound': bound_ms / ms[i]}
    return timing


def phase_kernel_bwd() -> dict:
    """Both backward kernels against their plain versions at every
    BWD_CASES shape, deterministic, timed at the TIMED_BWD shapes.
    Returns the times by case name."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    failures, timed = [], {}
    for name, b, hq, hkv, s, d, dtype, causal, window in BWD_CASES:
        args = bwd_inputs(gen, b, hq, hkv, s, d, dtype, causal, window)
        got = run_bwd(args)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(x, y)
                            for x, y in zip(got, run_bwd(args)))
        ref = plain_bwd(args)
        errs = bwd_errors(got, ref, fa.attention_bwd_bound(*args, ref))
        row = {'phase': 'kernel_bwd', 'case': name,
               'shape': [b, hq, hkv, s, d], 'dtype': str(dtype),
               'causal': causal, 'window': window,
               'deterministic': deterministic, **errs}
        if not deterministic or any(e['max_err_over_bound'] > 1.0
                                    for e in errs.values()):
            failures.append(name)
        del got, ref
        if name in TIMED_BWD:
            timing = time_bwd(args)
            timing['dq']['max_abs_err'] = errs['dq']['max_abs_err']
            timing['dkv']['max_abs_err'] = max(errs['dk']['max_abs_err'],
                                               errs['dv']['max_abs_err'])
            row['timing'] = timed[name] = timing
        emit(row)
        del args
        torch.cuda.empty_cache()
    check(not failures,
          f'backward kernels disagree with their plain versions or are not '
          f'deterministic: {failures}')
    return timed


# The headline shape of bench_torch.py: llama-800m at seq 8192, batch 6.
# The whole batch at once would need about 25 GB of f32 scores per plain
# version; batch rows are independent in the kernels and in the plain
# versions, so agreement is held one row at a time (about 4.3 GB a score
# tensor, a few at once).
HEADLINE_CASE = ('llama-800m-8192', 6, 16, 8, 8192, 128, torch.bfloat16,
                 True, None)


def timed_call(fn) -> tuple:
    """(fn()'s result, the CUDA-event time in ms of a second call)."""
    out = fn()
    return out, cuda_ms(fn, iters=1, warmup=0)


def headline_errors(args, out, lse, grads) -> tuple:
    """The kernels' full-batch outputs (O, LSE; dQ, dK, dV) against the
    plain versions on the same inputs, one batch row at a time, within
    the KERNEL_CASES bounds (fa.attention_fwd_bound and BOUND_LSE,
    fa.attention_bwd_bound).  Returns (the worst errors of each kernel,
    the plain versions' times in ms summed over the rows)."""
    q, k, v, do, full_lse, delta, causal, scale, window = args
    fwd, bwd = {}, {}
    plain = {'fwd': 0.0, 'dq': 0.0, 'dkv': 0.0}
    for i in range(q.shape[0]):
        qi, ki, vi, doi = (t[i:i + 1] for t in (q, k, v, do))
        row = (qi, ki, vi, doi, full_lse[i:i + 1], delta[i:i + 1], causal,
               scale, window)
        ref, ms = timed_call(lambda: fa.attention_fwd_reference(
            qi, ki, vi, causal, scale, window))
        plain['fwd'] += ms
        diff = (out[i:i + 1].float() - ref[0].float()).abs()
        bound = fa.attention_fwd_bound(qi, ki, vi, causal, scale, window,
                                       ref[0])
        for key, val in (('max_abs_err', diff.max().item()),
                         ('max_err_over_bound', (diff / bound).max().item()),
                         ('max_abs_err_lse',
                          (lse[i:i + 1] - ref[1]).abs().max().item())):
            fwd[key] = float(np.maximum(fwd.get(key, 0.0), val))  # NaN wins
        del ref, diff, bound
        dq, ms = timed_call(lambda: fa.attention_bwd_dq_reference(*row))
        plain['dq'] += ms
        dkv, ms = timed_call(lambda: fa.attention_bwd_dkv_reference(*row))
        plain['dkv'] += ms
        ref = (dq, *dkv)
        errs = bwd_errors([g[i:i + 1] for g in grads], ref,
                          fa.attention_bwd_bound(*row, ref))
        for name, e in errs.items():
            for key, val in e.items():
                bwd.setdefault(name, {})[key] = float(np.maximum(
                    bwd.get(name, {}).get(key, 0.0), val))
        del dq, dkv, ref
        torch.cuda.empty_cache()
    return {'fwd': fwd, **bwd}, plain


def phase_kernel_headline() -> dict:
    """All three kernels at the headline shape: the full batch launched
    at once, held against the plain versions row by row
    (headline_errors), and timed each in turns with
    scaled_dot_product_attention (forward: kernel, library, library,
    kernel; backward: dQ, dK/dV, library, library, dK/dV, dQ), with
    their bounds."""
    name, b, hq, hkv, s, d, dtype, causal, window = HEADLINE_CASE
    gen = torch.Generator(device='cuda').manual_seed(2)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                               device='cuda').to(dtype)
                   for h in (hq, hkv, hkv, hq))
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal, scale, window)
        grads = run_bwd(args)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all())
                  for t in (out, lse, *grads)),
              'non-finite kernel output at the headline shape')
        errs, plain = headline_errors(args, out, lse, grads)
        del grads
        (fwd_ms, fwd_lib_ms), fwd_turns = in_turns((
            lambda: fa.flash_attention_fwd(*args[:3], causal, scale, window),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)))
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=causal, enable_gqa=True)
    ms, turns = in_turns((
        lambda: fa.flash_attention_bwd_dq(*args),
        lambda: fa.flash_attention_bwd_dkv(*args),
        lambda: torch.autograd.grad(ref, (qr, kr, vr), do,
                                    retain_graph=True)))
    del ref, qr, kr, vr
    shape = (b, hq, hkv, s, d, dtype, causal, window)
    pairs = visible_pairs(s, causal, window)
    timing = {}
    for key, t_ms, lib_ms, bound_args, max_abs in (
            ('fwd', fwd_ms, fwd_lib_ms, (4, 2, 2, 1),
             errs['fwd']['max_abs_err']),
            ('dq', ms[0], ms[2], (6, 3, 2, 2), errs['dq']['max_abs_err']),
            ('dkv', ms[1], ms[2], (8, 2, 4, 2),
             max(errs['dk']['max_abs_err'], errs['dv']['max_abs_err']))):
        bound_ms, bound_by = attention_bound(*shape, *bound_args)
        timing[key] = {'ms': t_ms, 'library_ms': lib_ms,
                       'plain_ms': plain[key], 'max_abs_err': max_abs,
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       'tflop_per_s': (bound_args[0] * b * hq * d * pairs
                                       / (t_ms * 1e9)),
                       'share_of_bound': bound_ms / t_ms}
    emit({'phase': 'kernel_headline', 'case': name,
          'shape': [b, hq, hkv, s, d], 'dtype': str(dtype),
          'causal': causal, 'errors_row_by_row': errs,
          'bound_lse': BOUND_LSE,
          'plain_ms_summed_over_rows': plain,
          'fwd_turns_kernel_library_library_kernel': fwd_turns,
          'bwd_turns_dq_dkv_library_library_dkv_dq': turns, **timing})
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()
    failures = [key for key, e in errs.items()
                if not e['max_err_over_bound'] <= 1.0]
    if not errs['fwd']['max_abs_err_lse'] <= BOUND_LSE:
        failures.append('lse')
    check(not failures, f'kernels disagree with their plain versions at '
          f'the headline shape: {failures}')
    return timing


# bench_torch.py's points: (detail key, batch); each runs 1 + 3 x 10 steps,
# and every step launches the forward kernel twice per layer (full remat)
# and each backward kernel once.
BENCH_POINTS = (('seq8192', 6), ('seq2048', 24))
BENCH_STEPS = 1 + 3 * 10


def phase_bench(card: str) -> tuple:
    """bench_torch.py whole, in a subprocess (the script as a user runs
    it): its JSON line must carry finite losses, positive throughput, an
    MFU under 1.05 and the launch counts of every step.  Returns the
    kernels' launches summed over both points."""
    torch.cuda.empty_cache()
    script = pathlib.Path(__file__).resolve().parent / 'bench_torch.py'
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=900, cwd=script.parent)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f'bench_torch.py exited {proc.returncode}: {proc.stderr[-2000:]}')
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    layers = 16       # llama-800m
    want = [2 * layers * BENCH_STEPS, layers * BENCH_STEPS,
            layers * BENCH_STEPS]
    launches = [0, 0, 0]
    for key, batch in BENCH_POINTS:
        pt = line['detail'][key]
        check(pt['batch_per_chip'] == batch and
              math.isfinite(pt['final_loss']) and
              pt['raw_tokens_per_sec_per_chip'] > 0 and
              pt['mfu'] is not None and 0 < pt['mfu'] < 1.05,
              f'bench point {key}: {pt}')
        check(pt['flash_launches_fwd_dq_dkv'] == want,
              f'bench point {key} launched {pt["flash_launches_fwd_dq_dkv"]}'
              f', expected {want}')
        launches = [a + x for a, x in zip(launches,
                                          pt['flash_launches_fwd_dq_dkv'])]
    check(line['detail']['platform'] == 'gpu' and line['value'] > 0,
          f'bench line: {line}')
    emit({'phase': 'bench', 'device': card, 'wall_s': wall,
          'result': line})
    return tuple(launches)


def launch_counts() -> tuple:
    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches)


def reset_launch_counts() -> None:
    fa.flash_fwd_launches = 0
    fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0


def counted(fn, tally: list):
    """fn() with the kernels' launch counts set to 0 just before it and
    read just after, added into tally [fwd, dq, dkv]; returns fn()'s
    result.  Keeps a path's launches apart from its checks' forwards."""
    reset_launch_counts()
    out = fn()
    for i, n in enumerate(launch_counts()):
        tally[i] += n
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor,
            floor: float = 1e-30) -> float:
    """max |got - want| over max |want| (at least `floor`; on the CPU, in
    f32)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), floor)


def grad_errors(got: dict, want: dict) -> tuple:
    """The worst gradient's rel_err and its name: each gradient against
    its own max, floored at 1e-3 of the largest gradient of the model --
    a gradient whose exact value is 0 (BERT's key bias: a softmax takes a
    shift of a row's scores) holds rounding alone on both sides."""
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    errs = {n: rel_err(g, want[n], floor) for n, g in got.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def launches_per_step(run) -> tuple:
    """run(wrap) with the kernels' counts set to 0 just before; `wrap`
    wraps a batch iterator so that the counts are read as each step takes
    its batch.  Returns (run's result, the launches of each step, the
    total)."""
    counts = []

    def wrap(batches):
        for batch in batches:
            counts.append(launch_counts())
            yield batch

    reset_launch_counts()
    out = run(wrap)
    torch.cuda.synchronize()
    counts.append(launch_counts())
    return out, [[b - a for a, b in zip(c0, c1)]
                 for c0, c1 in zip(counts, counts[1:])], counts[-1]


def stderr_log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


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
    # Device activity only: the rows below are device-side kernels, and
    # recording the host's ops too multiplies the events the profiler
    # post-processes (seconds a window at llama2-7b's 48 slots).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side kernels only: a user annotation (Optimizer.step) also
    # shows a device-side range, which would count its kernels twice.
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
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
    reset_launch_counts()
    logits = forward(model, tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts[0]
    check(counts == (model.config.num_layers, 0, 0),
          f'forward launched the kernels {counts} times, expected '
          f'{(model.config.num_layers, 0, 0)}')
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


def teacher_forced_gaps(model, results, use_cache: bool = False,
                        cache_dtype=None) -> torch.Tensor:
    """|logprob| gap, token by token, between what the engine reported
    for each generated token and a forward over prompt + output: the
    no-cache forward (flash kernel) or, with use_cache, the cached forward
    (the engine's own attention path) over a fresh cache of cache_dtype
    (the model's dtype by default).  Every request's gaps, concatenated,
    on the host."""
    reported = torch.cat([torch.tensor(r.logprobs) for r in results])
    return (teacher_forced_logprobs(model, results, use_cache, cache_dtype)
            - reported).abs()


def teacher_forced_logprobs(model, results, use_cache: bool = False,
                            cache_dtype=None) -> torch.Tensor:
    """The logprob `model` gives each generated token after prompt +
    output (see teacher_forced_gaps), concatenated, on the host."""
    dev = next(model.parameters()).device
    out = []
    for r in results:
        toks = r.prompt_tokens + r.output_tokens[:-1]
        seq = torch.tensor([toks], device=dev)
        with torch.inference_mode():
            if use_cache:
                cache = llama.init_cache(model.config, 1, len(toks),
                                         cache_dtype or model.config.dtype,
                                         dev)
                pos = torch.arange(len(toks), device=dev)[None]
                logits = model(seq, pos, cache)[0]
            else:
                logits = model(seq)
            lp = torch.log_softmax(logits[0], dim=-1)
        n = len(r.prompt_tokens)
        pos = torch.arange(n - 1, n - 1 + len(r.output_tokens), device=dev)
        out.append(lp[pos, torch.tensor(r.output_tokens, device=dev)].cpu())
    return torch.cat(out)


def teacher_forced_err(model, results, use_cache: bool = False,
                       cache_dtype=None) -> float:
    """The largest of teacher_forced_gaps."""
    return teacher_forced_gaps(model, results, use_cache,
                               cache_dtype).max().item()


def serve_prompts(vocab: int) -> tuple:
    """The serve phase's 12 requests from a seed: prompts of 20-250
    tokens, 10 greedy and 2 at temperature 0.8."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(rng.integers(20, 251))).tolist()
               for _ in range(12)]
    return prompts, [0.0] * 10 + [0.8] * 2


def phase_serve(model, card: str) -> None:
    cfg = InferConfig(model='llama-1b', num_slots=8, max_cache_len=1024,
                      prefill_buckets=(64, 128, 256), decode_steps=8,
                      max_new_tokens=32)
    engine = InferenceEngine(model.config, cfg, params=model.state_dict(),
                             generator=torch.Generator(
                                 device='cuda').manual_seed(1))
    prompts, temps = serve_prompts(model.config.vocab_size)

    def run():
        reqs = [Request(tokens=p, temperature=t, request_id=str(i))
                for i, (p, t) in enumerate(zip(prompts, temps))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(reqs)
        return res, time.perf_counter() - t0

    reset_launch_counts()
    first, first_wall = run()
    second, wall = run()
    serve_launches = launch_counts()[0]
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
        torch.zeros(n_slots, device='cuda'), cfg.decode_steps)[0])

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


def http(port: int, method: str, path: str, body=None,
         timeout: float = 600.0) -> tuple:
    """(status, headers, JSON body or the list of SSE `data:` payloads)."""
    conn = HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        data, headers = resp.read(), dict(resp.getheaders())
    finally:
        conn.close()
    if headers.get('Content-Type') == 'text/event-stream':
        return resp.status, headers, [
            ev[6:].decode() if ev[6:] == b'[DONE]' else json.loads(ev[6:])
            for ev in data.split(b'\n\n') if ev.startswith(b'data: ')]
    return resp.status, headers, json.loads(data)


def start_server(engine) -> tuple:
    """The port's serve() on 127.0.0.1 in a daemon thread, warm-up on,
    polled until ready (wait_ready); returns (port, thread, warm-up
    seconds, statuses seen)."""
    port = free_port()
    thread = threading.Thread(target=server.serve, args=(engine,),
                              kwargs=dict(host='127.0.0.1', port=port,
                                          warmup=True), daemon=True)
    return (port, thread, *wait_ready(port, thread))


def wait_ready(port: int, thread: threading.Thread) -> tuple:
    """Start the server thread and poll /healthz from the moment the
    listener answers until it says ok; returns (warm-up seconds,
    statuses seen): 503 starting, then 200 ok."""
    t0 = time.perf_counter()
    thread.start()
    statuses = []
    while time.perf_counter() - t0 < 600:
        try:
            code, _, doc = http(port, 'GET', '/healthz', timeout=10)
        except OSError:              # not listening yet
            time.sleep(0.01)
            continue
        if not statuses or statuses[-1] != (code, doc['status']):
            statuses.append((code, doc['status']))
        if code == 200:
            break
        time.sleep(0.05)
    warm_s = time.perf_counter() - t0
    check(statuses[:1] == [(503, 'starting')] and
          statuses[-1] == (200, 'ok'),
          f'/healthz went {statuses}, expected 503 starting then 200 ok')
    return warm_s, statuses


SERVER_NEW_TOKENS = 32


def server_requests(vocab: int) -> list:
    """The 16 requests of the server phase, from a seed: (kind, path,
    body).  Prompts of 20-1000 tokens, 32 new tokens each: 8 plain greedy
    /generate, 4 SSE /generate repeating the first 4 plain prompts, one
    /v1/completions prompt (token array, temperature 0) plain and
    streamed, 2 plain /generate at temperature 0.8."""
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, vocab, int(rng.integers(20, 1001))).tolist()

    plain = [prompt() for _ in range(8)]
    comp, sampled = prompt(), [prompt() for _ in range(2)]
    n = SERVER_NEW_TOKENS
    return ([('plain', '/generate',
              {'tokens': p, 'max_new_tokens': n, 'logprobs': True})
             for p in plain] +
            [('sse', '/generate',
              {'tokens': p, 'max_new_tokens': n, 'stream': True})
             for p in plain[:4]] +
            [('completion', '/v1/completions',
              {'prompt': comp, 'max_tokens': n, 'temperature': 0,
               'logprobs': 1}),
             ('completion_sse', '/v1/completions',
              {'prompt': comp, 'max_tokens': n, 'temperature': 0,
               'stream': True})] +
            [('sampled', '/generate',
              {'tokens': p, 'max_new_tokens': n, 'temperature': 0.8})
             for p in sampled])


def post_all(port: int, requests: list) -> tuple:
    """Post every request at once, one thread each; returns the replies
    in request order and the wall seconds of the burst."""
    replies = [None] * len(requests)
    go = threading.Barrier(len(requests) + 1)

    def one(i, path, body):
        go.wait()
        replies[i] = http(port, 'POST', path, body)

    threads = [threading.Thread(target=one, args=(i, path, body))
               for i, (_, path, body) in enumerate(requests)]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return replies, time.perf_counter() - t0


def read_replies(requests: list, replies: list) -> dict:
    """Check every reply and pull out what each request generated: every
    reply 200 with 32 tokens, each stream's chunks concatenating to its
    final tokens, each repeated greedy prompt giving the same tokens
    plain and streamed.  Returns the greedy results (prompt, tokens,
    logprobs where the reply carries them), the server TTFTs and the
    number of new tokens."""
    greedy, ttfts, n_tok = {}, [], 0
    for i, ((kind, _, body), (code, _, doc)) in enumerate(
            zip(requests, replies)):
        check(code == 200, f'request {i} ({kind}) answered {code}: {doc}')
        prompt = body.get('tokens') or body.get('prompt')
        lps = None
        if kind in ('plain', 'sampled'):
            tokens, lps = doc['output_tokens'], doc.get('logprobs')
            ttfts.append(doc['ttft_s'])
        elif kind == 'sse':
            done = doc[-1]
            streamed = [t for ev in doc[:-1] for t in ev['tokens']]
            check(done['done'] and streamed == done['output_tokens'],
                  f'request {i}: SSE chunks {streamed} do not concatenate '
                  f'to {done["output_tokens"]}')
            tokens, lps = done['output_tokens'], done['logprobs']
            ttfts.append(done['ttft_s'])
        elif kind == 'completion':
            choice = doc['choices'][0]
            tokens, lps = choice['tokens'], \
                choice['logprobs']['token_logprobs']
        else:                                          # completion_sse
            check(doc[-1] == '[DONE]', f'request {i}: no [DONE]')
            tokens = [t for ev in doc[:-1]
                      for t in ev['choices'][0].get('tokens', [])]
        check(len(tokens) == SERVER_NEW_TOKENS,
              f'request {i} ({kind}): {len(tokens)} tokens')
        n_tok += len(tokens)
        if kind != 'sampled':
            greedy[i] = types.SimpleNamespace(
                kind=kind, prompt_tokens=prompt, output_tokens=tokens,
                logprobs=lps)
    for i, r in greedy.items():
        twin = next(j for j, q in greedy.items()
                    if q.prompt_tokens == r.prompt_tokens)
        check(r.output_tokens == greedy[twin].output_tokens,
              f'requests {twin} and {i}: one prompt, two greedy outputs')
    return {'greedy': greedy, 'ttfts': ttfts, 'new_tokens': n_tok}


def drain_check(port: int, thread: threading.Thread, vocab: int) -> dict:
    """POST /drain while 4 long requests are in flight: /healthz turns
    503 with X-SkyTpu-Draining: 1, a new /generate gets 503 with
    Retry-After, the in-flight requests finish with 200, and serve()
    returns."""
    rng = np.random.default_rng(1)
    long = [('plain', '/generate',
             {'tokens': rng.integers(0, vocab, 200).tolist(),
              'max_new_tokens': 256}) for _ in range(4)]
    replies = [None] * 4

    def one(i):
        replies[i] = http(port, 'POST', long[i][1], long[i][2])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    while http(port, 'GET', '/healthz')[2]['inflight'] < 4:
        check(time.perf_counter() - t0 < 60, 'requests never in flight')
        time.sleep(0.01)
    code, _, doc = http(port, 'POST', '/drain', {'deadline_s': 300})
    check(code == 200 and doc['status'] == 'draining',
          f'/drain answered {code} {doc}')
    code, headers, doc = http(port, 'GET', '/healthz')
    check(code == 503 and headers.get('X-SkyTpu-Draining') == '1' and
          doc['status'] == 'draining' and doc['inflight'] > 0,
          f'/healthz while draining: {code} {headers} {doc}')
    code, headers, doc = http(port, 'POST', '/generate',
                              {'tokens': [1, 2, 3], 'max_new_tokens': 4})
    check(code == 503 and 'Retry-After' in headers and
          headers.get('X-SkyTpu-Draining') == '1',
          f'/generate while draining: {code} {headers} {doc}')
    for t in threads:
        t.join()
    for code, _, doc in replies:
        check(code == 200 and len(doc['output_tokens']) == 256,
              f'in-flight request during the drain: {code} {doc}')
    thread.join(timeout=120)
    check(not thread.is_alive(), 'serve() did not return after the drain')
    return {'inflight_finished': 4, 'drain_s': time.perf_counter() - t0}


def profile_windows(engine, vocab: int, windows: int = 4) -> dict:
    """Decode windows over all 8 slots as the serving loop runs them
    (lookahead engages only there), under profile_device: one call runs
    `windows` windows.  Run with the serving loop stopped."""
    rng = np.random.default_rng(2)
    with engine._lock:
        items = []
        for slot in range(engine.cfg.num_slots):
            req = Request(tokens=rng.integers(0, vocab, 256).tolist(),
                          max_new_tokens=1024)
            items.append((req, slot, time.time(),
                          *engine._validate_request(req)))
        engine._start_batch(items)
        engine._serving = True

        def run():
            for _ in range(windows):
                engine._decode_step()

        try:
            run()                                  # steady state
            prof = profile_device(run)
        finally:
            engine._ahead = None
            engine._serving = False
            for i, s in enumerate(engine._slots):
                if s is not None:
                    engine._finish_slot(i, 'cancelled')
    return {'windows': windows, **prof,
            'wall_ms_per_window': prof['wall_ms'] / windows,
            'device_ms_per_window': (None if prof['device_ms'] is None
                                     else prof['device_ms'] / windows)}


def burst(port: int, requests: list) -> tuple:
    """The 16 requests at once; returns (report, greedy results)."""
    replies, wall = post_all(port, requests)
    got = read_replies(requests, replies)
    ttfts = np.array(got['ttfts'])
    return {'wall_s': wall, 'new_tokens': got['new_tokens'],
            'tok_per_s': got['new_tokens'] / wall,
            'ttft_s_mean': float(ttfts.mean()),
            'ttft_s_p50': float(np.percentile(ttfts, 50)),
            'ttft_s_p90': float(np.percentile(ttfts, 90))}, got['greedy']


# The server phase's two engines, and the order their bursts run in:
# in turns, so that a drift of the host or the card falls on both.
SERVER_CONFIGS = {
    'lookahead_off': {},
    'lookahead_on': {'decode_lookahead': True,
                     'adaptive_decode_window': True},
}
SERVER_TURNS = ('lookahead_off', 'lookahead_on', 'lookahead_on',
                'lookahead_off', 'lookahead_off', 'lookahead_on')


def phase_server(model, env: dict) -> None:
    """The port's HTTP server at llama-1b full width and depth, bf16, its
    defaults (8 slots, cache 2048, the default buckets, decode_steps 8),
    twice over the forward phase's weights: as configured, and with
    decode lookahead and the adaptive window on.  Readiness of each; the
    16 concurrent requests three times on each, in turns, greedy tokens
    identical across all six; the teacher-forced bound; a drain with
    requests in flight; the decode window's device and wall time with
    lookahead off and on."""
    vocab = model.config.vocab_size
    requests = server_requests(vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    servers = {}
    for name, options in SERVER_CONFIGS.items():
        engine = InferenceEngine(model.config,
                                 InferConfig(model='llama-1b', **options),
                                 params=model.state_dict(),
                                 generator=torch.Generator(
                                     device='cuda').manual_seed(1))
        port, thread, warm_s, statuses = start_server(engine)
        servers[name] = {'engine': engine, 'port': port, 'thread': thread,
                         'report': {'warmup_s': warm_s,
                                    'healthz': statuses, 'bursts': []}}
    first = None
    for name in SERVER_TURNS:
        report, greedy = burst(servers[name]['port'], requests)
        servers[name]['report']['bursts'].append(report)
        tokens = {i: r.output_tokens for i, r in greedy.items()}
        if first is None:
            first, first_greedy = tokens, greedy
        check(tokens == first, f'greedy tokens of a {name} burst differ '
                               'from the first burst')
    for name, srv in servers.items():
        rep = srv['report']
        for key in ('tok_per_s', 'ttft_s_mean', 'ttft_s_p50', 'ttft_s_p90'):
            rep[key + '_median'] = float(np.median(
                [b[key] for b in rep['bursts']]))
    off, on = servers['lookahead_off'], servers['lookahead_on']
    drain = drain_check(off['port'], off['thread'], vocab)
    code, _, _ = http(on['port'], 'POST', '/drain', {'deadline_s': 60})
    on['thread'].join(timeout=120)
    check(code == 200 and not on['thread'].is_alive(),
          'the second server did not drain')
    windows = {name: profile_windows(srv['engine'], vocab)
               for name, srv in servers.items()}
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # The bf16 bound of the serve phase: the engine's logprob of each
    # generated token against the no-cache forward (flash kernel) over
    # prompt + output.
    tf_bound = 0.25
    tf_err = teacher_forced_err(
        off['engine'].model,
        [r for r in first_greedy.values() if r.logprobs is not None])
    check(tf_err <= tf_bound, f'teacher-forced logprobs differ by {tf_err}')
    reports = {name: srv['report'] for name, srv in servers.items()}
    del servers, off, on
    torch.cuda.empty_cache()
    emit({'phase': 'server', 'model': 'llama-1b',
          'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
          'config': {'num_slots': 8, 'max_cache_len': 2048,
                     'decode_steps': 8, 'dtype': 'bfloat16'},
          'requests': len(requests),
          'prompt_lens': [len(b.get('tokens') or b['prompt'])
                          for _, _, b in requests],
          'turns': list(SERVER_TURNS),
          # The server's path attends through decode_attention, as the
          # JAX engine does: no flash launches are expected here.
          'flash_launches': list(launches),
          **reports,
          'greedy_identical_across_bursts': True,
          'teacher_forced_max_abs_err': tf_err,
          'teacher_forced_bound': tf_bound,
          'drain': drain,
          'decode_window_lookahead_off': windows['lookahead_off'],
          'decode_window_lookahead_on': windows['lookahead_on'],
          'max_memory_allocated_gib': peak_gib})


# The paged phase's engines: llama-1b bf16 at the server's defaults (8
# slots, cache 2048, the default buckets, decode_steps 8) with 16-token
# blocks; the tight pool holds about three full-length requests.
PAGED_BLOCK = 16
PAGED_NEW_TOKENS = 32
TIGHT_BLOCKS = 3 * (2048 // PAGED_BLOCK) + 1
TIER_BYTES = 512 << 20


def paged_engine(model, **options) -> InferenceEngine:
    options = {'kv_block_size': PAGED_BLOCK, **options}
    return InferenceEngine(
        model.config, InferConfig(model='llama-1b',
                                  max_new_tokens=PAGED_NEW_TOKENS,
                                  **options),
        params=model.state_dict(), device=model.embedding.device,
        generator=torch.Generator(
            device=model.embedding.device).manual_seed(1))


def conservation_errors(eng) -> list:
    """The pool's block-conservation law, as the port's sanitizer checks
    it (each block's refcount equals its holders -- slot table entries, a
    radix node, a registered prefix entry, 1 for the dump block 0 -- the
    free list is exactly the unheld blocks, the host tier's ledger
    balances), read without the engine's lock (the window audit runs
    inside it), plus a clause the sanitizer lacks: idle slots (neither
    active nor chunking) hold none."""
    errors = [f'idle slot {slot} holds {int(eng._slot_nblocks[slot])} blocks'
              for slot in range(eng.cfg.num_slots)
              if int(eng._slot_nblocks[slot]) and eng._slots[slot] is None
              and slot not in eng._chunking]
    try:
        sanitizers.check_block_conservation(eng, lock=False)
    except sanitizers.BlockLeakError as e:
        errors += e.errors
    return errors


def audited_windows(eng) -> list:
    """Check the conservation law after every decode window the engine
    runs from now on; returns the list the window count and any
    violation land in."""
    log = [0]
    step = eng._step

    def audited():
        step()
        log[0] += 1
        log.extend(conservation_errors(eng))

    eng._step = audited
    return log


def first_diffs(a: list, b: list) -> list:
    """Per request pair: the first index where two greedy outputs differ,
    None where they agree."""
    return [next((i for i, (x, y) in enumerate(
        zip(r.output_tokens, q.output_tokens)) if x != y), None)
        for r, q in zip(a, b)]


def radix_requests(vocab: int) -> list:
    """16 requests behind one seeded 1024-token system prompt, suffixes of
    16-200 tokens, 32 new tokens each, greedy."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 1024).tolist()
    return [system + rng.integers(0, vocab,
                                  int(rng.integers(16, 201))).tolist()
            for _ in range(16)]


def wave(engine, prompts: list) -> tuple:
    """One offline wave through generate(); (results, report): wall, TTFT
    p50 from submission, tok/s and the radix counters it moved."""
    hits0 = engine.radix_stats['hits']
    blocks0 = engine.paged_stats['prefix_block_hits']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate([Request(tokens=p, request_id=str(i))
                           for i, p in enumerate(prompts)])
    wall = time.perf_counter() - t0
    for r in res:
        check(r.finish_reason == 'length' and
              len(r.output_tokens) == PAGED_NEW_TOKENS,
              f'request {r.request_id}: {r.finish_reason} ({r.error})')
    n_tok = sum(len(r.output_tokens) for r in res)
    return res, {'wall_s': wall, 'tok_per_s': n_tok / wall,
                 'ttft_s_p50': float(np.percentile(
                     [r.ttft_s for r in res], 50)),
                 'radix_hits': engine.radix_stats['hits'] - hits0,
                 'hit_blocks': (engine.paged_stats['prefix_block_hits']
                                - blocks0)}


def pool_rows(engine, blocks: list) -> tuple:
    """Pool rows of `blocks` as [n, L, Hkv, bs, D] (k, v) device tensors."""
    idx = torch.tensor(blocks, device=engine.device)
    return (torch.stack([kp[idx] for kp, _ in engine.cache], dim=1),
            torch.stack([vp[idx] for _, vp in engine.cache], dim=1))


def payload_rows(prefix: dict, shape: tuple, device) -> tuple:
    """A /hot_prefixes prefix's blocks decoded as [n, L, Hkv, bs, D] bf16
    (k, v): the wire's raw little-endian bytes."""
    def rows(key):
        return torch.stack([torch.frombuffer(
            bytearray(base64.b64decode(rec[key])),
            dtype=torch.bfloat16).reshape(shape)
            for rec in prefix['blocks']]).to(device)
    return rows('k'), rows('v')


def phase_paged(model, env: dict) -> None:
    """The block-paged pool at llama-1b full width and depth, bf16, the
    server's defaults with 16-token blocks, over the forward phase's
    weights: (a) the serve phase's 12 requests through a fully
    provisioned pool (1025 blocks) against the dense engine; (b) 16
    requests behind a shared 1024-token system prompt, two waves with
    the radix cache on and off in turns; (c) (b) again on a pool of
    three full requests with a 512 MiB host tier, the conservation law
    checked after every window; (d) two servers: /hot_prefixes from (b)'s
    radix engine, /adopt_blocks into a fresh one, then a hot request
    there (lookahead on).  No flash kernel runs on this path (the engine attends
    through decode_attention over the gathered blocks)."""
    vocab = model.config.vocab_size
    bf16_bound = 0.25          # the serve phase's teacher-forced bound
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    # (a) Paged against dense.
    prompts, temps = serve_prompts(vocab)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    out = {}
    for name, options in (('dense', {'kv_block_size': 0}), ('paged', {})):
        engine = paged_engine(model, **options)
        check(name == 'dense' or engine._num_blocks == 1025,
              f'the full pool has {engine._num_blocks} blocks')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate([Request(tokens=p, temperature=t,
                                       request_id=str(i))
                               for i, (p, t) in enumerate(zip(prompts,
                                                              temps))])
        wall = time.perf_counter() - t0
        for r in res:
            check(r.finish_reason == 'length',
                  f'{name} request {r.request_id}: {r.finish_reason}')
        out[name] = ([res[i] for i in greedy], wall, engine)
    # A decode window over 8 slots at 256 prompt tokens on each engine, in
    # turns: the paged one attends over a 512-row gathered view, the
    # dense one over all 2048 rows of its cache.
    windows = {'dense': [], 'paged': []}
    for name in ('dense', 'paged', 'paged', 'dense'):
        windows[name].append(profile_windows(out[name][2], vocab))
    paged_res, paged_wall, paged_eng = out['paged']
    launches_a = launch_counts()
    gap_a = teacher_forced_err(paged_eng.model, paged_res)
    check(gap_a <= bf16_bound, f'paged teacher-forced gap {gap_a}')
    n_tok = sum(len(r.output_tokens) for r in paged_res)
    report_a = {'requests': len(prompts), 'pool_blocks': 1025,
                'first_diff_vs_dense': first_diffs(paged_res, out['dense'][0]),
                'teacher_forced_max_abs_err': gap_a,
                'teacher_forced_bound': bf16_bound,
                'paged_wall_s': paged_wall, 'dense_wall_s': out['dense'][1],
                'paged_greedy_tok_per_s': n_tok / paged_wall,
                'kv': paged_eng.stats()['kv']['blocks'],
                'decode_window': {
                    name: [{k: w[k] for k in ('wall_ms_per_window',
                                              'device_ms_per_window',
                                              'idle_share', 'top')}
                           for w in ws] for name, ws in windows.items()}}
    del out, paged_eng
    torch.cuda.empty_cache()

    # (b) Radix on and off, in turns.
    reset_launch_counts()
    system_prompts = radix_requests(vocab)
    engines = {'radix_on': paged_engine(model, auto_prefix_cache=True),
               'radix_off': paged_engine(model)}
    report_b = {name: [] for name in engines}
    results_b = {}
    for turn in ('radix_on', 'radix_off', 'radix_on', 'radix_off'):
        res, rep = wave(engines[turn], system_prompts)
        report_b[turn].append(rep)
        results_b.setdefault(turn, []).append(res)
    launches_b = launch_counts()
    second = report_b['radix_on'][1]
    check(second['hit_blocks'] >= 8 * 64,
          f'second radix wave hit {second["hit_blocks"]} blocks')
    gap_b = teacher_forced_err(engines['radix_on'].model,
                               results_b['radix_on'][1])
    check(gap_b <= bf16_bound, f'radix teacher-forced gap {gap_b}')
    report_b.update(
        teacher_forced_max_abs_err=gap_b, teacher_forced_bound=bf16_bound,
        first_diff_on_vs_off=first_diffs(results_b['radix_on'][1],
                                         results_b['radix_off'][1]),
        radix=engines['radix_on'].stats()['kv']['radix'])
    radix_engine = engines['radix_on']
    del engines
    torch.cuda.empty_cache()

    # (c) A pool of three full requests and the host tier.
    reset_launch_counts()
    tight = paged_engine(model, auto_prefix_cache=True,
                         kv_blocks=TIGHT_BLOCKS, host_kv_bytes=TIER_BYTES)
    audit = audited_windows(tight)
    waves_c = [wave(tight, system_prompts) for _ in range(2)]
    launches_c = launch_counts()
    del tight._step
    tier = tight.stats()['kv']['host_tier']
    deferred = tight.stats()['admission_deferred']
    check(audit[0] > 0 and audit[1:] == [],
          f'conservation after {audit[0]} windows: {audit[1:]}')
    check(tier['spills'] > 0 and tier['restores'] > 0,
          f'host tier: {tier}')
    check(deferred > 0, 'a pool of three requests deferred nothing')
    gap_c = max(teacher_forced_err(tight.model, res) for res, _ in waves_c)
    check(gap_c <= bf16_bound, f'tight-pool teacher-forced gap {gap_c}')
    report_c = {'kv_blocks': TIGHT_BLOCKS, 'host_kv_bytes': TIER_BYTES,
                'waves': [rep for _, rep in waves_c],
                'windows_audited': audit[0], 'conservation_errors': 0,
                'admission_deferred': deferred, 'host_tier': tier,
                'first_diff_vs_full_pool': first_diffs(
                    waves_c[1][0], results_b['radix_on'][1]),
                'teacher_forced_max_abs_err': gap_c,
                'teacher_forced_bound': bf16_bound}
    del tight
    torch.cuda.empty_cache()

    # (d) The drain-time handoff between two port servers.
    reset_launch_counts()
    src_port, src_thread, _, _ = start_server(radix_engine)
    # The survivor serves with decode lookahead and the adaptive window:
    # the paged tables of a window queued ahead come from host mirrors.
    dst_engine = paged_engine(model, auto_prefix_cache=True,
                              decode_lookahead=True,
                              adaptive_decode_window=True)
    dst_port, dst_thread, _, _ = start_server(dst_engine)
    # The warm-up's prompts are now the newest leaves of the source's
    # tree: one more request behind the system prompt makes that path
    # the hottest again, as live traffic would.
    body = {'tokens': system_prompts[0], 'max_new_tokens': 2}
    check(http(src_port, 'POST', '/generate', body)[0] == 200,
          'the source server did not serve')
    t0 = time.perf_counter()
    code, _, payload = http(src_port, 'GET', '/hot_prefixes')
    export_s = time.perf_counter() - t0
    check(code == 200 and payload['cache_dtype'] == 'bfloat16' and
          payload['prefixes'], f'/hot_prefixes answered {code}')
    hot = payload['prefixes'][0]
    check(hot['tokens'][:1024] == system_prompts[0][:1024],
          'the hottest prefix is not the system prompt')
    t0 = time.perf_counter()
    code, _, adopted = http(dst_port, 'POST', '/adopt_blocks',
                            {**payload, 'prefixes': [hot]})
    adopt_s = time.perf_counter() - t0
    n_blocks = len(hot['blocks'])
    check(code == 200 and adopted['adopted_blocks'] == n_blocks,
          f'/adopt_blocks answered {code} {adopted}')
    mc = model.config
    shape = (mc.num_layers, mc.num_kv_heads, PAGED_BLOCK, mc.head_dim_)
    blocks = dst_engine._radix.peek(None, hot['tokens'], len(hot['tokens']))
    check(len(blocks) == n_blocks, f'{len(blocks)} blocks in the tree')
    got, sent = pool_rows(dst_engine, blocks), payload_rows(hot, shape, dst_engine.device)
    check(all(torch.equal(a, b) for a, b in zip(got, sent)),
          'adopted pool rows differ from the exported bytes')
    probe = system_prompts[0][:1024] + list(range(5, 105))
    hits = dst_engine.radix_stats['hits']
    body = {'tokens': probe, 'max_new_tokens': PAGED_NEW_TOKENS}
    code, _, doc = http(dst_port, 'POST', '/generate', body)
    check(code == 200 and dst_engine.radix_stats['hits'] == hits + 1,
          f'the hot request on the survivor: {code}, radix hits '
          f'{dst_engine.radix_stats["hits"] - hits}')
    _, _, src_doc = http(src_port, 'POST', '/generate', body)
    launches_d = launch_counts()
    for port_, thread in ((src_port, src_thread), (dst_port, dst_thread)):
        http(port_, 'POST', '/drain', {'deadline_s': 60})
        thread.join(timeout=120)
        check(not thread.is_alive(), 'a paged server did not drain')
    report_d = {'exported_prefixes': len(payload['prefixes']),
                'adopted_blocks': n_blocks,
                'payload_mb': len(json.dumps(payload)) / 1e6,
                'export_s': export_s, 'adopt_s': adopt_s,
                'rows_identical': True, 'survivor_radix_hit': True,
                'greedy_same_as_exporter': (doc['output_tokens'] ==
                                            src_doc['output_tokens'])}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del radix_engine, dst_engine
    torch.cuda.empty_cache()
    emit({'phase': 'paged', 'model': 'llama-1b',
          'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
          'config': {'num_slots': 8, 'max_cache_len': 2048,
                     'decode_steps': 8, 'kv_block_size': PAGED_BLOCK,
                     'dtype': 'bfloat16'},
          # Attention over the gathered blocks is decode_attention, as in
          # the JAX engine: no flash launch is expected on this path.
          'flash_launches': {'a': list(launches_a), 'b': list(launches_b),
                             'c': list(launches_c), 'd': list(launches_d)},
          'a_paged_vs_dense': report_a, 'b_radix': report_b,
          'c_tight_pool_tier': report_c, 'd_handoff': report_d,
          'max_memory_allocated_gib': peak_gib})


# Chunked prefill at llama-1b full width: 256-row chunks, buckets up to
# 1024, prompts of 1100-2000 tokens (past the largest bucket).
CHUNK_ROWS = 256
CHUNK_BUCKETS = (64, 128, 256, 512, 1024)
CHUNK_NEW_TOKENS = 32
# Serving: 8 streams decode STREAM_NEW_TOKENS each while 4 long prompts
# arrive; 12 slots hold all of them.
STREAM_NEW_TOKENS = 160


def chunk_engine(model, chunk: int, **options) -> InferenceEngine:
    return InferenceEngine(
        model.config, InferConfig(model='llama-1b', num_slots=12,
                                  max_cache_len=2048,
                                  prefill_buckets=CHUNK_BUCKETS,
                                  decode_steps=8,
                                  max_new_tokens=CHUNK_NEW_TOKENS,
                                  prefill_chunk=chunk, **options),
        params=model.state_dict(), device=model.embedding.device,
        generator=torch.Generator(
            device=model.embedding.device).manual_seed(1))


def long_prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(1100, 2001))).tolist()
            for _ in range(4)]


def stream_stall(engine, shorts: list, longs: list) -> tuple:
    """Serve `shorts` as streams, then, once each has had four deliveries,
    let `longs` arrive 20 ms apart.  Returns (results by id, report): the
    worst gap between two deliveries of any stream from the first
    arrival until the last long prompt's first token, the streams'
    median gap before it, and the long prompts' TTFT."""
    q, results, stop = queue.Queue(), {}, threading.Event()
    times = [[] for _ in shorts]
    loop = threading.Thread(target=engine.generate_stream,
                            args=(q, lambda r: results.__setitem__(
                                r.request_id, r), stop), daemon=True)
    loop.start()
    for i, p in enumerate(shorts):
        q.put(Request(tokens=p, max_new_tokens=STREAM_NEW_TOKENS,
                      request_id=f's{i}', arrival_time=time.time(),
                      stream_cb=lambda toks, t=times[i]: t.append(
                          time.perf_counter())))

    def wait(cond, what):
        t0 = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t0 < 300, f'waited 300 s for {what}')
            time.sleep(0.001)

    wait(lambda: all(len(t) >= 4 for t in times),
         'the streams\' first windows')
    arrivals = []
    for j, p in enumerate(longs):
        arrivals.append(time.perf_counter())
        q.put(Request(tokens=p, request_id=f'l{j}',
                      arrival_time=time.time()))
        time.sleep(0.02)
    wait(lambda: len(results) == len(shorts) + len(longs), 'every result')
    stop.set()
    loop.join(timeout=60)
    check(not loop.is_alive(), 'the serving loop did not stop')
    t_arrive = arrivals[0]
    t_first = max(a + results[f'l{j}'].ttft_s
                  for j, a in enumerate(arrivals))
    worst = before = 0.0
    steady = []
    for t in times:
        check(t[-1] > t_first, 'a stream ended before the long prompts '
              'had their first tokens')
        for a, b in zip(t, t[1:]):
            if b < t_arrive:
                steady.append(b - a)
            elif a < t_first:
                worst = max(worst, b - max(a, t_arrive))
    ttft = [results[f'l{j}'].ttft_s for j in range(len(longs))]
    return results, {'worst_gap_ms': 1e3 * worst,
                     'steady_gap_ms_p50': 1e3 * float(np.median(steady)),
                     'long_ttft_s_p50': float(np.median(ttft)),
                     'long_ttft_s': ttft}


def phase_chunked(model, env: dict) -> None:
    """Chunked prefill at llama-1b full width and depth, bf16, dense and
    paged (16-token blocks): (a) offline, four prompts of 1100-2000
    tokens past the largest bucket chunk 256 rows a round; (b) serving,
    8 streams decode while the four arrive, chunking off and on in turns
    (dense: off, on, on, off; paged: on, off): the streams' worst
    inter-token gap and the long prompts' TTFT.  Checks: every request's tokens against the no-cache
    forward over its prompt + output (teacher-forced, 0.25 nats, the
    serve phase's bf16 bound) and, paged, the conservation law after
    every window."""
    vocab = model.config.vocab_size
    longs = long_prompts(vocab, seed=5)
    rng = np.random.default_rng(6)
    shorts = [rng.integers(0, vocab, int(rng.integers(100, 201))).tolist()
              for _ in range(8)]
    launches = [0, 0, 0]
    report = {}
    for layout, options, order in (
            ('dense', {}, ('off', 'on', 'on', 'off')),
            ('paged', {'kv_block_size': PAGED_BLOCK}, ('on', 'off'))):
        eng = chunk_engine(model, CHUNK_ROWS, **options)
        audit = audited_windows(eng) if eng._paged else [0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = counted(lambda: eng.generate([
            Request(tokens=p, request_id=str(i))
            for i, p in enumerate(longs)]), launches)
        wall = time.perf_counter() - t0
        for r in res:
            check(r.finish_reason == 'length' and
                  len(r.output_tokens) == CHUNK_NEW_TOKENS,
                  f'{layout} long request {r.request_id}: '
                  f'{r.finish_reason} ({r.error})')
        check(eng.chunk_stats['requests'] == len(longs),
              f'{layout}: chunk_stats {eng.chunk_stats}')
        tf_err = teacher_forced_err(eng.model, res)
        check(tf_err <= 0.25,
              f'{layout} chunked: teacher-forced logprobs differ by {tf_err}')
        check(len(audit) == 1, f'{layout} conservation: {audit[1:6]}')
        offline = {'wall_s': wall, 'chunk_stats': dict(eng.chunk_stats),
                   'teacher_forced_max_abs_err': tf_err,
                   'windows_audited': audit[0]}
        del eng, audit
        gc.collect()
        torch.cuda.empty_cache()
        engines = {'off': chunk_engine(model, 0, **options),
                   'on': chunk_engine(model, CHUNK_ROWS, **options)}
        audits = {k: audited_windows(e) if e._paged else [0]
                  for k, e in engines.items()}
        turns = []
        for turn in order:
            results, rep = counted(lambda: stream_stall(
                engines[turn], shorts, longs), launches)
            for r in results.values():
                check(r.finish_reason == 'length', f'{layout} {turn} '
                      f'{r.request_id}: {r.finish_reason} ({r.error})')
            tf_err = teacher_forced_err(
                model, [results[f'l{j}'] for j in range(len(longs))])
            check(tf_err <= 0.25, f'{layout} serving {turn}: '
                  f'teacher-forced logprobs differ by {tf_err}')
            turns.append({'chunking': turn, **rep,
                          'teacher_forced_max_abs_err': tf_err})
        for k, log in audits.items():
            check(len(log) == 1, f'{layout} {k} conservation: {log[1:6]}')
        report[layout] = {
            'offline': offline, 'serving_turns': turns,
            'chunk_stats_on': dict(engines['on'].chunk_stats),
            'windows_audited': {k: log[0] for k, log in audits.items()}}
        del engines, audits
        gc.collect()          # the audits' closures hold their engines
        torch.cuda.empty_cache()
    emit({'phase': 'chunked', 'model': 'llama-1b', 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'],
          'config': {'num_slots': 12, 'max_cache_len': 2048,
                     'prefill_chunk': CHUNK_ROWS,
                     'prefill_buckets': list(CHUNK_BUCKETS),
                     'decode_steps': 8, 'dtype': 'bfloat16',
                     'kv_block_size_paged': PAGED_BLOCK},
          'long_prompt_lens': [len(p) for p in longs],
          'stream_prompt_lens': [len(p) for p in shorts],
          # The engine runs alone (not the teacher-forced checks'
          # forwards): chunks attend through decode_attention, as in the
          # JAX engine, so no flash launch is expected on this path.
          'flash_launches': launches, **report})


def score_errors(model, results) -> float:
    """Max |prompt logprob - log-softmax of the no-cache forward| over
    every scored position (entry 0 has none)."""
    dev = model.embedding.device
    err = 0.0
    for r in results:
        seq = torch.tensor([r.prompt_tokens], device=dev)
        with torch.inference_mode():
            lp = torch.log_softmax(model(seq)[0].float(), dim=-1)
        rows = torch.arange(len(r.prompt_tokens) - 1, device=dev)
        ref = lp[rows, seq[0, 1:]].cpu()
        err = max(err, (ref - torch.tensor(r.prompt_logprobs[1:])
                        ).abs().max().item())
    return err


def phase_prompt_logprobs(model, env: dict) -> None:
    """Prompt scoring at llama-1b full width, bf16: (a) the engine's
    prompt logprobs, dense and paged, against the log-softmax of the
    no-cache forward on the same tokens (0.25 nats, the serve phase's
    bf16 bound); (b) the lm-eval-harness loglikelihood pattern over HTTP
    (/v1/completions with echo, logprobs 1, max_tokens 0) against a port
    server: each continuation's summed score against the same forward
    (0.25 nats a token); is_greedy is recorded beside the forward's
    argmax (bf16 near-ties may flip it, so it is not a check)."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (37, 300, 1000)]
    launches = [0, 0, 0]
    report = {}
    for layout, options in (('dense', {}),
                            ('paged', {'kv_block_size': PAGED_BLOCK,
                                       'auto_prefix_cache': True})):
        eng = chunk_engine(model, 0, **options)
        res = counted(lambda: eng.generate([
            Request(tokens=p, max_new_tokens=4, want_prompt_logprobs=True)
            for p in prompts]), launches)
        for r in res:
            check(r.finish_reason == 'length' and
                  len(r.prompt_logprobs) == len(r.prompt_tokens) and
                  r.prompt_logprobs[0] is None,
                  f'{layout} scored request: {r.finish_reason} ({r.error})')
        err = score_errors(eng.model, res)
        check(err <= 0.25, f'{layout} prompt logprobs differ by {err}')
        report[layout] = {'max_abs_err': err,
                          'radix_lookups': eng.radix_stats['lookups']}
        if eng._radix is not None:
            check(eng.radix_stats['lookups'] == 0,
                  'a scored request looked up the radix tree')
        del eng
        torch.cuda.empty_cache()
    eng = chunk_engine(model, 0)
    port_, thread, warm_s, _ = start_server(eng)
    context = rng.integers(0, vocab, 200).tolist()
    code, _, doc = counted(lambda: http(
        port_, 'POST', '/generate',
        {'tokens': context, 'max_new_tokens': 6}), launches)
    check(code == 200, f'/generate answered {code}: {doc}')
    greedy = doc['output_tokens']
    conts = [greedy, rng.integers(0, vocab, 6).tolist(),
             rng.integers(0, vocab, 20).tolist()]
    rows = []
    for cont in conts:
        code, _, doc = counted(lambda: http(
            port_, 'POST', '/v1/completions', {
                'prompt': context + cont, 'max_tokens': 0, 'echo': True,
                'logprobs': 1, 'temperature': 0}), launches)
        check(code == 200, f'/v1/completions echo answered {code}: {doc}')
        lp = doc['choices'][0]['logprobs']
        check(len(lp['token_logprobs']) == len(context) + len(cont) and
              lp['token_logprobs'][0] is None and
              doc['usage']['completion_tokens'] == 0,
              f'echo reply shape: {doc["usage"]}')
        got = sum(lp['token_logprobs'][-len(cont):])
        got_greedy = all(
            abs(max(t.values()) - x) < 1e-6 for t, x in zip(
                lp['top_logprobs'][-len(cont):],
                lp['token_logprobs'][-len(cont):]))
        seq = torch.tensor([context + cont], device=eng.device)
        with torch.inference_mode():
            ref_lp = torch.log_softmax(eng.model(seq)[0].float(), dim=-1)
        pos = torch.arange(len(context) - 1, len(context) + len(cont) - 1,
                           device=eng.device)
        tok = torch.tensor(cont, device=eng.device)
        want = ref_lp[pos, tok].sum().item()
        want_greedy = bool((ref_lp[pos].argmax(-1) == tok).all())
        check(abs(got - want) <= 0.25 * len(cont),
              f'loglikelihood {got} vs the forward\'s {want}')
        rows.append({'continuation_len': len(cont), 'sum': got,
                     'forward_sum': want, 'is_greedy': got_greedy,
                     'forward_is_greedy': want_greedy})
    http(port_, 'POST', '/drain', {'deadline_s': 60})
    thread.join(timeout=120)
    check(not thread.is_alive(), 'the scoring server did not drain')
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'prompt_logprobs', 'model': 'llama-1b',
          'device': env['device'], 'prompt_lens': [len(p) for p in prompts],
          'engine': report, 'bound_nats': 0.25, 'server_warmup_s': warm_s,
          'lm_eval_pattern': rows,
          # The engine and server alone, as in the chunked phase.
          'flash_launches': launches})


# ------------------------------------------- fp8 cache, prefixes, spec

FP8 = torch.float8_e4m3fn
# The fp8 phase's bound against the no-cache forward: e4m3 keeps 3
# mantissa bits, so each cached K/V value is off by up to 2^-4 of itself
# where bf16's rounding is 2^-9; much of it averages out over 128-wide
# heads, the rest compounds over 22 layers.  Four times the serve phase's
# bf16 bound.  Through the engine's own attention path over a fresh fp8
# cache (the same quantized rows) the bf16 bound stands.
FP8_NO_CACHE_BOUND = 1.0


def fp8_sweep() -> torch.Tensor:
    """bf16 values on the host: normal values at scales 1e-3 .. 300, the
    band 440 .. 1000 around e4m3's largest finite value (448) and its
    overflow past 464, +-464, +-465, +-inf, NaN and the subnormal range,
    both signs."""
    rng = np.random.default_rng(9)
    x = np.concatenate(
        [rng.normal(0, s, 20000) for s in (1e-3, 1e-2, 0.1, 1, 10, 100, 300)]
        + [np.linspace(440, 1000, 5601), [464, 465, 1e6, np.inf, np.nan],
           np.linspace(0, 2 ** -6, 2001), [2 ** -9, 2 ** -10, 3 * 2 ** -11]])
    x = torch.from_numpy(x.astype(np.float32))
    return torch.cat([x, -x]).to(torch.bfloat16)


def serve_engine(model, **options) -> InferenceEngine:
    """An engine at the serve phase's settings (8 slots, cache 1024,
    buckets 64/128/256, decode_steps 8, 32 new tokens) over the forward
    phase's weights."""
    dev = model.embedding.device
    return InferenceEngine(
        model.config, InferConfig(model='llama-1b', num_slots=8,
                                  max_cache_len=1024,
                                  prefill_buckets=(64, 128, 256),
                                  decode_steps=8, max_new_tokens=32,
                                  **options),
        params=model.state_dict(), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))


def cache_bytes(engine) -> int:
    """Bytes the engine's KV cache tensors hold on the card."""
    return sum(t.numel() * t.element_size()
               for kv in engine.cache for t in kv)


def pool_bytes(engine, blocks: list) -> torch.Tensor:
    """Pool rows of `blocks` as bytes [2, n, L, Hkv, bs, D] (k, v)."""
    idx = torch.tensor(blocks, device=engine.device)
    return torch.stack([torch.stack([llama.as_bytes(kv[part])[idx]
                                     for kv in engine.cache], dim=1)
                        for part in (0, 1)])


def window_device_ms(engine, steps: Optional[int] = None) -> dict:
    """One decode window of `steps` steps (the engine's decode_steps by
    default) over every slot at cache position 256 (rows past every
    request's end) under profile_device (dense engines)."""
    n, dev = engine.cfg.num_slots, engine.device
    return profile_device(lambda: engine._decode(
        torch.zeros(n, dtype=torch.long, device=dev),
        torch.full((n,), 256, dtype=torch.long, device=dev),
        torch.zeros(n, device=dev), steps or engine.cfg.decode_steps)[0])


def count_calls(obj, name: str) -> list:
    """Count the calls of obj.<name> from now on (an instance attribute
    over the method); returns the one-element counter."""
    calls = [0]
    fn = getattr(obj, name)

    def counting(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, counting)
    return calls


def timed_generate(engine, requests: list) -> tuple:
    """engine.generate(requests) after a sync; (results, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(requests)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_fp8(model, env: dict) -> None:
    """The fp8 (e4m3) KV cache at llama-1b full width and depth: (a) the
    card's cast (models.llama.to_fp8) over fp8_sweep gives the CPU's
    bytes, which tests/test_torch_fp8.py holds against the JAX cast; (b)
    the dense and the paged engine with an fp8 cache serve the serve
    phase's 12 requests: the teacher-forced gap against the no-cache
    forward within FP8_NO_CACHE_BOUND and through the engine's own
    attention path within 0.25 nats, cache bytes exactly half the bf16
    engine's, the decode window's device time fp8 beside bf16 (recorded);
    (c) the hot-prefix handoff between two fp8 engines gives
    byte-identical pool rows, and a bf16 engine refuses the payload."""
    vocab = model.config.vocab_size
    dev = model.embedding.device
    launches = [0, 0, 0]
    x = fp8_sweep()
    want = llama.to_fp8(x).view(torch.uint8)
    got = llama.to_fp8(x.to(dev)).view(torch.uint8).cpu()
    check(torch.equal(got, want), 'the card\'s fp8 bytes differ from the '
          f'CPU\'s at {int((got != want).sum())} values')
    xf = x.float()
    over = ~(xf.abs() <= 464)
    plain = x.to(dev).to(FP8).view(torch.uint8).cpu()
    cast = {'values': x.numel(), 'overflow_values': int(over.sum()),
            'nan_bytes': int(((want & 0x7F) == 0x7F).sum()),
            'card_equals_cpu': True,
            # What torch's own cast gives past 464 on this card.
            'plain_cast_overflow_bytes': sorted(set(
                plain[over & torch.isfinite(xf)].tolist()))}
    prompts, temps = serve_prompts(vocab)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]

    def requests():
        return [Request(tokens=p, temperature=t, request_id=str(i))
                for i, (p, t) in enumerate(zip(prompts, temps))]

    report = {}
    for layout, options in (('dense', {}),
                            ('paged', {'kv_block_size': PAGED_BLOCK})):
        row = {}
        for name, dtype in (('bfloat16', torch.bfloat16), ('fp8', FP8)):
            eng = serve_engine(model, cache_dtype=dtype, **options)
            counted(lambda: eng.generate(requests()), launches)   # warm
            res, wall = counted(lambda: timed_generate(eng, requests()),
                                launches)
            for r in res:
                check(r.finish_reason == 'length' and
                      len(r.output_tokens) == 32,
                      f'{layout} {name} request {r.request_id}: '
                      f'{r.finish_reason} ({r.error})')
            n_tok = sum(len(r.output_tokens) for r in res)
            entry = {'cache_bytes': cache_bytes(eng),
                     'stats_bytes_total':
                         eng.stats()['kv']['bytes']['total'],
                     'wall_s': wall, 'tok_per_s': n_tok / wall,
                     'greedy': [res[i].output_tokens for i in greedy]}
            if dtype is FP8:
                tf = teacher_forced_err(eng.model, [res[i] for i in greedy])
                tfc = teacher_forced_err(eng.model, [res[i] for i in greedy],
                                         use_cache=True, cache_dtype=FP8)
                check(tf <= FP8_NO_CACHE_BOUND,
                      f'{layout} fp8 teacher-forced gap {tf}')
                check(tfc <= 0.25, f'{layout} fp8 cache-path gap {tfc}')
                entry.update(teacher_forced_max_abs_err=tf,
                             cache_path_max_abs_err=tfc)
            if layout == 'dense':
                entry['decode_window_profile'] = window_device_ms(eng)
            row[name] = entry
            del eng
            torch.cuda.empty_cache()
        half = row['fp8']
        check(2 * half['cache_bytes'] == row['bfloat16']['cache_bytes'] and
              2 * half['stats_bytes_total'] ==
              row['bfloat16']['stats_bytes_total'],
              f'{layout}: fp8 cache {half["cache_bytes"]} bytes, bf16 '
              f'{row["bfloat16"]["cache_bytes"]}')
        same = sum(a == b for a, b in zip(row['fp8'].pop('greedy'),
                                          row['bfloat16'].pop('greedy')))
        row['greedy_streams_identical_to_bf16'] = same
        report[layout] = row
    # (c) the handoff: 4 requests behind the radix phase's 1024-token
    # system prompt on one fp8 radix engine, exported and adopted.
    hot = radix_requests(vocab)[:4]
    a = paged_engine(model, auto_prefix_cache=True, cache_dtype=FP8)
    a.generate([Request(tokens=p) for p in hot])
    t0 = time.perf_counter()
    payload = a.export_hot_prefixes()
    export_s = time.perf_counter() - t0
    check(payload['cache_dtype'] == 'float8_e4m3fn' and
          payload['prefixes'], f'fp8 export: {payload["cache_dtype"]}, '
          f'{len(payload["prefixes"])} prefixes')
    b = paged_engine(model, auto_prefix_cache=True, cache_dtype=FP8)
    t0 = time.perf_counter()
    adopted = b.adopt_prefixes(payload)
    adopt_s = time.perf_counter() - t0
    check(adopted['adopted_blocks'] > 0, f'fp8 adoption: {adopted}')
    compared = 0
    for pref in payload['prefixes']:
        toks = pref['tokens']
        on_b = b._radix.peek(None, toks, len(toks))
        on_a = a._radix.peek(None, toks, len(toks))[:len(on_b)]
        check(len(on_b) == len(pref['blocks']),
              f'{len(on_b)} of {len(pref["blocks"])} blocks adopted')
        check(torch.equal(pool_bytes(a, on_a), pool_bytes(b, on_b)),
              'adopted fp8 rows differ from the exporter\'s')
        compared += len(on_b)
    hits = b.radix_stats['hits']
    probe = [Request(tokens=hot[0][:1024] + [5, 6, 7], max_new_tokens=8)]
    check(b.generate(probe)[0].output_tokens ==
          a.generate(probe)[0].output_tokens,
          'the adopter\'s tokens differ from the exporter\'s')
    check(b.radix_stats['hits'] == hits + 1, 'the probe missed the tree')
    mb = len(json.dumps(payload)) / 1e6
    del a, b
    torch.cuda.empty_cache()
    bf = paged_engine(model, auto_prefix_cache=True)
    try:
        bf.adopt_prefixes(payload)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and 'cache_dtype mismatch' in refused,
          f'a bf16 engine took an fp8 payload ({refused})')
    del bf, payload
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'fp8', 'model': 'llama-1b', 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'], 'cast': cast,
          'requests': len(prompts), 'greedy': len(greedy),
          'teacher_forced_bound': FP8_NO_CACHE_BOUND,
          'cache_path_bound': 0.25, **report,
          'handoff': {**adopted,
                      'blocks_compared': compared, 'payload_mb': mb,
                      'export_s': export_s, 'adopt_s': adopt_s,
                      'bf16_engine_refused': refused},
          # The serving paths attend through decode_attention.
          'flash_launches': launches})


def phase_prefix(model, env: dict) -> None:
    """Registered prefixes at llama-1b full width, bf16.  Dense, over
    HTTP (the server's defaults): 8 requests behind a 1024-token system
    prompt, before and after POST /cache_prefix of it -- 8 hits, 8 x 1024
    tokens reused, the teacher-forced gap within 0.25 nats, TTFT p50
    without and with the prefix and the streams greedy-identical to the
    unprefixed run (recorded: in bf16 the suffix-only prefill's products
    have other shapes).  --auto-prefix (the same engine under an
    InferenceServer with auto_prefix) registers a head on its second
    sighting.  Paged: a 1000-token prefix (62 full blocks and an 8-row
    tail, so paged_copy_blocks runs) with the conservation law after
    every window, and _force_admit_blocks reached by an offline request
    in a 160-block pool held by three prefixes.  Radix: a pinned prefix
    survives waves that evict the rest of a 385-block pool."""
    vocab = model.config.vocab_size
    dev = model.embedding.device
    launches = [0, 0, 0]
    prompts = radix_requests(vocab)[:8]
    system = prompts[0][:1024]
    n_new = PAGED_NEW_TOKENS
    eng = InferenceEngine(model.config, InferConfig(model='llama-1b'),
                          params=model.state_dict(), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    port_, thread, warm_s, _ = start_server(eng)
    reqs = [('plain', '/generate',
             {'tokens': p, 'max_new_tokens': n_new, 'logprobs': True})
            for p in prompts]
    runs = {}
    for name in ('without', 'with'):
        if name == 'with':
            code, _, doc = http(port_, 'POST', '/cache_prefix',
                                {'tokens': system})
            check(code == 200 and doc == {'cached_prefix_len': 1024},
                  f'/cache_prefix answered {code} {doc}')
        replies, wall = counted(lambda: post_all(port_, reqs), launches)
        for code, _, doc in replies:
            check(code == 200 and len(doc['output_tokens']) == n_new,
                  f'prefixed request answered {code}: {doc}')
        runs[name] = {'wall_s': wall, 'replies': replies,
                      'ttft_s_p50': float(np.percentile(
                          [d['ttft_s'] for _, _, d in replies], 50))}
    code, _, st = http(port_, 'GET', '/stats')
    check(st['prefix'] == {'hits': 8, 'tokens_reused': 8 * 1024} and
          st['resident_prefixes'] == 1, f'/stats prefix: {st["prefix"]}')
    results = [types.SimpleNamespace(prompt_tokens=p,
                                     output_tokens=d['output_tokens'],
                                     logprobs=d['logprobs'])
               for p, (_, _, d) in zip(prompts, runs['with']['replies'])]
    tf = teacher_forced_err(eng.model, results)
    check(tf <= 0.25, f'prefixed teacher-forced gap {tf}')
    identical = sum(a[2]['output_tokens'] == b[2]['output_tokens']
                    for a, b in zip(runs['without']['replies'],
                                    runs['with']['replies']))
    http(port_, 'POST', '/drain', {'deadline_s': 60})
    thread.join(timeout=120)
    check(not thread.is_alive(), 'the prefix server did not drain')
    dense = {name: {k: v for k, v in run.items() if k != 'replies'}
             for name, run in runs.items()}
    # --auto-prefix: a second system prompt's 1024-token head (the
    # longest bucket inside a 1100-token prompt) registers on its second
    # sighting, and the third prompt behind it is a hit.
    rng = np.random.default_rng(11)
    head = rng.integers(0, vocab, 1024).tolist()
    srv = server.InferenceServer(eng, auto_prefix=True)
    srv.start()
    check(srv.ready.wait(300), 'the auto-prefix server never got ready')
    key = (None, tuple(head))
    seen = []
    for k in range(3):
        if k == 2:
            t0 = time.perf_counter()
            while key not in eng._prefixes and \
                    time.perf_counter() - t0 < 120:
                time.sleep(0.01)
            hits = dict(eng.prefix_stats)
        res = counted(lambda: srv.submit(Request(
            tokens=head + rng.integers(0, vocab, 76).tolist(),
            max_new_tokens=8)), launches)
        check(res is not None and res.finish_reason == 'length',
              f'auto-prefix request {k}: {res}')
        seen.append(key in eng._prefixes)
    srv.stop()
    check(seen[0] is False and key in eng._prefixes,
          f'auto-prefix registration after sightings: {seen}')
    check(eng.prefix_stats['hits'] == hits['hits'] + 1 and
          eng.prefix_stats['tokens_reused'] ==
          hits['tokens_reused'] + 1024, f'auto-prefix hit: {hits} -> '
          f'{eng.prefix_stats}')
    auto = {'registered_after_sighting': 2, 'third_request_hit': True}
    del eng, srv
    torch.cuda.empty_cache()
    # Paged: a registered prefix with a partial tail block.
    pe = paged_engine(model)
    check(pe.register_prefix(system[:1000]) == 1000, 'paged registration')
    copies = count_calls(pe, '_paged_copy_blocks')
    log = audited_windows(pe)
    res, wall = counted(lambda: timed_generate(
        pe, [Request(tokens=p) for p in prompts]), launches)
    for r in res:
        check(r.finish_reason == 'length', f'paged prefixed: {r.error}')
    check(log[1:] == [], f'conservation: {log[1:6]}')
    check(pe.prefix_stats == {'hits': 8, 'tokens_reused': 8000} and
          copies[0] >= 1 and pe.stats()['blocks_prefix'] == 63,
          f'paged prefix: {pe.prefix_stats}, {copies[0]} copies')
    tf_paged = teacher_forced_err(pe.model, res)
    check(tf_paged <= 0.25, f'paged prefixed teacher-forced gap {tf_paged}')
    paged = {'windows_audited': log[0], 'tail_copies': copies[0],
             'prefix_block_hits': pe.paged_stats['prefix_block_hits'],
             'wall_s': wall, 'teacher_forced_max_abs_err': tf_paged}
    del pe
    torch.cuda.empty_cache()
    # _force_admit_blocks: 160 usable blocks, three 512-token prefixes
    # hold 96; a 1500-token request with 32 new tokens needs 96.
    tight = paged_engine(model, kv_blocks=161, max_prefixes=4)
    for _ in range(3):
        tight.register_prefix(rng.integers(0, vocab, 512).tolist())
    forced = count_calls(tight, '_force_admit_blocks')
    log = audited_windows(tight)
    [big] = counted(lambda: tight.generate([Request(
        tokens=rng.integers(0, vocab, 1500).tolist())]), launches)
    check(big.finish_reason == 'length' and forced[0] >= 1 and
          len(tight._prefixes) == 2 and log[1:] == [] and
          conservation_errors(tight) == [],
          f'force-admit: {big.finish_reason}, {forced[0]} calls, '
          f'{len(tight._prefixes)} prefixes left, {log[1:4]}')
    paged['force_admit'] = {'calls': forced[0], 'prefixes_left': 2,
                            'windows_audited': log[0]}
    del tight
    torch.cuda.empty_cache()
    # Radix: pinning survives eviction waves.
    rx = paged_engine(model, auto_prefix_cache=True, kv_blocks=TIGHT_BLOCKS)
    check(rx.register_prefix(system) == 1024 and rx._radix.pinned == 64,
          f'radix pin: {rx._radix.pinned} nodes')
    log = audited_windows(rx)
    for _ in range(2):
        counted(lambda: rx.generate([Request(
            tokens=rng.integers(0, vocab, int(n)).tolist())
            for n in rng.integers(800, 1001, 8)]), launches)
    hits = dict(rx.radix_stats)
    counted(lambda: rx.generate([Request(tokens=prompts[1])]), launches)
    check(rx.radix_stats['evictions'] > 0 and rx._radix.pinned == 64 and
          rx.radix_stats['hits'] == hits['hits'] + 1 and
          rx.radix_stats['tokens_reused'] >= hits['tokens_reused'] + 1024
          and log[1:] == [],
          f'radix pin through waves: {rx.radix_stats}, pinned '
          f'{rx._radix.pinned}, {log[1:4]}')
    radix = {'pinned_nodes': 64, 'evictions': rx.radix_stats['evictions'],
             'windows_audited': log[0]}
    del rx
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'prefix', 'model': 'llama-1b', 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'], 'system_prompt': 1024,
          'requests': len(prompts), 'server_warmup_s': warm_s,
          'dense_http': {**dense, 'hits': 8, 'tokens_reused': 8 * 1024,
                         'teacher_forced_max_abs_err': tf,
                         'teacher_forced_bound': 0.25,
                         'greedy_identical_to_unprefixed': identical},
          'auto_prefix': auto, 'paged': paged, 'radix': radix,
          'flash_launches': launches})


SPEC_DRAFT = 4


def repetitive_prompts(vocab: int) -> list:
    """8 prompts from a seed, each a 16-token pattern six times over and
    8 tokens more: prompt lookup drafts from the pattern when a stream
    continues it."""
    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, 16).tolist() * 6 +
            rng.integers(0, vocab, 8).tolist() for _ in range(8)]


def phase_spec(model, env: dict) -> None:
    """Prompt-lookup speculative decoding (draft_len 4) at llama-1b full
    width, bf16, dense and paged, against windowed decode at the serve
    phase's settings: (a) prompt lookup on repetitive prompts; (b)
    oracle drafts -- each prompt's windowed greedy continuation, through
    a patched engine.prompt_lookup_draft -- on the serve phase's 12
    requests (2 sampled, which ride the verify at one token).  Random
    weights seldom continue a prompt's pattern, so lookup may find no
    draft at all (then every dispatch is a window).  Checks: accepted <=
    drafted, verify dispatched and accepted > 0 under the oracle,
    finish reasons and
    token counts equal windowed decode's, teacher-forced gap within 0.25
    nats.  Recorded: acceptance rate, verify dispatches beside windowed
    windows, tok/s beside windowed decode's."""
    vocab = model.config.vocab_size
    launches = [0, 0, 0]
    serve_p, temps = serve_prompts(vocab)
    sets = {'prompt_lookup': (repetitive_prompts(vocab), [0.0] * 8),
            'oracle': (serve_p, temps)}
    report = {}
    for layout, options in (('dense', {}),
                            ('paged', {'kv_block_size': PAGED_BLOCK})):
        windowed = serve_engine(model, **options)
        windows = count_calls(windowed, '_decode')
        refs = {}
        for name, (prompts, ts) in sets.items():
            reqs = [Request(tokens=p, temperature=t)
                    for p, t in zip(prompts, ts)]
            windows[0] = 0
            res, wall = counted(lambda: timed_generate(windowed, reqs),
                                launches)
            refs[name] = (res, wall, windows[0])
        del windowed
        torch.cuda.empty_cache()
        row = {}
        for name, (prompts, ts) in sets.items():
            ref, ref_wall, ref_windows = refs[name]
            spec = serve_engine(model, draft_len=SPEC_DRAFT, **options)
            fallback = count_calls(spec, '_decode')
            lookup = engine_mod.prompt_lookup_draft
            if name == 'oracle':
                by_prompt = {tuple(r.prompt_tokens): r.output_tokens
                             for r, t in zip(ref, ts) if t == 0.0}

                def oracle(hist, k, nmax):
                    for prompt, out in by_prompt.items():
                        if tuple(hist[:len(prompt)]) == prompt:
                            done = len(hist) - len(prompt)
                            return out[done:done + k]
                    return []

                engine_mod.prompt_lookup_draft = oracle
            try:
                spec._warm_spec(64)        # restores spec_stats
                reqs = [Request(tokens=p, temperature=t)
                        for p, t in zip(prompts, ts)]
                fallback[0] = 0
                res, wall = counted(lambda: timed_generate(spec, reqs),
                                    launches)
            finally:
                engine_mod.prompt_lookup_draft = lookup
            st = dict(spec.spec_stats)
            check([(r.finish_reason, len(r.output_tokens)) for r in res] ==
                  [(r.finish_reason, len(r.output_tokens)) for r in ref],
                  f'{layout} {name}: finishes differ from windowed decode')
            check(st['accepted'] <= st['drafted'],
                  f'{layout} {name} spec_stats {st}')
            if name == 'oracle':
                check(st['dispatches'] > 0 and st['accepted'] > 0,
                      f'{layout} oracle: {st}')
            greedy = [r for r, t in zip(res, ts) if t == 0.0]
            tf = teacher_forced_err(spec.model, greedy)
            check(tf <= 0.25, f'{layout} {name} teacher-forced gap {tf}')
            n_tok = sum(len(r.output_tokens) for r in res)
            ref_tok = sum(len(r.output_tokens) for r in ref)
            row[name] = {
                'spec_stats': st,
                'acceptance_rate': (st['accepted'] / st['drafted']
                                    if st['drafted'] else None),
                'verify_dispatches': st['dispatches'],
                'windowed_fallback_windows': fallback[0],
                'windowed_engine_windows': ref_windows,
                'tok_per_s': n_tok / wall,
                'windowed_tok_per_s': ref_tok / ref_wall,
                'teacher_forced_max_abs_err': tf,
                'greedy_streams_identical_to_windowed': sum(
                    a.output_tokens == b.output_tokens
                    for a, b, t in zip(ref, res, ts) if t == 0.0)}
            del spec
            torch.cuda.empty_cache()
        report[layout] = row
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'spec', 'model': 'llama-1b', 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'], 'draft_len': SPEC_DRAFT,
          'new_tokens': 32, 'teacher_forced_bound': 0.25, **report,
          'flash_launches': launches})


# Step-1 loss of the random init: ln V plus about sigma^2 / 2, where the
# tied logits' std is sigma ~ sqrt(2048) * 0.02 ~ 0.9 (a unit-RMS hidden
# state against N(0, 0.02^2) embedding rows): ~0.4 nats above ln V for
# llama-1b and gemma-2b alike (both 2048 wide).  Held within
# [ln V, ln V + LOSS_STEP1_MARGIN].
LOSS_STEP1_MARGIN = 1.125
# Depth 2, f32, the card (the kernels' f32 paths, cuBLAS f32) against the
# CPU (autograd through the plain attention): f32 sums in another order
# over a 2048-wide residual stream and a 32000-way (llama-1b) or
# 256000-way (gemma-2b) logsumexp.  Loss relative; each gradient tensor
# against its own max |g|.
BOUND_DEPTH2_LOSS = 1e-5
BOUND_DEPTH2_GRAD = 5e-4


def train_phase_name(model_name: str) -> str:
    return 'train' if model_name == 'llama-1b' else f'{model_name}_train'


def chunked_loss_ms(mc, batch: tuple, loss_chunk: int) -> float:
    """The chunked loss alone (its f32 vocabulary GEMMs, logsumexp and
    gather), forward and backward, at a train step's shapes: random f32
    hidden states [B, T, H] against an f32 [H, V] projection, CUDA
    events."""
    b, t = batch
    gen = torch.Generator(device='cuda').manual_seed(3)
    hidden = torch.randn((b, t, mc.hidden_size), generator=gen,
                         device='cuda').requires_grad_(True)
    proj = (torch.randn((mc.hidden_size, mc.vocab_size), generator=gen,
                        device='cuda') * 0.02).requires_grad_(True)
    targets = torch.randint(0, mc.vocab_size, (b, t), generator=gen,
                            device='cuda')

    def run():
        train_lib.chunked_cross_entropy(hidden, proj, targets,
                                        chunk_t=loss_chunk).backward()

    ms = cuda_ms(run, iters=3, warmup=1)
    del hidden, proj
    torch.cuda.empty_cache()
    return ms


def phase_train(card: str, model_name: str = 'llama-1b',
                batch: tuple = (8, 2048), num_layers: Optional[int] = None,
                depth2_batch: int = 2) -> tuple:
    """`model_name` (at `num_layers` when given) trained for 6 steps at
    `batch` (sequences x tokens) through the Trainer (f32 master weights,
    remat full, loss chunk 128): launches per step, the step-1 loss near
    ln V, step time and peak memory, the chunked loss's share of the
    step; a repeated batch's loss falls; depth 2 in f32, card against
    CPU (`depth2_batch` sequences of 256 tokens).  Mixtral also: the
    router aux term of one step beside its loss and a non-zero router
    gradient.  Returns the kernels' launches over the 6 steps and the
    phase's line."""
    cfg = train_lib.TrainConfig(model=model_name, batch_size=batch[0],
                                seq_len=batch[1], warmup_steps=2,
                                total_steps=100)
    mc = get_model_config(model_name)
    if num_layers is not None:
        mc = dataclasses.replace(mc, num_layers=num_layers)
    trainer = train_lib.Trainer(cfg, mc)
    trainer.setup(seed=0)
    moe = isinstance(mc, MixtralConfig)
    # remat 'full': each layer's forward kernel runs again in backward.
    expected = (2 * mc.num_layers, mc.num_layers, mc.num_layers)
    loss_step1 = (math.log(mc.vocab_size),
                  math.log(mc.vocab_size) + LOSS_STEP1_MARGIN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, per_step, launches = launches_per_step(
        lambda wrap: trainer.train(data=wrap(train_lib.synthetic_data(
            cfg.batch_size, cfg.seq_len, mc.vocab_size, seed=0)),
            num_steps=6, log_every=1))
    check(per_step == [list(expected)] * 6,
          f'launches per step {per_step}, expected {expected}')
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [loss for _, loss in trainer.history]
    check(len(losses) == 6 and all(math.isfinite(x) for x in losses),
          f'losses {losses}')
    check(loss_step1[0] <= losses[0] <= loss_step1[1],
          f'step-1 loss {losses[0]} outside {loss_step1}')
    step_fn = train_lib.make_train_step(cfg.loss_chunk)
    batch = next(train_lib.synthetic_data(cfg.batch_size, cfg.seq_len,
                                          mc.vocab_size, seed=2))
    metrics = {}

    def one_step():
        metrics.update(step_fn(trainer.state, batch))
        float(metrics['loss'])

    step_profile = profile_device(one_step, top=12)
    router = {}
    if moe:
        aux = metrics['router_aux_loss'].item()
        grad = trainer.state.model.layers[0].moe.router.weight.grad
        router = {'router_aux_loss': aux, 'loss_with_aux': metrics[
            'loss'].item(), 'router_grad_norm_layer0': grad.norm().item()}
        check(0.0 < aux < 1.0 and math.isfinite(
            router['router_grad_norm_layer0']) and
            router['router_grad_norm_layer0'] > 0.0,
            f'router aux term {aux}, layer-0 router gradient norm '
            f'{router["router_grad_norm_layer0"]}')
    del trainer
    torch.cuda.empty_cache()
    step_ms = 1e3 * cfg.batch_size * cfg.seq_len / out['tokens_per_second']
    loss_ms = chunked_loss_ms(mc, batch=(cfg.batch_size, cfg.seq_len),
                              loss_chunk=cfg.loss_chunk)

    # One repeated batch: six steps (lr 0, half of peak, then peak) must
    # lower its loss.
    trainer = train_lib.Trainer(cfg, mc)
    trainer.setup(seed=0)
    batch = next(train_lib.synthetic_data(cfg.batch_size, cfg.seq_len,
                                          mc.vocab_size, seed=1))
    trainer.train(data=itertools.repeat(batch), num_steps=6, log_every=1)
    repeat = [loss for _, loss in trainer.history]
    after = trainer.evaluate(iter([batch]), num_batches=1)['eval_loss']
    check(after < repeat[1],
          f'repeated batch: loss {after} after 6 steps, {repeat[1]} at 2')
    del trainer
    torch.cuda.empty_cache()

    # Depth 2 in f32: the same weights and batch on the card and the CPU
    # (drawn on the card, one tensor at a time, and copied to the host).
    cfg2 = dataclasses.replace(mc, num_layers=2, dtype=torch.float32)
    sd = {k: v.cpu() for k, v in iter_params(
        cfg2, torch.Generator(device='cuda').manual_seed(0))}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg2.vocab_size, (depth2_batch, 257)))
    res = {}
    for dev in ('cuda', 'cpu'):
        model = build_model(cfg2, device=dev, param_dtype=torch.float32)
        model.load_state_dict(sd)
        t = toks.to(dev)
        loss = train_lib.loss_fn(model, t[:, :-1], t[:, 1:],
                                 loss_chunk=cfg.loss_chunk)
        loss.backward()
        res[dev] = (loss.item(), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()})
        del model, loss
    del sd
    loss_err = abs(res['cuda'][0] - res['cpu'][0]) / abs(res['cpu'][0])
    grad_err = max(rel_err(g, res['cpu'][1][n])
                   for n, g in res['cuda'][1].items())
    del res
    check(loss_err <= BOUND_DEPTH2_LOSS and grad_err <= BOUND_DEPTH2_GRAD,
          f'depth-2 f32 card vs CPU: loss {loss_err}, grads {grad_err}')
    tokens_per_step = cfg.batch_size * cfg.seq_len
    line = {'phase': train_phase_name(model_name), 'model': model_name,
            'device': card, 'num_layers': mc.num_layers,
            'params': mc.num_params,
            'batch': [cfg.batch_size, cfg.seq_len],
            'remat': getattr(mc, 'remat_policy', 'full'),
            'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
            'launches_per_step': per_step, 'losses': losses,
            'step_ms': step_ms,
            'tokens_per_s': out['tokens_per_second'],
            'max_memory_allocated_gib': peak_gib,
            'chunked_loss_fwd_bwd_ms': loss_ms,
            'chunked_loss_share_of_step': loss_ms / step_ms,
            'loss_step1_bounds': list(loss_step1),
            'repeat_batch_losses': repeat, 'repeat_batch_loss_after': after,
            'depth2_f32_loss_rel_err': loss_err,
            'depth2_f32_grad_max_rel_err': grad_err,
            'depth2_bounds': [BOUND_DEPTH2_LOSS, BOUND_DEPTH2_GRAD],
            'step_profile': step_profile, **router}
    emit(line)
    return launches, line


# LoRA at the rank and targets of examples/finetune_llama31.yaml and
# examples/serve_lora.yaml: rank 16 on q/k/v/o, alpha 16 (scale 1).
LORA_RANK = 16
LORA_ALPHA = 16.0
# llama-1b: 22 layers x (q 2048x16 + 16x2048, k and v 2048x16 + 16x1024,
# o 2048x16 + 16x2048).
LORA_TRAIN_PARAMS = 22 * (65_536 + 49_152 + 49_152 + 65_536)


def lora_param_count(mc) -> int:
    """rank x (in + out) summed over every adapted projection."""
    h, d = mc.hidden_size, mc.head_dim_
    dims = {'q_proj': (h, mc.num_heads * d),
            'k_proj': (h, mc.num_kv_heads * d),
            'v_proj': (h, mc.num_kv_heads * d),
            'o_proj': (mc.num_heads * d, h),
            'gate_proj': (h, mc.intermediate_size),
            'up_proj': (h, mc.intermediate_size),
            'down_proj': (mc.intermediate_size, h)}
    return mc.num_layers * sum(mc.lora_rank * sum(dims[t])
                               for t in mc.lora_targets)


def lora_config(model_name: str = 'llama-1b', **overrides):
    return dataclasses.replace(get_model_config(model_name),
                               lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA,
                               **overrides)


def phase_lora_train(card: str, full: dict,
                     model_name: str = 'llama-1b') -> tuple:
    """Frozen-base LoRA training of `model_name` at full width and depth:
    rank 16 on q/k/v/o, 6 steps at batch 8 x 2048 through the Trainer,
    the train phase's other settings.  Checks: 44/22/22 launches a step
    (dQ, dK and dV flow to the q/k/v adapters through the backward
    kernels); the step-1 loss equal, to the bit, to the base model's on
    the same batch and weights (B = 0); the base parameters byte-identical
    after 6 steps; Adam moments for exactly the adapters' 5,046,272
    parameters; a repeated batch's loss falls; at depth 2 in f32 the
    adapter gradients on the card within 5e-4 of their max of the CPU's.
    Records step ms, tokens/s and peak memory beside the full train
    phase's (`full`, its line), and the peak of the trainer's setup.  Saves the adapter with
    ``save_adapter_npz`` to a temporary directory.  Returns the kernels'
    launches over the 6 steps and that directory."""
    mc = lora_config(model_name)
    cfg = train_lib.TrainConfig(model=model_name, batch_size=8,
                                seq_len=2048, warmup_steps=2,
                                total_steps=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2 ** 30
    trainer = train_lib.Trainer(cfg, mc)
    trainer.setup(seed=0)
    setup_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    model = trainer.state.model
    base = {n: p.detach().clone() for n, p in model.named_parameters()
            if not lora.is_lora_path(n)}
    held = trainer.state.optimizer.param_groups[0]['params']
    n_adapter = lora.num_adapter_params(model)
    want_params = lora_param_count(mc)
    check(model_name != 'llama-1b' or want_params == LORA_TRAIN_PARAMS,
          f'{want_params} adapter parameters, expected {LORA_TRAIN_PARAMS}')
    check(sum(p.numel() for p in held) == n_adapter == want_params
          and all(p.requires_grad == lora.is_lora_path(n)
                  for n, p in model.named_parameters()),
          f'optimizer holds {sum(p.numel() for p in held)} parameters, '
          f'adapters {n_adapter}, expected {want_params}')

    # The base model on the same weights and step-1 batch, under grad as
    # the step runs it (each layer checkpointed).
    first = next(train_lib.synthetic_data(
        cfg.batch_size, cfg.seq_len, mc.vocab_size, seed=0,
        device='cuda'))['tokens']
    plain = llama.Llama(get_model_config(model_name), device='cuda',
                        param_dtype=torch.float32)
    plain.load_state_dict(base)
    base_loss = train_lib.loss_fn(plain, first[:, :-1], first[:, 1:],
                                  loss_chunk=cfg.loss_chunk).item()
    del plain
    torch.cuda.empty_cache()

    expected = (2 * mc.num_layers, mc.num_layers, mc.num_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, per_step, launches = launches_per_step(
        lambda wrap: trainer.train(data=wrap(train_lib.synthetic_data(
            cfg.batch_size, cfg.seq_len, mc.vocab_size, seed=0,
            device='cuda')), num_steps=6, log_every=1))
    check(per_step == [list(expected)] * 6,
          f'launches per step {per_step}, expected {expected}')
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [loss for _, loss in trainer.history]
    check(len(losses) == 6 and all(math.isfinite(x) for x in losses),
          f'losses {losses}')
    check(losses[0] == base_loss,
          f'step-1 loss {losses[0]} differs from the base model loss '
          f'{base_loss}')
    frozen = all(torch.equal(p, base[n]) for n, p in
                 model.named_parameters() if not lora.is_lora_path(n))
    check(frozen, 'a base parameter changed')
    # B started at 0: each trained B must have moved off it.
    moved = [bool(p.detach().any()) for n, p in model.named_parameters()
             if n.endswith('lora_b')]
    moments = sum(st['exp_avg'].numel()
                  for st in trainer.state.optimizer.state.values())
    check(moments == want_params and all(moved),
          f'Adam moments for {moments} parameters, {sum(moved)} of '
          f'{len(moved)} B moved')
    adapter_dir = tempfile.mkdtemp(prefix='lora_smoke_')
    npz = pathlib.Path(adapter_dir) / 'trained.npz'
    leaves = lora.save_adapter_npz(model, str(npz))
    del trainer, model, base
    torch.cuda.empty_cache()

    # One repeated batch: six steps (lr 0, half of peak, then peak) must
    # lower its loss.
    trainer = train_lib.Trainer(cfg, mc)
    trainer.setup(seed=0)
    batch = next(train_lib.synthetic_data(cfg.batch_size, cfg.seq_len,
                                          mc.vocab_size, seed=1,
                                          device='cuda'))
    trainer.train(data=itertools.repeat(batch), num_steps=6, log_every=1)
    repeat = [loss for _, loss in trainer.history]
    after = trainer.evaluate(iter([batch]), num_batches=1)['eval_loss']
    check(after < repeat[1],
          f'repeated batch: loss {after} after 6 steps, {repeat[1]} at 2')
    del trainer
    torch.cuda.empty_cache()

    # Depth 2 in f32, B drawn non-zero so A has a gradient too: the
    # adapters' gradients on the card against the CPU's.
    cfg2 = dataclasses.replace(mc, num_layers=2, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    sd = {k: (torch.randn(v.shape, generator=gen) * 0.02
              if k.endswith('lora_b') else v)
          for k, v in init_params(cfg2, gen).items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg2.vocab_size, (2, 257)))
    res = {}
    for dev in ('cuda', 'cpu'):
        m2 = llama.Llama(cfg2, device=dev, param_dtype=torch.float32)
        m2.load_state_dict(sd)
        train_lib.trainable_parameters(m2)
        t = toks.to(m2.embedding.device)
        loss = train_lib.loss_fn(m2, t[:, :-1], t[:, 1:],
                                 loss_chunk=cfg.loss_chunk)
        loss.backward()
        res[dev] = (loss.item(), {n: p.grad.cpu()
                                  for n, p in m2.named_parameters()
                                  if p.grad is not None})
        del m2, loss
    check(set(res['cuda'][1]) == set(res['cpu'][1]) and
          all(lora.is_lora_path(n) for n in res['cpu'][1]),
          'depth-2: gradients beyond the adapters')
    loss_err = abs(res['cuda'][0] - res['cpu'][0]) / abs(res['cpu'][0])
    grad_err = max(rel_err(g, res['cpu'][1][n])
                   for n, g in res['cuda'][1].items())
    check(loss_err <= BOUND_DEPTH2_LOSS and grad_err <= BOUND_DEPTH2_GRAD,
          f'depth-2 f32 card vs CPU: loss {loss_err}, adapter grads '
          f'{grad_err}')
    tokens_per_step = cfg.batch_size * cfg.seq_len
    emit({'phase': 'lora_train', 'model': model_name, 'device': card,
          'lora': {'rank': LORA_RANK, 'alpha': LORA_ALPHA,
                   'targets': list(mc.lora_targets)},
          'batch': [cfg.batch_size, cfg.seq_len], 'remat': mc.remat_policy,
          'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
          'launches_per_step': per_step, 'losses': losses,
          'base_model_step1_loss': base_loss,
          'step1_loss_equals_base': True, 'base_byte_identical': True,
          'adapter_params': n_adapter, 'adam_moment_params': moments,
          'step_ms': 1e3 * tokens_per_step / out['tokens_per_second'],
          'tokens_per_s': out['tokens_per_second'],
          'max_memory_allocated_gib': peak_gib,
          'setup_max_memory_allocated_gib': setup_peak_gib,
          'allocated_before_setup_gib': before_gib,
          'full_train': {k: full[k] for k in (
              'step_ms', 'tokens_per_s', 'max_memory_allocated_gib')},
          'repeat_batch_losses': repeat, 'repeat_batch_loss_after': after,
          'depth2_f32_loss_rel_err': loss_err,
          'depth2_f32_adapter_grad_max_rel_err': grad_err,
          'depth2_bounds': [BOUND_DEPTH2_LOSS, BOUND_DEPTH2_GRAD],
          'npz_leaves': leaves, 'npz_bytes': npz.stat().st_size})
    return launches, adapter_dir


# Random serving adapters, A at the init's 0.02.  B at 0.05 gives a delta
# about a fifth of each adapted projection's output (trained adapters are
# small next to their base), which moves a random model's greedy tokens.
# At 0.5 (the JAX package's tests draw that for a 32-wide model) the
# deltas double the projections and the bf16 teacher-forced gap reached
# 0.66-1.06 nats on an H100 (PERF.md, the LoRA findings); the f32 check
# at depth 2, where only summation order differs, keeps B at 0.5.
LORA_B_STD = 0.05
LORA_B_STD_F32 = 0.5
LORA_NEW_TOKENS = 32


def random_adapter_tree(engine, seed: int, b_std: Optional[float] = None
                        ) -> dict:
    """A rank-16 adapter for the engine's targets as a nested flax-form
    tree, every leaf drawn with numpy from `seed` (B at `b_std`, by
    default LORA_B_STD)."""
    b_std = LORA_B_STD if b_std is None else b_std
    rng = np.random.default_rng(seed)
    return lora.nest({
        lora.flax_path(name): rng.normal(
            0, b_std if name.endswith('lora_b') else 0.02,
            tuple(p.shape[1:])).astype(np.float32)
        for name, p in engine.model.named_parameters()
        if lora.is_lora_path(name)})


def single_adapter_model(engine, slot: Optional[int]) -> llama.Llama:
    """The engine's base weights with stack slot `slot`'s adapter, as a
    single-adapter model (no stack, no ids): the teacher-forced
    reference of that adapter's streams.  slot None: the base model."""
    cfg = dataclasses.replace(engine.model_config, lora_num_adapters=0)
    if slot is None:
        cfg = dataclasses.replace(cfg, lora_rank=0)
    model = llama.Llama(cfg, device='cuda').eval()
    sd = engine.model.state_dict()
    model.load_state_dict({k: (v[slot] if lora.is_lora_path(k) else v)
                           for k, v in sd.items()
                           if slot is not None or not lora.is_lora_path(k)})
    return model


def adapter_gaps(engine, results: list, names: list, tally: list) -> dict:
    """Per adapter, the teacher-forced gap of its streams against a
    single-adapter model with its weights: the no-cache forward (the
    flash kernel, whose launches go into `tally`) and the cached forward
    (the engine's own attention path)."""
    gaps = {}
    for slot, name in enumerate(names):
        ref = single_adapter_model(engine, slot)
        mine = [r for r in results if r.adapter == name]
        gaps[name] = {
            'no_cache': counted(lambda: teacher_forced_err(ref, mine),
                                tally),
            'cache_path': teacher_forced_err(ref, mine, use_cache=True)}
        del ref
    return gaps


def wrong_adapter_gaps(engine, results: list, names: list,
                       slots: list) -> dict:
    """Controls of the teacher-forced gate: the streams of each adapter
    in `names` (stack slots `slots`) against the no-cache forward of the
    next one's single-adapter model (two slots swapped) and of the base
    model (the base served in place of the adapter).  Each must exceed
    the gate, or the gate could not tell a wrong adapter from the
    right one."""
    out = {}
    base = single_adapter_model(engine, None)
    for i, name in enumerate(names):
        other = names[(i + 1) % len(names)]
        ref = single_adapter_model(engine, slots[(i + 1) % len(slots)])
        mine = [r for r in results if r.adapter == name]
        out[name] = {f'as_{other}': teacher_forced_err(ref, mine),
                     'as_base': teacher_forced_err(base, mine)}
        del ref
    del base
    return out


def f32_adapter_gaps(engine, prompts: list, tally: list) -> dict:
    """The engine's base weights at depth 2 in f32 with two adapters at
    B std 0.5: an f32 engine serves `prompts` over the base and both
    adapters in one batch; each adapter stream against the no-cache
    forward of its single-adapter model (the kernel's f32 path), whose
    launches go into `tally`.  Only summation order differs: 2e-3 nats,
    the serve phase's f32 bound."""
    cfg = dataclasses.replace(engine.model_config, num_layers=2,
                              dtype=torch.float32)
    keep = {k: v.float() for k, v in engine.model.state_dict().items()
            if not lora.is_lora_path(k) and (
                not k.startswith('layers.') or k.split('.')[1] in ('0', '1'))}
    eng = InferenceEngine(
        dataclasses.replace(cfg, lora_rank=0, lora_num_adapters=0),
        InferConfig(model=engine.cfg.model, num_slots=8, max_cache_len=512,
                    prefill_buckets=(64, 128, 256), max_new_tokens=16,
                    cache_dtype=torch.float32, lora_rank=LORA_RANK,
                    lora_alpha=LORA_ALPHA, lora_max_adapters=2),
        params=keep)
    names = ['f32_a', 'f32_b']
    for i, name in enumerate(names):
        eng.register_adapter(name, random_adapter_tree(
            eng, seed=20 + i, b_std=LORA_B_STD_F32))
    adapters = [a for _ in prompts for a in [None] + names]
    res = [types.SimpleNamespace(prompt_tokens=r.prompt_tokens,
                                 output_tokens=r.output_tokens,
                                 logprobs=r.logprobs, adapter=a)
           for r, a in zip(eng.generate([
               Request(tokens=p, adapter=a)
               for p, a in zip([p for p in prompts for _ in range(3)],
                               adapters)]), adapters)]
    gaps = {n: g['no_cache']
            for n, g in adapter_gaps(eng, res, names, tally).items()}
    moved = sum(a.output_tokens != b.output_tokens
                for a, b in zip(res[1::3], res[0::3]))
    del eng
    return {'gaps': gaps, 'adapter_streams_differing_from_base': moved,
            'b_std': LORA_B_STD_F32}


def lora_requests(prompts: list, names: list) -> list:
    """(kind, path, body, adapter) per prompt, adapters in turns over
    `names` (None: the base), every other one named through the OpenAI
    "model" field of /v1/completions, the rest through /generate's
    "adapter" field; all greedy."""
    out = []
    for i, p in enumerate(prompts):
        name = names[i % len(names)]
        if i % 2 and name is not None:
            out.append(('completion', '/v1/completions',
                        {'model': name, 'prompt': p,
                         'max_tokens': LORA_NEW_TOKENS, 'temperature': 0,
                         'logprobs': 1}, name))
        else:
            body = {'tokens': p, 'max_new_tokens': LORA_NEW_TOKENS,
                    'logprobs': True}
            if name is not None:
                body['adapter'] = name
            out.append(('plain', '/generate', body, name))
    return out


def lora_burst(port: int, requests: list) -> tuple:
    """The requests at once; returns (tok/s, wall s, per request:
    namespace of prompt, output tokens, logprobs, adapter)."""
    replies, wall = post_all(port, [r[:3] for r in requests])
    got = []
    for (kind, _, body, name), (code, _, doc) in zip(requests, replies):
        check(code == 200, f'{kind} under {name}: {code} {doc}')
        if kind == 'plain':
            tokens, lps = doc['output_tokens'], doc['logprobs']
        else:
            choice = doc['choices'][0]
            check(doc['model'] == name, f'answered as {doc["model"]}')
            tokens = choice['tokens']
            lps = choice['logprobs']['token_logprobs']
        check(len(tokens) == LORA_NEW_TOKENS, f'{len(tokens)} tokens')
        got.append(types.SimpleNamespace(
            prompt_tokens=body.get('tokens') or body['prompt'],
            output_tokens=tokens, logprobs=lps, adapter=name))
    n_tok = sum(len(r.output_tokens) for r in got)
    return n_tok / wall, wall, got


def window_ms(engine, ids: list) -> dict:
    """One decode window over every slot at cache position 256, with
    per-slot adapter ids `ids` (None: an engine without adapters), under
    profile_device."""
    n = engine.cfg.num_slots
    kw = ({} if ids is None else
          {'adapter_ids': torch.tensor(ids, device='cuda')})
    prof = profile_device(lambda: engine._decode(
        torch.zeros(n, dtype=torch.long, device='cuda'),
        torch.full((n,), 256, dtype=torch.long, device='cuda'),
        torch.zeros(n, device='cuda'), engine.cfg.decode_steps, **kw)[0])
    return {k: prof[k] for k in ('wall_ms', 'device_ms', 'idle_share')}


def phase_lora_serve(env: dict, adapter_dir: str,
                     model_name: str = 'llama-1b') -> int:
    """Multi-LoRA serving of `model_name` with the flags of
    examples/serve_lora.yaml (--lora-rank 16 --lora-max-adapters 8),
    started through server.run() with --adapter-dir at the lora_train
    phase's directory.  POST /load_adapter loads the trained adapter and
    two drawn from a seeded generator; a path escaping the directory
    gets 400; /v1/models lists them.  The serve phase's 12 prompts go
    first all to the base (no adapter registered yet), then mixed over
    the base and the three adapters (by "adapter" and by the OpenAI
    "model" field), all at once, so base and adapters share windows.
    Checks: the base streams byte-identical to the first burst's; at
    least one adapter stream differs from the base's; each adapter
    stream's teacher-forced gap against the no-cache forward (the flash
    kernel) of a single-adapter model with its weights within 0.25 nats
    (bf16, as the serve phase), and each random adapter's streams beyond
    0.25 nats against the other's model and the base model (the gate's
    controls).  Then a paged pool with the radix cache:
    a second wave under one adapter hits, the other adapters' and the
    base's do not; the conservation law after every window; and C3:
    re-registering that adapter with another's weights, its next wave
    has no hit and gives that other adapter's tokens.  Recorded, not
    gated: tok/s of the mixed burst against the base-only one, and the
    decode window's device time with the slots spread over the base and
    the adapters, all base, and on an engine without adapters.  Returns
    the forward kernel's launches of the teacher-forced reference."""
    torch.cuda.synchronize()
    port = free_port()
    built = []

    class Recording(InferenceEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    server.InferenceEngine = Recording
    try:
        thread = threading.Thread(target=server.run, kwargs=dict(
            model=model_name, host='127.0.0.1', port=port,
            lora_rank=LORA_RANK, lora_max_adapters=8,
            adapter_dir=adapter_dir, warmup=True), daemon=True)
        warm_s, statuses = wait_ready(port, thread)
    finally:
        server.InferenceEngine = InferenceEngine
    [engine] = built
    names = ['trained', 'rand1', 'rand2']
    for i, name in enumerate(names[1:]):
        lora.save_adapter_npz(random_adapter_tree(engine, seed=10 + i),
                              str(pathlib.Path(adapter_dir) / f'{name}.npz'))
    prompts, _ = serve_prompts(engine.model_config.vocab_size)
    base_only = lora_requests(prompts, [None])
    base_tps, base_wall, base_res = lora_burst(port, base_only)
    code, _, doc = http(port, 'POST', '/load_adapter',
                        {'name': 'x', 'path': '../trained.npz'})
    check(code == 400 and 'escapes' in doc['error'],
          f'escaping path: {code} {doc}')
    for slot, name in enumerate(names):
        code, _, doc = http(port, 'POST', '/load_adapter',
                            {'name': name, 'path': f'{name}.npz'})
        check((code, doc) == (200, {'adapter': name, 'slot': slot}),
              f'/load_adapter {name}: {code} {doc}')
    code, _, doc = http(port, 'GET', '/v1/models')
    listed = [m['id'] for m in doc['data']]
    check(listed == [model_name] + sorted(names), f'/v1/models {listed}')
    mixed = lora_requests(prompts, [None] + names)
    mixed_tps, mixed_wall, mixed_res = lora_burst(port, mixed)
    for r, b in zip(mixed_res, base_res):
        if r.adapter is None:
            check(r.output_tokens == b.output_tokens,
                  'a base stream changed once adapters were registered')
    check(any(r.output_tokens != b.output_tokens
              for r, b in zip(mixed_res, base_res) if r.adapter),
          'no adapter stream differs from the base stream')
    lora_forward = [0, 0, 0]
    gaps = adapter_gaps(engine, mixed_res, names, lora_forward)
    check(max(g['no_cache'] for g in gaps.values()) <= 0.25,
          f'teacher-forced gaps {gaps}')
    controls = wrong_adapter_gaps(engine, mixed_res, names[1:], [1, 2])
    check(min(x for g in controls.values() for x in g.values()) > 0.25,
          f'a wrong adapter within the 0.25-nat gate: {controls}')
    layers = engine.model_config.num_layers
    check(lora_forward[0] == layers * len(prompts) * 3 // 4 and
          lora_forward[1:] == [0, 0], f'reference launches {lora_forward}')
    f32 = f32_adapter_gaps(engine, prompts[:6], lora_forward)
    check(max(f32['gaps'].values()) <= 2e-3,
          f'f32 depth-2 teacher-forced gaps {f32}')
    with engine._lock:
        n = engine.cfg.num_slots
        spread = [i % 4 - 1 for i in range(n)]     # base and 3 adapters
        windows = {'base_and_adapters': window_ms(engine, spread),
                   'all_base': window_ms(engine, [-1] * n)}
    code, _, _ = http(port, 'POST', '/drain', {'deadline_s': 60})
    thread.join(timeout=120)
    check(code == 200 and not thread.is_alive(), 'server did not drain')
    base_sd = {k: v for k, v in engine.model.state_dict().items()
               if not lora.is_lora_path(k)}
    trees = {name: random_adapter_tree(engine, seed=10 + i)
             for i, name in enumerate(names[1:])}
    del engine, built
    gc.collect()
    torch.cuda.empty_cache()
    plain = InferenceEngine(get_model_config(model_name),
                            InferConfig(model=model_name), params=base_sd)
    windows['no_adapters_engine'] = window_ms(plain, None)
    del plain

    # The paged pool with the radix cache: 4 prompts behind a shared
    # 256-token system prompt, in one 512-token bucket.
    paged = InferenceEngine(
        get_model_config(model_name),
        InferConfig(model=model_name, kv_block_size=PAGED_BLOCK,
                    auto_prefix_cache=True, lora_rank=LORA_RANK,
                    lora_max_adapters=8, max_new_tokens=LORA_NEW_TOKENS),
        params=base_sd)
    for name, tree in trees.items():
        paged.register_adapter(name, tree)
    rng = np.random.default_rng(3)
    vocab = paged.model_config.vocab_size
    system = rng.integers(0, vocab, 256).tolist()
    wave_p = [system + rng.integers(0, vocab, 40).tolist()
              for _ in range(4)]

    def wave(adapters):
        return paged.generate([Request(tokens=p, adapter=a)
                               for a in adapters for p in wave_p])

    audit = audited_windows(paged)
    wave(['rand1'])
    hits0 = paged.radix_stats['hits']
    second = wave(['rand1', 'rand2', None])
    hits1 = paged.radix_stats['hits']
    check(hits1 - hits0 == len(wave_p),
          f'second wave: {hits1 - hits0} hits, expected {len(wave_p)} '
          '(rand1 only)')
    paged.register_adapter('rand1', trees['rand2'])
    third = wave(['rand1'])
    hits2 = paged.radix_stats['hits']
    del paged._step
    check(hits2 == hits1, f'{hits2 - hits1} hits after re-registration')
    check([r.output_tokens for r in third] ==
          [r.output_tokens for r in second[4:8]],
          're-registered rand1 does not give the tokens of rand2')
    check(audit[0] > 0 and audit[1:] == [],
          f'conservation after {audit[0]} windows: {audit[1:]}')
    check(conservation_errors(paged) == [], 'conservation at the end')
    radix = dict(paged.radix_stats)
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'lora_serve', 'model': model_name,
          'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
          'flags': {'lora_rank': LORA_RANK, 'lora_max_adapters': 8,
                    'adapter_dir': True},
          'warmup_s': warm_s, 'healthz': statuses,
          'adapters': names, 'requests': len(prompts),
          'new_tokens': LORA_NEW_TOKENS,
          'base_only_tok_per_s': base_tps, 'base_only_wall_s': base_wall,
          'mixed_tok_per_s': mixed_tps, 'mixed_wall_s': mixed_wall,
          'base_streams_identical': True,
          'adapter_streams_differing_from_base': sum(
              r.output_tokens != b.output_tokens
              for r, b in zip(mixed_res, base_res) if r.adapter),
          'teacher_forced_max_abs_err': gaps, 'teacher_forced_bound': 0.25,
          'wrong_adapter_controls': controls,
          'b_std': LORA_B_STD, 'f32_depth2': f32,
          'f32_teacher_forced_bound': 2e-3,
          'reference_flash_fwd_launches': lora_forward[0],
          'decode_window': windows,
          'paged_radix': {'block_size': PAGED_BLOCK, 'prompts': len(wave_p),
                          'second_wave_hits': hits1 - hits0,
                          'hits_after_reregistration': hits2 - hits1,
                          'radix_stats': radix,
                          'windows_audited': audit[0],
                          'conservation_errors': 0}})
    return lora_forward[0]


def drawn_model(cfg, seed: int) -> torch.nn.Module:
    """`cfg`'s model on the card, random weights from a seed: each tensor
    is drawn in f32 (iter_params, init_params' draws) and copied into the
    model's own dtype before the next is drawn, so the f32 state_dict (34
    GB at gemma-7b, 93 GB at mixtral-8x7b's 16 layers) never exists
    whole."""
    model = build_model(cfg, device='cuda').eval()
    sd = model.state_dict()
    filled = set()
    with torch.no_grad():
        for key, t in iter_params(cfg, torch.Generator(
                device='cuda').manual_seed(seed)):
            sd[key].copy_(t)
            filled.add(key)
            del t
    check(filled == set(sd),
          f'{cfg.name}: init left {set(sd) - filled} unset')
    return model


# Timed runs of the gemma phase's 12 requests after the first.
GEMMA_SERVE_RUNS = 3


def phase_gemma(card: str) -> int:
    """gemma-7b (head_dim 256, MHA) on the card: the no-cache forward over
    tokens [1, 1024] through the head_dim-256 forward kernel, then the
    dense-cache engine at the server's defaults (8 slots, cache 2048, the
    default buckets, decode_steps 8) serving the serve phase's 12
    requests x 32 new tokens: a first run, then GEMMA_SERVE_RUNS timed
    ones, greedy tokens identical across all, each greedy token's logprob
    held against the no-cache forward over prompt + output.  Returns the
    forward's kernel launches."""
    torch.cuda.reset_peak_memory_stats()
    model = drawn_model(get_model_config('gemma-7b'), seed=0)
    cfg = model.config
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 1024))).cuda()
    n_params = sum(t.numel() for t in model.parameters())
    param_gib = sum(t.numel() * t.element_size()
                    for t in model.parameters()) / 2 ** 30

    def forward():
        with torch.inference_mode():
            return model(tokens)

    torch.cuda.synchronize()
    reset_launch_counts()
    logits = forward()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == (cfg.num_layers, 0, 0),
          f'gemma-7b forward launched the kernels {counts} times, expected '
          f'{(cfg.num_layers, 0, 0)}')
    check(tuple(logits.shape) == (1, 1024, cfg.vocab_size),
          f'logits shape {tuple(logits.shape)}')
    check(bool(torch.isfinite(logits).all()), 'non-finite gemma-7b logits')
    del logits
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        forward()
    torch.cuda.synchronize()
    forward_ms = 1e3 * (time.perf_counter() - t0) / reps
    profile = profile_device(forward)

    # Dense-cache serving, then the teacher-forced gap against the
    # no-cache forward (the head_dim-256 kernel), bounded as in the serve
    # phase (bf16, two attention paths that round apart).
    engine = InferenceEngine(
        cfg, InferConfig(model='gemma-7b', max_new_tokens=32),
        params=model.state_dict(),
        generator=torch.Generator(device='cuda').manual_seed(1))
    del model
    torch.cuda.empty_cache()
    prompts, temps = serve_prompts(cfg.vocab_size)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    runs = []
    for _ in range(1 + GEMMA_SERVE_RUNS):
        reqs = [Request(tokens=p, temperature=t, request_id=str(i))
                for i, (p, t) in enumerate(zip(prompts, temps))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(reqs)
        runs.append((res, time.perf_counter() - t0))
        for r in res:
            check(r.finish_reason == 'length' and len(r.output_tokens) == 32,
                  f'gemma-7b request {r.request_id}: {r.finish_reason} '
                  f'after {len(r.output_tokens)} tokens ({r.error})')
        check(all(res[i].output_tokens == runs[0][0][i].output_tokens
                  for i in greedy), 'gemma-7b greedy tokens differ between '
              'runs')
    tf_bound = 0.25
    tf_err = teacher_forced_err(engine.model, [runs[0][0][i]
                                               for i in greedy])
    check(tf_err <= tf_bound,
          f'gemma-7b teacher-forced logprobs differ by {tf_err}')
    n_tok = sum(len(r.output_tokens) for r in runs[0][0])
    timed_runs = runs[1:]
    ttft = [r.ttft_s for res, _ in timed_runs for r in res]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'gemma', 'model': 'gemma-7b', 'device': card,
          'params': n_params, 'param_gib': param_gib,
          'tokens': [1, 1024], 'flash_fwd_launches': counts[0],
          'forward_ms': forward_ms, 'logits_finite': True,
          'profile': profile, 'requests': len(prompts),
          'greedy': len(greedy), 'prompt_lens': [len(p) for p in prompts],
          'new_tokens_a_run': n_tok, 'first_run_wall_s': runs[0][1],
          'wall_s': [wall for _, wall in timed_runs],
          'tok_per_s': [n_tok / wall for _, wall in timed_runs],
          'ttft_s_mean': float(np.mean(ttft)),
          'ttft_s_max': float(np.max(ttft)),
          'teacher_forced_max_abs_err': tf_err,
          'teacher_forced_bound': tf_bound,
          'max_memory_allocated_gib': peak_gib})
    return counts[0]


# The qos phase: llama-1b in f32 (so the token-equality gate tests the
# scheduler, not bf16 rounding of two prefill shapes), paged, radix on,
# 256-token chunks, 4 slots; 4 batch prompts past the largest bucket chunk
# in every slot until QOS_ARRIVE_AFTER chunk rounds have run, then 6
# interactive requests arrive.
QOS_SLOTS = 4
QOS_ARRIVE_AFTER = 3
# One cache length of blocks past full provisioning, so the radix tree
# can hold the parked prompts' rows while the slots' requests hold theirs
# (at full provisioning admission evicts a parked prompt's leaves).
QOS_BLOCKS = (QOS_SLOTS + 1) * (2048 // 16) + 1
QOS_WEIGHTS = {'a': 3.0, 'b': 1.0}
QOS_NEW_TOKENS = 32


def qos_traffic(vocab: int) -> tuple:
    """(batch, interactive) requests from a seed: 4 batch prompts of
    1650-1750 tokens and 6 interactive ones of 30-120, tenants a and b."""
    rng = np.random.default_rng(12)
    batch = [Request(tokens=rng.integers(0, vocab, int(
        rng.integers(1650, 1751))).tolist(), request_id=f'b{i}',
        max_new_tokens=QOS_NEW_TOKENS, priority='batch',
        tenant_id='ab'[i % 2]) for i in range(4)]
    inter = [Request(tokens=rng.integers(0, vocab, int(
        rng.integers(30, 121))).tolist(), request_id=f'i{i}',
        max_new_tokens=QOS_NEW_TOKENS, priority='interactive',
        tenant_id='ab'[i % 2]) for i in range(6)]
    return batch, inter


def qos_run(engine, first: list, later: tuple = ()) -> dict:
    """Serve `first`, then queue `later` from inside the engine's
    QOS_ARRIVE_AFTER-th chunk round (deterministic: every chunking prompt
    has written that many chunks); a request's arrival time is set as it
    is queued unless it has one.  {request_id: result}."""
    q, results, stop = queue.Queue(), {}, threading.Event()

    def put(r):
        q.put(r if r.arrival_time is not None else
              dataclasses.replace(r, arrival_time=time.time()))

    chunk_round, rounds = engine._chunk_round, [0]

    def arrive_after():
        out = chunk_round()
        rounds[0] += 1
        if rounds[0] == QOS_ARRIVE_AFTER:
            for r in later:
                put(r)
        return out

    engine._chunk_round = arrive_after
    loop = threading.Thread(target=engine.generate_stream, args=(
        q, lambda r: results.__setitem__(r.request_id, r), stop),
        daemon=True)
    loop.start()
    for r in first:
        put(r)
    t0 = time.perf_counter()
    while len(results) < len(first) + len(later):
        check(time.perf_counter() - t0 < 300, 'qos: waited 300 s for '
              f'results ({sorted(results)})')
        time.sleep(0.005)
    stop.set()
    loop.join(timeout=60)
    check(not loop.is_alive(), 'qos: the serving loop did not stop')
    del engine._chunk_round
    return results


def phase_qos(model, env: dict) -> None:
    """QoS at llama-1b full width and depth (f32), paged (16-token
    blocks), radix on, prefill_chunk 256, tenant weights a=3, b=1: while
    4 batch prompts of ~1,700 tokens chunk in every slot, 6 interactive
    requests arrive, with QoS off and then on.  Checks: preemptions >= 1
    and each parked prompt resumes from a radix hit (a suffix-only
    prefill); every request's greedy tokens equal the QoS-off run's; the
    conservation law after every window; a request whose deadline the
    projection cannot meet and one expired in the queue are shed with the
    typed shape; the service rate is None before the first clean finish
    and positive after.  Recorded: interactive TTFT p50 off and on."""
    cfg = dataclasses.replace(model.config, dtype=torch.float32)
    sd = {k: v.float() for k, v in model.state_dict().items()}
    device = model.embedding.device
    batch, inter = qos_traffic(cfg.vocab_size)
    runs = {}
    for mode in ('off', 'on'):
        eng = InferenceEngine(cfg, InferConfig(
            model='llama-1b', num_slots=QOS_SLOTS, max_cache_len=2048,
            prefill_buckets=CHUNK_BUCKETS, decode_steps=8,
            max_new_tokens=QOS_NEW_TOKENS, kv_block_size=PAGED_BLOCK,
            kv_blocks=QOS_BLOCKS, auto_prefix_cache=True,
            prefill_chunk=CHUNK_ROWS, qos=mode == 'on',
            qos_tenant_weights=QOS_WEIGHTS),
            params=sd, device=device,
            generator=torch.Generator(device=device).manual_seed(1))
        check(eng.stats()['qos']['service_rate_tokens_per_s'] is None,
              f'qos {mode}: a service rate before any finish')
        audit = audited_windows(eng)
        t0 = time.perf_counter()
        res = qos_run(eng, batch, inter)
        wall = time.perf_counter() - t0
        for r in res.values():
            check(r.finish_reason == 'length' and
                  len(r.output_tokens) == QOS_NEW_TOKENS,
                  f'qos {mode} {r.request_id}: {r.finish_reason} '
                  f'({r.error})')
        check(len(audit) == 1, f'qos {mode} conservation: {audit[1:6]}')
        stats = eng.stats()['qos']
        rate = stats['service_rate_tokens_per_s']
        check(isinstance(rate, float) and rate > 0,
              f'qos {mode}: service rate {rate} after clean finishes')
        runs[mode] = {
            'results': res, 'wall_s': wall, 'windows_audited': audit[0],
            'qos': stats, 'radix_stats': dict(eng.radix_stats),
            'chunk_stats': dict(eng.chunk_stats),
            'interactive_ttft_s': [res[r.request_id].ttft_s for r in inter],
            'batch_ttft_s': [res[r.request_id].ttft_s for r in batch]}
        if mode == 'on':
            # The typed sheds: a deadline the projection at the observed
            # rate cannot meet, and one already expired in the queue.
            late = Request(tokens=inter[0].tokens, request_id='late',
                           max_new_tokens=QOS_NEW_TOKENS, deadline_s=1.0,
                           arrival_time=time.time() - 10)
            doomed = Request(tokens=batch[0].tokens, request_id='doomed',
                             max_new_tokens=QOS_NEW_TOKENS,
                             deadline_s=0.5)
            shed = qos_run(eng, [doomed, late])
            for rid, text in (('doomed', 'projected completion'),
                              ('late', 'expired in queue')):
                r = shed[rid]
                check(r.finish_reason == 'deadline' and
                      r.error_class == 'shed' and not r.output_tokens and
                      text in (r.error or ''),
                      f'qos shed {rid}: {r.finish_reason} '
                      f'{r.error_class} {r.error}')
            runs[mode]['sheds'] = {rid: r.error for rid, r in shed.items()}
            runs[mode]['qos_after_sheds'] = eng.stats()['qos']
            check(eng.qos_stats['sheds'] == 2,
                  f'qos sheds {eng.qos_stats}')
        del eng, audit
        gc.collect()
        torch.cuda.empty_cache()
    off, on = runs['off'], runs['on']
    pre = on['qos']['preemptions']
    check(pre >= 1, f'qos: no preemption ({on["qos"]})')
    check(off['qos']['preemptions'] == 0, 'qos off preempted')
    check(on['radix_stats']['hits'] >= pre,
          f'qos: {pre} parked prompts, radix {on["radix_stats"]}')
    diffs = {rid: first_diffs([r], [on['results'][rid]])[0]
             for rid, r in off['results'].items()}
    check(all(d is None for d in diffs.values()),
          f'qos on vs off: first differing token by request {diffs}')
    emit({'phase': 'qos', 'model': 'llama-1b', 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'],
          'config': {'dtype': 'float32', 'num_slots': QOS_SLOTS,
                     'max_cache_len': 2048, 'kv_block_size': PAGED_BLOCK,
                     'kv_blocks': QOS_BLOCKS,
                     'prefill_chunk': CHUNK_ROWS,
                     'prefill_buckets': list(CHUNK_BUCKETS),
                     'auto_prefix_cache': True,
                     'qos_tenant_weights': QOS_WEIGHTS,
                     'arrive_after_chunk_rounds': QOS_ARRIVE_AFTER},
          'batch_prompt_lens': [len(r.tokens) for r in batch],
          'interactive_prompt_lens': [len(r.tokens) for r in inter],
          'preemptions': pre, 'tokens_equal_qos_off': True,
          **{f'qos_{mode}': {k: v for k, v in run.items()
                             if k != 'results'}
             for mode, run in runs.items()},
          'interactive_ttft_s_p50': {
              mode: float(np.median(run['interactive_ttft_s']))
              for mode, run in runs.items()}})


# The int8_hf phase: examples/serve_llama2_7b_int8.yaml's model and flags
# (int8 weights, the fp8 cache, --max-cache-len 512) with the CLI's
# throughput preset passed explicitly (skypilot_tpu/cli.py:905-906: 48
# slots, decode_steps 32, prefills_per_gap 4).
INT8_MODEL = 'llama2-7b'
INT8_SERVE = dict(num_slots=48, max_cache_len=512, decode_steps=32,
                  prefills_per_gap=4, max_new_tokens=32)
INT8_REQUESTS = 48
INT8_TIMED_RUNS = 1
# Steps of the profiled decode window: a quarter of decode_steps keeps
# the profiler's event count (and its post-processing) a quarter.
INT8_WINDOW_STEPS = 8
# Teacher-forced bound of the int8 streams against the int8 no-cache
# forward.  The fp8 cache's own gap at llama2-7b (32 MHA layers; e4m3
# rounds to 2^-4 of a value) read 1.48 nats with bf16 weights and with
# int8 ones alike, against 0.23-0.25 over a bf16 cache (NVIDIA H100 80GB
# HBM3, 700 W): the fp8 phase's FP8_NO_CACHE_BOUND (1.0), set at llama-1b,
# is below it, so the bound is 2.0.  The phase reports the bf16-weight
# engine's gap beside it.
INT8_BOUND = 2.0
# The bound where the fp8 cache's own rounding is out of the comparison:
# the int8 streams through the engine's own attention path over a fresh
# fp8 cache (the same quantized rows), and an int8 engine's over a bf16
# cache against the no-cache forward.  The serve phase's bf16 bound
# (0.25), set at llama-1b's 22 layers, is under what a sound path reads at
# llama2-7b's 32 MHA layers (0.2524 over a bf16 cache, 0.2376 through the
# cached forward over fp8; NVIDIA H100 80GB HBM3, 700 W): twice it here.
INT8_TIGHT_BOUND = 0.5


# The chaos phase: the replica plane under faults at llama-1b's width
# (SERVE_LAYERS deep, f32 weights as the qos phase, so that batch
# composition cannot move a greedy token) over a bf16 paged cache with
# the radix cache and a host tier; 16-token blocks.
CHAOS_SEEDS = (0, 1, 2)
CHAOS_REQUESTS = 12
CHAOS_INFER = dict(num_slots=4, max_cache_len=256, prefill_buckets=(16, 32,
                                                                    64),
                   decode_steps=4, max_new_tokens=64, kv_block_size=16,
                   auto_prefix_cache=True, host_kv_bytes=64 << 20)
CHAOS_CYCLES = 3                # kill + respawn cycles of (b)
CHAOS_STALL_S = 0.02            # a replica's loop pass, so a kill lands
CHAOS_DELAY_S = 0.25            # (c)'s injected downstream delay
CHAOS_STREAM = dict(tokens=[11, 17, 23, 29, 31, 37, 41, 43],
                    max_new_tokens=48)


def chaos_script():
    """scripts/chaos_smoke_torch.py as a module: its fault plan, requests
    and episode (the script imports the serve plane only inside its
    replica and batch legs, which this phase does not run)."""
    path = pathlib.Path(__file__).resolve().parent / 'scripts' / \
        'chaos_smoke_torch.py'
    spec = importlib.util.spec_from_file_location('chaos_smoke_torch', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ChaosRecorder(sanitizers._OrderGraph):
    """The lock-order graph, recording every LockOrderError it raises
    (raised on a serving thread, one would surface only as a failed
    request)."""

    def __init__(self):
        super().__init__()
        self.errors = []

    def before_acquire(self, name: str) -> None:
        try:
            super().before_acquire(name)
        except sanitizers.LockOrderError as e:
            self.errors.append(str(e))
            raise

    def after_acquire(self, name: str) -> None:
        try:
            super().after_acquire(name)
        except sanitizers.LockOrderError as e:
            self.errors.append(str(e))
            raise


def sse_stream(port: int, body: dict, on_first=None, timeout=60) -> tuple:
    """POST /generate as a stream: (events, seconds to the first token
    chunk, the exception that ended the read or None)."""
    conn = HTTPConnection('127.0.0.1', port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request('POST', '/generate',
                 body=json.dumps({**body, 'stream': True}).encode(),
                 headers={'Content-Type': 'application/json'})
    events, ttft, buf, err = [], None, b'', None
    try:
        resp = conn.getresponse()
        check(resp.status == 200, f'chaos: stream answered {resp.status}')
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b'\n\n' in buf:
                ev, buf = buf.split(b'\n\n', 1)
                if ev.startswith(b'data: '):
                    events.append(json.loads(ev[6:]))
            if events and ttft is None:
                ttft = time.perf_counter() - t0
                if on_first is not None:
                    on_first()
    except OSError as e:         # a reset mid-stream
        err = e
    finally:
        conn.close()
    return events, ttft, err


def chaos_engine(cfg, sd: dict, device, stall: bool) -> InferenceEngine:
    eng = InferenceEngine(cfg, InferConfig(model='llama-1b', **CHAOS_INFER),
                          params=sd, device=device,
                          generator=torch.Generator(
                              device=device).manual_seed(1))
    if stall:
        eng.arm_faults(FaultPlan(seed=0, specs=[
            FaultSpec(site='stall', prob=1.0,
                                 stall_s=CHAOS_STALL_S)]))
    return eng


def chaos_replicas(cfg, sd: dict, device, reference: list) -> dict:
    """(b) Two KillableReplicas on the card, no LB: CHAOS_CYCLES times, a
    stream to one of them is killed once its first chunk has arrived (the
    client sees the connection end with no final event), the replica
    respawns on its port and the re-issued greedy request is
    byte-identical to the offline reference; the card's allocated bytes
    come back to their value after the first start."""
    reps = [KillableReplica(lambda: chaos_engine(cfg, sd, device, True),
                            free_port()) for _ in range(2)]
    for rep in reps:
        rep.start()
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    cycles = []
    try:
        for cycle in range(CHAOS_CYCLES):
            rep = reps[cycle % 2]
            killed = []

            def kill(rep=rep, killed=killed):
                check(rep.busy(), 'chaos (b): the stream is not in flight')
                t0 = time.perf_counter()
                rep.kill()
                killed.append(time.perf_counter() - t0)

            events, _, err = sse_stream(rep.port, CHAOS_STREAM,
                                        on_first=kill)
            check(killed and not any(e.get('done') for e in events),
                  f'chaos (b) cycle {cycle}: the stream finished '
                  f'({events[-1:]}, {err!r})')
            streamed = sum(len(e.get('tokens', ())) for e in events)
            check(0 < streamed < CHAOS_STREAM['max_new_tokens'],
                  f'chaos (b): {streamed} tokens before the reset')
            t0 = time.perf_counter()
            rep.respawn()
            respawn_s = time.perf_counter() - t0
            events, ttft, err = sse_stream(rep.port, CHAOS_STREAM)
            done = [e for e in events if e.get('done')]
            check(err is None and len(done) == 1 and
                  done[0]['output_tokens'] == reference,
                  f'chaos (b) cycle {cycle}: the re-issued request gave '
                  f'{done[-1:]} ({err!r}), the reference {reference}')
            cycles.append({'replica': cycle % 2, 'kill_s': killed[0],
                           'tokens_before_reset': streamed,
                           'reset': repr(err) if err else 'eof',
                           'respawn_s': respawn_s, 'reissue_ttft_s': ttft})
        deadline = time.perf_counter() + 10
        while True:
            gc.collect()
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated()
            if abs(mem - mem0) <= 0.01 * mem0 or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        check(abs(mem - mem0) <= 0.01 * mem0,
              f'chaos (b): {mem} bytes allocated after {CHAOS_CYCLES} '
              f'kill/respawn cycles, {mem0} after the first start')
        return {'cycles': cycles, 'allocated_first_start': mem0,
                'allocated_after_cycles': mem}
    finally:
        for rep in reps:
            rep.kill()


def chaos_degraded(cfg, sd: dict, device, reference: list) -> dict:
    """(c) A DegradedReplica in front of a port replica: through the
    proxy the greedy tokens are the reference's, and the time to the
    first token is at least the injected delay."""
    rep = KillableReplica(lambda: chaos_engine(cfg, sd, device, False),
                          free_port())
    rep.start()
    proxy = DegradedReplica(rep, FaultPlan(seed=0, specs=[
        FaultSpec(site='net_degrade', prob=1.0,
                             delay_s=CHAOS_DELAY_S, jitter_s=0.0)]))
    proxy.start()
    try:
        runs = {}
        for name, port in (('direct', rep.port), ('proxy', proxy.port),
                           ('direct_again', rep.port)):
            events, ttft, err = sse_stream(port, CHAOS_STREAM)
            done = [e for e in events if e.get('done')]
            check(err is None and len(done) == 1 and
                  done[0]['output_tokens'] == reference,
                  f'chaos (c) {name}: {done[-1:]} ({err!r})')
            runs[name] = ttft
        check(runs['proxy'] >= CHAOS_DELAY_S and proxy.chunks_delayed > 0,
              f'chaos (c): TTFT {runs} through a {CHAOS_DELAY_S} s delay '
              f'({proxy.chunks_delayed} chunks delayed)')
        return {'ttft_s': runs, 'chunks_delayed': proxy.chunks_delayed,
                'delay_s': CHAOS_DELAY_S}
    finally:
        proxy.stop()
        rep.kill()


def phase_chaos(model, env: dict) -> None:
    """The replica plane under chaos, with SKYTPU_SANITIZERS=1 (the lock-
    order and block-conservation sanitizers on, the locks instrumented):
    (a) the fault-mixture sweep of scripts/chaos_smoke_torch.py, seeds
    0-2 x 12 requests: one terminal result each, every episode drained
    within its bound, the pool balanced at drain, after every window and
    at every quiesce point, no lock-order error, and each clean finish
    the fault-free served run's tokens; (b) kill and respawn of port
    replicas (chaos_replicas); (c) a gray-failure proxy (chaos_degraded);
    (d) a planted leak (a block gone from the free list with no holder)
    makes the serving loop's quiesce point raise BlockLeakError."""
    t_phase = time.perf_counter()
    smoke = chaos_script()
    cfg = dataclasses.replace(model.config, dtype=torch.float32)
    sd = {k: v.float() for k, v in model.state_dict().items()}
    device = model.embedding.device
    saved_env = os.environ.get('SKYTPU_SANITIZERS')
    os.environ['SKYTPU_SANITIZERS'] = '1'
    graph, sanitizers._GRAPH = sanitizers._GRAPH, ChaosRecorder()
    # Every quiesce-point check the serving loop makes: None when it
    # passed, else the error.
    maybe_check, quiesce = sanitizers.maybe_check_block_conservation, []

    def counted_check(engine):
        try:
            maybe_check(engine)
        except sanitizers.BlockLeakError as e:
            quiesce.append(str(e))
            raise
        quiesce.append(None)

    sanitizers.maybe_check_block_conservation = counted_check
    try:
        eng = chaos_engine(cfg, sd, device, False)
        check(isinstance(eng._lock, sanitizers.InstrumentedLock),
              'chaos: the engine lock is not instrumented')
        served = []

        def wave():
            served.append(eng.generate_served(
                smoke.make_requests(CHAOS_REQUESTS)))

        prof = profile_device(wave)
        check([r.output_tokens for r in served[0]] ==
              [r.output_tokens for r in served[1]] and
              all(r.finish_reason == 'length' for r in served[0]),
              'chaos (a): two fault-free served runs differ')
        reference = {r.request_id: r.output_tokens for r in served[0]}
        audit = audited_windows(eng)
        episodes = []
        for seed in CHAOS_SEEDS:
            n0, t0 = len(quiesce), time.perf_counter()
            bad = smoke.episode(eng, seed, CHAOS_REQUESTS,
                                reference=reference)
            wall = time.perf_counter() - t0
            checks = len(quiesce) - n0
            check(not bad, f'chaos (a) seed {seed}: {bad}')
            check(checks > 0, f'chaos (a) seed {seed}: no quiesce check')
            episodes.append({'seed': seed, 'wall_s': wall,
                             'quiesce_checks': checks,
                             'fault_stats': dict(eng.fault_stats)})
        check(len(audit) == 1 and audit[0] > 0,
              f'chaos (a): window audit {audit[:6]}')
        check(not any(quiesce), f'chaos (a): quiesce check {quiesce}')
        quiesce_checks = len(quiesce)
        # (d) the planted leak, at the quiesce point.
        leaked = eng._free_blocks.pop()
        try:
            eng.generate_stream(queue.Queue(), lambda res: None,
                                threading.Event())
            raised = None
        except sanitizers.BlockLeakError as e:
            raised = str(e)
        finally:
            eng._free_blocks.append(leaked)
        check(raised is not None and f'[{leaked}]' in raised,
              f'chaos (d): the planted leak of block {leaked} gave '
              f'{raised!r}')
        check(sanitizers.check_block_conservation(eng) is not None,
              'chaos (d): the pool after the planted leak is undone')
        ref_eng = eng
        [ref] = ref_eng.generate([Request(**CHAOS_STREAM)])
        reference_stream = ref.output_tokens
        del eng, ref_eng, audit
        gc.collect()
        replicas = chaos_replicas(cfg, sd, device, reference_stream)
        degraded = chaos_degraded(cfg, sd, device, reference_stream)
        recorder = sanitizers._GRAPH
        check(not recorder.errors,
              f'chaos: lock-order errors {recorder.errors[:3]}')
        edges = recorder.snapshot()
        check('infer.engine._lock' in edges,
              f'chaos: the lock sanitizer recorded {sorted(edges)}')
    finally:
        sanitizers.maybe_check_block_conservation = maybe_check
        sanitizers._GRAPH = graph
        if saved_env is None:
            os.environ.pop('SKYTPU_SANITIZERS', None)
        else:
            os.environ['SKYTPU_SANITIZERS'] = saved_env
    emit({'phase': 'chaos', 'nvidia_smi': env['nvidia_smi'],
          'sanitizers': 'SKYTPU_SANITIZERS=1',
          'config': {**CHAOS_INFER, 'weights': 'float32',
                     'cache': 'bfloat16'},
          'reference_wave': {k: prof[k] for k in ('wall_ms', 'device_ms',
                                                  'idle_share')},
          'episodes': episodes,
          'quiesce_checks': quiesce_checks,
          'lock_edges': {k: sorted(v) for k, v in edges.items()},
          'replicas': replicas, 'degraded': degraded,
          'planted_leak': raised.splitlines()[-1].strip(),
          'wall_s': time.perf_counter() - t_phase})


def hf_checkpoint(model) -> tuple:
    """The drawn model under HF names, beside a namespace with
    llama-2-7b's config.json fields: the same weight tensors, the norms
    as HF stores them (the port's scale + 1)."""
    cfg = model.config
    ns = types.SimpleNamespace(
        model_type='llama', vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        max_position_embeddings=cfg.max_seq_len, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, attention_bias=False,
        tie_word_embeddings=False, hidden_act='silu')
    names = {'embedding': 'model.embed_tokens.weight',
             'final_norm.scale': 'model.norm.weight',
             'lm_head.weight': 'lm_head.weight'}
    sd = {}
    for key, t in model.state_dict().items():
        if key.startswith('layers.'):
            hf = ('model.' + key.replace('.attn.', '.self_attn.')
                  .replace('.input_norm.scale', '.input_layernorm.weight')
                  .replace('.post_attn_norm.scale',
                           '.post_attention_layernorm.weight'))
        else:
            hf = names[key]
        sd[hf] = t + 1.0 if key.endswith('norm.scale') else t
    return ns, sd


def phase_int8_hf(card: str) -> int:
    """llama2-7b at full width and depth: bf16 weights drawn on the card
    from a seed, laid out as an HF-named state dict and carried through
    hf_import.config_from_hf and convert_state_dict (the converted
    model's no-cache logits over [1, 512] must equal the drawn model's
    bit for bit), quantized on the card (one layer's bytes and scales
    against the CPU's quantization of the same bf16 weights), then served
    with int8 weights and the fp8 cache at the throughput preset: 48
    requests x 32 new tokens, a first run then INT8_TIMED_RUNS timed,
    greedy tokens identical across runs, the teacher-forced gap against
    the int8 no-cache forward within INT8_BOUND and through the cached
    forward over a fresh fp8 cache within INT8_TIGHT_BOUND; the same int8
    weights over a bf16 cache within INT8_TIGHT_BOUND of the no-cache
    forward; a model of another seed as the gate's control, then
    quantized and served under the same gates (max and mean gaps of
    each recorded).  Recorded: weight bytes int8 vs bf16, peak
    memory, TTFT p50, tok/s, the int8 streams' gap against the bf16
    no-cache forward, and, from a bf16 engine on the same weights and
    flags built after the int8 one is freed, its own streams' gap (the
    fp8 cache's share), tok/s and the decode window's device time beside
    the int8 engine's.  Returns the int8 no-cache forward's kernel
    launches."""
    from skypilot_tpu_torch.models import quantize
    seconds, t_last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        seconds[step], t_last[0] = now - t_last[0], now

    torch.cuda.reset_peak_memory_stats()
    name = INT8_MODEL
    drawn = drawn_model(get_model_config(name), seed=0)
    device = drawn.embedding.device
    ns, hf_sd = hf_checkpoint(drawn)
    cfg = hf_import.config_from_hf(ns, name=name)
    want_cfg = get_model_config(name)
    check(dataclasses.replace(cfg, dtype=want_cfg.dtype) == want_cfg,
          f'config_from_hf gave {cfg}, the registry has {want_cfg}')
    model = llama.Llama(cfg, device=device).eval()
    model.load_state_dict(hf_import.convert_state_dict(cfg, hf_sd))
    del hf_sd
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 512))).to(device)
    with torch.inference_mode():
        a, b = drawn(tokens), model(tokens)
    logits_equal = bool(torch.equal(a, b))
    check(logits_equal, 'the converted model\'s logits differ from the '
          f'drawn model\'s by {(a - b).abs().max().item()}')
    check(bool(torch.isfinite(a).all()), 'non-finite llama2-7b logits')
    del drawn, a, b
    gc.collect()
    torch.cuda.empty_cache()
    lap('draw_convert_logits')

    # Quantize on the card; one layer's bytes against the CPU's.
    int8_sd = quantize.quantize_state_dict(model.state_dict())
    for key in ('layers.0.attn.q_proj.', 'layers.0.attn.o_proj.',
                'layers.0.mlp.down_proj.'):
        q, scale = quantize.quantize_weight(
            model.state_dict()[key + 'weight'].cpu())
        check(torch.equal(int8_sd[key + 'weight_q'].cpu(), q) and
              torch.equal(int8_sd[key + 'scale'].cpu(), scale),
              f'{key}: the card\'s int8 bytes or scales differ from the '
              'CPU\'s')
    bf16_bytes = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
    int8_bytes = sum(t.numel() * t.element_size()
                     for t in int8_sd.values())
    cfg8 = dataclasses.replace(cfg, weight_dtype='int8')
    serve_cfg = dict(model=name, cache_dtype=llama.FP8, **INT8_SERVE)

    def int8_engine(params, cache_dtype=llama.FP8):
        return InferenceEngine(
            cfg8, InferConfig(**{**serve_cfg, 'cache_dtype': cache_dtype}),
            params=params, device=device,
            generator=torch.Generator(device=device).manual_seed(1))

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
        20, 251))).tolist() for _ in range(INT8_REQUESTS)]

    def serve(eng, what):
        res, wall = timed_generate(eng, [
            Request(tokens=p, request_id=str(i))
            for i, p in enumerate(prompts)])
        for r in res:
            check(r.finish_reason == 'length' and
                  len(r.output_tokens) == INT8_SERVE['max_new_tokens'],
                  f'{what} request {r.request_id}: {r.finish_reason} '
                  f'({r.error})')
        return res, wall

    def gated(eng, res, what, tally=None) -> dict:
        """The streams' gaps against eng's no-cache forward (within
        INT8_BOUND over the fp8 cache, INT8_TIGHT_BOUND over bf16) and,
        over the fp8 cache, through its cached forward over a fresh fp8
        cache (within INT8_TIGHT_BOUND): max and mean of each."""
        fp8 = eng.cfg.cache_dtype == llama.FP8
        nc = (counted(lambda: teacher_forced_gaps(eng.model, res), tally)
              if tally is not None else teacher_forced_gaps(eng.model, res))
        out = {'no_cache_max': nc.max().item(),
               'no_cache_mean': nc.mean().item()}
        bound = INT8_BOUND if fp8 else INT8_TIGHT_BOUND
        check(out['no_cache_max'] <= bound,
              f'{what}: teacher-forced logprobs differ by '
              f'{out["no_cache_max"]} (bound {bound})')
        if fp8:
            cp = teacher_forced_gaps(eng.model, res, use_cache=True,
                                     cache_dtype=llama.FP8)
            out.update(cache_path_max=cp.max().item(),
                       cache_path_mean=cp.mean().item())
            check(out['cache_path_max'] <= INT8_TIGHT_BOUND,
                  f'{what}: cache-path gap {out["cache_path_max"]} (bound '
                  f'{INT8_TIGHT_BOUND})')
        return out

    engine = int8_engine(int8_sd)
    del int8_sd
    gc.collect()
    torch.cuda.empty_cache()
    lap('quantize_engine')
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(1 + INT8_TIMED_RUNS):
        res, wall = serve(engine, 'int8')
        check(all(r.output_tokens == r0.output_tokens
                  for r, r0 in zip(res, runs[0][0] if runs else res)),
              'int8 greedy tokens differ between runs')
        runs.append((res, wall))
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap('serve_runs')
    results = runs[0][0]
    launches = [0, 0, 0]
    gaps = gated(engine, results, 'int8', launches)
    check(launches == [cfg.num_layers * len(results), 0, 0],
          f'int8 no-cache forwards launched the kernels {launches} times')
    quant_gap = teacher_forced_err(model, results)
    lap('teacher_forced')
    window_int8 = window_device_ms(engine, INT8_WINDOW_STEPS)
    lap('window_int8')
    n_tok = sum(len(r.output_tokens) for r in results)
    timed_runs = runs[1:]
    ttft = [r.ttft_s for res, _ in timed_runs for r in res]
    # The same int8 weights over a bf16 cache: the int8 serving path
    # held without the fp8 cache's rounding.
    bf16_cache = int8_engine(engine.model.state_dict(), torch.bfloat16)
    del engine
    gaps_bf16_cache = gated(bf16_cache, serve(bf16_cache,
                                              'int8 bf16-cache')[0],
                            'int8 over a bf16 cache')
    del bf16_cache
    gc.collect()
    torch.cuda.empty_cache()
    lap('bf16_cache')
    # The gate's control: the same streams against a model of another
    # seed must read far past the bound.  That model, quantized and
    # served, is the gates' second seed.
    other = drawn_model(get_model_config(name), seed=1)
    control = teacher_forced_err(other, results[:8])
    check(control > INT8_BOUND,
          f'the control (another seed) reads {control} nats, within the '
          'bound: the gate cannot fail')
    other_engine = int8_engine(quantize.quantize_state_dict(
        other.state_dict()))
    del other
    gc.collect()
    torch.cuda.empty_cache()
    gaps_seed1 = gated(other_engine, serve(other_engine, 'int8 seed 1')[0],
                       'int8 seed 1')
    del other_engine
    gc.collect()
    torch.cuda.empty_cache()
    lap('control_seed1')
    bf16_engine = InferenceEngine(cfg, InferConfig(**serve_cfg),
                                  params=model.state_dict(), device=device,
                                  generator=torch.Generator(
                                      device=device).manual_seed(1))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bf16_res, bf16_wall = timed_generate(bf16_engine, [
        Request(tokens=p, request_id=str(i))
        for i, p in enumerate(prompts)])
    bf16_gap = teacher_forced_err(bf16_engine.model, bf16_res)
    window_bf16 = window_device_ms(bf16_engine, INT8_WINDOW_STEPS)
    del bf16_engine
    gc.collect()
    torch.cuda.empty_cache()
    lap('bf16_engine')
    emit({'phase': 'int8_hf', 'model': name, 'device': card,
          'params': cfg.num_params, 'config': {
              **{k: v for k, v in serve_cfg.items() if k != 'cache_dtype'},
              'cache_dtype': 'float8_e4m3fn', 'weight_dtype': 'int8'},
          'hf_logits_bit_exact': logits_equal, 'tokens': [1, 512],
          'int8_bytes_equal_cpu': True,
          'weight_bytes': {'int8': int8_bytes, 'bf16': bf16_bytes,
                           'ratio': int8_bytes / bf16_bytes},
          'requests': len(prompts), 'prompt_lens': [len(p) for p in prompts],
          'new_tokens_a_run': n_tok, 'first_run_wall_s': runs[0][1],
          'wall_s': [wall for _, wall in timed_runs],
          'tok_per_s': [n_tok / wall for _, wall in timed_runs],
          'ttft_s_p50': float(np.median(ttft)),
          'ttft_s_max': float(np.max(ttft)),
          'max_memory_allocated_gib_serving': serve_peak,
          'teacher_forced_max_abs_err': gaps['no_cache_max'],
          'teacher_forced_bound': INT8_BOUND,
          'teacher_forced_tight_bound': INT8_TIGHT_BOUND,
          'gaps': gaps, 'gaps_bf16_cache': gaps_bf16_cache,
          'gaps_seed1': gaps_seed1,
          'control_other_seed_max_abs_err': control,
          'int8_vs_bf16_forward_max_abs_err': quant_gap,
          'bf16_engine_teacher_forced_max_abs_err': bf16_gap,
          'bf16_engine_wall_s': bf16_wall,
          'bf16_engine_tok_per_s': n_tok / bf16_wall,
          'int8_forward_launches': launches[0],
          'window_steps': INT8_WINDOW_STEPS,
          'window_int8': window_int8, 'window_bf16': window_bf16,
          'window_device_ratio': (
              None if None in (window_int8['device_ms'],
                               window_bf16['device_ms'])
              else window_int8['device_ms'] / window_bf16['device_ms']),
          'seconds': seconds})
    return launches[0]


# ------------------------------------------------------------------ gpt2
# examples/gpt2_managed_spot.yaml: gpt2 at --batch-size 16 --seq-len 1024,
# --checkpoint-every 100 (here every GPT2_RESUME_AT steps, so a resume
# comes within the phase).
GPT2_BATCH = (16, 1024)
GPT2_RESUME_AT = 2
# The gpt2 serving model and the server's flags: 16 slots, cache 1024
# (the wpe table's length, GPT-2's max_seq_len).
GPT2_SERVE_MODEL = 'gpt2-large'
GPT2_SERVE = dict(num_slots=16, max_cache_len=1024)
GPT2_NEW_TOKENS = 32
# Teacher-forced bound of gpt2-large's bf16 streams against its no-cache
# forward (the flash kernel at head_dim 64): the serve phase's 0.25, set
# at llama-1b's 22 layers, doubled for 36 layers, as int8_hf doubled it
# for llama2-7b's 32 (0.2524 read there over a bf16 cache).
GPT2_BOUND = 0.5


def resume_check(model_name: str, batch: tuple, mesh=None) -> dict:
    """The managed-spot recipe's recovery: a Trainer checkpoints at step
    GPT2_RESUME_AT, a fresh Trainer restores from that checkpoint and
    takes the next GPT2_RESUME_AT steps; their losses and the final
    parameters must equal an uninterrupted run's bit for bit.  With
    `mesh` (a MeshSpec) every Trainer runs on it: the checkpoint is
    gathered whole, and read back by rank 0 and broadcast."""
    cfg = train_lib.TrainConfig(model=model_name, batch_size=batch[0],
                                seq_len=batch[1], warmup_steps=2,
                                total_steps=100, mesh=mesh)
    vocab = get_model_config(model_name).vocab_size
    n = GPT2_RESUME_AT
    batches = list(itertools.islice(train_lib.synthetic_data(
        batch[0], batch[1], vocab, seed=5), 2 * n))
    straight = train_lib.Trainer(cfg)
    straight.setup(seed=0)
    straight.train(iter(batches), num_steps=2 * n, log_every=1)
    want = {k: v.clone() for k, v in straight._full_state()[0].items()}
    history = straight.history
    del straight
    ckpt = tempfile.mkdtemp(prefix='gpt2_resume_')
    try:
        ccfg = dataclasses.replace(cfg, checkpoint_dir=ckpt,
                                   checkpoint_every=n)
        first = train_lib.Trainer(ccfg)
        first.setup(seed=0)
        first.train(iter(batches[:n]), num_steps=n, log_every=1)
        del first
        t0 = time.perf_counter()
        resumed = train_lib.Trainer(ccfg)
        resumed.setup(seed=0)
        restore_s = time.perf_counter() - t0
        check(resumed.state.step == n,
              f'resumed at step {resumed.state.step}, expected {n}')
        resumed.train(iter(batches[n:]), num_steps=n, log_every=1)
        equal = all(torch.equal(p, want[k]) for k, p in
                    resumed._full_state()[0].items())
        check(resumed.history == history[n:] and equal,
              f'resumed losses {resumed.history} against {history[n:]}, '
              f'parameters equal: {equal}')
        ckpt_bytes = sum(f.stat().st_size for f in
                         pathlib.Path(ckpt).rglob('*') if f.is_file())
        del resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return {'resume_at': n, 'straight_losses': [l for _, l in history],
            'resumed_losses_bit_equal': True, 'params_bit_equal': True,
            'checkpoint_bytes': ckpt_bytes, 'restore_s': restore_s}


def phase_gpt2(env: dict) -> tuple:
    """GPT-2 on the card: (a) gpt2 trained at the managed-spot recipe's
    batch through phase_train (24/12/12 launches a step, the step-1 loss,
    the repeated batch, depth-2 f32 card vs CPU); (b) the recipe's
    recovery (resume_check); (c) gpt2-large served through server.run()
    over HTTP (16 slots, cache 1024, warm-up on): the serve phase's 12
    requests x 32 tokens at once, each reply 200 with its tokens, each
    greedy stream's teacher-forced gap against the no-cache forward (the
    flash kernel at head_dim 64, MHA) within GPT2_BOUND, then a drain.
    Recorded: tok/s, TTFT, a decode window's device time, peak memory.
    Returns the training launches (fwd, dq, dkv) and the forward launches
    of the teacher-forced reference."""
    card = env['device']
    train_launches, _ = timed(phase_train, card, 'gpt2', GPT2_BATCH,
                              label='phase_gpt2_train')
    gc.collect()
    torch.cuda.empty_cache()
    resume = timed(resume_check, 'gpt2', GPT2_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port = free_port()
    built = []

    class Recording(InferenceEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    server.InferenceEngine = Recording
    try:
        thread = threading.Thread(target=server.run, kwargs=dict(
            model=GPT2_SERVE_MODEL, host='127.0.0.1', port=port,
            warmup=True, **GPT2_SERVE), daemon=True)
        warm_s, _ = wait_ready(port, thread)
    finally:
        server.InferenceEngine = InferenceEngine
    [engine] = built
    mc = engine.model_config
    prompts, temps = serve_prompts(mc.vocab_size)
    requests = [('plain', '/generate',
                 {'tokens': p, 'max_new_tokens': GPT2_NEW_TOKENS,
                  'temperature': t, 'logprobs': True})
                for p, t in zip(prompts, temps)]
    replies, wall = post_all(port, requests)
    results, ttfts = [], []
    for i, (code, _, doc) in enumerate(replies):
        check(code == 200 and doc['finish_reason'] == 'length' and
              len(doc['output_tokens']) == GPT2_NEW_TOKENS,
              f'gpt2-large request {i}: {code} {doc}')
        ttfts.append(doc['ttft_s'])
        if temps[i] == 0.0:
            results.append(types.SimpleNamespace(
                prompt_tokens=prompts[i], output_tokens=doc['output_tokens'],
                logprobs=doc['logprobs']))
    n_tok = GPT2_NEW_TOKENS * len(requests)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    code, _, _ = http(port, 'POST', '/drain', {'deadline_s': 60})
    thread.join(timeout=120)
    check(code == 200 and not thread.is_alive(), 'server did not drain')
    tally = [0, 0, 0]
    gaps = counted(lambda: teacher_forced_gaps(engine.model, results), tally)
    check(tally == [mc.num_layers * len(results), 0, 0],
          f'teacher-forced forwards launched the kernels {tally} times')
    tf_err = gaps.max().item()
    check(tf_err <= GPT2_BOUND,
          f'gpt2-large teacher-forced logprobs differ by {tf_err} '
          f'(bound {GPT2_BOUND})')
    window = window_device_ms(engine)
    del engine, built
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'gpt2', 'device': card, 'nvidia_smi': env['nvidia_smi'],
          'train_model': 'gpt2', 'train_batch': list(GPT2_BATCH),
          'train_launches': list(train_launches), 'resume': resume,
          'serve_model': GPT2_SERVE_MODEL, 'params': mc.num_params,
          'config': {**GPT2_SERVE, 'decode_steps': 8,
                     'cache_dtype': 'bfloat16'},
          'warm_up_s': warm_s, 'requests': len(requests),
          'greedy': len(results), 'new_tokens': n_tok, 'wall_s': wall,
          'tok_per_s': n_tok / wall,
          'ttft_s_p50': float(np.median(ttfts)),
          'ttft_s_max': float(np.max(ttfts)),
          'teacher_forced_max_abs_err': tf_err,
          'teacher_forced_mean_abs_err': gaps.mean().item(),
          'teacher_forced_bound': GPT2_BOUND, 'flash_fwd_launches': tally[0],
          'window': window, 'max_memory_allocated_gib_serving': serve_peak})
    return train_launches, tally[0]


# --------------------------------------------------------------- mixtral
# mixtral-8x7b holds 1,451,270,144 parameters a layer: 92.9 GB of bf16
# at 32 layers, past the card's 80 GB (examples/serve_mixtral.yaml needs
# --tensor-parallel 8, ROADMAP A9).  Served at full width and 16 layers:
# 46.4 GB of bf16 weights and 1.05 GB of f32 embedding and lm_head.
MIXTRAL_MODEL = 'mixtral-8x7b'
MIXTRAL_SERVE_LAYERS = 16
# examples/serve_mixtral.yaml's engine flags but --tensor-parallel: 64
# slots, cache 2048, decode_steps 16, the fp8 cache.
MIXTRAL_SERVE = dict(num_slots=64, max_cache_len=2048, decode_steps=16,
                     max_new_tokens=32)
MIXTRAL_REQUESTS = 64
MIXTRAL_TIMED_RUNS = 1
# Steps of the profiled decode window (a quarter of decode_steps keeps
# the profiler's post-processing short).
MIXTRAL_WINDOW_STEPS = 4
# Training: 16 bytes a parameter (f32 weight, gradient, two Adam moments)
# fit full width at depth 2 (3.165e9 parameters, 50.6 GB before
# activations), batch 4 x 2048.
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN_BATCH = (4, 2048)
# Gates, each against a drop-free scorer (capacity factor E/k: the engine
# routes exactly, a capacity forward may drop tokens).  A random-weight
# Mixtral amplifies rounding through its routers: a bf16-sized nudge of
# the input (the embedding moved by 2^-9 of itself) flips near-tied top-2
# choices and moves the scorer's own logprobs by up to 3.8 nats at depth
# 2 in f32 and 7.0 at 16 layers in bf16 (means 0.04 and 0.52; my chip
# call 2, PR 12), so at 16 layers a maximum gap cannot tell a sound
# engine from a broken one (call 1 read 8.86 over the fp8 cache against
# the 2.0 set before it).  The tight gate is at depth 2 in f32, full
# width, where rounding is 2^-24 and the engine read 2.9e-5 nats
# (MIXTRAL_F32_BOUND, the f32 bound of the forward phase).  At 16 layers
# the gates are on the mean gap a token: over a bf16 cache, and through
# the cached forward over a fresh fp8 cache (the same quantized rows),
# within MIXTRAL_MEAN_BOUND (read 0.45 and 0.28, the nudge 0.52); over
# the fp8 cache against the no-cache scorer, where e4m3's 2^-4 rounding
# is itself a nudge 32x bf16's, within MIXTRAL_FP8_MEAN_BOUND (read
# 2.01).  An other-seed model must read above MIXTRAL_CONTROL_MIN on the
# fp8 streams (~5.3 expected: the argmax of ~N(0, 1.28^2) logits against
# a random token's).  Maxima and the nudge's gaps are recorded.  Set after
# call 2.
MIXTRAL_F32_LAYERS = 2
MIXTRAL_F32_REQUESTS = 16
MIXTRAL_F32_BOUND = 2e-3
MIXTRAL_MEAN_BOUND = 1.0
MIXTRAL_FP8_MEAN_BOUND = 3.0
MIXTRAL_CONTROL_MIN = 4 * MIXTRAL_MEAN_BOUND
MIXTRAL_NUDGE = 2 ** -9


@contextlib.contextmanager
def drop_free(model):
    """The Mixtral model's no-cache forward with capacity factor E/k: no
    token is dropped, so it routes as the engine's exact path does."""
    cfg = model.config
    free = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    blocks = [layer.moe for layer in model.layers]
    for block in blocks:
        block.config = free
    try:
        yield
    finally:
        for block in blocks:
            block.config = cfg


def engine_over(model, cfg: InferConfig) -> InferenceEngine:
    """An engine whose module is `model` itself: no second copy of the
    weights (two copies of the 16-layer mixtral do not fit the card)."""
    build = engine_mod.build_model
    engine_mod.build_model = lambda *args, **kwargs: model
    try:
        return InferenceEngine(model.config, cfg, params=model.state_dict(),
                               device='cuda', generator=torch.Generator(
                                   device='cuda').manual_seed(1))
    finally:
        engine_mod.build_model = build


def nudged_logprobs(model, results) -> torch.Tensor:
    """The drop-free scorer's teacher-forced logprobs with the embedding
    table moved by MIXTRAL_NUDGE of itself (seeded), then restored: how
    far a bf16-sized change of the input moves the model's own answer."""
    table = model.embedding.data.clone()
    gen = torch.Generator(device=table.device).manual_seed(7)
    with torch.no_grad():
        model.embedding.mul_(1 + MIXTRAL_NUDGE * torch.randn(
            table.shape, generator=gen, device=table.device))
    try:
        with drop_free(model):
            return teacher_forced_logprobs(model, results)
    finally:
        model.embedding.data.copy_(table)


def gap_stats(gaps: torch.Tensor) -> dict:
    return {'max': gaps.max().item(), 'mean': gaps.mean().item(),
            'p99': gaps.float().quantile(0.99).item(),
            'frac_over_0.5': (gaps > 0.5).float().mean().item()}


def phase_mixtral(env: dict) -> int:
    """mixtral-8x7b at full width and MIXTRAL_SERVE_LAYERS layers, drawn
    on the card from a seed, served with examples/serve_mixtral.yaml's
    engine flags (64 slots, cache 2048, decode_steps 16, the fp8 cache;
    exact routing on the cache path): 64 requests x 32 tokens, a first
    run then MIXTRAL_TIMED_RUNS timed, greedy tokens identical across
    runs; the same weights over a bf16 cache; a model of another seed as
    the control; then MIXTRAL_F32_LAYERS layers at full width in f32.
    The gates (see MIXTRAL_F32_BOUND) hold the streams against the
    drop-free scorer: at 16 layers the mean gap a token, at depth 2 in
    f32 the largest.  Recorded: each gap's max, mean, p99 and share over
    0.5 nats, the nudge's, tok/s, TTFT, a decode window's device time,
    peak memory.  Returns the forward launches of the teacher-forced
    references."""
    card = env['device']
    seconds, t_last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        seconds[step], t_last[0] = now - t_last[0], now

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_model_config(MIXTRAL_MODEL),
                              num_layers=MIXTRAL_SERVE_LAYERS)
    model = drawn_model(cfg, seed=0)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in model.parameters())
    lap('draw')
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
        20, 251))).tolist() for _ in range(MIXTRAL_REQUESTS)]
    serve_cfg = dict(model=MIXTRAL_MODEL, **MIXTRAL_SERVE)

    def serve(eng, what, prompts=prompts):
        res, wall = timed_generate(eng, [
            Request(tokens=p, request_id=str(i))
            for i, p in enumerate(prompts)])
        for r in res:
            check(r.finish_reason == 'length' and
                  len(r.output_tokens) == MIXTRAL_SERVE['max_new_tokens'],
                  f'{what} request {r.request_id}: {r.finish_reason} '
                  f'({r.error})')
        return res, wall

    engine = engine_over(model, InferConfig(cache_dtype=llama.FP8,
                                            **serve_cfg))
    runs = []
    for _ in range(1 + MIXTRAL_TIMED_RUNS):
        res, wall = serve(engine, 'mixtral fp8')
        check(all(r.output_tokens == r0.output_tokens
                  for r, r0 in zip(res, runs[0][0] if runs else res)),
              'mixtral greedy tokens differ between runs')
        runs.append((res, wall))
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap('serve_runs')
    window = window_device_ms(engine, MIXTRAL_WINDOW_STEPS)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    lap('window')
    results = runs[0][0]
    reported = torch.cat([torch.tensor(r.logprobs) for r in results])
    tally = [0, 0, 0]
    with drop_free(model):
        scored = counted(lambda: teacher_forced_logprobs(model, results),
                         tally)
    check(tally == [cfg.num_layers * len(results), 0, 0],
          f'teacher-forced forwards launched the kernels {tally} times')
    gaps = {'fp8_no_cache': gap_stats((scored - reported).abs()),
            'fp8_cache_path': gap_stats(teacher_forced_gaps(
                model, results, use_cache=True, cache_dtype=llama.FP8)),
            'nudge': gap_stats((nudged_logprobs(model, results) -
                                scored).abs())}
    lap('teacher_forced')
    bf16 = engine_over(model, InferConfig(cache_dtype=torch.bfloat16,
                                          **serve_cfg))
    bf16_res, bf16_wall = serve(bf16, 'mixtral bf16-cache')
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    with drop_free(model):
        gaps['bf16_no_cache'] = gap_stats(teacher_forced_gaps(model,
                                                              bf16_res))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap('bf16_cache')
    other = drawn_model(cfg, seed=1)
    with drop_free(other):
        gaps['control_other_seed'] = gap_stats(teacher_forced_gaps(
            other, results))
    del other
    gc.collect()
    torch.cuda.empty_cache()
    lap('control')
    # Depth 2 in f32 at full width: rounding too small to flip a router.
    cfg32 = dataclasses.replace(cfg, num_layers=MIXTRAL_F32_LAYERS,
                                dtype=torch.float32)
    model32 = drawn_model(cfg32, seed=0)
    f32 = engine_over(model32, InferConfig(cache_dtype=torch.float32,
                                           **serve_cfg))
    f32_res, _ = serve(f32, 'mixtral f32', prompts[:MIXTRAL_F32_REQUESTS])
    del f32
    with drop_free(model32):
        gaps['f32_depth2_no_cache'] = gap_stats(counted(
            lambda: teacher_forced_gaps(model32, f32_res), tally))
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    lap('f32_depth2')
    emit({'phase': 'mixtral', 'model': MIXTRAL_MODEL, 'device': card,
          'nvidia_smi': env['nvidia_smi'], 'num_layers': cfg.num_layers,
          'params': cfg.num_params, 'param_bytes': param_bytes,
          'config': {**MIXTRAL_SERVE, 'cache_dtype': 'float8_e4m3fn'},
          'requests': len(prompts), 'prompt_lens': [len(p) for p in prompts],
          'new_tokens_a_run': sum(len(r.output_tokens) for r in results),
          'first_run_wall_s': runs[0][1],
          'wall_s': [wall for _, wall in runs[1:]],
          'tok_per_s': [sum(len(r.output_tokens) for r in results) / wall
                        for _, wall in runs[1:]],
          'ttft_s_p50': float(np.median([r.ttft_s for res, _ in runs[1:]
                                         for r in res])),
          'ttft_s_max': float(np.max([r.ttft_s for res, _ in runs[1:]
                                      for r in res])),
          'max_memory_allocated_gib_serving': serve_peak,
          'bounds': {'f32_depth2_max': MIXTRAL_F32_BOUND,
                     'mean': MIXTRAL_MEAN_BOUND,
                     'fp8_no_cache_mean': MIXTRAL_FP8_MEAN_BOUND,
                     'control_mean_min': MIXTRAL_CONTROL_MIN},
          'gaps': gaps, 'bf16_cache_wall_s': bf16_wall,
          'flash_fwd_launches': tally[0],
          'window_steps': MIXTRAL_WINDOW_STEPS, 'window': window,
          'seconds': seconds})
    for name, stat, bound in (
            ('f32_depth2_no_cache', 'max', MIXTRAL_F32_BOUND),
            ('fp8_cache_path', 'mean', MIXTRAL_MEAN_BOUND),
            ('bf16_no_cache', 'mean', MIXTRAL_MEAN_BOUND),
            ('fp8_no_cache', 'mean', MIXTRAL_FP8_MEAN_BOUND)):
        check(gaps[name][stat] <= bound,
              f'mixtral {name}: {stat} gap {gaps[name][stat]} (bound '
              f'{bound})')
    check(gaps['control_other_seed']['mean'] > MIXTRAL_CONTROL_MIN,
          f'the control (another seed) reads a mean of '
          f'{gaps["control_other_seed"]["mean"]} nats, within '
          f'{MIXTRAL_CONTROL_MIN}: the gates cannot fail')
    check(tally == [cfg.num_layers * len(results) + MIXTRAL_F32_LAYERS
                    * len(f32_res), 0, 0],
          f'teacher-forced forwards launched the kernels {tally} times')
    return tally[0]


# BERT and ResNet through their task loops (train/tasks.py,
# examples/bert_imdb.yaml's and examples/resnet.yaml's settings), BERT's
# HF import, and LoRA on Mixtral.
BERT_MODEL = 'bert-base'
# examples/bert_imdb.yaml: batch 32, seq 128, lr 2e-5, 50 steps.
BERT_RECIPE = dict(steps=50, batch_size=32, seq_len=128, lr=2e-5)
BERT_REPEAT_STEPS = 6
# Depth 2 at bert-base width in f32, card against CPU: the f32 kernels
# non-causal at head_dim 64 and cuBLAS f32, summed in another order than
# the CPU's plain attention.  Loss relative; logits and each gradient
# against their own max (the depth-2 bounds of the train phase).
BERT_DEPTH2_BATCH = (4, 128)
# The HF import's MLM logits on the card against transformers' CPU
# forward: tests/test_hf_import.py's tolerance.
BERT_HF_ATOL, BERT_HF_RTOL = 2e-3, 1e-3
# examples/resnet.yaml: resnet50, batch 256, 32x32 images, 10 classes,
# lr 0.1, momentum 0.9, 200 steps (examples/train_resnet.py's defaults).
RESNET_MODEL = 'resnet50'
RESNET_RECIPE = dict(steps=200, batch_size=256, image_size=32,
                     num_classes=10, lr=0.1, momentum=0.9)
# The final logged accuracy must clear this (chance 0.1): the classes
# are a fixed mean image each under N(0, 0.8^2) noise, which
# resnet18-debug separates in 10 steps on the CPU.  Set before the first
# chip call.
RESNET_ACC_MIN = 0.5
# The one-step f32 card-vs-CPU check at resnet50 width: batch 8 of 32x32.
RESNET_CHECK_BATCH = 8
# LoRA on Mixtral: mixtral-8x7b at the train phase's depth 2 and batch
# 4 x 2048, rank 16 on q/k/v/o (LORA_RANK, LORA_ALPHA); its peak must stay
# below full training's at the same depth and batch (59.04 GiB on an
# H100 80GB HBM3 at 700 W, the mixtral-8x7b_train phase).
MIXTRAL_LORA_PEAK_MAX_GIB = 59.04
MIXTRAL_LORA_STEPS = 6


def bert_depth2(mc, tally: list) -> dict:
    """bert-base width at depth 2 in f32, the classifier head, the same
    weights and batch on the card and the CPU: the logits, the loss and
    every gradient without a mask (the kernels, counted into `tally`),
    then the logits with a padding mask (the plain masked path: no
    launch)."""
    cfg = dataclasses.replace(mc, num_layers=2, dtype=torch.float32)
    sd = init_params(cfg, torch.Generator().manual_seed(0), head='classify')
    b, s = BERT_DEPTH2_BATCH
    batch = next(tasks.synthetic_bert_batches(
        np.random.default_rng(5), cfg.vocab_size, b, s, cfg.num_classes))
    tokens = torch.from_numpy(batch['tokens']).long()
    labels = torch.from_numpy(batch['labels']).long()
    mask = torch.ones((b, s), dtype=torch.long)
    for i in range(b):
        mask[i, s - 17 * (i + 1):] = 0
    res, masked_launches = {}, [0, 0, 0]
    for dev in ('cuda', 'cpu'):
        model = build_model(cfg, head='classify', device=dev,
                            param_dtype=torch.float32)
        model.load_state_dict(sd)

        def fwd_bwd():
            logits = model(tokens.to(dev))
            loss = torch.nn.functional.cross_entropy(logits, labels.to(dev))
            loss.backward()
            return logits.detach(), loss.item()

        logits, loss = (counted(fwd_bwd, tally) if dev == 'cuda'
                        else fwd_bwd())
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        with torch.no_grad():
            run = lambda: model(tokens.to(dev), None,   # noqa: E731
                                mask.to(dev)).cpu()
            masked = (counted(run, masked_launches) if dev == 'cuda'
                      else run())
        res[dev] = (logits.cpu(), loss, grads, masked)
        del model
    (lc, fc, gc_, mc_), (lx, fx, gx, mx) = res['cuda'], res['cpu']
    grad_err, worst = grad_errors(gc_, gx)
    return {'batch': [b, s],
            'loss_rel_err': abs(fc - fx) / abs(fx),
            'logits_rel_err': rel_err(lc, lx),
            'grad_max_rel_err': grad_err, 'grad_worst': worst,
            'masked_logits_rel_err': rel_err(mc_, mx),
            'masked_vs_unmasked_max_abs': (mx - lx).abs().max().item(),
            'masked_launches': masked_launches}


def bert_hf_import(tally: list) -> dict:
    """A random transformers.BertForMaskedLM at bert-base's shape, saved
    with save_pretrained, loaded with the port's load_hf_model in f32 and
    run on the card (the MLM head; the forward kernel 12 times, counted
    into `tally`) against the HF model's CPU forward."""
    import transformers
    torch.manual_seed(0)
    hf = transformers.BertForMaskedLM(transformers.BertConfig()).eval()
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, hf.config.vocab_size, (2, 128)))
    with torch.no_grad():
        want = hf(tokens).logits
    with tempfile.TemporaryDirectory(prefix='bert_hf_') as ckpt:
        t0 = time.perf_counter()
        hf.save_pretrained(ckpt)
        del hf
        t1 = time.perf_counter()
        cfg, sd = hf_import.load_hf_model(ckpt, dtype=torch.float32)
        t2 = time.perf_counter()
    model = build_model(cfg, head='mlm', device='cuda')
    model.load_state_dict(sd)
    with torch.no_grad():
        got = counted(lambda: model(tokens.to('cuda')).cpu(), tally)
    diff = (got - want).abs()
    within = bool((diff <= BERT_HF_ATOL + BERT_HF_RTOL * want.abs()).all())
    del model, sd
    return {'config': {'vocab_size': cfg.vocab_size,
                       'hidden_size': cfg.hidden_size,
                       'num_layers': cfg.num_layers,
                       'num_heads': cfg.num_heads},
            'tokens': list(tokens.shape), 'max_abs_err': diff.max().item(),
            'max_abs_logit': want.abs().max().item(),
            'within_tolerance': within,
            'tolerance': [BERT_HF_ATOL, BERT_HF_RTOL],
            'save_s': t1 - t0, 'load_hf_model_s': t2 - t1}


def phase_bert(env: dict) -> tuple:
    """bert-base on the card through train/tasks.py: (a) examples/
    bert_imdb.yaml's fine-tune (50 steps at 32 x 128, lr 2e-5, f32 master
    weights, bf16 compute, synthetic data) with 24/12/12 launches a step
    (remat: each layer's forward again in backward), the first loss and
    the final accuracy recorded, a steady step profiled, a repeated
    batch's loss falling over 6 steps; depth 2 at full width in f32, card
    against CPU (bert_depth2, the kernels non-causal at head_dim 64);
    (b) the masked path on the card against the CPU with no launch;
    (c) the HF import (bert_hf_import).  Returns the launches of the
    fine-tune and the HF-import forward, and the phase's line."""
    mc = get_model_config(BERT_MODEL)
    r = BERT_RECIPE
    expected = [2 * mc.num_layers, mc.num_layers, mc.num_layers]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data = tasks.synthetic_bert_batches(
        np.random.default_rng(0), mc.vocab_size, r['batch_size'],
        r['seq_len'], mc.num_classes)
    out, per_step, launches = launches_per_step(
        lambda wrap: tasks.finetune_bert(
            BERT_MODEL, steps=r['steps'], batch_size=r['batch_size'],
            seq_len=r['seq_len'], lr=r['lr'], seed=0, device='cuda',
            data=wrap(data), log=stderr_log))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(per_step == [expected] * r['steps'],
          f'bert launches per step {per_step[:3]}..., expected {expected}')
    history = out['history']
    check(all(math.isfinite(x) for _, x, _ in history),
          f'bert losses {history}')
    state = out['state']
    params = sum(p.numel() for p in state.model.parameters())
    batch = next(data)
    step_profile = profile_device(
        lambda: float(tasks.bert_step(state, batch)[0]), top=10)
    del state
    out.pop('state')
    gc.collect()
    torch.cuda.empty_cache()

    # One repeated batch at the recipe's rate: 6 steps must lower its loss.
    state = tasks.bert_setup(mc, r['lr'], seed=0, device='cuda')
    repeat = [tasks.bert_step(state, batch)[0].item()
              for _ in range(BERT_REPEAT_STEPS)]
    with torch.no_grad():
        after = torch.nn.functional.cross_entropy(
            state.model(torch.from_numpy(batch['tokens']).long().to('cuda')),
            torch.from_numpy(batch['labels']).long().to('cuda')).item()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    check(after < repeat[0],
          f'bert repeated batch: loss {after} after {BERT_REPEAT_STEPS} '
          f'steps, {repeat[0]} at 1')

    tally = [0, 0, 0]
    depth2 = bert_depth2(mc, tally)
    check(tally == [4, 2, 2],
          f'depth-2 forward and backward launched {tally}, expected '
          '[4, 2, 2] (2 layers, remat)')
    check(depth2['loss_rel_err'] <= BOUND_DEPTH2_LOSS
          and depth2['logits_rel_err'] <= BOUND_DEPTH2_GRAD
          and depth2['grad_max_rel_err'] <= BOUND_DEPTH2_GRAD
          and depth2['masked_logits_rel_err'] <= BOUND_DEPTH2_GRAD,
          f'bert depth-2 f32 card vs CPU: {depth2}')
    check(depth2['masked_launches'] == [0, 0, 0]
          and depth2['masked_vs_unmasked_max_abs'] > 0,
          f'the masked path launched {depth2["masked_launches"]} or read '
          'the unmasked logits')
    hf_tally = [0, 0, 0]
    hf = bert_hf_import(hf_tally)
    check(hf_tally == [mc.num_layers, 0, 0] and hf['within_tolerance'],
          f'bert HF import on the card: {hf}, launches {hf_tally}')
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'bert', 'model': BERT_MODEL, 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'], 'recipe': r, 'params': params,
          'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
          'launches_per_step': per_step[0], 'launches': list(launches),
          'history': history, 'first_loss': history[0][1],
          'final_acc': history[-1][2], 'loop_s': out['seconds'],
          'sequences_per_s': out['sequences_per_s'],
          'step_ms': step_profile['wall_ms'], 'step_profile': step_profile,
          'max_memory_allocated_gib': peak_gib,
          'repeat_batch_losses': repeat, 'repeat_batch_loss_after': after,
          'depth2_f32': depth2, 'depth2_launches': tally,
          'depth2_bounds': [BOUND_DEPTH2_LOSS, BOUND_DEPTH2_GRAD],
          'hf_import': hf, 'hf_forward_launches': hf_tally})
    return launches, hf_tally[0]


def resnet_check(mc) -> dict:
    """One train step of resnet50's width in f32 on a small batch, the same
    weights and batch on the card and the CPU (TF32 off: main() clears
    cuDNN's and cuBLAS's flags, which would otherwise run f32 convolutions
    in TF32): the loss, every gradient and the running statistics after
    the step."""
    cfg = dataclasses.replace(mc, dtype=torch.float32)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    batch = next(tasks.synthetic_resnet_batches(
        3, 0, RESNET_CHECK_BATCH, RESNET_RECIPE['image_size'],
        cfg.num_classes))
    res = {}
    for dev in ('cuda', 'cpu'):
        model = build_model(cfg, device=dev, param_dtype=torch.float32)
        model.load_state_dict(sd)
        logits = model(torch.from_numpy(batch['images']).to(dev),
                       train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(batch['labels']).long().to(dev))
        loss.backward()
        res[dev] = (loss.item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {n: b.cpu() for n, b in model.named_buffers()})
        del model
    (fc, gc_, bc), (fx, gx, bx) = res['cuda'], res['cpu']
    grad_err, worst = grad_errors(gc_, gx)
    return {'batch': RESNET_CHECK_BATCH,
            'tf32': [torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32],
            'loss_rel_err': abs(fc - fx) / abs(fx),
            'grad_max_rel_err': grad_err, 'grad_worst': worst,
            'batch_stats_max_rel_err': max(rel_err(b, bx[n])
                                           for n, b in bc.items())}


def phase_resnet(env: dict) -> None:
    """resnet50 on the card through train/tasks.py at examples/
    resnet.yaml's settings (200 steps at batch 256 of 32x32 images, 10
    classes, lr 0.1 under the cosine decay, Nesterov momentum 0.9, bf16
    compute, f32 master weights and statistics): the loss falls, the final
    accuracy clears RESNET_ACC_MIN, the running statistics moved, no flash
    kernel launched; a steady step profiled; the f32 one-step check
    (resnet_check).  Records images/s, step ms, peak memory."""
    mc = dataclasses.replace(get_model_config(RESNET_MODEL),
                             num_classes=RESNET_RECIPE['num_classes'])
    r = RESNET_RECIPE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = tasks.train_resnet(RESNET_MODEL, seed=0, device='cuda',
                             log=stderr_log, **r)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history, state = out['history'], out['state']
    stats = {n: b for n, b in state.model.named_buffers()}
    moved = {'running_mean_max_abs': max(
        b.abs().max().item() for n, b in stats.items()
        if n.endswith('running_mean')), 'running_var_max_abs_dev': max(
        (b - 1).abs().max().item() for n, b in stats.items()
        if n.endswith('running_var'))}
    check(launches == (0, 0, 0), f'resnet launched the kernels {launches}')
    check(all(math.isfinite(x) for _, x, _ in history)
          and history[-1][1] < history[0][1],
          f'resnet losses {history}')
    check(history[-1][2] >= RESNET_ACC_MIN,
          f'resnet final accuracy {history[-1][2]} < {RESNET_ACC_MIN}')
    check(min(moved.values()) > 0, f'running statistics did not move: '
          f'{moved}')
    batch = next(tasks.synthetic_resnet_batches(
        1, 0, r['batch_size'], r['image_size'], r['num_classes']))
    step_profile = profile_device(
        lambda: float(tasks.resnet_step(state, batch)[0]), top=10)
    params = sum(p.numel() for p in state.model.parameters())
    del state
    out.pop('state')
    gc.collect()
    torch.cuda.empty_cache()
    check_f32 = resnet_check(mc)
    check(check_f32['loss_rel_err'] <= BOUND_DEPTH2_LOSS
          and check_f32['grad_max_rel_err'] <= BOUND_DEPTH2_GRAD
          and check_f32['batch_stats_max_rel_err'] <= BOUND_DEPTH2_GRAD,
          f'resnet f32 card vs CPU: {check_f32}')
    emit({'phase': 'resnet', 'model': RESNET_MODEL, 'device': env['device'],
          'nvidia_smi': env['nvidia_smi'], 'recipe': r, 'params': params,
          'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
          'history': history, 'first_loss': history[0][1],
          'final_acc': history[-1][2], 'acc_min': RESNET_ACC_MIN,
          'loop_s': out['seconds'], 'images_per_s': out['images_per_s'],
          'step_ms': step_profile['wall_ms'], 'step_profile': step_profile,
          'max_memory_allocated_gib': peak_gib, 'flash_launches': launches,
          'running_stats_moved': moved, 'f32_check': check_f32,
          'f32_bounds': [BOUND_DEPTH2_LOSS, BOUND_DEPTH2_GRAD]})


def phase_mixtral_lora_train(env: dict) -> tuple:
    """Frozen-base LoRA on mixtral-8x7b at depth 2 and full width, batch
    4 x 2048, rank 16 on q/k/v/o, through the Trainer (the train phase's
    settings): 4/2/2 launches a step over 6 steps; on one repeated batch,
    the first step's loss less its router aux term equal to the eval
    step's (the router term is in the loss, in (0, 1)), then the loss
    lower after 6 steps; every base tensor -- the routers and the experts
    too -- bit-identical to a copy taken before the first step, every B
    moved off 0; Adam moments for the adapters alone; the peaks of the
    setup (the drawn f32 state_dict beside the model) and of the steps
    below full training's.  Records step ms, tokens/s, the step's
    profile.  Returns the launches of the 6 steps."""
    mc = lora_config(MIXTRAL_MODEL, num_layers=MIXTRAL_TRAIN_LAYERS)
    b, s = MIXTRAL_TRAIN_BATCH
    cfg = train_lib.TrainConfig(model=MIXTRAL_MODEL, batch_size=b,
                                seq_len=s, warmup_steps=2, total_steps=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_lib.Trainer(cfg, mc)
    trainer.setup(seed=0)
    setup_s = time.perf_counter() - t0
    setup_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    model = trainer.state.model
    base = {n: p.detach().cpu() for n, p in model.named_parameters()
            if not lora.is_lora_path(n)}
    expected = [2 * mc.num_layers, mc.num_layers, mc.num_layers]
    torch.cuda.reset_peak_memory_stats()
    out, per_step, launches = launches_per_step(
        lambda wrap: trainer.train(data=wrap(train_lib.synthetic_data(
            b, s, mc.vocab_size, seed=0)), num_steps=MIXTRAL_LORA_STEPS,
            log_every=1))
    check(per_step == [expected] * MIXTRAL_LORA_STEPS,
          f'mixtral lora launches per step {per_step}, expected {expected}')
    losses = [loss for _, loss in trainer.history]
    check(all(math.isfinite(x) for x in losses), f'losses {losses}')

    batch = next(train_lib.synthetic_data(b, s, mc.vocab_size, seed=1))
    step_fn = train_lib.make_train_step(cfg.loss_chunk)
    eval_fn = train_lib.make_eval_step(cfg.loss_chunk)
    ce_before = eval_fn(trainer.state, batch).item()
    metrics = step_fn(trainer.state, batch)
    aux = metrics['router_aux_loss'].item()
    first = metrics['loss'].item()
    check(0.0 < aux < 1.0 and abs(first - aux - ce_before) <=
          1e-4 * abs(ce_before),
          f'router term {aux}: step loss {first}, the eval CE {ce_before}')
    step_profile = profile_device(
        lambda: float(step_fn(trainer.state, batch)['loss']), top=12)
    for _ in range(MIXTRAL_LORA_STEPS - 3):
        step_fn(trainer.state, batch)
    ce_after = eval_fn(trainer.state, batch).item()
    check(ce_after < ce_before,
          f'repeated batch: CE {ce_after} after {MIXTRAL_LORA_STEPS} steps, '
          f'{ce_before} before')
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(max(peak_gib, setup_peak_gib) < MIXTRAL_LORA_PEAK_MAX_GIB,
          f'mixtral lora peak {peak_gib} GiB (setup {setup_peak_gib}), '
          f'full training {MIXTRAL_LORA_PEAK_MAX_GIB}')
    changed = [n for n, p in model.named_parameters()
               if not lora.is_lora_path(n)
               and not torch.equal(p.detach().cpu(), base[n])]
    check(not changed, f'base tensors changed: {changed[:4]}')
    moved = [bool(p.detach().any()) for n, p in model.named_parameters()
             if n.endswith('lora_b')]
    n_adapter = lora.num_adapter_params(model)
    moments = sum(st['exp_avg'].numel()
                  for st in trainer.state.optimizer.state.values())
    check(all(moved) and moments == n_adapter == lora_param_count(mc),
          f'{sum(moved)} of {len(moved)} B moved; Adam moments for '
          f'{moments} parameters, adapters {n_adapter}')
    del trainer, model, base
    gc.collect()
    torch.cuda.empty_cache()
    emit({'phase': 'mixtral_lora_train', 'model': MIXTRAL_MODEL,
          'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
          'num_layers': mc.num_layers, 'params': mc.num_params,
          'lora': {'rank': LORA_RANK, 'alpha': LORA_ALPHA,
                   'targets': list(mc.lora_targets)},
          'adapter_params': n_adapter, 'batch': [b, s],
          'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
          'launches_per_step': per_step, 'losses': losses,
          'step_ms': 1e3 * b * s / out['tokens_per_second'],
          'tokens_per_s': out['tokens_per_second'],
          'step_profile': step_profile, 'setup_s': setup_s,
          'setup_max_memory_allocated_gib': setup_peak_gib,
          'max_memory_allocated_gib': peak_gib,
          'peak_max_gib': MIXTRAL_LORA_PEAK_MAX_GIB,
          'router_aux_loss': aux, 'repeat_batch_ce': [ce_before, ce_after],
          'base_byte_identical': True})
    return launches


# Planted faults: (fault, library, line of the sound source, the line
# with the fault).  Each must fail its kernel's bf16 bound at the training
# shape.  No fault touches an mbarrier phase: a wrong phase hangs instead
# of failing.
FAULTS = (
    ('o_rescale_skipped', 'flash_attention_fwd',
     'for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];',
     'for (int j = 0; j < D / 2; ++j) o[j] *= 1.f;'),
    ('v_read_from_the_wrong_stage', 'flash_attention_fwd',
     'issue_pv<D>(o, pa, sV + prev * kBytes);',
     'issue_pv<D>(o, pa, sV + st * kBytes);'),
    ('diagonal_tile_mask_skipped', 'flash_attention_fwd',
     '(p.causal && kv0 + kKvRows - 1 > wq0) ||',
     '(p.causal && kv0 > wq0) ||'),
    ('p_subtile_dropped_from_pv', 'flash_attention_fwd',
     'wgmma_rs<D>(o, pa[kc], sw128_desc(sv + kc * 16 * kRowBytes,',
     'if (kc != 3) wgmma_rs<D>(o, pa[kc], sw128_desc(sv + kc * 16 * '
     'kRowBytes,'),
    ('delta_dropped', 'flash_attention_bwd_dq',
     'sc[j] = sc[j] * (dp[j] - dlt[(j >> 1) & 1]) * p.scale;  // dS',
     'sc[j] = sc[j] * dp[j] * p.scale;  // dS'),
    ('delta_dropped', 'flash_attention_bwd_dkv',
     'pt[4 * j + e] * (dst[4 * j + e] - (e & 1 ? dl.y : dl.x)) * scale;',
     'pt[4 * j + e] * dst[4 * j + e] * scale;'),
    ('k_tile_shifted_by_a_row', 'flash_attention_bwd_dq',
     '&tm_k,\n                                  full_bar + 8 * st, kv0, kvh);',
     '&tm_k,\n                                  full_bar + 8 * st, '
     'kv0 + (kv0 == (kv_first + 1) * kKvRows), kvh);'),
    ('k_tile_shifted_by_a_row', 'flash_attention_bwd_dkv',
     'tma_load_tile<D, kKvRows>(sK, &tm_k, kv_bar, kv0, bkv);',
     'tma_load_tile<D, kKvRows>(sK, &tm_k, kv_bar, kv0 + (kv_tile == 1), '
     'bkv);'),
    ('diagonal_tile_mask_skipped', 'flash_attention_bwd_dq',
     '(p.causal && kv0 + kKvRows - 1 > wq0) ||',
     '(p.causal && kv0 > wq0) ||'),
    ('diagonal_tile_mask_skipped', 'flash_attention_bwd_dkv',
     '(p.causal && wkv0 + kWgRows - 1 > q0) ||',
     '(p.causal && wkv0 > q0) ||'),
    ('k_read_from_the_wrong_stage', 'flash_attention_bwd_dq',
     'issue_dsk<D>(dq, dsa, sk);',
     'issue_dsk<D>(dq, dsa, sK + ((st + 1) % kStages) * T::kKvBytes);'),
    ('do_read_from_the_wrong_stage', 'flash_attention_bwd_dkv',
     'issue_acc<D>(dv, pa, sdo);',
     'issue_acc<D>(dv, pa, sdO + ((st + 1) % kStages) * T::kQBytes);'),
)
# And one for each kernel at head_dim 256, where only that instantiation
# goes, each caught at the gemma-2b training shape: (fault, library, the
# file it is planted in -- hopper.cuh in that library's build alone --,
# the sound line, the line with the fault).
FAULTS_D256 = (
    ('pv_upper_half_reads_lower_columns', 'flash_attention_fwd',
     'hopper.cuh', 'desc_b + 2 * ((desc_b >> 16) & 0x3FFF));', 'desc_b);'),
    ('dsk_upper_half_reads_lower_columns', 'flash_attention_bwd_dq',
     'hopper.cuh', 'desc_b + 2 * ((desc_b >> 16) & 0x3FFF));', 'desc_b);'),
    ('p_t_taken_from_the_next_row', 'flash_attention_bwd_dkv',
     'flash_attention_bwd_dkv.cu',
     'for (int j = 0; j < kQRows / 2; ++j) pt[j] = sP[j * 128 + t];',
     'for (int j = 0; j < kQRows / 2; ++j) pt[j] = sP[j * 128 + (t ^ 4)];'),
)


# The mesh phase: llama3-8b at full width (4096, GQA 32:8 x 128, vocab
# 128,256, untied) at examples/train_llama3_8b.yaml's seq 8192, batch 1
# per card, cut to 4 of 32 layers: 1.92e9 parameters, whose f32 master
# weights, gradients and Adam moments (16 bytes each) take 30.7 GB of the
# card's 80 GB, the no-mesh trainer's and the mesh trainer's in turn.
MESH_MODEL = 'llama3-8b'
MESH_LAYERS = 4
MESH_BATCH = (1, 8192)
MESH_STEPS = 4
# Depth 2 at the same width in f32, the FSDP2-wrapped one-rank mesh
# trainer against the no-mesh trainer: the same kernels on the same
# values, so the bounds are the train phase's card-vs-CPU ones tightened
# on the loss.
MESH_CHECK_SEQ = 1024
BOUND_MESH_LOSS = 1e-6
# The task loops through the process-group path (a one-rank data mesh)
# against their single-process steps: 3 steps each.
MESH_TASK_STEPS = 3
# The recovery of a mesh trainer (resume_check through the one-rank
# mesh), at a small model: what it shows is the broadcast restore path.
MESH_RESUME_MODEL = 'gpt2'
MESH_RESUME_BATCH = (2, 256)


def mesh_grads(trainer) -> dict:
    """Every gradient of a trainer's model, whole, on the CPU (a frozen
    parameter has none)."""
    from torch.distributed.tensor import DTensor
    return {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                else p.grad).detach().float().cpu()
            for n, p in trainer.state.model.named_parameters()
            if p.grad is not None}


def mesh_depth2(mc) -> dict:
    """One train step at depth 2 in f32 of the mesh trainer
    (MeshSpec(fsdp=1): FSDP2 over the one-rank NCCL group) and of the
    no-mesh trainer, from the same weights and batch: the loss, every
    gradient and the launches of each."""
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    cfg2 = dataclasses.replace(mc, num_layers=2, dtype=torch.float32)
    sd = {k: v.cpu() for k, v in iter_params(
        cfg2, torch.Generator(device='cuda').manual_seed(0))}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg2.vocab_size, (1, MESH_CHECK_SEQ + 1)))
    res = {}
    for name, mesh in (('no_mesh', None), ('mesh', MeshSpec(fsdp=1))):
        tr = train_lib.Trainer(train_lib.TrainConfig(
            model=MESH_MODEL, batch_size=1, seq_len=MESH_CHECK_SEQ,
            warmup_steps=2, total_steps=100, mesh=mesh), cfg2,
            device='cuda')
        tr.setup(params=sd)
        tally = [0, 0, 0]
        m = counted(lambda: tr._step_fn(tr.state, {'tokens': tokens}),
                    tally)
        res[name] = (m['loss'].item(), mesh_grads(tr), tally)
        del tr, m
        gc.collect()
        torch.cuda.empty_cache()
    del sd
    (lm, gm, tm), (ln, gn, tn) = res['mesh'], res['no_mesh']
    grad_err, worst = grad_errors(gm, gn)
    return {'num_layers': 2, 'seq': MESH_CHECK_SEQ, 'loss_mesh': lm,
            'loss_no_mesh': ln, 'loss_rel_err': abs(lm - ln) / abs(ln),
            'grad_max_rel_err': grad_err, 'grad_worst': worst,
            'launches_mesh': tm, 'launches_no_mesh': tn}


def mesh_full_width(mc, mesh, probe=None) -> tuple:
    """MESH_STEPS steps of llama3-8b (MESH_LAYERS layers) at MESH_BATCH
    through the Trainer, with `mesh` (a MeshSpec, or None), then one more
    profiled: the launches of each step, the losses, step ms, tokens/s,
    the peak and the device's idle share.  `probe(trainer)`, called after
    setup, returns a function of the trainer called after the steps,
    whose dict joins the result."""
    cfg = train_lib.TrainConfig(model=MESH_MODEL, batch_size=MESH_BATCH[0],
                                seq_len=MESH_BATCH[1], warmup_steps=2,
                                total_steps=100, mesh=mesh)
    tr = train_lib.Trainer(cfg, mc, device='cuda')
    tr.setup(seed=0)
    finish = probe(tr) if probe is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, per_step, launches = launches_per_step(
        lambda wrap: tr.train(data=wrap(train_lib.synthetic_data(
            cfg.batch_size, cfg.seq_len, mc.vocab_size, seed=0)),
            num_steps=MESH_STEPS, log_every=1))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = next(train_lib.synthetic_data(cfg.batch_size, cfg.seq_len,
                                          mc.vocab_size, seed=2))
    step_profile = profile_device(
        lambda: float(tr._step_fn(tr.state, batch)['loss']), top=10)
    losses = [loss for _, loss in tr.history]
    extra = finish(tr) if finish is not None else {}
    del tr, finish
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {
        **extra, 'launches_per_step': per_step, 'losses': losses,
        'step_ms': 1e3 * cfg.batch_size * cfg.seq_len
        / out['tokens_per_second'],
        'tokens_per_s': out['tokens_per_second'],
        'max_memory_allocated_gib': peak_gib,
        'idle_share': step_profile['idle_share'],
        'step_profile': step_profile}


def mesh_task_loops() -> dict:
    """BERT's and ResNet's steps through the process-group path (a
    one-rank data mesh: gradients, loss and accuracy all-reduced, the
    BatchNorm sums through the data group when it has more than one rank)
    against their single-process steps, from the same weights and
    batches: the losses of MESH_TASK_STEPS steps of each."""
    from skypilot_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(data=1), 'cuda')
    bert_cfg = get_model_config(BERT_MODEL)
    res_cfg = dataclasses.replace(get_model_config(RESNET_MODEL),
                                  num_classes=RESNET_RECIPE['num_classes'])
    bert_data = tasks.synthetic_bert_batches(
        np.random.default_rng(0), bert_cfg.vocab_size,
        BERT_RECIPE['batch_size'], BERT_RECIPE['seq_len'],
        bert_cfg.num_classes)
    bert_batches = [next(bert_data) for _ in range(MESH_TASK_STEPS)]
    res_data = tasks.synthetic_resnet_batches(
        0, 0, RESNET_RECIPE['batch_size'], RESNET_RECIPE['image_size'],
        RESNET_RECIPE['num_classes'])
    res_batches = [next(res_data) for _ in range(MESH_TASK_STEPS)]
    out = {}
    for name, m in (('single', None), ('group', mesh)):
        state = tasks.bert_setup(bert_cfg, BERT_RECIPE['lr'], seed=0,
                                 device='cuda', mesh=m)
        out[f'bert_{name}'] = [tasks.bert_step(state, b)[0].item()
                               for b in bert_batches]
        state = tasks.resnet_setup(res_cfg, RESNET_RECIPE['lr'],
                                   RESNET_RECIPE['momentum'],
                                   RESNET_RECIPE['steps'], seed=0,
                                   device='cuda', mesh=m)
        out[f'resnet_{name}'] = [tasks.resnet_step(state, b)[0].item()
                                 for b in res_batches]
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_mesh_train(env: dict) -> tuple:
    """Multi-GPU training through a one-rank NCCL process group (the card
    host shows one card): (a) the depth-2 f32 check of the FSDP2-wrapped
    mesh trainer against the no-mesh trainer; (b) llama3-8b at full width
    and MESH_LAYERS layers, seq 8192, batch 1, no mesh then
    MeshSpec(fsdp=1), with 2L/L/L launches a step (remat full) on both;
    (c) BERT's and ResNet's task loops through the process-group path
    against their single-process steps; (d) resume_check through the
    mesh trainer.  Returns the mesh trainer's launches over its steps and
    the phase's line."""
    from torch import distributed as dist

    from skypilot_tpu_torch.parallel.mesh import (MeshSpec,
                                                  ensure_process_group)
    ensure_process_group('cuda')
    check(dist.get_backend() == 'nccl' and dist.get_world_size() == 1,
          f'process group {dist.get_backend()} x {dist.get_world_size()}')
    full = get_model_config(MESH_MODEL)
    depth2 = mesh_depth2(full)
    check(depth2['launches_mesh'] == [4, 2, 2] ==
          depth2['launches_no_mesh'],
          f'depth-2 launches {depth2["launches_mesh"]} (mesh), '
          f'{depth2["launches_no_mesh"]} (no mesh), expected [4, 2, 2]')
    check(depth2['loss_rel_err'] <= BOUND_MESH_LOSS
          and depth2['grad_max_rel_err'] <= BOUND_DEPTH2_GRAD,
          f'depth-2 f32 mesh vs no mesh: {depth2}')
    mc = dataclasses.replace(full, num_layers=MESH_LAYERS)
    expected = [2 * MESH_LAYERS, MESH_LAYERS, MESH_LAYERS]
    runs = {}
    for name, mesh in (('no_mesh', None), ('mesh', MeshSpec(fsdp=1))):
        launches, runs[name] = mesh_full_width(mc, mesh)
        check(runs[name]['launches_per_step'] == [expected] * MESH_STEPS,
              f'{name} launches per step '
              f'{runs[name]["launches_per_step"]}, expected {expected}')
        losses = runs[name]['losses']
        check(all(math.isfinite(x) for x in losses)
              and math.log(mc.vocab_size) <= losses[0]
              <= math.log(mc.vocab_size) + LOSS_STEP1_MARGIN,
              f'{name} losses {losses}')
    tasks_out = mesh_task_loops()
    resume = resume_check(MESH_RESUME_MODEL, MESH_RESUME_BATCH,
                          mesh=MeshSpec(fsdp=1))
    for fam in ('bert', 'resnet'):
        a, b = tasks_out[f'{fam}_group'], tasks_out[f'{fam}_single']
        check(all(abs(x - y) <= BOUND_MESH_LOSS * abs(y)
                  for x, y in zip(a, b)),
              f'{fam} through the process group {a}, single process {b}')
    line = {'phase': 'mesh_train', 'model': MESH_MODEL,
            'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
            'process_group': [dist.get_backend(), dist.get_world_size()],
            'mesh': list(MeshSpec(fsdp=1).shape),
            'num_layers': MESH_LAYERS, 'of_layers': full.num_layers,
            'params': mc.num_params, 'batch': list(MESH_BATCH),
            'dtype': str(mc.dtype), 'param_dtype': 'torch.float32',
            'reduced': f'depth {full.num_layers} -> {MESH_LAYERS}: f32 '
                       'master weights, gradients and Adam moments of '
                       f'{mc.num_params:.3g} parameters',
            'depth2_f32': depth2,
            'depth2_bounds': [BOUND_MESH_LOSS, BOUND_DEPTH2_GRAD],
            'runs': runs,
            'step_ms_ratio_mesh_over_no_mesh':
                runs['mesh']['step_ms'] / runs['no_mesh']['step_ms'],
            'task_loops': tasks_out,
            'resume': {'model': MESH_RESUME_MODEL,
                       'batch': list(MESH_RESUME_BATCH), **resume}}
    emit(line)
    return launches, line


# The mesh LoRA phase: examples/finetune_llama31.yaml's body on the one
# card -- LoRA at its LORA_RANK (16) on q/k/v/o, the base frozen -- at the
# mesh phase's llama3-8b (full width, MESH_LAYERS of 32 layers, 1 x 8192
# a card), under MeshSpec(fsdp=1) on the one-rank NCCL group beside the
# no-mesh LoRA trainer.  Depth 2 in f32 with B drawn non-zero (so A has
# a gradient): the mesh trainer against the no-mesh one, the mesh phase's
# loss bound and the train phase's gradient bound.


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def lora_probe(trainer):
    """mesh_full_width's probe of a LoRA trainer: the base parameters'
    local shards copied after setup; after the steps, whether every one
    is byte-identical and the element count of the Adam moments (each
    adapter parameter's first moment)."""
    base = {n: local_tensor(p.detach()).clone()
            for n, p in trainer.state.model.named_parameters()
            if not lora.is_lora_path(n)}

    def after(tr) -> dict:
        frozen = all(torch.equal(local_tensor(p.detach()), base[n])
                     for n, p in tr.state.model.named_parameters()
                     if not lora.is_lora_path(n))
        moments = sum(local_tensor(st['exp_avg']).numel()
                      for st in tr.state.optimizer.state.values())
        base.clear()
        return {'base_byte_identical': frozen,
                'adam_moment_params': moments}

    return after


def mesh_lora_depth2(full) -> dict:
    """One LoRA step at depth 2 in f32 of the mesh trainer
    (MeshSpec(fsdp=1)) and of the no-mesh trainer from the same weights
    (B at std 0.02) and batch: the loss, the adapters' gradients and the
    launches of each."""
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    cfg2 = dataclasses.replace(full, num_layers=2, dtype=torch.float32,
                               lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
    gen = torch.Generator(device='cuda').manual_seed(0)
    sd = {k: (torch.randn(v.shape, generator=gen, device='cuda') * 0.02
              if k.endswith('lora_b') else v).cpu()
          for k, v in iter_params(cfg2, gen)}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg2.vocab_size, (1, MESH_CHECK_SEQ + 1)))
    res = {}
    for name, mesh in (('no_mesh', None), ('mesh', MeshSpec(fsdp=1))):
        tr = train_lib.Trainer(train_lib.TrainConfig(
            model=MESH_MODEL, batch_size=1, seq_len=MESH_CHECK_SEQ,
            warmup_steps=2, total_steps=100, mesh=mesh), cfg2,
            device='cuda')
        tr.setup(params=sd)
        tally = [0, 0, 0]
        m = counted(lambda: tr._step_fn(tr.state, {'tokens': tokens}),
                    tally)
        res[name] = (m['loss'].item(), mesh_grads(tr), tally)
        del tr, m
        gc.collect()
        torch.cuda.empty_cache()
    del sd
    (lm, gm, tm), (ln, gn, tn) = res['mesh'], res['no_mesh']
    check(set(gm) == set(gn) and gn and
          all(lora.is_lora_path(n) for n in gn),
          'depth-2: gradients beyond the adapters')
    grad_err, worst = grad_errors(gm, gn)
    return {'num_layers': 2, 'seq': MESH_CHECK_SEQ, 'loss_mesh': lm,
            'loss_no_mesh': ln, 'loss_rel_err': abs(lm - ln) / abs(ln),
            'adapter_grad_max_rel_err': grad_err, 'grad_worst': worst,
            'adapter_grads': len(gn), 'launches_mesh': tm,
            'launches_no_mesh': tn}


def phase_mesh_lora(env: dict, mesh_line: dict) -> tuple:
    """LoRA under a mesh (ROADMAP A9.3) on the one-rank NCCL group: (a)
    depth 2 in f32, the mesh LoRA trainer against the no-mesh one (loss
    BOUND_MESH_LOSS relative, adapter gradients BOUND_DEPTH2_GRAD of their
    max, 4/2/2 launches); (b) llama3-8b at full width, MESH_LAYERS
    layers, 1 x 8192, rank 16 on q/k/v/o, no mesh then MeshSpec(fsdp=1):
    8/4/4 launches a step, the step-1 loss the base model's (B = 0: the
    mesh phase's trainers on the same seed-0 weights and batch, within
    BOUND_MESH_LOSS), the base byte-identical after the steps, Adam
    moments for exactly the adapters' parameters.  Records step ms and
    peak memory beside the no-mesh LoRA trainer's and the mesh phase's.
    Returns the mesh LoRA trainer's launches over its steps and the
    line."""
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    full = get_model_config(MESH_MODEL)
    depth2 = mesh_lora_depth2(full)
    check(depth2['launches_mesh'] == [4, 2, 2] ==
          depth2['launches_no_mesh'],
          f'depth-2 launches {depth2["launches_mesh"]} (mesh), '
          f'{depth2["launches_no_mesh"]} (no mesh), expected [4, 2, 2]')
    check(depth2['loss_rel_err'] <= BOUND_MESH_LOSS
          and depth2['adapter_grad_max_rel_err'] <= BOUND_DEPTH2_GRAD,
          f'depth-2 f32 LoRA mesh vs no mesh: {depth2}')
    mc = dataclasses.replace(full, num_layers=MESH_LAYERS,
                             lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
    want_params = lora_param_count(mc)
    expected = [2 * MESH_LAYERS, MESH_LAYERS, MESH_LAYERS]
    runs = {}
    for name, mesh in (('no_mesh', None), ('mesh', MeshSpec(fsdp=1))):
        launches, runs[name] = mesh_full_width(mc, mesh, lora_probe)
        run = runs[name]
        check(run['launches_per_step'] == [expected] * MESH_STEPS,
              f'{name} LoRA launches per step {run["launches_per_step"]}, '
              f'expected {expected}')
        base_loss = mesh_line['runs'][name]['losses'][0]
        run['base_model_step1_loss'] = base_loss
        run['step1_rel_err'] = abs(run['losses'][0] - base_loss) / base_loss
        check(run['step1_rel_err'] <= BOUND_MESH_LOSS,
              f'{name} LoRA step-1 loss {run["losses"][0]}, the base '
              f'model\'s {base_loss}')
        check(run['base_byte_identical'] and
              run['adam_moment_params'] == want_params,
              f'{name}: base identical {run["base_byte_identical"]}, Adam '
              f'moments for {run["adam_moment_params"]} parameters, '
              f'adapters {want_params}')
    line = {'phase': 'mesh_lora', 'model': MESH_MODEL,
            'device': env['device'], 'nvidia_smi': env['nvidia_smi'],
            'lora': {'rank': LORA_RANK, 'alpha': LORA_ALPHA,
                     'targets': list(mc.lora_targets),
                     'adapter_params': want_params},
            'mesh': list(MeshSpec(fsdp=1).shape),
            'num_layers': MESH_LAYERS, 'of_layers': full.num_layers,
            'batch': list(MESH_BATCH), 'dtype': str(mc.dtype),
            'reduced': f'depth {full.num_layers} -> {MESH_LAYERS}, as the '
                       'mesh phase (its full-training state bounds it)',
            'depth2_f32': depth2,
            'depth2_bounds': [BOUND_MESH_LOSS, BOUND_DEPTH2_GRAD],
            'runs': runs,
            'step_ms_ratio_mesh_over_no_mesh':
                runs['mesh']['step_ms'] / runs['no_mesh']['step_ms'],
            'full_training_mesh': {k: mesh_line['runs']['mesh'][k] for k in
                                   ('step_ms', 'max_memory_allocated_gib')}}
    emit(line)
    return launches, line


def phase_dryrun(env: dict) -> tuple:
    """``dryrun_multichip(torch.cuda.device_count())``: the training legs of
    the reference's multi-chip dryrun over this host's cards (a leg that
    needs an even rank count is skipped, with the reason printed, on an odd
    count -- decided from the count before any leg starts); each leg's
    lines on stderr.  Returns the launches of the legs and the line."""
    from skypilot_tpu_torch.entry import dryrun_multichip
    n = torch.cuda.device_count()
    lines = []

    def log(text):
        lines.append(text)
        stderr_log(text)

    tally = [0, 0, 0]
    losses = counted(lambda: dryrun_multichip(n, device='cuda', log=log),
                     tally)
    want = {'dp', 'ep'} | ({'sp', 'pp'} if n % 2 == 0 else set())
    check(set(losses) == want and all(math.isfinite(x)
                                      for x in losses.values()),
          f'dryrun legs {losses}, expected {sorted(want)}')
    check(all(tally), f'dryrun launched {tally}')
    line = {'phase': 'dryrun', 'device': env['device'],
            'nvidia_smi': env['nvidia_smi'], 'ranks': n, 'losses': losses,
            'lines': lines, 'launches': tally}
    emit(line)
    return tally, line


# -------------------------------------------------------------- serve_tp
# Tensor-parallel serving (ROADMAP A9.2) on the one card: two ranks, each
# a process of its own, in a gloo group whose collectives run on CUDA
# tensors (the card host shows one H100 and NCCL refuses two ranks on one
# card).  (a) depth 2 in f32 at llama2-7b's widths: the tp=2 engine
# against the tp=1 engine; (b) llama2-7b at full width and depth in bf16
# at examples/serve_llama.yaml's engine flags (--decode-steps 32
# --cache-dtype fp8), tp=2 of its 8, slots and cache cut to what two
# ranks' fp8 caches and weights hold on one card; a paged radix engine
# over a bf16 cache on the same weights; (c) Mixtral at depth 2 in f32 at
# mixtral-8x7b's widths, 8 experts over 2 ranks; (e) multi-LoRA and (f)
# gpt2-large (their constants below).  The ranks' collectives are plain
# torch.distributed calls: DTensor's functional collectives segfault in
# wait_tensor over gloo on CUDA tensors (my probe, PR 16), so no DTensor
# path (tensor-parallel training) runs on two ranks here.
TP_MODEL = 'llama2-7b'
TP_SERVE = dict(num_slots=16, max_cache_len=512, decode_steps=32,
                max_new_tokens=32, prefill_buckets=(64, 128, 256, 512))
TP_REQUESTS = 8
TP_PAGED = dict(kv_block_size=16, auto_prefix_cache=True)
TP_SYSTEM_PROMPT = 128          # tokens shared by the paged waves
TP_F32_LAYERS = 2
TP_F32_SERVE = dict(num_slots=8, max_cache_len=512, decode_steps=8,
                    max_new_tokens=16, prefill_buckets=(64, 128, 256, 512),
                    cache_dtype=torch.float32)
TP_F32_REQUESTS = 8
TP_MIXTRAL_SERVE = dict(num_slots=4, max_cache_len=256, decode_steps=8,
                        max_new_tokens=16, prefill_buckets=(64, 128, 256),
                        cache_dtype=torch.float32)
TP_MIXTRAL_REQUESTS = 4
# f32 on both sides, the tensor split sums two ranks' partial outputs in
# another order: the serve phase's f32 "sum order only" bound.
TP_F32_BOUND = 2e-3
# The recorded window: 8 of the recipe's 32 steps (every step of it is a
# host round trip through gloo; recorded, not gated).
TP_WINDOW_STEPS = 8
# (d) the protocol's host cost: decode windows of a one-rank mesh engine
# against the no-mesh engine, in turns.
TP_HOST_MODEL = 'llama-1b'
TP_HOST_SERVE = dict(num_slots=8, max_cache_len=512, decode_steps=8,
                     max_new_tokens=32, prefill_buckets=(64, 128, 256))


def tp_prompts(vocab: int, n: int, seed: int, prefix=()) -> list:
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(0, vocab, int(rng.integers(
        20, 200))).tolist() for _ in range(n)]


def tp_engine(cfg, infer: dict, mesh=None) -> InferenceEngine:
    """An engine of `cfg` drawn from seed 0 on the card: every rank of a
    mesh draws the same tensors and keeps its slice."""
    return InferenceEngine(cfg, InferConfig(model=cfg.name, **infer),
                           device='cuda', mesh=mesh,
                           generator=torch.Generator(
                               device='cuda').manual_seed(0))


def tp_served(rank: int, eng: InferenceEngine, fn):
    """fn() on rank 0, then the other ranks released; the other ranks run
    rank 0's dispatches meanwhile.  Returns fn()'s result, everywhere (a
    broadcast from rank 0)."""
    from torch import distributed as dist
    out = [None]
    if rank == 0:
        try:
            out[0] = fn()
        finally:
            eng.shutdown()
    else:
        eng.serve_worker()
    dist.broadcast_object_list(out, src=0, group=eng._tpc.ctl)
    return out[0]


def tp_results(results: list) -> list:
    """What the lockstep scoring needs of each result (picklable)."""
    return [types.SimpleNamespace(
        prompt_tokens=r.prompt_tokens, output_tokens=r.output_tokens,
        logprobs=r.logprobs, finish_reason=r.finish_reason,
        ttft_s=r.ttft_s) for r in results]


def tp_lockstep_gaps(eng, results, tally: list) -> dict:
    """Every rank's no-cache forward over each request's prompt + output
    (the flash kernel at this rank's heads; the model's collectives meet
    because every rank scores the same tokens in the same order): the
    teacher-forced gaps against the reported logprobs, and a control
    scoring random tokens in place of the outputs."""
    from skypilot_tpu_torch.parallel.mesh import mesh_context
    with mesh_context(eng._mesh):
        gaps = counted(lambda: teacher_forced_gaps(eng.model, results),
                       tally)
        rng = np.random.default_rng(5)
        control = [types.SimpleNamespace(
            prompt_tokens=r.prompt_tokens, logprobs=r.logprobs,
            output_tokens=rng.integers(0, eng.model_config.vocab_size,
                                       len(r.output_tokens)).tolist())
                   for r in results[:4]]
        ctl = teacher_forced_gaps(eng.model, control)
    return {'max': gaps.max().item(), 'mean': gaps.mean().item(),
            'control_max': ctl.max().item()}


def tp_cache_bytes(eng) -> int:
    return sum(k.numel() * k.element_size() + v.numel() * v.element_size()
               for k, v in eng.cache)


def tp_window_ms(eng) -> dict:
    """A decode window of TP_WINDOW_STEPS steps over every slot at cache
    position 256, run by every rank in lockstep outside the protocol
    (after shutdown), under the profiler: this rank's wall and device
    time."""
    from skypilot_tpu_torch.parallel.mesh import mesh_context
    n = eng.cfg.num_slots

    def window():
        with mesh_context(eng._mesh):
            type(eng)._decode.raw(
                eng, torch.zeros(n, dtype=torch.long, device='cuda'),
                torch.full((n,), 256, dtype=torch.long, device='cuda'),
                torch.zeros(n, device='cuda'), TP_WINDOW_STEPS)

    return {'steps': TP_WINDOW_STEPS, **profile_device(window)}


def tp_depth2(rank: int, mesh) -> dict:
    """(a): tp=2 against tp=1 at depth 2 in f32, llama2-7b's widths."""
    cfg = dataclasses.replace(get_model_config(TP_MODEL),
                              num_layers=TP_F32_LAYERS, dtype=torch.float32)
    prompts = tp_prompts(cfg.vocab_size, TP_F32_REQUESTS, 21)
    eng = tp_engine(cfg, TP_F32_SERVE, mesh)
    got = tp_served(rank, eng, lambda: tp_results(eng.generate(
        [Request(tokens=p) for p in prompts])))
    out = {'heads': int(eng.cache[0][0].shape[1])}
    del eng
    torch.cuda.empty_cache()
    if rank == 0:
        want = tp_engine(cfg, TP_F32_SERVE).generate(
            [Request(tokens=p) for p in prompts])
        out['tokens_identical'] = all(
            g.output_tokens == w.output_tokens for g, w in zip(got, want))
        out['logprob_max_abs_err'] = max(
            abs(a - b) for g, w in zip(got, want)
            for a, b in zip(g.logprobs, w.logprobs))
        torch.cuda.empty_cache()
    return out


def tp_full(rank: int, mesh, tally: list) -> dict:
    """(b): llama2-7b at full width and depth, tp=2, bf16 weights."""
    cfg = get_model_config(TP_MODEL)
    prompts = tp_prompts(cfg.vocab_size, TP_REQUESTS, 23)
    out = {}
    eng = tp_engine(cfg, {**TP_SERVE, 'cache_dtype': llama.FP8}, mesh)
    out['cache_bytes'] = tp_cache_bytes(eng)
    out['cache_bytes_tp1'] = tp_cache_bytes(types.SimpleNamespace(
        cache=llama.init_cache(cfg, TP_SERVE['num_slots'],
                               TP_SERVE['max_cache_len'], llama.FP8,
                               'meta')))

    def serve():
        res = {'shard': sanitizers.check_shard_layout(eng)}
        k, v = eng.cache[0]
        eng.cache[0] = (torch.empty((k.shape[0], cfg.num_kv_heads)
                                    + tuple(k.shape[2:]), dtype=k.dtype,
                                    device='meta'), v)
        try:
            sanitizers.check_shard_layout(eng)
            res['drift_raised'] = False
        except sanitizers.ShardLayoutError as e:
            res['drift_raised'], res['drift'] = True, str(e)[:300]
        finally:
            eng.cache[0] = (k, v)
        runs = []
        for _ in range(2):          # a first run, then one timed
            results, wall = timed_generate(
                eng, [Request(tokens=p, request_id=str(i))
                      for i, p in enumerate(prompts)])
            runs.append((tp_results(results), wall))
        res['tokens_repeat'] = all(
            a.output_tokens == b.output_tokens
            for a, b in zip(runs[0][0], runs[1][0]))
        res['results'], res['wall_s'] = runs[1]
        res['stats'] = eng.stats()['kv']
        return res

    res = tp_served(rank, eng, serve)
    res['window'] = tp_window_ms(eng)
    res['gaps_fp8'] = tp_lockstep_gaps(eng, res['results'], tally)
    results = res.pop('results')
    n_tok = sum(len(r.output_tokens) for r in results)
    res['tok_per_s'] = n_tok / res['wall_s']
    res['ttft_s_p50'] = float(np.median([r.ttft_s for r in results]))
    res['finishes'] = sorted({r.finish_reason for r in results})
    out.update(res)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # The same weights over a bf16 paged radix pool: two waves behind a
    # shared system prompt, the second one's prefixes from the tree.
    eng = tp_engine(cfg, {**TP_SERVE, **TP_PAGED}, mesh)
    system = tp_prompts(cfg.vocab_size, 1, 29)[0][:TP_SYSTEM_PROMPT]
    system += [7] * (TP_SYSTEM_PROMPT - len(system))
    waves = [tp_prompts(cfg.vocab_size, TP_REQUESTS // 2, 31 + w,
                        prefix=system) for w in range(2)]

    def paged():
        log = audited_windows(eng)
        res = {}
        for w, wave in enumerate(waves):
            results = eng.generate([Request(tokens=p) for p in wave])
            res[f'wave{w}'] = tp_results(results)
        res['radix'] = dict(eng.radix_stats)
        res['windows_audited'], res['conservation'] = log[0], log[1:]
        res['conservation'] += conservation_errors(eng)
        return res

    res = tp_served(rank, eng, paged)
    res['gaps_bf16'] = tp_lockstep_gaps(
        eng, res['wave0'] + res['wave1'], tally)
    del res['wave0'], res['wave1']
    out['paged'] = res
    out['heads'] = int(eng.cache[0][0].shape[1])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_mixtral(rank: int, mesh) -> dict:
    """(c): Mixtral at depth 2 in f32, mixtral-8x7b's widths, tp=2 (each
    rank 4 of the 8 experts) against tp=1."""
    cfg = dataclasses.replace(get_model_config(MIXTRAL_MODEL),
                              num_layers=TP_F32_LAYERS, dtype=torch.float32)
    prompts = tp_prompts(cfg.vocab_size, TP_MIXTRAL_REQUESTS, 37)
    eng = tp_engine(cfg, TP_MIXTRAL_SERVE, mesh)
    got = tp_served(rank, eng, lambda: tp_results(eng.generate(
        [Request(tokens=p) for p in prompts])))
    out = {'experts_a_rank': int(eng.model.layers[0].moe.w_gate.shape[0])}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        want = tp_engine(cfg, TP_MIXTRAL_SERVE).generate(
            [Request(tokens=p) for p in prompts])
        out['tokens_identical'] = all(
            g.output_tokens == w.output_tokens for g, w in zip(got, want))
        out['logprob_max_abs_err'] = max(
            abs(a - b) for g, w in zip(got, want)
            for a, b in zip(g.logprobs, w.logprobs))
        gc.collect()
        torch.cuda.empty_cache()
    return out


# The sixteenth slice's legs (ROADMAP A9.3).  (e) multi-LoRA at tp=2,
# llama2-7b's widths: depth 2 in f32 (two adapters at B std 0.5, base and
# adapter requests in one batch) against tp=1; then
# examples/serve_lora.yaml's flags (--lora-rank 16 --lora-max-adapters 8)
# with int8 weights and the fp8 cache, three adapters registered (B at
# LORA_B_STD), at TP_LORA_LAYERS of 32 layers, every adapter stream held
# against the no-cache forward of a rank-local single-adapter model and,
# over a fresh fp8 cache, against its cached forward, with the
# lora_serve phase's controls (the next adapter's model, the base).
# (f) gpt2-large at tp=2 (10 of 20 heads a rank): depth 2 in f32 against
# tp=1, then its 36 layers in bf16 at the gpt2 phase's flags.
TP_LORA = dict(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
TP_LORA_LAYERS = 8
TP_LORA_SERVE = dict(TP_SERVE, cache_dtype=llama.FP8, lora_max_adapters=8,
                     **TP_LORA)
# The multi-LoRA gates: each adapter stream against its single-adapter
# model's cached forward over a fresh fp8 cache (the same quantized rows)
# within the lora_serve phase's bf16 bound, and against its no-cache
# forward (the flash kernel) within int8_hf's INT8_BOUND, which holds the
# fp8 cache's own rounding (0.44 nats at 8 layers on an NVIDIA H100 80GB
# HBM3, 700 W, above the 0.25 of a bf16 cache); the controls (the next
# adapter's model, the base model) must exceed each.
TP_LORA_BOUND = 0.25
TP_GPT2_SERVE = dict(num_slots=8, max_cache_len=1024, decode_steps=32,
                     max_new_tokens=32, prefill_buckets=(64, 128, 256))


def tp_adapter_tree(eng, seed: int, b_std: float) -> dict:
    """A rank-16 adapter of the engine's full (unsliced) stacked shapes,
    every leaf drawn with numpy from `seed` (rank 0 registers it; each
    rank receives its slices)."""
    rng = np.random.default_rng(seed)
    return lora.nest({
        lora.flax_path(name): rng.normal(
            0, b_std if name.endswith('lora_b') else 0.02,
            eng._full_shapes.get(name, tuple(p.shape))[1:]).astype(
                np.float32)
        for name, p in eng.model.named_parameters()
        if lora.is_lora_path(name)})


def tp_adapter_results(results: list, adapters: list) -> list:
    out = tp_results(results)
    for r, a in zip(out, adapters):
        r.adapter = a
    return out


def tp_lora_depth2(rank: int, mesh) -> dict:
    """(e), depth 2 in f32: tp=2 against tp=1 on the same weights and
    adapters."""
    cfg = dataclasses.replace(get_model_config(TP_MODEL),
                              num_layers=TP_F32_LAYERS, dtype=torch.float32)
    names = [None, 'f32_a', 'f32_b']
    prompts = [p for p in tp_prompts(cfg.vocab_size, 3, 43)
               for _ in names]
    adapters = names * 3
    infer = dict(TP_F32_SERVE, lora_max_adapters=2, **TP_LORA)
    eng = tp_engine(cfg, infer, mesh)

    def serve():
        trees = [tp_adapter_tree(eng, 20 + i, LORA_B_STD_F32)
                 for i in range(2)]
        for name, tree in zip(names[1:], trees):
            eng.register_adapter(name, tree)
        res = eng.generate([Request(tokens=p, adapter=a)
                            for p, a in zip(prompts, adapters)])
        return tp_adapter_results(res, adapters), trees

    got, trees = tp_served(rank, eng, serve)
    out = {'lora_b_q_cols_a_rank': int(
        eng.model.layers[0].attn.q_proj_lora.lora_b.shape[-1])}
    del eng
    torch.cuda.empty_cache()
    if rank == 0:
        ref = tp_engine(cfg, infer)
        for name, tree in zip(names[1:], trees):
            ref.register_adapter(name, tree)
        want = ref.generate([Request(tokens=p, adapter=a)
                             for p, a in zip(prompts, adapters)])
        out['tokens_identical'] = all(
            g.output_tokens == w.output_tokens for g, w in zip(got, want))
        out['logprob_max_abs_err'] = max(
            abs(a - b) for g, w in zip(got, want)
            for a, b in zip(g.logprobs, w.logprobs))
        out['adapter_streams_differing_from_base'] = sum(
            g.output_tokens != b.output_tokens
            for g, b in zip(got[1::3], got[0::3]))
        del ref
        torch.cuda.empty_cache()
    return out


def tp_single_adapter_model(eng, slot: Optional[int]) -> llama.Llama:
    """single_adapter_model on one rank of a tensor-parallel engine: the
    rank's slices of the base weights with stack slot `slot`'s adapter
    slices, a rank-local model (slot None: the base)."""
    cfg = dataclasses.replace(eng._local_config, lora_num_adapters=0)
    if slot is None:
        cfg = dataclasses.replace(cfg, lora_rank=0)
    model = llama.Llama(cfg, device='cuda').eval()
    model.load_state_dict({k: (v[slot] if lora.is_lora_path(k) else v)
                           for k, v in eng.model.state_dict().items()
                           if slot is not None or not lora.is_lora_path(k)})
    return model


def tp_adapter_gaps(eng, results: list, names: list, tally: list) -> dict:
    """Every rank in lockstep (after shutdown): each adapter's streams
    against its rank-local single-adapter model, the no-cache forward
    (the flash kernel, launches into `tally`) and the cached forward over
    a fresh fp8 cache; the controls: each stream against the next
    adapter's model and the base model (no-cache and cached)."""
    from skypilot_tpu_torch.parallel.mesh import mesh_context
    out = {}
    with mesh_context(eng._mesh):
        base = tp_single_adapter_model(eng, None)
        for slot, name in enumerate(names):
            mine = [r for r in results if r.adapter == name]
            ref = tp_single_adapter_model(eng, slot)
            other = tp_single_adapter_model(eng, (slot + 1) % len(names))
            out[name] = {
                'no_cache': counted(lambda: teacher_forced_err(ref, mine),
                                    tally),
                'cache_fp8': teacher_forced_err(ref, mine, True,
                                                llama.FP8),
                'control_next_no_cache': teacher_forced_err(other, mine),
                'control_next_cache_fp8': teacher_forced_err(
                    other, mine, True, llama.FP8),
                'control_base_no_cache': teacher_forced_err(base, mine),
                'control_base_cache_fp8': teacher_forced_err(
                    base, mine, True, llama.FP8)}
            del ref, other
            torch.cuda.empty_cache()
    return out


def tp_lora_full(rank: int, mesh, tally: list) -> dict:
    """(e) at serve_lora.yaml's flags with int8 weights and the fp8 cache,
    TP_LORA_LAYERS layers, three adapters; the shard check passing and
    raising on a planted adapter drift (a q_proj lora_b stack at its full
    width on rank 0)."""
    cfg = dataclasses.replace(get_model_config(TP_MODEL),
                              num_layers=TP_LORA_LAYERS,
                              weight_dtype='int8')
    names = ['ad1', 'ad2', 'ad3']
    prompts = [p for p in tp_prompts(cfg.vocab_size, TP_REQUESTS // 4, 47)
               for _ in range(4)]
    adapters = [None, *names] * (TP_REQUESTS // 4)
    eng = tp_engine(cfg, TP_LORA_SERVE, mesh)

    def serve():
        res = {'shard': sanitizers.check_shard_layout(eng)}
        attn = eng.model.layers[0].attn
        old = attn.q_proj_lora.lora_b
        attn.q_proj_lora.lora_b = torch.nn.Parameter(torch.empty(
            eng._full_shapes['layers.0.attn.q_proj_lora.lora_b'],
            device='meta'), requires_grad=False)
        try:
            sanitizers.check_shard_layout(eng)
            res['drift_raised'] = False
        except sanitizers.ShardLayoutError as e:
            res['drift_raised'], res['drift'] = True, str(e)[:300]
        finally:
            attn.q_proj_lora.lora_b = old
        for i, name in enumerate(names):
            res[f'slot_{name}'] = eng.register_adapter(
                name, tp_adapter_tree(eng, 10 + i, LORA_B_STD))
        results, wall = timed_generate(
            eng, [Request(tokens=p, adapter=a, request_id=str(i))
                  for i, (p, a) in enumerate(zip(prompts, adapters))])
        res['results'] = tp_adapter_results(results, adapters)
        res['wall_s'] = wall
        res['stats'] = eng.stats()['kv']
        return res

    res = tp_served(rank, eng, serve)
    results = res.pop('results')
    res['gaps'] = tp_adapter_gaps(eng, results, names, tally)
    res['adapter_streams_differing_from_base'] = sum(
        r.output_tokens != b.output_tokens
        for r, b in zip(results, [results[i - i % 4]
                                  for i in range(len(results))])
        if r.adapter)
    res['finishes'] = sorted({r.finish_reason for r in results})
    res['tok_per_s'] = sum(len(r.output_tokens)
                           for r in results) / res['wall_s']
    res['lora_a_o_rows_a_rank'] = int(
        eng.model.layers[0].attn.o_proj_lora.lora_a.shape[1])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_gpt2_depth2(rank: int, mesh) -> dict:
    """(f), depth 2 in f32 at gpt2-large's widths: tp=2 against tp=1."""
    cfg = dataclasses.replace(get_model_config(GPT2_SERVE_MODEL),
                              num_layers=TP_F32_LAYERS, dtype=torch.float32)
    prompts = tp_prompts(cfg.vocab_size, TP_F32_REQUESTS, 53)
    eng = tp_engine(cfg, TP_F32_SERVE, mesh)
    got = tp_served(rank, eng, lambda: tp_results(eng.generate(
        [Request(tokens=p) for p in prompts])))
    out = {'heads': int(eng.cache[0][0].shape[1])}
    del eng
    torch.cuda.empty_cache()
    if rank == 0:
        want = tp_engine(cfg, TP_F32_SERVE).generate(
            [Request(tokens=p) for p in prompts])
        out['tokens_identical'] = all(
            g.output_tokens == w.output_tokens for g, w in zip(got, want))
        out['logprob_max_abs_err'] = max(
            abs(a - b) for g, w in zip(got, want)
            for a, b in zip(g.logprobs, w.logprobs))
        torch.cuda.empty_cache()
    return out


def tp_gpt2_full(rank: int, mesh, tally: list) -> dict:
    """(f) gpt2-large at its 36 layers in bf16, tp=2: the streams' gap
    against the rank-local no-cache forward, with a random-token
    control."""
    cfg = get_model_config(GPT2_SERVE_MODEL)
    prompts = tp_prompts(cfg.vocab_size, TP_REQUESTS, 59)
    eng = tp_engine(cfg, TP_GPT2_SERVE, mesh)

    def serve():
        res = {'shard': sanitizers.check_shard_layout(eng)}
        results, res['wall_s'] = timed_generate(
            eng, [Request(tokens=p, request_id=str(i))
                  for i, p in enumerate(prompts)])
        res['results'] = tp_results(results)
        return res

    res = tp_served(rank, eng, serve)
    res['gaps'] = tp_lockstep_gaps(eng, res['results'], tally)
    results = res.pop('results')
    res['tok_per_s'] = sum(len(r.output_tokens)
                           for r in results) / res['wall_s']
    res['finishes'] = sorted({r.finish_reason for r in results})
    res['heads'] = int(eng.cache[0][0].shape[1])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_tp_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank of the serve_tp phase: (a), (b) and (c) over a gloo group
    on card 0; its result (or traceback) as JSON in out_dir."""
    import traceback

    from torch import distributed as dist

    from skypilot_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    res = {}
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group('gloo', init_method=init, rank=rank,
                                world_size=world)
        mesh = make_mesh(MeshSpec(tensor=world), 'cuda')
        tally = [0, 0, 0]
        seconds = {}
        for name, fn in (('depth2_f32', lambda: tp_depth2(rank, mesh)),
                         ('full', lambda: tp_full(rank, mesh, tally)),
                         ('mixtral_f32', lambda: tp_mixtral(rank, mesh)),
                         ('lora_f32', lambda: tp_lora_depth2(rank, mesh)),
                         ('lora_int8_fp8',
                          lambda: tp_lora_full(rank, mesh, tally)),
                         ('gpt2_f32', lambda: tp_gpt2_depth2(rank, mesh)),
                         ('gpt2_large',
                          lambda: tp_gpt2_full(rank, mesh, tally))):
            t0 = time.perf_counter()
            res[name] = fn()
            seconds[name] = time.perf_counter() - t0
        res['launches'], res['seconds'] = tally, seconds
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- shipped to the parent
        res['error'] = traceback.format_exc()[-4000:]
    pathlib.Path(out_dir, f'rank{rank}.json').write_text(
        json.dumps(res, default=str))


def tp_host_cost() -> dict:
    """(d): decode windows of a one-rank mesh engine (every dispatch
    broadcast and run through the protocol) against the no-mesh engine on
    the same weights, in turns (no mesh, mesh, mesh, no mesh): the median
    wall time of a window each."""
    from skypilot_tpu_torch.parallel.mesh import (MeshSpec,
                                                  ensure_process_group,
                                                  make_mesh)
    ensure_process_group('cuda')
    cfg = get_model_config(TP_HOST_MODEL)
    mesh = make_mesh(MeshSpec(tensor=1), 'cuda')
    engines = {'no_mesh': tp_engine(cfg, TP_HOST_SERVE),
               'mesh': tp_engine(cfg, TP_HOST_SERVE, mesh)}
    prompts = tp_prompts(cfg.vocab_size, TP_HOST_SERVE['num_slots'], 41)
    walls = {name: [] for name in engines}
    tokens = {}
    for name in ('no_mesh', 'mesh', 'mesh', 'no_mesh'):
        eng = engines[name]
        step = eng._step

        def timed_step(_step=step, _log=walls[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _step()
            _log.append(1e3 * (time.perf_counter() - t0))

        eng._step = timed_step
        res = eng.generate([Request(tokens=p) for p in prompts])
        del eng._step
        tokens.setdefault(name, [r.output_tokens for r in res])
    engines['mesh'].shutdown()
    med = {name: float(np.median(w)) for name, w in walls.items()}
    return {'model': TP_HOST_MODEL, 'config': TP_HOST_SERVE,
            'windows': {k: len(v) for k, v in walls.items()},
            'window_wall_ms_median': med,
            'ratio_mesh_over_no_mesh': med['mesh'] / med['no_mesh'],
            'tokens_identical': tokens['mesh'] == tokens['no_mesh']}


def phase_serve_tp(env: dict) -> tuple:
    """Tensor-parallel serving (see the constants' comment): (a)-(c) on two
    ranks sharing the card, spawned here; (d) the protocol's host cost on
    this process's one-rank NCCL group.  Gates: (a) and (c) greedy tokens
    identical to tp=1, logprobs within TP_F32_BOUND; (b) the teacher-forced
    gap against the no-cache forward within INT8_BOUND over the fp8 cache
    and INT8_TIGHT_BOUND over a bf16 cache, a random-token control above
    INT8_BOUND, each rank's cache bytes exactly half of tp=1's, stats()'s
    per-chip bytes total // 2, check_shard_layout passing and raising on
    a planted drift, the paged second wave's radix hits and conservation
    exact; every rank ran the forward kernel; (e) multi-LoRA at depth 2 in
    f32 tokens identical to tp=1 and logprobs within TP_F32_BOUND, at
    int8 + fp8 each adapter stream within TP_LORA_BOUND of its rank-local
    single-adapter model's cached forward over fp8 and within INT8_BOUND
    of its no-cache forward, the controls above each, the shard check
    passing and raising on a planted adapter drift, the adapter slices'
    widths; (f) gpt2-large at depth 2 in f32 tokens identical to tp=1,
    at 36 layers in bf16 the gap within GPT2_BOUND and a control above
    it, 10 heads a rank.  Returns the kernels' launches (both ranks) and
    the line."""
    import multiprocessing as mproc
    out_dir = tempfile.mkdtemp(prefix='serve_tp_')
    init = 'file://' + str(pathlib.Path(out_dir, 'store'))
    ctx = mproc.get_context('spawn')
    t0 = time.perf_counter()
    host = tp_host_cost()          # before the ranks share the card
    gc.collect()
    torch.cuda.empty_cache()
    procs = [ctx.Process(target=serve_tp_rank, args=(r, 2, init, out_dir))
             for r in range(2)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(900)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        path = pathlib.Path(out_dir, f'rank{r}.json')
        check(path.exists(), f'serve_tp rank {r} left no result')
        ranks.append(json.loads(path.read_text()))
        check('error' not in ranks[r],
              f'serve_tp rank {r} failed:\n{ranks[r].get("error")}')
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    a, b, c = r0['depth2_f32'], r0['full'], r0['mixtral_f32']
    check(a['tokens_identical'] and a['logprob_max_abs_err'] <= TP_F32_BOUND,
          f'(a) depth-2 f32 tp=2 vs tp=1: {a}')
    check(c['tokens_identical'] and c['logprob_max_abs_err'] <= TP_F32_BOUND,
          f'(c) Mixtral depth-2 f32 tp=2 vs tp=1: {c}')
    cfg = get_model_config(TP_MODEL)
    for r, rank in enumerate(ranks):
        f = rank['full']
        check(f['cache_bytes'] * 2 == f['cache_bytes_tp1'],
              f'rank {r} cache bytes {f["cache_bytes"]}, tp=1 '
              f'{f["cache_bytes_tp1"]}')
        check(f['heads'] == cfg.num_kv_heads // 2 and
              rank['mixtral_f32']['experts_a_rank'] == 4,
              f'rank {r}: {f["heads"]} kv heads, '
              f'{rank["mixtral_f32"]["experts_a_rank"]} experts')
        check(rank['launches'][0] > 0,
              f'rank {r} ran the forward kernel {rank["launches"]} times')
    kv = b['stats']['bytes']
    check(kv['per_chip_total'] * 2 == kv['total'] and
          kv['per_chip_resident'] * 2 == kv['resident'] and
          b['stats']['tp'] == 2, f'(b) stats: {b["stats"]}')
    check(b['shard']['tensor_degree'] == 2 and
          b['shard']['param_leaves_sharded'] > 0 and b['drift_raised'],
          f'(b) shard layout {b["shard"]}, drift raised: '
          f'{b["drift_raised"]}')
    check(b['tokens_repeat'] and b['finishes'] == ['length'],
          f'(b) repeat {b["tokens_repeat"]}, finishes {b["finishes"]}')
    check(b['gaps_fp8']['max'] <= INT8_BOUND, f'(b) fp8 gap {b["gaps_fp8"]}')
    check(b['gaps_fp8']['control_max'] > INT8_BOUND,
          f'(b) control {b["gaps_fp8"]}: the gate cannot fail')
    p = b['paged']
    check(p['gaps_bf16']['max'] <= INT8_TIGHT_BOUND,
          f'(b) paged bf16 gap {p["gaps_bf16"]}')
    check(p['radix']['hits'] > 0 and p['conservation'] == [] and
          p['windows_audited'] > 0, f'(b) paged radix {p}')
    e, e8 = r0['lora_f32'], r0['lora_int8_fp8']
    check(e['tokens_identical'] and e['logprob_max_abs_err'] <= TP_F32_BOUND
          and e['adapter_streams_differing_from_base'] > 0,
          f'(e) multi-LoRA depth-2 f32 tp=2 vs tp=1: {e}')
    check(e8['shard']['tensor_degree'] == 2 and
          e8['shard']['param_leaves_sharded'] > 0 and e8['drift_raised'],
          f'(e) shard layout {e8["shard"]}, adapter drift raised: '
          f'{e8["drift_raised"]}')
    check([e8[f'slot_{n}'] for n in ('ad1', 'ad2', 'ad3')] == [0, 1, 2]
          and e8['finishes'] == ['length'] and
          e8['adapter_streams_differing_from_base'] > 0,
          f'(e) slots, finishes, adapter streams: {e8}')
    for name, g in e8['gaps'].items():
        check(g['cache_fp8'] <= TP_LORA_BOUND and
              g['no_cache'] <= INT8_BOUND,
              f'(e) {name} teacher-forced gaps {g} (bounds {TP_LORA_BOUND} '
              f'over fp8, {INT8_BOUND} against the no-cache forward)')
        check(min(g['control_next_cache_fp8'],
                  g['control_base_cache_fp8']) > TP_LORA_BOUND and
              min(g['control_next_no_cache'],
                  g['control_base_no_cache']) > INT8_BOUND,
              f'(e) {name} controls {g}: the gate cannot tell adapters')
    f2, fl = r0['gpt2_f32'], r0['gpt2_large']
    check(f2['tokens_identical'] and
          f2['logprob_max_abs_err'] <= TP_F32_BOUND,
          f'(f) gpt2-large depth-2 f32 tp=2 vs tp=1: {f2}')
    check(fl['gaps']['max'] <= GPT2_BOUND and
          fl['gaps']['control_max'] > GPT2_BOUND and
          fl['finishes'] == ['length'] and
          fl['shard']['param_leaves_sharded'] > 0,
          f'(f) gpt2-large tp=2: {fl}')
    gpt2 = get_model_config(GPT2_SERVE_MODEL)
    for r, rank in enumerate(ranks):
        check(rank['gpt2_f32']['heads'] == rank['gpt2_large']['heads']
              == gpt2.num_heads // 2 and
              rank['lora_f32']['lora_b_q_cols_a_rank'] ==
              rank['lora_int8_fp8']['lora_a_o_rows_a_rank'] ==
              cfg.num_heads * cfg.head_dim_ // 2,
              f'rank {r}: gpt2-large heads, adapter slices '
              f'{[rank[k] for k in ("gpt2_f32", "lora_f32")]}')
    tally = [sum(rank['launches'][i] for rank in ranks) for i in range(3)]
    line = {'phase': 'serve_tp', 'device': env['device'],
            'nvidia_smi': env['nvidia_smi'],
            'transport': 'two processes on card 0, a gloo group, '
                         'collectives on CUDA tensors',
            'model': TP_MODEL, 'tensor_parallel': 2,
            'config': {**TP_SERVE, 'cache_dtype': 'float8_e4m3fn'},
            'reduced': 'examples/serve_llama.yaml: --tensor-parallel 8 -> 2 '
                       '(one card), --num-slots 128 -> 16 and '
                       'max_cache_len 2048 -> 512 (two ranks\' caches and '
                       'weights on one card); (a) and (c) depth 32 -> 2 in '
                       'f32',
            'depth2_f32': a, 'mixtral_f32': c, 'full': b,
            'lora_f32': e, 'lora_int8_fp8': {
                **e8, 'model': TP_MODEL, 'num_layers': TP_LORA_LAYERS,
                'config': {**TP_LORA_SERVE, 'cache_dtype': 'float8_e4m3fn',
                           'weight_dtype': 'int8'},
                'reduced': f'depth 32 -> {TP_LORA_LAYERS} (the time: every '
                           'collective crosses the host in gloo)',
                'bounds': {'cache_fp8': TP_LORA_BOUND,
                           'no_cache': INT8_BOUND}},
            'gpt2_f32': f2, 'gpt2_large': {
                **fl, 'config': TP_GPT2_SERVE, 'bound': GPT2_BOUND},
            'rank1': {k: ranks[1][k] for k in ('launches', 'seconds')},
            'rank1_window': ranks[1]['full']['window'],
            'protocol_host_cost': host, 'bounds': {
                'f32': TP_F32_BOUND, 'fp8': INT8_BOUND,
                'bf16': INT8_TIGHT_BOUND},
            'launches': tally, 'wall_s': wall,
            'seconds': {'rank0': r0['seconds']}}
    emit(line)
    return tally, line


def phase_planted_faults() -> None:
    """Build a copy of a kernel per planted fault (under
    build/planted_faults/), run it in place of the sound library at its
    case, and hold its output to the smoke run's bound."""
    root = _build.BUILD_DIR.parent / 'planted_faults'
    shutil.rmtree(root, ignore_errors=True)
    builds = []
    faults = ([(fault, lib, f'{lib}.cu', sound, planted, TRAIN_CASE)
               for fault, lib, sound, planted in FAULTS]
              + [(*fault, GEMMA_TRAIN_CASE) for fault in FAULTS_D256])
    for i, (fault, lib, file, sound, planted, case) in enumerate(faults):
        src = (_build.CSRC / file).read_text()
        check(src.count(sound) == 1,
              f'{fault}: the line to plant is not in {file} exactly once')
        d = root / str(i)
        d.mkdir(parents=True)
        for source in (*_build.CSRC.glob('*.cuh'), _build.CSRC / f'{lib}.cu'):
            shutil.copy(source, d)
        (d / file).write_text(src.replace(sound, planted))
        so = d / f'lib{lib}.so'
        builds.append((fault, lib, case, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(so),
             str(d / f'{lib}.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for fault, lib, _, _, proc in builds:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f'{fault} in {lib}: nvcc failed\n{log}')
    missed = []
    for case in (TRAIN_CASE, GEMMA_TRAIN_CASE):
        gen = torch.Generator(device='cuda').manual_seed(1)
        args = bwd_inputs(gen, *case[1:])
        ref = plain_bwd(args)
        bounds = fa.attention_bwd_bound(*args, ref)
        q, k, v, _, _, _, causal, scale, window = args
        fwd_args = (q, k, v, causal, scale, window)
        fwd_ref = fa.attention_fwd_reference(*fwd_args)
        for fault, lib, _, so, _ in (b for b in builds if b[2] is case):
            sound = _build.load(lib)
            _build.swap(lib, ctypes.CDLL(str(so)))
            try:
                if lib == 'flash_attention_fwd':
                    errs = {'o': fwd_errors(*fwd_args, fwd_ref)}
                else:
                    got = run_bwd(args)
                    torch.cuda.synchronize()
                    errs = bwd_errors(got, ref, bounds)
                    del got
            finally:
                _build.swap(lib, sound)
            worst = max(e['max_err_over_bound'] for e in errs.values())
            caught = not worst <= 1.0   # NaN is caught too
            emit({'phase': 'planted_fault', 'fault': fault, 'kernel': lib,
                  'case': case[0], 'shape': list(case[1:6]), **errs,
                  'caught': caught})
            if not caught:
                missed.append(f'{fault} in {lib}')
        del args, ref, bounds, q, k, v, fwd_args, fwd_ref
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    check(not missed, f'planted faults within the bound: {missed}')


def timed(fn, *args, label: str = ''):
    """fn(*args), its wall seconds on stderr (the run's time budget)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f'[{label or fn.__name__}] {time.perf_counter() - t0:.1f} s',
          file=sys.stderr, flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = phase_env()
    phase_build()
    if '--planted-faults' in sys.argv[1:]:
        phase_planted_faults()
        print(json.dumps({'planted_faults': 'all caught',
                          'device': env['device']}), flush=True)
        return 0
    fwd = timed(phase_kernel)
    bwd = timed(phase_kernel_bwd)
    headline = timed(phase_kernel_headline)
    if '--kernels' in sys.argv[1:]:
        print(json.dumps({'kernels_only': 'all within their bounds',
                          'device': env['device']}), flush=True)
        return 0
    bench_fwd, bench_dq, bench_dkv = timed(phase_bench, env['device'])
    model, forward_launches = timed(phase_forward)
    model = shallower(model, SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_serve, model, env['device'])
    timed(phase_server, model, env)
    timed(phase_paged, model, env)
    timed(phase_chunked, model, env)
    timed(phase_prompt_logprobs, model, env)
    timed(phase_fp8, model, env)
    timed(phase_prefix, model, env)
    timed(phase_spec, model, env)
    timed(phase_qos, model, env)
    timed(phase_chaos, model, env)
    del model
    gc.collect()    # engines held in reference cycles (window audits)
    torch.cuda.empty_cache()
    (train_fwd, train_dq, train_dkv), train_line = timed(
        phase_train, env['device'])
    torch.cuda.empty_cache()
    lora_train, adapter_dir = timed(phase_lora_train, env['device'],
                                    train_line)
    torch.cuda.empty_cache()
    try:
        lora_forward = timed(phase_lora_serve, env, adapter_dir)
    finally:
        shutil.rmtree(adapter_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    gemma_fwd = timed(phase_gemma, env['device'])
    gemma_train, _ = timed(phase_train, env['device'], 'gemma-2b',
                           label='phase_' + train_phase_name('gemma-2b'))
    gc.collect()
    torch.cuda.empty_cache()
    int8_forward = timed(phase_int8_hf, env['device'])
    gc.collect()
    torch.cuda.empty_cache()
    gpt2_train, gpt2_forward = timed(phase_gpt2, env)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_forward = timed(phase_mixtral, env)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_train, _ = timed(
        phase_train, env['device'], MIXTRAL_MODEL, MIXTRAL_TRAIN_BATCH,
        MIXTRAL_TRAIN_LAYERS, 1,
        label='phase_' + train_phase_name(MIXTRAL_MODEL))
    gc.collect()
    torch.cuda.empty_cache()
    bert_train, bert_hf_forward = timed(phase_bert, env)
    timed(phase_resnet, env)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_lora = timed(phase_mixtral_lora_train, env)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train, mesh_line = timed(phase_mesh_train, env)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_lora, _ = timed(phase_mesh_lora, env, mesh_line)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun, _ = timed(phase_dryrun, env)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp, _ = timed(phase_serve_tp, env)
    from torch import distributed as dist
    dist.destroy_process_group()
    csrc = 'skypilot_tpu_torch/ops/csrc/'
    tpu = 'skypilot_tpu/ops/flash_attention.py:'
    print(json.dumps({'kernels': [
        dict(name='flash_attention_fwd', route='cuda',
             source=csrc + 'flash_attention_fwd.cu', replaces=tpu + '146',
             launches=(forward_launches + train_fwd + bench_fwd + gemma_fwd
                       + gemma_train[0] + lora_train[0] + lora_forward
                       + int8_forward + gpt2_train[0] + gpt2_forward
                       + mixtral_forward + mixtral_train[0]
                       + bert_train[0] + bert_hf_forward
                       + mixtral_lora[0] + mesh_train[0] + mesh_lora[0]
                       + dryrun[0] + serve_tp[0]),
             launches_by_path={'forward': forward_launches,
                               'train': train_fwd, 'bench': bench_fwd,
                               'gemma_forward': gemma_fwd,
                               'gemma_train': gemma_train[0],
                               'lora_train': lora_train[0],
                               'lora_forward': lora_forward,
                               'int8_forward': int8_forward,
                               'gpt2_train': gpt2_train[0],
                               'gpt2_large_forward': gpt2_forward,
                               'mixtral_forward': mixtral_forward,
                               'mixtral_train': mixtral_train[0],
                               'bert_train': bert_train[0],
                               'bert_hf_forward': bert_hf_forward,
                               'mixtral_lora_train': mixtral_lora[0],
                               'mesh_train': mesh_train[0],
                               'mesh_lora': mesh_lora[0],
                               'dryrun': dryrun[0],
                               'serve_tp': serve_tp[0]},
             **fwd[KERNEL_CASES[0][0]], train_shape=fwd[TRAIN_CASE[0]],
             headline_shape=headline['fwd'],
             head_dim_256_shapes={name: fwd[name]
                                  for name in TIMED_FWD[2:4]},
             slice12_shapes={name: fwd[name] for name in SLICE12_FWD},
             bert_shapes={name: fwd[name] for name in BERT_SHAPES},
             serve_tp_shape=fwd[TP_FWD_CASE[0]],
             grid_shape=fwd[GRID_CASE[0]],
             slice16_shapes={name: fwd[name] for name in SLICE16_FWD}),
        dict(name='flash_attention_bwd_dq', route='cuda',
             source=csrc + 'flash_attention_bwd_dq.cu', replaces=tpu + '185',
             launches=(train_dq + bench_dq + gemma_train[1] + lora_train[1]
                       + gpt2_train[1] + mixtral_train[1] + bert_train[1]
                       + mixtral_lora[1] + mesh_train[1] + mesh_lora[1]
                       + dryrun[1]),
             launches_by_path={'train': train_dq, 'bench': bench_dq,
                               'gemma_train': gemma_train[1],
                               'lora_train': lora_train[1],
                               'gpt2_train': gpt2_train[1],
                               'mixtral_train': mixtral_train[1],
                               'bert_train': bert_train[1],
                               'mixtral_lora_train': mixtral_lora[1],
                               'mesh_train': mesh_train[1],
                               'mesh_lora': mesh_lora[1],
                               'dryrun': dryrun[1]},
             **bwd[TRAIN_CASE[0]]['dq'], headline_shape=headline['dq'],
             head_dim_256_shapes={name: bwd[name]['dq']
                                  for name in TIMED_BWD[1:2]},
             slice12_shapes={name: bwd[name]['dq'] for name in SLICE12_BWD},
             bert_shapes={name: bwd[name]['dq'] for name in BERT_SHAPES},
             slice16_shapes={name: bwd[name]['dq']
                             for name in SLICE16_BWD}),
        dict(name='flash_attention_bwd_dkv', route='cuda',
             source=csrc + 'flash_attention_bwd_dkv.cu',
             replaces=tpu + '227',
             launches=(train_dkv + bench_dkv + gemma_train[2]
                       + lora_train[2] + gpt2_train[2] + mixtral_train[2]
                       + bert_train[2] + mixtral_lora[2] + mesh_train[2]
                       + mesh_lora[2] + dryrun[2]),
             launches_by_path={'train': train_dkv, 'bench': bench_dkv,
                               'gemma_train': gemma_train[2],
                               'lora_train': lora_train[2],
                               'gpt2_train': gpt2_train[2],
                               'mixtral_train': mixtral_train[2],
                               'bert_train': bert_train[2],
                               'mixtral_lora_train': mixtral_lora[2],
                               'mesh_train': mesh_train[2],
                               'mesh_lora': mesh_lora[2],
                               'dryrun': dryrun[2]},
             **bwd[TRAIN_CASE[0]]['dkv'], headline_shape=headline['dkv'],
             head_dim_256_shapes={name: bwd[name]['dkv']
                                  for name in TIMED_BWD[1:2]},
             slice12_shapes={name: bwd[name]['dkv']
                             for name in SLICE12_BWD},
             bert_shapes={name: bwd[name]['dkv'] for name in BERT_SHAPES},
             slice16_shapes={name: bwd[name]['dkv']
                             for name in SLICE16_BWD}),
    ]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
