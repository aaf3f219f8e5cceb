#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: Llama train-step
throughput on one CUDA card -- the twin of ``bench.py``.

    python3 bench_torch.py

Prints ONE JSON line with ``bench.py``'s keys:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "detail": {...}}

Metric: Llama-3-8B-equivalent training tokens/sec/card at the anchor's
sequence length (8192).  As in ``bench.py``, the model measured is
``llama-800m`` (f32 master weights, AdamW state, full remat) through the
port's single-card trainer, whose attention runs the Hopper
flash-attention kernels forward and backward; its achieved model
FLOP/s are expressed as tokens/sec of Llama-3-8B at seq 8192 (the same
FLOPs accounting, ``LlamaConfig.flops_per_token``).  A second point at
seq 2048, batch 24, is reported in ``detail``.

``detail`` also carries the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), its dense bf16 peak and the MFU against it (null for a card this
script does not know), the f32 matmul precision set for the run, and the
flash-attention kernels' launch counts over each point.

``vs_baseline`` keeps ``bench.py``'s anchor, the reference's torch-XLA
FSDP Llama-3-8B run on TPU v6e-8 (BASELINE.md): 487.4 tokens/sec/chip.
"""
import json
import statistics
import subprocess
import time

import torch

# Dense bf16 peak (TFLOP/s) of the cards this script knows, by a
# substring of torch.cuda.get_device_name (NVIDIA data sheets).
PEAK_TFLOPS = {'H100 80GB HBM3': 989.0, 'H100 SXM': 989.0}
# torch's counterpart of bench.py's jax_default_matmul_precision
# 'bfloat16': f32 matmuls (the chunked loss's projection) may run with
# bf16 internals; on CUDA this enables TF32, as 'high' does.
F32_MATMUL_PRECISION = 'medium'
BASELINE_8B_TOK_S_CHIP = 0.476 * 8192 / 8   # reference, v6e-8


def measure(model_name: str, seq_len: int, batch_per_chip: int,
            steps: int = 10, windows: int = 3, device=None):
    """Median-of-N window throughput for one (seq_len, batch) point on
    one card.  Returns (tokens/s, window spread, final loss, achieved
    TFLOP/s, flash-attention launches (fwd, dq, dkv) over the point).
    device None means the card."""
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.models.registry import get_model_config
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  make_train_step,
                                                  synthetic_data)

    device = resolve_device(device)
    cfg = get_model_config(model_name)
    tcfg = TrainConfig(model=model_name, batch_size=batch_per_chip,
                       seq_len=seq_len, warmup_steps=10, total_steps=1000)
    trainer = Trainer(tcfg, cfg, device=device)
    trainer.setup(seed=0)
    state = trainer.state
    # Fused/chunked loss: never materializes [B, T, V] f32 logits.
    step_fn = make_train_step(loss_chunk=128)
    data = synthetic_data(batch_per_chip, seq_len, cfg.vocab_size,
                          device=device)
    launches0 = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
                 fa.flash_bwd_dkv_launches)
    # Warm-up step, then windows each ended by a host read of the loss
    # (it waits for every queued step).
    metrics = step_fn(state, next(data))
    metrics['loss'].item()
    window_tps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step_fn(state, next(data))
        metrics['loss'].item()
        window_tps.append(batch_per_chip * seq_len * steps /
                          (time.perf_counter() - t0))
    launches = tuple(b - a for a, b in zip(launches0, (
        fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
        fa.flash_bwd_dkv_launches)))
    tps = statistics.median(window_tps)
    loss = metrics['loss'].item()
    tflops = tps * cfg.flops_per_token(seq_len) / 1e12
    spread = [round(w, 1) for w in window_tps]
    del trainer, state, metrics
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return tps, spread, loss, tflops, launches


def card_identity() -> str:
    """'name, power limit' of card 0, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def point(tps, spread, loss, tflops, launches, batch, peak) -> dict:
    return {
        'batch_per_chip': batch,
        'raw_tokens_per_sec_per_chip': round(tps, 1),
        'window_spread_tok_s_per_chip': spread,
        'achieved_tflops_per_chip': round(tflops, 1),
        'mfu': round(tflops / peak, 3) if peak else None,
        'final_loss': round(loss, 3),
        'flash_launches_fwd_dq_dkv': list(launches),
    }


def main() -> None:
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.models.registry import get_model_config

    device = resolve_device(None)
    torch.set_float32_matmul_precision(F32_MATMUL_PRECISION)
    model_name = 'llama-800m'
    kind = torch.cuda.get_device_name(device)
    peak = next((v for k, v in PEAK_TFLOPS.items() if k in kind), None)
    cfg8b = get_model_config('llama3-8b')

    # Headline point at the anchor's seq (8192): 6 sequences keep the
    # same ~49k tokens per step as the seq-2048 point (24 x 2048).
    r8192 = measure(model_name, seq_len=8192, batch_per_chip=6)
    r2048 = measure(model_name, seq_len=2048, batch_per_chip=24)
    tps_8b_equiv = r8192[3] * 1e12 / cfg8b.flops_per_token(8192)
    result = {
        'metric': 'llama3_8b_equiv_train_tokens_per_sec_per_chip',
        'value': round(tps_8b_equiv, 2),
        'unit': 'tokens/s/chip',
        'vs_baseline': round(tps_8b_equiv / BASELINE_8B_TOK_S_CHIP, 3),
        'detail': {
            'bench_model': model_name,
            'devices': 1,
            'platform': 'gpu',
            'device_kind': kind,
            'nvidia_smi': card_identity(),
            'peak_tflops': peak,
            'f32_matmul_precision': torch.get_float32_matmul_precision(),
            'headline_seq_len': 8192,
            'seq8192': point(*r8192, 6, peak),
            'seq2048': point(*r2048, 24, peak),
            'baseline': 'ref torch-XLA FSDP llama3-8b on v6e-8: '
                        '487.4 tok/s/chip @ seq 8192 (BASELINE.md)',
        },
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()
