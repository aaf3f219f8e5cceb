#!/usr/bin/env python3
"""Speculative decoding measured where it can pay, on the PyTorch port:
the twin of ``scripts/bench_speculative.py`` over ``skypilot_tpu_torch``.

Prompt-lookup drafting only pays on a model whose greedy continuation
agrees with the drafts -- a model that copies from its context.  Random
weights never engage the verify path.  This script:

1. **Trains** a ~160M llama (``llama-induct-160m``: 768 wide, 12 heads of
   64, 8 layers, tied, vocab 32,000) on induction data -- tiled
   ``[segment ; segment ; ...]`` rows of random tokens whose length is
   log-uniform per batch -- through the port's ``Trainer`` state and train
   step (batch 32 x 512, loss chunk 128, lr 6e-4, warmup 100).  On the
   card every step runs the three Hopper flash-attention kernels (forward,
   dQ, dK/dV) at q/k/v [32, 12, 512, 64] bf16 causal; the launches of each
   step are counted and printed.
2. **Benchmarks** the engine on grounded traffic: each prompt is a fresh
   ``doc + start-of-repeat``; to the degree the model copies, prompt-lookup
   drafts the same copy and the verify dispatch accepts -- acceptance rate,
   tokens per dispatch, copy fidelity and throughput of ``draft_len`` 4
   and 7 against the windowed decode (``draft_len=0``).
3. Also records an **ungrounded** row (random continuation traffic).

The trained weights go to bf16 on the device for serving.  One card trains
without a mesh; under torchrun with N ranks the trainer runs over
``MeshSpec.auto(N)`` (FSDP over every rank) and rank 0 serves.

  python scripts/bench_speculative_torch.py [--steps 6000] [--out spec.json]
  python scripts/bench_speculative_torch.py --model llama-debug --device cpu \\
      --steps 20 --requests 4      # a small run without a card

The last line of stdout is the whole report as one JSON object; nothing is
written unless --out is given.
"""
import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from skypilot_tpu_torch.infer.engine import (InferConfig,  # noqa: E402
                                             InferenceEngine, Request)
from skypilot_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from skypilot_tpu_torch.models.registry import \
    get_model_config  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402
from skypilot_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from skypilot_tpu_torch.train.trainer import (TrainConfig,  # noqa: E402
                                              Trainer, make_train_step)

MODEL = 'llama-induct-160m'
SEG = 256                     # training: [seg;seg;...] tiled rows
DOC = 32                      # eval: doc length to copy from
CUE = 8                       # eval: repeated prefix cueing the copy
NEW = 24                      # eval: tokens to generate (the copy)
BATCH = 32

# The in-script config: a ~160M llama.  Small models form induction heads
# within tens of millions of tokens; the acceptance rate it yields is a
# property of the traffic and of the model's copying fidelity.
_CUSTOM = {
    'llama-induct-160m': dict(vocab_size=32000, hidden_size=768,
                              intermediate_size=2048, num_layers=8,
                              num_heads=12, num_kv_heads=12,
                              max_seq_len=1024, tie_embeddings=True),
}


def model_config(name: str):
    if name in _CUSTOM:
        return LlamaConfig(name=name, **_CUSTOM[name])
    return get_model_config(name)


def induction_batches(batch_size, vocab_size, seed=0):
    """[seg ; seg ; ...] rows with a VARIED segment length per batch: a
    fixed length teaches position-based copying (offset -SEG), which fails
    the moment the eval offset differs -- varying it forces content-based
    induction (match the n-gram, copy what followed).  numpy int32 rows of
    2 * SEG + 1 tokens (the trainer's seq_len + 1 columns)."""
    rng = np.random.default_rng(seed)
    seq = 2 * SEG + 1
    while True:
        # Log-uniform lengths: short segments (close matches) carry the
        # early copy signal.
        length = int(np.exp(rng.uniform(np.log(8), np.log(SEG))))
        seg = rng.integers(1, vocab_size, size=(batch_size, length),
                           dtype=np.int32)
        reps = -(-seq // length)          # ceil: tile then crop
        yield {'tokens': np.tile(seg, (1, reps))[:, :seq]}


def launch_counts() -> tuple:
    """The flash kernels' launch counts (forward, dQ, dK/dV) so far."""
    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches)


def _mesh_spec():
    """None on one process; FSDP over every rank under torchrun (the
    reference's MeshSpec.auto over its devices)."""
    world = int(os.environ.get('WORLD_SIZE', '1'))
    return MeshSpec.auto(world) if world > 1 else None


def train(steps: int, device='cuda', batch: int = BATCH, params=None,
          seed: int = 0):
    """Train the induction task.  Returns (the bf16 state_dict on the
    device -- on rank 0 under a mesh, None elsewhere --, the logged losses
    rounded as the reference logs them, and a dict of the logged losses
    unrounded, the flash launches of every step, the seconds).  params:
    a starting state_dict (else the trainer draws one from `seed`)."""
    cfg = model_config(MODEL)
    tcfg = TrainConfig(model=MODEL, batch_size=batch, seq_len=2 * SEG,
                       learning_rate=6e-4, warmup_steps=100,
                       total_steps=steps, loss_chunk=128, mesh=_mesh_spec())
    trainer = Trainer(tcfg, cfg, device=device)
    trainer.setup(seed=seed, params=params)
    step_fn = make_train_step(loss_chunk=128, mesh=trainer.mesh,
                              global_batch=batch)
    data = induction_batches(batch, cfg.vocab_size)
    dev = trainer.device
    losses, raw, per_step = [], [], []
    t0 = time.time()
    for i in range(steps):
        tokens = torch.from_numpy(next(data)['tokens']).long()
        before = launch_counts()
        metrics = step_fn(trainer.state, {'tokens': tokens})
        per_step.append([b - a for a, b in zip(before, launch_counts())])
        if i % 50 == 0 or i == steps - 1:
            loss = float(metrics['loss'])   # host sync
            raw.append((i, loss))
            losses.append(round(loss, 3))
            print(f'step {i}: loss {loss:.3f} '
                  f'({time.time() - t0:.0f}s)', flush=True)
    seconds = time.time() - t0
    if trainer.mesh is None:
        sd = trainer.state.model.state_dict()
    else:
        sd = trainer._full_state()[0]
        if torch.distributed.get_rank() != 0:
            sd = None
    # bf16 for serving, on the device; dropping the trainer frees the f32
    # master weights and the AdamW state.
    params = (None if sd is None else
              {k: v.detach().to(dev, torch.bfloat16) for k, v in sd.items()})
    del trainer, step_fn, sd
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    return params, losses, {'step_losses': raw,
                            'flash_launches_per_step': per_step,
                            'train_seconds': seconds}


def grounded_requests(n, vocab_size, seed=1):
    """A fresh doc per request + a CUE-token repeat cue; the trained model
    copies doc[CUE:], which is exactly what prompt-lookup drafts."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        doc = rng.integers(1, vocab_size, size=DOC).tolist()
        reqs.append(Request(tokens=doc + doc[:CUE], max_new_tokens=NEW))
    return reqs


def random_requests(n, vocab_size, seed=2):
    rng = np.random.default_rng(seed)
    return [
        Request(tokens=rng.integers(1, vocab_size,
                                    size=DOC + CUE).tolist(),
                max_new_tokens=NEW) for _ in range(n)
    ]


def run_engine(params, draft_len, reqs, label, out, copy_check=None,
               device='cuda', mc=None, cache_dtype=torch.bfloat16,
               results=None):
    """One engine over `params` at `draft_len`: warm, then time the offline
    generate of `reqs`; the row (throughput, spec_stats, acceptance,
    tokens per dispatch, copy fidelity with copy_check) goes into
    out[label] and is returned.  mc: the model config (MODEL's by
    default); results: a dict that takes the RequestResults under
    label."""
    cfg = InferConfig(model=MODEL, num_slots=16, max_cache_len=256,
                      prefill_buckets=(64, 136, 256), decode_steps=8,
                      cache_dtype=cache_dtype, draft_len=draft_len)
    eng = InferenceEngine(mc or model_config(MODEL), cfg, params=params,
                          device=device)
    # Warm both dispatch paths outside the measurement.
    eng.generate([Request(tokens=list(reqs[0].tokens), max_new_tokens=2)])
    eng._warm_spec(len(reqs[0].tokens))
    for k in eng.spec_stats:
        eng.spec_stats[k] = 0
    if eng.device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.time()
    res = eng.generate([
        Request(tokens=list(r.tokens), max_new_tokens=r.max_new_tokens)
        for r in reqs
    ])
    elapsed = time.time() - t0
    st = dict(eng.spec_stats)
    row = {
        'output_tokens_per_second': round(
            sum(len(r.output_tokens) for r in res) / elapsed, 1),
        'requests_per_second': round(len(res) / elapsed, 2),
        'spec': st,
    }
    if st['drafted']:
        row['accept_rate'] = round(st['accepted'] / st['drafted'], 3)
    if st['dispatches']:
        row['tokens_per_dispatch'] = round(
            1 + st['accepted'] / st['dispatches'], 2)
    if copy_check is not None:
        # Fidelity: the fraction of generated tokens equal to the copy the
        # doc dictates (the model must have LEARNED the task, or the whole
        # measurement is vacuous).
        good = total = 0
        for req, r in zip(reqs, res):
            want = (req.tokens[:DOC] * 2)[DOC + CUE:DOC + CUE +
                                          len(r.output_tokens)]
            good += sum(int(a == b) for a, b in zip(r.output_tokens, want))
            total += len(r.output_tokens)
        row['copy_fidelity'] = round(good / max(total, 1), 3)
    out[label] = row
    if results is not None:
        results[label] = res
    del eng
    gc.collect()
    return row


def main(argv=None) -> int:
    global MODEL, SEG, DOC, NEW
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=6000)
    ap.add_argument('--requests', type=int, default=32)
    ap.add_argument('--model', default=MODEL,
                    help='registry model (llama-debug for a CPU smoke)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (the card) or cpu')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if args.device != 'cpu' and not torch.cuda.is_available():
        print('bench_speculative_torch: no CUDA device is visible (pass '
              '--device cpu to run on the CPU)', file=sys.stderr)
        return 1
    MODEL = args.model
    mcfg = model_config(MODEL)
    vocab = mcfg.vocab_size
    if mcfg.max_seq_len < 2 * SEG:   # a CPU smoke with llama-debug
        SEG = mcfg.max_seq_len // 2
        DOC = SEG // 2
        NEW = DOC - CUE

    params, losses, info = train(args.steps, device=args.device, batch=BATCH)
    if params is None:               # a rank > 0 under torchrun
        return 0
    per_step = info['flash_launches_per_step']
    out = {
        'description':
            f'speculative decoding on a TRAINED {MODEL} (induction task:'
            ' [seg;seg] copy, trained on the card), bf16 serving. grounded'
            f' = fresh doc({DOC}) + {CUE}-token repeat cue, {NEW} new'
            ' tokens (the model copies; prompt-lookup drafts the same'
            ' copy). ungrounded = random prompts (acceptance ~0; the EMA'
            ' gate falls back to windowed decode).',
        'train_loss_trajectory': losses,
        'train_steps': args.steps,
        'train_seconds': info['train_seconds'],
        'flash_launches_per_step': sorted({tuple(c) for c in per_step}),
        'flash_launches_fwd_dq_dkv': [sum(c[i] for c in per_step)
                                      for i in range(3)],
    }
    grounded = grounded_requests(args.requests, vocab)
    rnd = random_requests(args.requests, vocab)
    for draft, reqs, label, copy_check in (
            (0, grounded, 'grounded_draft_0', True),
            (4, grounded, 'grounded_draft_4', True),
            (7, grounded, 'grounded_draft_7', True),
            (4, rnd, 'ungrounded_draft_4', None)):
        run_engine(params, draft, reqs, label, out, copy_check=copy_check,
                   device=args.device)
        print(json.dumps(out[label]), flush=True)
    d0 = out['grounded_draft_0']['output_tokens_per_second']
    d4 = out['grounded_draft_4']['output_tokens_per_second']
    d7 = out['grounded_draft_7']['output_tokens_per_second']
    out['grounded_speedup_draft_4'] = round(d4 / d0, 3)
    out['grounded_speedup_draft_7'] = round(d7 / d0, 3)
    print(json.dumps({k: v for k, v in out.items()
                      if k.startswith('grounded_speedup')}))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=2)
        print(f'wrote {args.out}')
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
