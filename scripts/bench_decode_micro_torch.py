#!/usr/bin/env python3
"""Decode-dispatch microbenchmark of the PyTorch port: the twin of
``scripts/bench_decode_micro.py`` over the port's engine
(``skypilot_tpu_torch``).  Where does TPOT go?

Separates the three components of the serving engine's inter-token
latency on the card:

  1. production dispatch time -- one decode window of K steps with a host
     sync after each, exactly what ``_decode_step`` pays;
  2. chained dispatch time     -- M windows queued back to back, one sync
     at the end;
  3. prefill dispatch time     -- the TTFT device component at the bucket.

Fitting dispatch(K) = F + K*s over K in ``--windows`` (least squares, as
the reference) gives the fixed overhead F and the marginal per-step cost
s: TPOT at window K is s + F/K.

One column more than the reference: CUDA launches are asynchronous, so
the chained time (2) measures how fast the host queues kernels, not what
the device does.  Beside both columns each window carries its *device*
time -- the kernels of one dispatch summed by ``torch.profiler`` (device
activity only) -- and the idle share of the production dispatch that
this leaves (``not measured``, null, off the card).

The other modes are the reference's, each an analytic report at the
target model's geometry plus a measured sweep on a tiny model through the
port engine's own dispatch functions (``_decode`` over a dense cache or
block tables, ``_paged_prefill`` for a chunk round, ``_prefill_insert``):

  --paged    dense vs paged KV bytes per decode step, slot capacity at
             --hbm-gb, and a measured dense-vs-paged decode sweep;
  --radix    TTFT vs prefix-overlap fraction with the radix cache on/off;
  --tp       per-rank KV bytes and slot capacity vs tensor degree, and a
             measured single vs tp=2 paged sweep over two ranks started
             as ``server.run(tensor_parallel=2)`` starts them (skipped,
             with the reason, where fewer than two devices are visible:
             one card, or one CPU core);
  --kv-tier  host-RAM KV tier coverage and restore-vs-reprefill cost, and
             a measured sweep cycling prefix families through a small pool.

Defaults are the reference's (--hbm-gb 16, --tflops 100, ...); pass the
card's figures by flag (an H100: --hbm-gb 80).  Nothing is written unless
--out is given.  ``--device cpu`` runs every mode without a card.

  python scripts/bench_decode_micro_torch.py            # the fit, on the card
  python scripts/bench_decode_micro_torch.py --paged --hbm-gb 80
  python scripts/bench_decode_micro_torch.py --radix --device cpu
"""
import argparse
import copy
import dataclasses
import functools
import json
import os
import random as pyrandom
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from skypilot_tpu_torch.analysis import sanitizers  # noqa: E402
from skypilot_tpu_torch.infer.engine import (  # noqa: E402
    InferConfig, InferenceEngine, Request, _dtype_name, resolve_cache_dtype)
from skypilot_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from skypilot_tpu_torch.models.registry import \
    get_model_config  # noqa: E402


def _pow2_bucket(n: int, cap: int) -> int:
    nb = 1
    while nb < n and nb < cap:
        nb *= 2
    return min(nb, cap)


def _row_bytes(mc, dt: torch.dtype) -> int:
    """One token's K+V across all layers."""
    return 2 * mc.num_kv_heads * mc.head_dim_ * dt.itemsize * mc.num_layers


def _tiny_config(name: str, m: int, hidden: int = 64,
                 layers: int = 2) -> LlamaConfig:
    return LlamaConfig(name=name, vocab_size=256, hidden_size=hidden,
                       intermediate_size=2 * hidden, num_layers=layers,
                       num_heads=4, num_kv_heads=2, max_seq_len=m,
                       tie_embeddings=True, dtype=torch.float32)


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


DEVICE_EVENTS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_ms(fn, device, reps: int = 1):
    """Device time of one call of fn: the durations of the kernels, copies
    and sets of `reps` calls as torch.profiler traced them (device
    activity only), over reps.  None off the card (not measured).  The
    durations are read from the exported trace: building the profiler's
    Python events for a 7B decode window's ~10^5 kernels takes longer
    than the window."""
    if torch.device(device).type != 'cuda':
        return None
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return sum(e.get('dur', 0) for e in events
               if str(e.get('cat', '')).lower() in DEVICE_EVENTS
               ) / 1e3 / reps


def fit_dispatch_cost(ks, ts):
    """Least-squares t(K) = F + K*s over the windows ks and their
    production dispatch times ts (seconds); returns (F, s) in seconds."""
    n = len(ks)
    mk = sum(ks) / n
    mt = sum(ts) / n
    s = (sum((k - mk) * (t - mt) for k, t in zip(ks, ts)) /
         sum((k - mk) ** 2 for k in ks))
    return mt - s * mk, s


def _emit(out: dict, path) -> dict:
    print(json.dumps(out))
    if path:
        with open(path, 'w') as f:
            json.dump(out, f, indent=2)
        print(f'wrote {path}')
    return out


def paged_report(args) -> dict:
    """--paged mode: analytic sweep + capacity model + tiny measured
    sweep.  The analytic part reads the geometry only, so it runs at 7B
    scale without building the model."""
    mc = get_model_config(args.model)
    m = args.max_cache_len
    bs = args.block_size
    dt = resolve_cache_dtype(args.cache_dtype)
    row_bytes = _row_bytes(mc, dt)
    hq = mc.num_heads
    fills = [f for f in args.fill_sweep if f < m] + [m - 1]
    sweep = []
    for fill in fills:
        blocks = -(-(fill + 1) // bs)
        nb = _pow2_bucket(blocks, m // bs)
        # Per decode step, per slot: KV rows streamed by the attention
        # (the HBM-bound term) and the score/value FLOPs over them.
        row = {
            'filled_len': fill,
            'dense_rows_per_step': m,
            'paged_rows_exact': blocks * bs,
            'paged_rows_bucketed': nb * bs,
            'dense_kv_bytes_per_step': m * row_bytes,
            'paged_kv_bytes_per_step': nb * bs * row_bytes,
            'kv_read_reduction': round(m / (nb * bs), 2),
            # 2 matmuls (scores + values), 2 flops/MAC, all q heads.
            'dense_attn_flops_per_step':
                2 * 2 * hq * mc.head_dim_ * m * mc.num_layers,
            'paged_attn_flops_per_step':
                2 * 2 * hq * mc.head_dim_ * nb * bs * mc.num_layers,
        }
        sweep.append(row)
        print(f'fill={fill:4d}: dense reads {m:4d} rows/step, paged '
              f'{nb * bs:4d} ({row["kv_read_reduction"]:.2f}x less)',
              flush=True)
    # Capacity model: max concurrent slots at a fixed KV memory budget.
    # Dense reserves max_cache_len rows per slot up front; paged holds
    # ceil(len/block) blocks per slot at the typical resident length.
    kv_budget = int((args.hbm_gb - args.weights_gb) * (1 << 30))
    dense_slots = kv_budget // (m * row_bytes)
    pool_blocks = kv_budget // (bs * row_bytes)
    typical = args.typical_len
    blocks_per_slot = -(-typical // bs)
    paged_slots = pool_blocks // blocks_per_slot
    capacity = {
        'hbm_budget_gb': args.hbm_gb,
        'weights_gb': args.weights_gb,
        'kv_budget_bytes': kv_budget,
        'kv_row_bytes': row_bytes,
        'block_size': bs,
        'typical_resident_len': typical,
        'max_slots_dense': int(dense_slots),
        'max_slots_paged': int(paged_slots),
        'capacity_gain': round(paged_slots / max(dense_slots, 1), 2),
    }
    print(f'capacity @ {args.hbm_gb:.0f} GB HBM ({args.weights_gb:.0f} '
          f'GB weights): dense {dense_slots} slots, paged {paged_slots} '
          f'({capacity["capacity_gain"]:.2f}x) at typical resident len '
          f'{typical}', flush=True)

    measured = None
    if not args.no_measure:
        measured = _measure_tiny_sweep(args, fills)
    out = {
        'description':
            f'paged-KV decode bandwidth/capacity model at {args.model} '
            f'geometry (Hkv={mc.num_kv_heads}, D={mc.head_dim_}, '
            f'layers={mc.num_layers}, {_dtype_name(dt)} cache). Analytic '
            'bytes/FLOPs per decode step per slot: dense streams '
            'max_cache_len rows regardless of fill; paged streams the '
            'power-of-two-bucketed ceil(len/block)*block rows. '
            'measured_tiny_sweep times REAL dense vs paged decode '
            'dispatches on a 2-layer toy model on the current backend '
            '(CPU dryrun: direction-of-effect, not chip TPOT).',
        'model': args.model,
        'max_cache_len': m,
        'block_size': bs,
        'filled_len_sweep': sweep,
        'capacity_model': capacity,
        'measured_tiny_sweep': measured,
    }
    return _emit(out, args.out)


def _timed_ms(dispatch, reps: int) -> float:
    """Wall ms of one dispatch with a host read of its first token after
    each (the first call, a warm-up, is not timed)."""
    dispatch()[0, 0, 0].item()
    t0 = time.perf_counter()
    for _ in range(reps):
        dispatch()[0, 0, 0].item()
    return (time.perf_counter() - t0) / reps * 1e3


def _lane_args(eng: InferenceEngine, b: int, fill: int):
    dev = eng.device
    return (torch.ones(b, dtype=torch.long, device=dev),
            torch.full((b,), fill, dtype=torch.long, device=dev),
            torch.zeros(b, device=dev))


def _measure_tiny_sweep(args, fills, steps=4, reps=5):
    """Dense vs paged decode dispatch wall time on a tiny llama at each
    filled length -- the measured counterpart of the analytic sweep,
    through the engine's own ``_decode`` (the code serving runs), with
    each dispatch's device time beside it on the card."""
    m = args.max_cache_len
    bs = args.block_size
    b = 8
    dev = args.device
    cfg_m = _tiny_config('paged-micro', m)
    common = dict(num_slots=b, max_cache_len=m, prefill_buckets=(64,),
                  decode_steps=steps, cache_dtype=torch.float32)
    dense = InferenceEngine(cfg_m, InferConfig(**common), device=dev,
                            generator=_generator(dev))
    paged = InferenceEngine(cfg_m, InferConfig(kv_block_size=bs, **common),
                            params=dense.model.state_dict(), device=dev,
                            generator=_generator(dev))
    rows = []
    for fill in fills:
        tokens, lengths, temps = _lane_args(dense, b, fill)

        def d_dense():
            return dense._decode(tokens, lengths, temps, steps)[0]

        for i in range(b):
            paged._ensure_blocks(i, min(fill + steps, m))
        nb = paged._nb_bucket(-(-(fill + steps) // bs))
        tables = paged._lane_tables(range(b), nb)

        def d_paged():
            return paged._decode(tokens, lengths, temps, steps,
                                 tables=tables)[0]

        dms = _timed_ms(d_dense, reps)
        pms = _timed_ms(d_paged, reps)
        ddev = device_ms(d_dense, dev)
        pdev = device_ms(d_paged, dev)
        for i in range(b):
            paged._free_slot_blocks(i)
        rows.append({'filled_len': fill, 'table_blocks': int(nb),
                     'dense_dispatch_ms': round(dms, 2),
                     'paged_dispatch_ms': round(pms, 2),
                     'dense_tpot_ms': round(dms / steps, 3),
                     'paged_tpot_ms': round(pms / steps, 3),
                     'dense_device_ms': ddev,
                     'paged_device_ms': pdev})
        print(f'measured fill={fill:4d}: dense {dms:7.2f} ms, paged '
              f'{pms:7.2f} ms ({nb} blocks gathered)', flush=True)
    if sanitizers.shard_sanitizer_enabled():
        # The sweep's engines keep their weights and cache live the whole
        # run: their layouts must still match the declared registry
        # (no-op off a mesh).
        for eng in (dense, paged):
            report = sanitizers.check_shard_layout(eng)
            print(f'shard layout ok: {report}', flush=True)
    return {'batch': b, 'decode_steps': steps,
            'model': 'tiny 2-layer llama (float32)', 'rows': rows}


def tp_report(args) -> dict:
    """--tp mode: analytic per-rank KV bandwidth + replica capacity vs
    tensor degree at the target geometry, plus a measured tiny-model
    single vs tp=2 paged sweep."""
    mc = get_model_config(args.model)
    m = args.max_cache_len
    bs = args.block_size
    dt = resolve_cache_dtype(args.cache_dtype)
    row_bytes = _row_bytes(mc, dt)
    typical = args.typical_len
    blocks_per_slot = -(-typical // bs)
    nb = _pow2_bucket(blocks_per_slot, m // bs)
    # Per decode step, per slot, a rank gathers its Hkv/tp heads of the
    # bucketed ceil(len/block)*block rows: the HBM-bound attention term.
    full_read = nb * bs * row_bytes
    weights_bytes = int(args.weights_gb * (1 << 30))
    sweep = []
    base_slots = None
    for tp in args.tp_sweep:
        if mc.num_kv_heads % tp:
            sweep.append({'tp': tp, 'supported': False,
                          'reason': f'num_kv_heads {mc.num_kv_heads} % '
                                    f'{tp} != 0'})
            continue
        # A tp replica owns tp devices: the weights shard over all of
        # them and the pool pages shard on kv heads, so the replica's KV
        # budget is the whole group's memory minus ONE weight copy.
        kv_budget = int(tp * args.hbm_gb * (1 << 30)) - weights_bytes
        pool_blocks = kv_budget // (bs * row_bytes)
        slots = int(pool_blocks // blocks_per_slot)
        if base_slots is None:
            base_slots = max(slots, 1)
        row = {
            'tp': tp,
            'supported': True,
            'per_chip_kv_read_bytes_per_step': full_read // tp,
            'kv_read_fraction_of_tp1': round(1.0 / tp, 4),
            'per_chip_weights_bytes': weights_bytes // tp,
            'replica_kv_budget_bytes': kv_budget,
            'pool_blocks': int(pool_blocks),
            'max_slots_paged': slots,
            'capacity_gain_vs_tp1': round(slots / base_slots, 2),
        }
        sweep.append(row)
        print(f'tp={tp}: per-chip KV read {full_read // tp:>12d} B/step '
              f'(1/{tp} of tp=1), {slots:5d} slots at typical len '
              f'{typical} ({row["capacity_gain_vs_tp1"]:.2f}x)',
              flush=True)

    measured = None
    if not args.no_measure:
        measured = _measure_tp_sweep(args)
    out = {
        'description':
            f'Head-sharded paged KV pool vs tensor degree at '
            f'{args.model} geometry (Hkv={mc.num_kv_heads}, '
            f'D={mc.head_dim_}, layers={mc.num_layers}, {_dtype_name(dt)} '
            'cache). Pool pages carry P(None, kv_heads, None, None): '
            'per-chip KV read bytes per decode step scale 1/tp (each '
            'chip gathers only its Hkv/tp heads, chip-local), and the '
            'replica KV budget is the whole slice HBM minus one '
            '(sharded) weight copy, so slot capacity grows ~linearly '
            'in tp. measured_tiny_sweep drives the REAL single-chip '
            'vs tp=2 paged decode roots on the current backend and '
            'checks greedy identity (CPU dryrun: direction-of-effect, '
            'not chip TPOT).',
        'model': args.model,
        'max_cache_len': m,
        'block_size': bs,
        'typical_resident_len': typical,
        'hbm_gb_per_chip': args.hbm_gb,
        'weights_gb': args.weights_gb,
        'kv_row_bytes': row_bytes,
        'tp_sweep': sweep,
        'measured_tiny_sweep': measured,
    }
    return _emit(out, args.out)


def _measure_tp_sweep(args, steps=4, reps=5):
    """Single-device vs tp=2 paged decode dispatch on a tiny llama: the
    measured counterpart of the analytic tp sweep, through the same
    ``_decode`` serving runs.  The tp=2 engine's second rank is a process
    of its own, started and fed as ``server.run(tensor_parallel=2)``
    starts its ranks.  Also asserts greedy identity and the per-rank pool
    accounting."""
    from torch import distributed as dist

    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.parallel.mesh import tp_mesh

    dev = args.device
    visible = server._visible_devices(dev)
    if visible < 2:
        print(f'tp measured sweep skipped: {visible} device(s) visible, '
              'two ranks need two', flush=True)
        return None
    m = min(args.max_cache_len, 256)
    bs = args.block_size
    b = 8
    cfg_m = _tiny_config('tp-micro', m)
    common = dict(num_slots=b, max_cache_len=m, prefill_buckets=(64,),
                  decode_steps=steps, cache_dtype=torch.float32,
                  kv_block_size=bs, max_new_tokens=8)
    single = InferenceEngine(cfg_m, InferConfig(**common), device=dev,
                             generator=_generator(dev))
    ranks = server._join_tp_group(2, dev)
    tp = None
    try:
        mesh = tp_mesh(2, torch.device(dev).type)
        tp_lib.control_group()
        tp_lib.broadcast_object(functools.partial(
            InferenceEngine, cfg_m, InferConfig(**common), device=dev))
        tp = InferenceEngine(cfg_m, InferConfig(**common),
                             params=single.model.state_dict(), device=dev,
                             generator=_generator(dev), mesh=mesh)
        # Greedy identity through the full paged path.
        reqs = [Request(tokens=[3 + i, 7, 11, 2 * i + 1], max_new_tokens=6)
                for i in range(4)]
        out_s = single.generate([copy.deepcopy(r) for r in reqs])
        out_t = tp.generate([copy.deepcopy(r) for r in reqs])
        identical = all(a.output_tokens == c.output_tokens
                        for a, c in zip(out_s, out_t))
        assert identical, 'tp=2 greedy stream diverged from single-device'
        print(f'greedy identity tp=2 vs single-device: ok '
              f'({len(reqs)} requests)', flush=True)

        fill = min(args.typical_len, m - steps - 1)
        rows = []
        for name, eng in (('single', single), ('tp2', tp)):
            for i in range(b):
                eng._ensure_blocks(i, min(fill + steps, m))
            nb = eng._nb_bucket(-(-(fill + steps) // bs))
            tables = eng._lane_tables(range(b), nb)
            # Dispatch arguments through the engine's own host->device
            # copy: a tp dispatch broadcasts what the host sent.
            tokens = eng._to_device(np.ones(b, np.int64))
            lengths = eng._to_device(np.full(b, fill, np.int64))
            temps = eng._to_device(np.zeros(b, np.float32))

            def dispatch():
                return eng._decode(tokens, lengths, temps, steps,
                                   tables=tables)[0]

            ms = _timed_ms(dispatch, reps)
            for i in range(b):
                eng._free_slot_blocks(i)
            kv = eng.stats()['kv']
            rows.append({'engine': name, 'tp': kv['tp'],
                         'dispatch_ms': round(ms, 2),
                         'tpot_ms': round(ms / steps, 3),
                         'pool_bytes_total': kv['bytes']['total'],
                         'pool_bytes_per_chip':
                             kv['bytes']['per_chip_total']})
            print(f'measured {name}: {ms:7.2f} ms/dispatch, pool '
                  f'{kv["bytes"]["per_chip_total"]} B/chip', flush=True)
        assert rows[1]['pool_bytes_per_chip'] * 2 == \
            rows[1]['pool_bytes_total']
        if sanitizers.shard_sanitizer_enabled():
            for eng in (single, tp):
                report = sanitizers.check_shard_layout(eng)
                print(f'shard layout ok: {report}', flush=True)
    finally:
        if tp is not None:
            tp.shutdown()
        else:
            tp_lib.broadcast_object(None)   # no engine: release rank 1
        for proc in ranks:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
        if ranks:
            dist.destroy_process_group()
    return {'batch': b, 'decode_steps': steps, 'filled_len': fill,
            'greedy_identity': identical,
            'model': 'tiny 2-layer llama (float32)', 'rows': rows}


def radix_report(args) -> dict:
    """--radix mode: measured TTFT sweep vs prefix-overlap fraction on a
    tiny model, radix caching on vs off, plus the analytic suffix-only
    prefill model."""
    L = 64                     # prompt length; overlap = shared/L
    bs = 8
    m = 128
    dev = args.device
    cfg_m = _tiny_config('radix-micro', m)
    common = dict(num_slots=4, max_cache_len=m,
                  prefill_buckets=(8, 16, 32, 64), max_new_tokens=4,
                  cache_dtype=torch.float32)
    off = InferenceEngine(cfg_m, InferConfig(kv_block_size=bs, **common),
                          device=dev, generator=_generator(dev))
    on = InferenceEngine(cfg_m, InferConfig(kv_block_size=bs,
                                            auto_prefix_cache=True,
                                            **common),
                         params=off.model.state_dict(), device=dev,
                         generator=_generator(dev))
    off.warmup()
    on.warmup()
    r = pyrandom.Random(0)
    shared_full = [r.randrange(1, 256) for _ in range(L)]
    reps = args.reps if args.reps < 20 else 8

    def ttft_ms(eng, prompts):
        # Per-request single-token generate: prefill + 1 decode, the TTFT
        # shape.  The first call seeds the shared prefix into the tree.
        for p in prompts[:1]:
            eng.generate([Request(tokens=list(p), max_new_tokens=1)])
        times = []
        for p in prompts[1:]:
            _sync(dev)
            t0 = time.perf_counter()
            eng.generate([Request(tokens=list(p), max_new_tokens=1)])
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] * 1e3

    sweep = []
    for overlap in (0.0, 0.25, 0.5, 0.75):
        shared_len = int(L * overlap) // bs * bs
        shared = shared_full[:shared_len]
        prompts = [shared + [r.randrange(1, 256)
                             for _ in range(L - shared_len)]
                   for _ in range(reps + 2)]
        suffix = L - shared_len
        sb = next(k for k in common['prefill_buckets'] if k >= max(suffix, 1))
        hits0 = on.radix_stats['hits']
        reused0 = on.radix_stats['tokens_reused']
        off_ms = ttft_ms(off, prompts)
        on_ms = ttft_ms(on, prompts)
        row = {
            'overlap': overlap,
            'shared_tokens': shared_len,
            'suffix_tokens': suffix,
            'prefill_tokens_baseline': L,
            'prefill_tokens_radix': sb,
            'prefill_compute_fraction': round(sb / L, 3),
            'ttft_ms_radix_off': round(off_ms, 2),
            'ttft_ms_radix_on': round(on_ms, 2),
            'ttft_reduction': round(off_ms / max(on_ms, 1e-9), 2),
            'radix_hits': on.radix_stats['hits'] - hits0,
            'radix_tokens_reused':
                on.radix_stats['tokens_reused'] - reused0,
        }
        sweep.append(row)
        print(f'overlap={overlap:.2f}: suffix {suffix:2d} tokens '
              f'(prefill bucket {sb:2d}/{L}), TTFT off '
              f'{off_ms:6.1f} ms vs on {on_ms:6.1f} ms '
              f'({row["ttft_reduction"]:.2f}x)', flush=True)

    out = {
        'description':
            'Automatic radix prefix caching: TTFT vs prefix-overlap '
            f'fraction on a tiny 2-layer llama (L={L} prompts, block '
            f'{bs}). With the tree warm, the radix engine matches the '
            'shared block-aligned prefix by refcount and prefills only '
            'the power-of-two-bucketed suffix, so prefill compute is '
            'proportional to (1 - overlap). CPU dryrun: '
            'direction-of-effect, not chip TTFT.',
        'prompt_len': L,
        'block_size': bs,
        'overlap_sweep': sweep,
        'radix_stats': dict(on.radix_stats),
    }
    return _emit(out, args.out)


def kv_tier_report(args) -> dict:
    """--kv-tier mode: host-RAM KV tier economics at working sets 2-8x
    the device pool.  Analytic sweep at the target geometry plus a
    measured tiny-model sweep."""
    mc = get_model_config(args.model)
    dt = resolve_cache_dtype(args.cache_dtype)
    row_bytes = _row_bytes(mc, dt)
    bs = args.block_size
    kv_budget = int((args.hbm_gb - args.weights_gb) * (1 << 30))
    host_budget = int(args.host_kv_gb * (1 << 30))
    # A typical prefix a tenant re-references: --typical-len tokens,
    # block-rounded.  A restore moves its rows host->device; a re-prefill
    # recomputes them (~2*params FLOPs/token at the target model).
    typical = args.typical_len
    blocks = -(-typical // bs)
    restore_bytes = blocks * bs * row_bytes
    restore_ms = restore_bytes / (args.h2d_gbps * 1e9) * 1e3
    params = args.weights_gb * (1 << 30)  # int8: ~1 byte/param
    reprefill_flops = 2 * params * typical
    reprefill_ms = reprefill_flops / (args.tflops * 1e12) * 1e3
    sweep = []
    for w in args.ws_sweep:
        working_set = w * kv_budget
        # Uniform re-reference over the hot set, LRU both tiers: each tier
        # covers its capacity fraction of the working set.
        device_hit = min(1.0, kv_budget / working_set)
        tier_hit = min(1.0, (kv_budget + host_budget) /
                       working_set) - device_hit
        miss = 1.0 - device_hit - tier_hit
        # Expected per-reference prefix cost, tier on vs off: a device hit
        # costs ~0, a tier hit the restore (overlapped with the suffix
        # prefill, so at worst the transfer), a miss the re-prefill.
        cost_off = (1.0 - device_hit) * reprefill_ms
        cost_on = tier_hit * restore_ms + miss * reprefill_ms
        row = {
            'ws_mult': w,
            'working_set_gb': round(working_set / (1 << 30), 1),
            'device_hit_rate': round(device_hit, 3),
            'host_hit_rate': round(tier_hit, 3),
            'miss_rate': round(max(miss, 0.0), 3),
            'restore_ms_per_prefix': round(restore_ms, 2),
            'reprefill_ms_per_prefix': round(reprefill_ms, 2),
            'restore_speedup': round(reprefill_ms / max(restore_ms,
                                                        1e-9), 2),
            'expected_prefix_cost_reduction':
                round(cost_off / max(cost_on, 1e-9), 2),
        }
        sweep.append(row)
        print(f'ws={w}x HBM ({row["working_set_gb"]:.1f} GB): device '
              f'hit {device_hit:.2f}, host-tier hit {tier_hit:.2f}, '
              f'miss {max(miss, 0.0):.2f} -> expected prefix cost '
              f'{row["expected_prefix_cost_reduction"]:.2f}x lower',
              flush=True)

    measured = None
    if not args.no_measure:
        measured = _measure_kv_tier_sweep(args)
    out = {
        'description':
            f'host-RAM KV tier at {args.model} geometry '
            f'(Hkv={mc.num_kv_heads}, D={mc.head_dim_}, '
            f'layers={mc.num_layers}, {_dtype_name(dt)} cache). Analytic: '
            'fraction of a uniform hot set covered by the device pool '
            f'vs a {args.host_kv_gb:.0f} GB host tier, and the cost '
            f'of restoring a {typical}-token prefix '
            f'({restore_bytes >> 10} KiB over {args.h2d_gbps:.0f} '
            'GB/s H2D, overlapped with the suffix prefill) vs '
            'recomputing it. measured_tiny_sweep cycles prefix '
            'families through a small device pool at 2-8x capacity '
            'and times round-2 re-references, tier on vs off (CPU '
            'dryrun: direction-of-effect, not chip TTFT).',
        'model': args.model,
        'block_size': bs,
        'kv_budget_bytes': kv_budget,
        'host_tier_budget_bytes': host_budget,
        'typical_prefix_tokens': typical,
        'working_set_sweep': sweep,
        'measured_tiny_sweep': measured,
    }
    return _emit(out, args.out)


def _measure_kv_tier_sweep(args):
    """A tiny 4-layer llama with a deliberately small paged pool (36
    usable blocks) serving prefix families whose KV footprint is 2-8x
    that pool.  Round 1 seeds every family (the tier-on engine spills the
    evicted ones to host RAM); round 2 re-references each and times TTFT:
    tier off re-prefills the whole prompt, tier on restores the spilled
    blocks and prefills only the suffix bucket."""
    bs = 8
    m = 256
    pool_blocks = 36           # usable; kv_blocks counts the dump too
    prefix_blocks = 31
    plen = prefix_blocks * bs  # 248 tokens; +1 probe token -> bucket 256
    dev = args.device
    cfg_m = _tiny_config('kv-tier-micro', m, hidden=128, layers=4)
    common = dict(num_slots=2, max_cache_len=m, kv_block_size=bs,
                  kv_blocks=pool_blocks + 1,
                  prefill_buckets=(8, 32, 256), max_new_tokens=4,
                  cache_dtype=torch.float32, auto_prefix_cache=True)
    off = InferenceEngine(cfg_m, InferConfig(**common), device=dev,
                          generator=_generator(dev))
    on = InferenceEngine(cfg_m, InferConfig(host_kv_bytes=32 << 20,
                                            **common),
                         params=off.model.state_dict(), device=dev,
                         generator=_generator(dev))
    off.warmup()
    on.warmup()
    # Warm the restore path: seed a throwaway family, churn it out of the
    # pool, and re-reference it once on the tier-on engine.
    r = pyrandom.Random(1)
    warm = [r.randrange(1, 256) for _ in range(plen)]
    churn = [[r.randrange(1, 256) for _ in range(plen)]
             for _ in range(pool_blocks // prefix_blocks + 1)]
    for p in [warm] + churn + [warm]:
        on.generate([Request(tokens=list(p) + [1], max_new_tokens=1)])

    rows = []
    for w in args.ws_sweep:
        families = max(2, w * pool_blocks // prefix_blocks)
        prefixes = [[r.randrange(1, 256) for _ in range(plen)]
                    for _ in range(families)]
        row = {'ws_mult': w, 'families': families,
               'prefix_tokens': plen, 'prefix_blocks': prefix_blocks}
        for label, eng in (('tier_off', off), ('tier_on', on)):
            for p in prefixes:       # round 1: seed (and evict/spill)
                eng.generate([Request(tokens=list(p) + [1],
                                      max_new_tokens=1)])
            ht0 = eng.kv_health()['host_tier']
            hits0 = eng.radix_stats['hits']
            times = []
            for p in prefixes:       # round 2: hot re-reference
                _sync(dev)
                t0 = time.perf_counter()
                eng.generate([Request(tokens=list(p) + [2],
                                      max_new_tokens=1)])
                times.append(time.perf_counter() - t0)
            times.sort()
            ht1 = eng.kv_health()['host_tier']
            row[f'ttft_ms_{label}'] = round(
                times[len(times) // 2] * 1e3, 2)
            row[f'radix_hits_{label}'] = \
                eng.radix_stats['hits'] - hits0
            if label == 'tier_on':
                restored = ht1['restores'] - ht0['restores']
                row['restored_blocks'] = restored
                row['restore_hit_rate'] = round(
                    min(1.0, restored /
                        max(families * prefix_blocks, 1)), 3)
        row['ttft_reduction'] = round(
            row['ttft_ms_tier_off'] /
            max(row['ttft_ms_tier_on'], 1e-9), 2)
        rows.append(row)
        print(f'measured ws={w}x ({families} families): TTFT off '
              f'{row["ttft_ms_tier_off"]:6.1f} ms vs on '
              f'{row["ttft_ms_tier_on"]:6.1f} ms '
              f'({row["ttft_reduction"]:.2f}x), restored '
              f'{row["restored_blocks"]} blocks (hit rate '
              f'{row["restore_hit_rate"]:.2f})', flush=True)
    return {
        'pool_blocks': pool_blocks,
        'host_tier_budget_bytes': 32 << 20,
        'rows': rows,
        'host_tier_final': dict(on.kv_health()['host_tier']),
    }


def dispatch_fit(args) -> dict:
    """The default mode: per window K, the production dispatch (a host
    read after each), the chained dispatch (one read after `reps`) and
    the device time of one dispatch; the fit dispatch(K) = F + K*s; the
    prefill at bucket 256; the decode stall of a monolithic prefill
    against one chunk round."""
    dev = args.device
    model_config = get_model_config(args.model)
    if args.weight_dtype == 'int8':
        model_config = dataclasses.replace(model_config,
                                           weight_dtype='int8')
    cfg = InferConfig(model=args.model, num_slots=args.num_slots,
                      max_cache_len=args.max_cache_len,
                      prefill_buckets=(256,),
                      cache_dtype=resolve_cache_dtype(args.cache_dtype),
                      decode_steps=max(args.windows))
    print(f'device: {torch.device(dev)}', flush=True)
    t0 = time.perf_counter()
    eng = InferenceEngine(model_config, cfg, device=dev,
                          generator=_generator(dev))
    print(f'engine built in {time.perf_counter() - t0:.1f}s', flush=True)

    b = args.num_slots
    tokens, lengths, temps = _lane_args(eng, b, args.prompt_len)

    def dispatch(k):
        return eng._decode(tokens, lengths, temps, k)[0]  # [K, B, 2+2k]

    results = {}
    for k in args.windows:
        dispatch(k)[0, 0, 0].item()                   # warm-up + sync
        # -- production shape: a host read after every dispatch
        t0 = time.perf_counter()
        for _ in range(args.reps):
            dispatch(k)[0, 0, 0].item()
        prod = (time.perf_counter() - t0) / args.reps
        # -- chained: queue every dispatch, read once at the end
        t0 = time.perf_counter()
        for _ in range(args.reps):
            toks = dispatch(k)
        toks[0, 0, 0].item()
        pure = (time.perf_counter() - t0) / args.reps
        dev_ms = device_ms(lambda: dispatch(k), dev)
        results[k] = {'dispatch_s': prod, 'chained_s': pure,
                      'tpot_ms': prod / k * 1e3,
                      'chained_per_step_ms': pure / k * 1e3,
                      'device_ms': dev_ms,
                      'device_per_step_ms':
                          None if dev_ms is None else dev_ms / k,
                      'idle_share':
                          None if dev_ms is None
                          else max(0.0, 1.0 - dev_ms / (prod * 1e3))}
        dev_txt = 'not measured' if dev_ms is None else f'{dev_ms:7.1f} ms'
        print(f'K={k:3d}: dispatch {prod * 1e3:7.1f} ms '
              f'(TPOT {prod / k * 1e3:6.1f} ms/tok) | chained '
              f'{pure * 1e3:7.1f} ms ({pure / k * 1e3:6.1f} ms/tok) | '
              f'device {dev_txt}', flush=True)

    ks = sorted(results)
    f, s = fit_dispatch_cost(ks, [results[k]['dispatch_s'] for k in ks])
    print(f'\nfit: dispatch(K) = {f * 1e3:.1f} ms + K * {s * 1e3:.1f} ms'
          f'  ->  TPOT(K) = {s * 1e3:.1f} + {f * 1e3:.1f}/K ms',
          flush=True)
    dev_fit = None
    if all(results[k]['device_ms'] is not None for k in ks) and len(ks) > 1:
        df, ds = fit_dispatch_cost(ks, [results[k]['device_ms'] / 1e3
                                        for k in ks])
        dev_fit = {'fixed_ms': df * 1e3, 'per_step_ms': ds * 1e3}

    # Prefill component of TTFT at the bucket size.
    pre = torch.ones((1, 256), dtype=torch.long, device=eng.device)
    true_lens = torch.tensor([args.prompt_len], device=eng.device)
    slots = torch.zeros(1, dtype=torch.long, device=eng.device)

    def prefill():
        return eng._prefill_insert(pre, true_lens, slots, temps[:1])[0]

    prefill()[0, 0].item()
    reps = max(5, args.reps // 2)
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill()[0, 0].item()
    prefill_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f'prefill bucket=256 P=1: {prefill_ms:.1f} ms', flush=True)

    # Worst-case decode stall during a long-prompt prefill: a monolithic
    # prefill stalls every active slot for the whole bucket dispatch, at
    # the production width (``_start_batch`` dispatches prefill_lanes
    # rows); chunked prefill stalls them for ONE [B, C] chunk round.
    chunk_stall = None
    if args.prefill_chunk:
        c = args.prefill_chunk
        lanes = cfg.prefill_lanes
        mtok = torch.ones((lanes, 256), dtype=torch.long, device=eng.device)
        mlens = torch.full((lanes,), args.prompt_len, device=eng.device)
        mslots = torch.zeros(lanes, dtype=torch.long, device=eng.device)
        mtemps = torch.zeros(lanes, device=eng.device)

        def mono():
            return eng._prefill_insert(mtok, mlens, mslots, mtemps)[0]

        mono()[0, 0].item()
        t0 = time.perf_counter()
        for _ in range(reps):
            mono()[0, 0].item()
        mono_ms = (time.perf_counter() - t0) / reps * 1e3
        ctokens = torch.ones((b, c), dtype=torch.long, device=eng.device)
        cstarts = torch.zeros(b, dtype=torch.long, device=eng.device)
        ctrue = torch.full((b,), c - 1, dtype=torch.long, device=eng.device)

        def chunk():
            return eng._paged_prefill(ctokens, cstarts, ctrue, None,
                                      temps)[0]

        chunk()[0, 0].item()
        t0 = time.perf_counter()
        for _ in range(reps):
            chunk()[0, 0].item()
        chunk_ms = (time.perf_counter() - t0) / reps * 1e3
        chunk_stall = {
            'prefill_chunk': c,
            'prefill_lanes': lanes,
            'worst_case_stall_ms_monolithic': round(mono_ms, 2),
            'worst_case_stall_ms_chunked': round(chunk_ms, 2),
            'stall_reduction': round(mono_ms / chunk_ms, 2),
        }
        print(f'worst-case decode stall: monolithic [{lanes}, 256] '
              f'{mono_ms:.1f} ms vs one [{b}, {c}] chunk {chunk_ms:.1f} '
              f'ms ({mono_ms / chunk_ms:.1f}x)', flush=True)

    out = {'model': args.model, 'num_slots': b,
           'max_cache_len': args.max_cache_len,
           'windows': {str(k): results[k] for k in results},
           'fit_fixed_ms': f * 1e3,
           'fit_per_step_ms': s * 1e3,
           'device_fit': dev_fit,
           'prefill_bucket256_p1_ms': round(prefill_ms, 2),
           'chunk_stall': chunk_stall}
    return _emit(out, args.out)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--model', default='llama2-7b')
    ap.add_argument('--num-slots', type=int, default=16)
    ap.add_argument('--max-cache-len', type=int, default=512)
    ap.add_argument('--weight-dtype', default='int8')
    ap.add_argument('--cache-dtype', default='fp8')
    ap.add_argument('--prompt-len', type=int, default=219)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--windows', type=int, nargs='+',
                    default=[1, 2, 4, 8, 16])
    ap.add_argument('--prefill-chunk', type=int, default=64,
                    help='chunk size for the worst-case decode-stall '
                         'comparison (0 skips it); must divide '
                         '--max-cache-len')
    ap.add_argument('--paged', action='store_true',
                    help='block-paged KV bandwidth/capacity report '
                         'instead of the dispatch-cost fit')
    ap.add_argument('--radix', action='store_true',
                    help='radix prefix-caching TTFT-vs-overlap sweep '
                         'instead of the dispatch-cost fit')
    ap.add_argument('--tp', action='store_true',
                    help='head-sharded paged pool vs tensor degree: '
                         'per-rank bandwidth + capacity model and a '
                         'measured tp=2 identity sweep')
    ap.add_argument('--tp-sweep', type=int, nargs='+',
                    default=[1, 2, 4, 8])
    ap.add_argument('--kv-tier', action='store_true',
                    help='host-RAM KV tier: hot-set coverage + '
                         'restore-vs-reprefill model at the target '
                         'geometry, and a measured tiny-model sweep '
                         'cycling prefix families at 2-8x the device '
                         'pool')
    ap.add_argument('--ws-sweep', type=int, nargs='+', default=[2, 4, 8],
                    help='working-set multiples of the device KV '
                         'budget for the --kv-tier sweep')
    ap.add_argument('--host-kv-gb', type=float, default=32.0,
                    help='host tier budget for the --kv-tier '
                         'analytic model')
    ap.add_argument('--h2d-gbps', type=float, default=8.0,
                    help='host->device transfer rate for the restore '
                         'cost model')
    ap.add_argument('--tflops', type=float, default=100.0,
                    help='sustained prefill TFLOP/s for the '
                         're-prefill cost model')
    ap.add_argument('--block-size', type=int, default=16)
    ap.add_argument('--fill-sweep', type=int, nargs='+',
                    default=[32, 64, 128, 256, 384])
    ap.add_argument('--typical-len', type=int, default=256,
                    help='steady-state resident rows/slot for the '
                         'capacity model (prompt + half the generation '
                         'budget at the serve-bench shape)')
    ap.add_argument('--hbm-gb', type=float, default=16.0,
                    help='device memory budget for the capacity model '
                         '(the reference default; an H100: 80)')
    ap.add_argument('--weights-gb', type=float, default=7.0,
                    help='weight memory at the target model (7B int8)')
    ap.add_argument('--no-measure', action='store_true',
                    help='skip the tiny-model measured sweep')
    ap.add_argument('--device', default='cuda',
                    help='the engines\' device: cuda (the card) or cpu')
    ap.add_argument('--out', default=None,
                    help='write the report JSON here (else print only)')
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    measures = not (args.no_measure and (args.paged or args.tp or
                                         args.kv_tier))
    if measures and torch.device(args.device).type == 'cuda' and \
            not torch.cuda.is_available():
        print('bench_decode_micro_torch: no CUDA device is visible (pass '
              '--device cpu to run on the CPU)', file=sys.stderr)
        return 1
    if args.paged:
        paged_report(args)
    elif args.radix:
        radix_report(args)
    elif args.kv_tier:
        kv_tier_report(args)
    elif args.tp:
        tp_report(args)
    else:
        dispatch_fit(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
