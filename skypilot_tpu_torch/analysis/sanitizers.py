"""Opt-in runtime sanitizers of the port: the twin of
``skypilot_tpu/analysis/sanitizers.py``.  Ported so far: the shard-layout
check.

- ``SKYTPU_SHARD_SANITIZER=1`` (or ``SKYTPU_SANITIZERS=1``):
  ``check_shard_layout(engine)`` runs at the serving loop's quiesce point
  and asserts, on every rank of a tensor-parallel engine, that the live
  KV cache and weights hold their declared layout: every cache leaf holds
  ``Hkv // tp`` kv heads (a paged pool is exactly ``[num_blocks, Hkv //
  tp, block_size, D]``: dim 0 is the allocator's block-id space), every
  parameter has its rank-local shape by the rules table
  (``parallel.mesh.local_shape``) and lies on the rank's device, and
  under ``tensor`` > 1 at least one parameter is sharded (a fully
  replicated model is the silent memory blow-up).  The LoRA adapter
  stacks of multi-LoRA serving are parameters like the others: each leaf
  has its rank-local shape (``lora_b`` split with a column-parallel
  projection, ``lora_a`` with a row-parallel one).  GPT-2's fused
  ``c_attn`` must hold the rank's heads of q, k and v: each of its heads'
  sums equals that head's in the full weight, which rank 0 saw at
  placement (``qkv_head_sums``), so a contiguous row split, which gives
  rank 0 every q head, fails.  Violations raise ``ShardLayoutError``; an
  engine without a mesh is a no-op.  Off, the check costs one
  environment read per idle pass.
"""
import os
from typing import Any, Dict, List

import torch

from skypilot_tpu_torch.parallel.mesh import local_shape

_TRUTHY = frozenset({'1', 'true', 'yes', 'on'})


def _env_on(name: str) -> bool:
    return os.environ.get(name, '').strip().lower() in _TRUTHY


def shard_sanitizer_enabled() -> bool:
    return (_env_on('SKYTPU_SHARD_SANITIZER') or
            _env_on('SKYTPU_SANITIZERS'))


class ShardLayoutError(RuntimeError):
    """A live cache leaf or weight drifted from the declared layout (or
    the weights replicated under tensor > 1)."""


def qkv_head_sums(t: torch.Tensor, heads: int) -> torch.Tensor:
    """The f32 sums [3, heads] of each head's rows of q, k and v in a
    fused c_attn weight or bias (rows q, k, v, each heads-major)."""
    return t.detach().float().reshape(3, heads, -1).sum(-1).cpu()


def local_shard_report(engine: Any) -> Dict[str, Any]:
    """This rank's counts and errors (see ``check_shard_layout``)."""
    errors: List[str] = []
    tp = engine._tp
    mc = engine.model_config
    hkv = mc.num_kv_heads // tp
    paged = bool(engine._paged)
    cache_leaves = 0
    for li, (k, v) in enumerate(engine.cache):
        for tag, leaf in (('k', k), ('v', v)):
            cache_leaves += 1
            if leaf.shape[1] != hkv:
                errors.append(
                    f'cache layer {li} {tag}: holds {leaf.shape[1]} kv '
                    f'heads, the declared layout owns {hkv} '
                    f'(Hkv={mc.num_kv_heads} over tensor={tp})')
            elif paged and tuple(leaf.shape) != (
                    engine._num_blocks, hkv, engine.cfg.kv_block_size,
                    mc.head_dim_):
                errors.append(
                    f'paged pool layer {li} {tag}: leaf shape '
                    f'{tuple(leaf.shape)} != allocator geometry '
                    f'({engine._num_blocks}, {hkv}, '
                    f'{engine.cfg.kv_block_size}, {mc.head_dim_})')
    state = engine.model.state_dict()
    device = (engine.device if engine._cuda_index is None
              else torch.device('cuda', engine._cuda_index))
    sharded = 0
    for name, t in state.items():
        full = engine._full_shapes.get(name)
        if full is None:
            continue
        want = local_shape(name, full, tp)
        if tuple(t.shape) != want:
            errors.append(f'param {name}: shape {tuple(t.shape)} != '
                          f'rank-local {want} of {full}')
        elif t.device != device:
            errors.append(f'param {name}: on {t.device}, the rank is on '
                          f'{device}')
        elif want != full:
            sharded += 1
    if tp > 1 and state and sharded == 0:
        errors.append(f'weights fully replicated across a tensor={tp} '
                      'mesh: every rank holds the whole model')
    qkv = {name: qkv_head_sums(t, mc.num_heads // tp)
           for name, t in state.items() if name in engine._qkv_head_sums}
    return {'cache_leaves': cache_leaves,
            'paged_pool_leaves': cache_leaves if paged else 0,
            'param_leaves': len(state),
            'param_leaves_sharded': sharded,
            'tensor_degree': tp,
            'errors': errors, 'qkv_head_sums': qkv}


def _qkv_errors(engine: Any, reports: List[Dict[str, Any]]) -> List[str]:
    """Each rank's fused q/k/v heads against the full weights' (rank 0's
    record): rank r of tensor coordinate c must hold heads
    [c * H / tp, (c + 1) * H / tp) of each of q, k and v."""
    tp = engine._tp
    per = engine.model_config.num_heads // tp
    errors = []
    for r, rep in enumerate(reports):
        c = engine._tpc.coords[r]
        for name, got in rep['qkv_head_sums'].items():
            want = engine._qkv_head_sums[name][:, c * per:(c + 1) * per]
            if got.shape != want.shape or not torch.allclose(
                    got, want, rtol=1e-5, atol=1e-6):
                errors.append(
                    f'rank {r}: {name} rows are not heads '
                    f'[{c * per}, {(c + 1) * per}) of q, k and v')
    return errors


def check_shard_layout(engine: Any) -> Dict[str, int]:
    """Assert every rank's live cache and weights hold their declared
    layout (see the module docstring).  Called on rank 0 (a dispatch:
    every rank checks its own shard).  Returns the JAX report's keys ({}
    without a mesh); raises ShardLayoutError on drift."""
    if getattr(engine, '_tpc', None) is None:
        return {}
    reports = engine._shard_report()
    errors = [f'rank {r}: {e}' for r, rep in enumerate(reports)
              for e in rep['errors']] + _qkv_errors(engine, reports)
    if errors:
        raise ShardLayoutError(
            'shard layout drifted from the declared layout:\n  '
            + '\n  '.join(errors[:8]))
    return {k: v for k, v in reports[0].items()
            if k not in ('errors', 'qkv_head_sums')}


def maybe_check_shard_layout(engine: Any) -> None:
    """Quiesce hook: the check when its sanitizer gate is on."""
    if shard_sanitizer_enabled():
        check_shard_layout(engine)
