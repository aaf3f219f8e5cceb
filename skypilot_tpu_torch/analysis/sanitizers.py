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
  replicated model is the silent memory blow-up).  Violations raise
  ``ShardLayoutError``; an engine without a mesh is a no-op.  Off, the
  check costs one environment read per idle pass.
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
    return {'cache_leaves': cache_leaves,
            'paged_pool_leaves': cache_leaves if paged else 0,
            'param_leaves': len(state),
            'param_leaves_sharded': sharded,
            'tensor_degree': tp,
            'errors': errors}


def check_shard_layout(engine: Any) -> Dict[str, int]:
    """Assert every rank's live cache and weights hold their declared
    layout (see the module docstring).  Called on rank 0 (a dispatch:
    every rank checks its own shard).  Returns the JAX report's keys ({}
    without a mesh); raises ShardLayoutError on drift."""
    if getattr(engine, '_tpc', None) is None:
        return {}
    reports = engine._shard_report()
    errors = [f'rank {r}: {e}' for r, rep in enumerate(reports)
              for e in rep['errors']]
    if errors:
        raise ShardLayoutError(
            'shard layout drifted from the declared layout:\n  '
            + '\n  '.join(errors[:8]))
    return {k: v for k, v in reports[0].items() if k != 'errors'}


def maybe_check_shard_layout(engine: Any) -> None:
    """Quiesce hook: the check when its sanitizer gate is on."""
    if shard_sanitizer_enabled():
        check_shard_layout(engine)
