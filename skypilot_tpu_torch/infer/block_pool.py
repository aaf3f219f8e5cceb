"""Paged KV block pool: allocator, refcounts, geometry, host tier -- the
port's twin of ``skypilot_tpu/infer/block_pool.py``.

- :class:`BlockPool`: per-block refcounts, the free list, per-slot block
  tables and the pool geometry (block size / count).  Pure host-side
  numpy + python ints, a copy of the JAX package's class; it never
  touches the device.  All methods run under the ENGINE lock.
- :class:`HostKVTier`: the second tier of the pool.  When radix eviction
  would free a recently-referenced node's block, the engine snapshots
  the block's rows to host RAM here before the block id is recycled; the
  next radix match restores the rows into fresh pool blocks.  Entries
  are keyed by ``(adapter, token-prefix)`` and hold the block's rows as
  host tensors ``[L, Hkv, block_size, D]`` in cache dtype -- the JAX
  tier's key and layout, so the hot-prefix wire form is the same.

The device side is torch's.  A pool block ``kp[blk]`` is a VIEW of the
pool, and the eviction that spills it recycles the block id at once, so
the next prefill may overwrite it in place: :meth:`HostKVTier.spill`
therefore queues the copy of the rows at the spill itself, on the
current stream (from a card: into pinned memory, ``non_blocking``,
behind a recorded event; on the CPU: a clone), ahead of any later write
to the block.  :meth:`HostKVTier.finalize` waits on the event.

Refcount discipline is unchanged by the tier: a spill COPIES rows (the
block is still freed by the ordinary eviction deref), and a restore
allocates fresh blocks through the ordinary allocator -- so the
block-conservation law holds with the tier on.
"""
import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Host-tier key: (adapter, token-prefix) for the block's FULL path from
# the radix root -- the identity the radix tree gives the block, so a
# restore can only resurrect rows for exactly the prefix that made them.
TierKey = Tuple[Optional[str], Tuple[int, ...]]
Rows = Tuple[torch.Tensor, torch.Tensor]


class BlockPool:
    """Host-side allocator for the paged KV cache.  See the module
    docstring; every method is called under the engine lock."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks: int, num_slots: int):
        self._num_blocks = num_blocks
        self.block_size = block_size
        # Blocks a single full-length request spans (table width).
        self._max_blocks = max_blocks
        # Refcounts per block (dump block 0 is permanently held), the
        # free list, and per-slot block tables (+ allocated counts).
        # Shared prefix blocks carry refcount > 1; freeing a slot decrefs
        # every table entry.
        self._block_refs = np.zeros((num_blocks,), np.int32)  # guarded-by: engine _lock
        self._tables_np = np.zeros((num_slots, max_blocks), np.int32)  # guarded-by: engine _lock
        self._slot_nblocks = np.zeros((num_slots,), np.int32)  # guarded-by: engine _lock
        self._free_blocks: List[int] = []  # guarded-by: engine _lock
        self.reset()

    def reset(self) -> None:  # locked: engine
        """Empty allocator: every block free except the reserved dump
        block 0 (the quarantine path resets this bookkeeping
        wholesale)."""
        self._block_refs[:] = 0
        self._block_refs[0] = 1
        self._free_blocks = list(range(self._num_blocks - 1, 0, -1))
        self._tables_np[:] = 0
        self._slot_nblocks[:] = 0

    def _alloc_blocks(self, k: int) -> List[int]:  # locked: engine
        if k > len(self._free_blocks):
            # Admission control reserves worst-case demand up front, so
            # a running slot can never get here; reaching it means the
            # accounting is broken.
            raise RuntimeError(
                f'KV block pool exhausted: need {k}, have '
                f'{len(self._free_blocks)} free (admission accounting '
                'bug)')
        out = [self._free_blocks.pop() for _ in range(k)]
        for b in out:
            self._block_refs[b] = 1
        return out

    def _deref_block(self, b: int) -> None:  # locked: engine
        if b == 0:
            return
        self._block_refs[b] -= 1
        if self._block_refs[b] == 0:
            self._free_blocks.append(b)

    def _addref_block(self, b: int) -> None:  # locked: engine
        """Refcount bump for a holder OTHER than a slot table (the radix
        tree adopting a finishing slot's prompt blocks)."""
        self._block_refs[b] += 1

    def _ensure_blocks(self, slot: int, upto: int) -> None:  # locked: engine
        """Grow the slot's table with fresh private blocks so rows
        [0, upto) are resident (no-op when already covered)."""
        need = min(-(-upto // self.block_size), self._max_blocks)
        cur = int(self._slot_nblocks[slot])
        if need <= cur:
            return
        ids = self._alloc_blocks(need - cur)  # owns-blocks: table
        self._tables_np[slot, cur:need] = ids
        self._slot_nblocks[slot] = need

    def _append_shared_blocks(self, slot: int, ids: Sequence[int]) -> None:  # locked: engine
        """Append a prefix's full blocks to the slot's table by REFERENCE
        (refcount bump) -- the copy-free prefix hit."""
        cur = int(self._slot_nblocks[slot])
        self._tables_np[slot, cur:cur + len(ids)] = ids
        for b in ids:
            self._block_refs[b] += 1
        self._slot_nblocks[slot] = cur + len(ids)

    def _free_slot_blocks(self, slot: int) -> None:  # locked: engine
        n = int(self._slot_nblocks[slot])
        for b in self._tables_np[slot, :n]:
            self._deref_block(int(b))
        self._tables_np[slot, :] = 0
        self._slot_nblocks[slot] = 0


def _nbytes(rows: Rows) -> int:
    return sum(t.numel() * t.element_size() for t in rows)


class HostKVTier:
    """Bounded host-RAM LRU of spilled KV blocks.  See the module
    docstring; every method is called under the engine lock.

    :meth:`spill` only queues the copies and parks them on a pending
    list; :meth:`finalize` -- at the next probe, export or idle pass,
    never on the eviction path -- waits for them and lands them in the
    LRU map, trimmed to the budget."""

    def __init__(self, budget_bytes: int, block_size: int,
                 recency_window: int = 0):
        self.budget_bytes = int(budget_bytes)
        self.block_size = block_size
        # Clock-tick window for "recently referenced": an evicted node
        # older than this is dead-cold traffic not worth the copy.
        self.recency_window = int(recency_window)
        # key -> (k_rows, v_rows), each [L, Hkv, block_size, D] host
        # tensors in cache dtype; insertion order == LRU order.
        self._entries: 'collections.OrderedDict[TierKey, Rows]' = (  # guarded-by: engine _lock
            collections.OrderedDict())
        # (key, k_rows, v_rows, event) copies in flight.
        self._pending: List[Tuple[TierKey, torch.Tensor, torch.Tensor,  # guarded-by: engine _lock
                                  Any]] = []
        self._bytes = 0  # guarded-by: engine _lock
        self.stats = {'spills': 0, 'restores': 0, 'lookups': 0,  # guarded-by: engine _lock
                      'hits': 0, 'evictions': 0, 'dropped': 0}

    # ------------------------------------------------------------- state

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def entries(self) -> int:
        return len(self._entries)

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def clear(self) -> None:  # locked: engine
        self._entries.clear()
        self._pending.clear()
        self._bytes = 0

    def drop_adapter(self, adapter: Optional[str]) -> int:  # locked: engine
        """Drop every entry (in flight ones landed first) whose key names
        `adapter`: rows computed under weights that were replaced.
        Returns the number dropped."""
        self.finalize()
        keys = [k for k in self._entries if k[0] == adapter]
        for key in keys:
            self._bytes -= _nbytes(self._entries.pop(key))
        return len(keys)

    # ------------------------------------------------------------- spill

    @staticmethod
    def _snapshot(slices: Sequence[torch.Tensor]) -> torch.Tensor:
        """The per-layer row views stacked into one host tensor [L, ...]:
        queued from pinned memory without blocking from a card, cloned
        on the CPU."""
        if slices[0].device.type != 'cuda':
            return torch.stack(list(slices))
        buf = torch.empty((len(slices),) + tuple(slices[0].shape),
                          dtype=slices[0].dtype, pin_memory=True)
        for i, x in enumerate(slices):
            buf[i].copy_(x, non_blocking=True)
        return buf

    def spill(self, key: TierKey, k_slices: Sequence[torch.Tensor],  # locked: engine
              v_slices: Sequence[torch.Tensor]) -> None:
        """Queue one block's per-layer row views for the host copy NOW,
        on the current stream, before the caller recycles the block id:
        a later write into the block is queued behind the copy."""
        k_rows = self._snapshot(k_slices)
        v_rows = self._snapshot(v_slices)
        ev = None
        if k_slices[0].device.type == 'cuda':
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(k_slices[0].device))
        self._pending.append((key, k_rows, v_rows, ev))
        self.stats['spills'] += 1

    def finalize(self) -> None:  # locked: engine
        """Land in-flight spills into the LRU map and trim to budget.
        Waits only for the copies already queued."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for key, k_rows, v_rows, ev in pending:
            if ev is not None:
                ev.synchronize()
            nbytes = _nbytes((k_rows, v_rows))
            if nbytes > self.budget_bytes:
                self.stats['dropped'] += 1
                continue
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= _nbytes(old)
            self._entries[key] = (k_rows, v_rows)
            self._bytes += nbytes
        while self._bytes > self.budget_bytes and self._entries:
            _, rows = self._entries.popitem(last=False)
            self._bytes -= _nbytes(rows)
            self.stats['evictions'] += 1

    # ----------------------------------------------------------- restore

    def contains(self, key: TierKey) -> bool:  # locked: engine
        """Restore probe (counts toward the restore-hit rate)."""
        self.finalize()
        self.stats['lookups'] += 1
        if key in self._entries:
            self.stats['hits'] += 1
            return True
        return False

    def take(self, key: TierKey) -> Optional[Rows]:  # locked: engine
        """Pop an entry for restore (the rows move back into pool
        blocks, so keeping the host copy would double-count the
        budget)."""
        self.finalize()
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= _nbytes(entry)
        return entry

    def get(self, key: TierKey) -> Optional[Rows]:  # locked: engine
        """Non-destructive read (hot-set export): LRU-touches."""
        self.finalize()
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def keys_recent_first(self) -> List[TierKey]:  # locked: engine
        self.finalize()
        return list(reversed(self._entries))

    # ------------------------------------------------------------- audit

    def audit(self) -> List[str]:  # locked: engine
        """Conservation-style self-check: the byte ledger must equal the
        entries it claims to cover, and the budget bound must hold.
        Returns error strings (empty = ok)."""
        self.finalize()
        errors = []
        actual = sum(_nbytes(rows) for rows in self._entries.values())
        if actual != self._bytes:
            errors.append(
                f'host tier byte ledger {self._bytes} != entry bytes '
                f'{actual} (leak across the tier boundary)')
        if self._bytes > self.budget_bytes:
            errors.append(
                f'host tier over budget: {self._bytes} > '
                f'{self.budget_bytes}')
        return errors

    def stats_section(self) -> Dict[str, Any]:
        """kv.host_tier rows (the key set of the engine's disabled-tier
        branch).  Read lock-free from kv_health()/stats(), so no
        finalize here: in-flight copies report as in_flight."""
        st = self.stats
        lookups = st['lookups']
        return {
            'enabled': True,
            'budget_bytes': self.budget_bytes,
            'bytes': self._bytes,
            'entries': len(self._entries),
            'spills': st['spills'],
            'restores': st['restores'],
            'restore_hit_rate': (st['hits'] / lookups) if lookups else 0.0,
            'in_flight': len(self._pending),
            'evictions': st['evictions'],
        }
