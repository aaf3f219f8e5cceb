"""The port's copies of the radix tree (skypilot_tpu_torch.infer.radix) and
the block pool's allocator (infer.block_pool.BlockPool) held against the
JAX package's classes: the same random operation sequences, drawn by
hypothesis, drive a tree + pool pair on each side the way the engine
does (match and share, allocate, adopt a finished prompt, adopt host
rows, evict, quarantine reset), and after every operation the two give
the same return values, matches, evictions, refcounts, free lists,
tables and tree."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from skypilot_tpu.infer.block_pool import BlockPool as JaxBlockPool
from skypilot_tpu.infer.radix import RadixTree as JaxRadixTree
from skypilot_tpu_torch.infer.block_pool import BlockPool
from skypilot_tpu_torch.infer.radix import RadixTree

BS, SLOTS, MAX_BLOCKS, NUM_BLOCKS = 4, 3, 6, 14


class _Side:
    """A tree + pool pair driven as the engine drives them."""

    def __init__(self, tree_cls, pool_cls):
        self.tree = tree_cls(BS)
        self.pool = pool_cls(NUM_BLOCKS, BS, MAX_BLOCKS, SLOTS)
        self.prompts = {}
        self.victims = []

    def _evict(self, need):
        return self.tree.evict(
            need, self.pool._block_refs, self.pool._deref_block,
            on_evict=lambda ad, nd: self.victims.append(
                (ad, self.tree.path_tokens(nd), nd.block)))

    def op(self, kind, slot, adapter, tokens, need):
        pool, tree = self.pool, self.tree
        if kind == 'admit':
            if slot in self.prompts:
                return 'busy'
            blocks = tree.match(adapter, tokens, len(tokens) - 1)
            want = -(-len(tokens) // BS) - len(blocks)
            short = want - len(pool._free_blocks)
            if short > 0:
                self._evict(short)
            if want > len(pool._free_blocks):
                return ('deferred', blocks)
            pool._append_shared_blocks(slot, blocks)
            pool._ensure_blocks(slot, len(tokens))
            self.prompts[slot] = (adapter, tokens)
            return ('admitted', blocks)
        if kind == 'finish':
            if slot not in self.prompts:
                return 'idle'
            adapter, prompt = self.prompts.pop(slot)
            full = min(len(prompt) // BS, int(pool._slot_nblocks[slot]))
            made = tree.insert(adapter, prompt,
                               [int(b) for b in pool._tables_np[slot, :full]],
                               addref=pool._addref_block)
            pool._free_slot_blocks(slot)
            return made
        if kind == 'adopt':
            runs = len(tokens) // BS
            existing = tree.match(adapter, tokens, runs * BS)
            k = min(runs - len(existing), len(pool._free_blocks))
            if k < 1:
                return ('none', existing)
            ids = pool._alloc_blocks(k)
            return tree.insert(adapter, tokens[:(len(existing) + k) * BS],
                               list(existing) + ids,
                               addref=pool._addref_block,
                               deref=pool._deref_block, own=True)
        if kind == 'peek':
            return tree.peek(adapter, tokens, len(tokens))
        if kind == 'evict':
            return self._evict(need)
        if kind == 'reset':
            self.prompts.clear()
            tree.clear()
            pool.reset()
            return None
        raise AssertionError(kind)

    def state(self):
        tree = sorted((ad or '', tuple(self.tree.path_tokens(nd)), nd.block,
                       nd.last_used, nd.pinned)
                      for ad, nd in self.tree.walk_adapters())
        return (self.pool._block_refs.tolist(),
                list(self.pool._free_blocks),
                self.pool._tables_np.tolist(),
                self.pool._slot_nblocks.tolist(),
                tree, self.tree.clock, self.tree.generation,
                self.tree.nodes, self.tree.blocks_held, self.victims)


_ops = st.lists(st.tuples(
    st.sampled_from(['admit', 'admit', 'finish', 'finish', 'adopt', 'peek',
                     'evict', 'reset']),
    st.integers(0, SLOTS - 1),
    st.sampled_from([None, None, 'a']),
    # A two-letter alphabet, so prompts share prefixes and runs collide.
    st.lists(st.integers(1, 2), min_size=1, max_size=MAX_BLOCKS * BS),
    st.integers(1, 4)), min_size=1, max_size=40)


@settings(max_examples=150, deadline=None, database=None)
@given(_ops)
def test_tree_and_pool_match_the_jax_classes(ops):
    mine = _Side(RadixTree, BlockPool)
    ref = _Side(JaxRadixTree, JaxBlockPool)
    for kind, slot, adapter, tokens, need in ops:
        assert mine.op(kind, slot, adapter, tokens, need) == \
            ref.op(kind, slot, adapter, tokens, need), kind
        assert mine.state() == ref.state(), kind
        refs = mine.pool._block_refs
        assert refs[0] == 1 and (refs >= 0).all()


def test_match_is_block_aligned_and_capped():
    tree, refs = RadixTree(4), np.zeros(8, np.int32)
    added = []
    assert tree.insert(None, list(range(10)), [3, 5, 6],
                       addref=added.append) == 2   # the 2-token tail: no
    assert added == [3, 5]
    assert tree.match(None, list(range(10)), 9) == [3, 5]
    assert tree.match(None, list(range(10)), 7) == [3]
    assert tree.match('a', list(range(10)), 9) == []
    assert tree.peek(None, [0, 1, 2, 3, 9], 5) == [3]
    refs[[3, 5]] = 1
    freed = []
    assert tree.evict(5, refs, freed.append) == 2
    assert freed == [5, 3] and tree.nodes == 0


def test_block_pool_rejects_over_allocation():
    pool = BlockPool(4, 8, 2, 2)
    assert pool._alloc_blocks(3) == [1, 2, 3]
    with pytest.raises(RuntimeError, match='exhausted'):
        pool._alloc_blocks(1)
    pool.reset()
    assert pool._free_blocks == [3, 2, 1] and pool._block_refs.tolist() == \
        [1, 0, 0, 0]
