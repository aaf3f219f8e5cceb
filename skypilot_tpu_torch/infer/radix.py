"""Radix tree over the paged KV block pool: automatic prefix caching --
the port's copy of ``skypilot_tpu/infer/radix.py`` (pure Python, no
device; kept apart because importing the JAX package's ``infer`` loads
its engine).

One node per ``kv_block_size``-token run: a node's path from its
adapter's root spells a block-aligned token prefix, and the node holds
ONE pool block id whose rows carry that run's KV (written by whichever
prefill produced them).  The tree itself owns one refcount on every
block it holds -- engine slots that match a prefix bump the same blocks'
refcounts through ``_append_shared_blocks``, so sharing is the pool's
ordinary refcount discipline, with the tree acting as one more holder.

All refcount side effects run through callbacks supplied by the engine's
allocator, so the accounting lives in one place (``infer/engine.py``).
Every mutating call happens under the engine lock.  The ``generation``
counter bumps on :meth:`clear` so a caller that matched against a
pre-quarantine tree can detect (and must not use) stale block ids -- see
``_start_radix_group_paged``.
"""
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

Run = Tuple[int, ...]


class _Node:
    __slots__ = ('run', 'block', 'children', 'parent', 'holder',
                 'last_used', 'pinned')

    def __init__(self, run: Run, block: int, parent: Optional['_Node'],
                 holder: Dict[Run, '_Node'], last_used: int):
        self.run = run
        self.block = block
        self.children: Dict[Run, '_Node'] = {}
        self.parent = parent
        self.holder = holder          # the dict that maps run -> self
        self.last_used = last_used
        self.pinned = False


class RadixTree:
    """Block-granular prefix index.  See the module docstring."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1 ({block_size})')
        self.block_size = block_size
        # Per-adapter roots: prefix KV is adapter-dependent, so entries
        # only ever match requests naming the same adapter (None = base
        # model) — the same gate the registered-prefix store applies.
        self._roots: Dict[Optional[str], Dict[Run, _Node]] = {}
        self._clock = 0               # monotonic LRU counter
        self._nodes = 0
        self._pinned = 0
        self.generation = 0

    # ------------------------------------------------------------ stats

    @property
    def nodes(self) -> int:
        return self._nodes

    @property
    def blocks_held(self) -> int:
        # One block per node, exactly.
        return self._nodes

    @property
    def pinned(self) -> int:
        return self._pinned

    @property
    def clock(self) -> int:
        """Current LRU tick — compared against a node's ``last_used``
        to judge recency (the host-tier spill gate)."""
        return self._clock

    def walk(self) -> Iterator[_Node]:
        for level in self._roots.values():
            stack = list(level.values())
            while stack:
                nd = stack.pop()
                yield nd
                stack.extend(nd.children.values())

    def walk_adapters(self) -> Iterator[Tuple[Optional[str], _Node]]:
        """walk() with adapter identity — the per-root DFS loses which
        root it started from, which the host tier (keys carry the
        adapter) and hot-set export need back."""
        for adapter, level in self._roots.items():
            stack = list(level.values())
            while stack:
                nd = stack.pop()
                yield adapter, nd
                stack.extend(nd.children.values())

    @staticmethod
    def path_tokens(node: _Node) -> Tuple[int, ...]:
        """The full token prefix a node's path spells (root run first)
        — the node's topology-neutral identity for the host tier."""
        runs = []
        nd: Optional[_Node] = node
        while nd is not None:
            runs.append(nd.run)
            nd = nd.parent
        out: List[int] = []
        for run in reversed(runs):
            out.extend(run)
        return tuple(out)

    # ------------------------------------------------------- operations

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def clear(self) -> None:
        """Drop every node WITHOUT touching refcounts — the quarantine
        path resets the whole allocator wholesale, so per-block derefs
        would double-count.  Bumps ``generation`` (stale-match guard)."""
        self._roots = {}
        self._nodes = 0
        self._pinned = 0
        self.generation += 1

    def drop_adapter(self, adapter: Optional[str],
                     deref: Callable[[int], None]) -> int:
        """Drop every node under `adapter`, pinned ones included, and
        deref each node's block: the tree's references go, blocks a slot
        still shares stay until it frees them.  For rows computed under
        weights that were replaced.  Returns the number of nodes
        dropped."""
        level = self._roots.pop(adapter, None)
        dropped = 0
        stack = list(level.values()) if level else []
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self._pinned -= nd.pinned
            deref(nd.block)
            dropped += 1
        self._nodes -= dropped
        return dropped

    def match(self, adapter: Optional[str], tokens: Sequence[int],
              max_tokens: int) -> List[int]:
        """Longest cached block-aligned prefix of ``tokens`` under
        ``adapter``, capped at ``max_tokens`` tokens.  Returns the
        matched nodes' block ids in path order (possibly empty) and
        LRU-touches the whole path.  The caller must bump each block's
        refcount (under the same lock) before the ids can outlive the
        next eviction."""
        bs = self.block_size
        level = self._roots.get(adapter)
        limit = min(len(tokens), max_tokens) // bs
        out: List[int] = []
        if not level or limit < 1:
            return out
        now = self._tick()
        for i in range(limit):
            run = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            node = level.get(run)
            if node is None:
                break
            node.last_used = now
            out.append(node.block)
            level = node.children
        return out

    def peek(self, adapter: Optional[str], tokens: Sequence[int],
             max_tokens: int) -> List[int]:
        """match() without the LRU touch or clock tick: a read-only
        probe for hot-set export/adoption, which must not reshuffle
        recency while iterating candidates."""
        bs = self.block_size
        level = self._roots.get(adapter)
        limit = min(len(tokens), max_tokens) // bs
        out: List[int] = []
        if not level or limit < 1:
            return out
        for i in range(limit):
            run = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            node = level.get(run)
            if node is None:
                break
            out.append(node.block)
            level = node.children
        return out

    def insert(self, adapter: Optional[str], tokens: Sequence[int],
               blocks: Sequence[int],
               addref: Callable[[int], None],
               deref: Optional[Callable[[int], None]] = None,
               own: bool = False, pinned: bool = False) -> int:
        """Index ``blocks[i]`` as the node for the i-th token run.
        Idempotent on the already-cached part of the path: an existing
        node keeps ITS block, the caller's duplicate is left alone
        (``own=False`` — the caller's slot still holds its own ref) or
        dereffed (``own=True`` — the caller transfers ownership, so a
        duplicate must not leak).  Newly adopted blocks get ``addref``
        under ``own=False``; under ``own=True`` the tree takes over the
        caller's existing ref.  Returns the number of nodes created."""
        bs = self.block_size
        level = self._roots.setdefault(adapter, {})
        parent: Optional[_Node] = None
        now = self._tick()
        created = 0
        for i, blk in enumerate(blocks):
            run = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            if len(run) < bs:
                break                    # partial tail run: not indexable
            node = level.get(run)
            if node is None:
                node = _Node(run, int(blk), parent, level, now)
                level[run] = node
                self._nodes += 1
                created += 1
                if not own:
                    addref(int(blk))
            else:
                node.last_used = now
                if own and int(blk) != node.block:
                    assert deref is not None
                    deref(int(blk))      # duplicate of a cached run
            if pinned and not node.pinned:
                node.pinned = True
                self._pinned += 1
            parent = node
            level = node.children
        return created

    def evict(self, need: int, block_refs,
              deref: Callable[[int], None],
              on_evict: Optional[Callable[[Optional[str], _Node],
                                          None]] = None) -> int:
        """Free up to ``need`` blocks by deleting unpinned LEAF nodes
        whose block refcount is exactly 1 (the tree holds the only
        reference, so the deref actually frees a block), LRU-first.
        Cascades: a parent becomes an eligible leaf once its children
        are gone.  Returns the number of blocks freed.

        ``on_evict(adapter, node)`` fires BEFORE the deref, while the
        victim's block rows are still the prefix's — the engine's
        host-tier spill hook snapshots them there.  The callback must
        not mutate the tree."""
        freed = 0
        while freed < need:
            victim: Optional[_Node] = None
            victim_adapter: Optional[str] = None
            for adapter, nd in self.walk_adapters():
                if nd.children or nd.pinned:
                    continue
                if block_refs[nd.block] != 1:
                    continue             # a slot still shares it
                if victim is None or nd.last_used < victim.last_used:
                    victim = nd
                    victim_adapter = adapter
            if victim is None:
                return freed
            if on_evict is not None:
                on_evict(victim_adapter, victim)
            # holder is the parent's children dict (or an adapter
            # root), so this single delete detaches the node.
            del victim.holder[victim.run]
            self._nodes -= 1
            deref(victim.block)
            freed += 1
        return freed
