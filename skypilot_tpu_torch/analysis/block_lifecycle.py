"""BLOCK pass: path-sensitive paged-block ownership proofs (the port's
twin of ``skypilot_tpu/analysis/block_lifecycle.py``).

``_alloc_blocks`` hands out refcount-1 block ids as a plain Python
list; nothing but discipline makes that list reach EXACTLY ONE of the
legal ownership sinks on every path — including the exception edges a
mid-function device dispatch can take:

- **free**: ``for b in VAR: self._deref_block(b)`` (or a scalar
  ``self._deref_block(VAR)``) — refs returned to the pool.
- **table**: ``self._tables_np[...] = VAR`` — the slot table adopts
  the refs (``_free_slot_blocks`` releases them at slot teardown).
- **entry**: ``self._prefixes[...] = {... VAR ...}`` — the resident
  prefix registry adopts (eviction derefs).
- **radix**: ``self._radix.insert(..., VAR, ..., own=True)`` — the
  radix tree takes over the allocation refs.
- **spill**: ``self._host_tier.spill(..., VAR, ...)`` — the host-RAM
  tier adopts the blocks across the tier boundary.
- **return** (the port's sink): ``return VAR`` — the caller takes the
  refs.  A function whose allocation site permits it is itself an
  allocator: each ``VAR = self.<function>(...)`` in the file is an
  allocation site of its own, proven like ``_alloc_blocks``'s
  (``_capture_into_blocks`` hands its blocks to the prefix registry's
  and the radix tree's registration paths).

The static complement of the runtime refcount sanitizer
(``sanitizers.check_block_conservation``): the sanitizer proves the
pool balanced at a quiesce point it actually reached; this pass proves
no path — taken or not — can leak or double-release.

Allocation sites are annotated in source::

    blocks = self._alloc_blocks(need)   # owns-blocks: entry

naming which sink kinds the site may use ('free' is always legal —
every owner must be able to unwind).  An UNannotated alloc site is
still analyzed, with every sink kind but 'return' allowed.

- **BLOCK001** (leak-on-path): some path from the allocation reaches a
  return / raise / escaping-exception edge / loop-iteration end while
  still owning the list.
- **BLOCK002** (double-release-on-path): a path releases the same list
  twice, or through a sink kind the annotation forbids.

Exception edges: the JAX pass's jit exception edges are the port's
dispatch exception edges — a call of an engine method wrapped in
``infer.tp.dispatch`` (a tensor-parallel dispatch, a kernel launch that
raises, an injected fault) or of ``_alloc_blocks``, and explicit
``raise`` statements.
"""
import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from skypilot_tpu_torch.analysis.findings import Finding

PASS_LEAK = 'BLOCK001'
PASS_DOUBLE_FREE = 'BLOCK002'

# Files whose alloc sites this pass owns (mirrors jit_boundary's
# explicit HOT_ROOTS config).
OWNED_FILES = (
    'skypilot_tpu_torch/infer/engine.py',
    'skypilot_tpu_torch/infer/radix.py',
    'skypilot_tpu_torch/infer/block_pool.py',
)

ALLOC_FUNCS = frozenset({'_alloc_blocks'})

# self-method calls treated as may-raise while owning: the port's
# dispatch methods (each wrapped in infer.tp.dispatch: a tensor-parallel
# broadcast, a kernel launch and injected faults all surface here), the
# JAX engine's names of the same roots, and the allocator.  Any method
# of the analyzed file decorated with ``dispatch`` is added.
RAISING_CALLS = frozenset({
    '_paged_prefill', '_paged_decode', '_paged_spec_verify',
    '_paged_copy_blocks', '_prefill_insert', '_chunk_prefill',
    '_decode', '_spec_verify', '_prefill_capture', '_prefix_prefill',
    '_alloc_blocks', '_paged_restore_blocks', '_zero_cache',
})

ALL_KINDS = frozenset({'free', 'table', 'entry', 'radix', 'spill',
                       'return'})
# An unannotated site may use every kind but 'return': handing the refs
# to the caller makes the function an allocator, which must be said.
DEFAULT_KINDS = ALL_KINDS - {'return'}

_ANNOT_RE = re.compile(r'#\s*owns-blocks:\s*([a-z,\s]+)')

# Ownership states for one symbolic allocation instance.
_INERT = 'INERT'     # before the allocation executes
_OWNED = 'OWNED'     # refs held by the local var
_DONE = 'DONE'       # refs handed to exactly one sink


def _annotation_kinds(lines: Sequence[str], lineno: int
                      ) -> Optional[frozenset]:
    """Sink kinds allowed by the ``# owns-blocks:`` comment on the
    alloc line (or the line above).  None = unannotated (all kinds)."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _ANNOT_RE.search(lines[ln - 1])
            if m:
                kinds = frozenset(
                    k.strip() for k in m.group(1).split(',')
                    if k.strip()) & ALL_KINDS
                # 'free' is always legal: every owner must be able to
                # unwind on the exception edge.
                return (kinds | {'free'}) if kinds else DEFAULT_KINDS
    return None


def _self_call_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name) and \
            node.func.value.id == 'self':
        return node.func.attr
    return None


def _alloc_target(stmt: ast.stmt, alloc_funcs: frozenset = ALLOC_FUNCS
                  ) -> Optional[Tuple[str, ast.Call]]:
    """(var, call) when stmt is ``VAR = self._alloc_blocks(...)`` or
    ``[VAR] = self._alloc_blocks(...)`` (or a call of another of
    ``alloc_funcs``)."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return None
    if _self_call_name(stmt.value) not in alloc_funcs:
        return None
    tgt = stmt.targets[0]
    if isinstance(tgt, ast.Name):
        return tgt.id, stmt.value
    if isinstance(tgt, (ast.List, ast.Tuple)) and \
            len(tgt.elts) == 1 and isinstance(tgt.elts[0], ast.Name):
        return tgt.elts[0].id, stmt.value
    return None


def _mentions_name(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _release_kind(stmt: ast.stmt, var: str
                  ) -> Optional[Tuple[str, int]]:
    """(kind, line) when stmt hands ``var``'s refs to a sink."""
    # free: for b in VAR: self._deref_block(b)
    if isinstance(stmt, ast.For) and \
            isinstance(stmt.iter, ast.Name) and stmt.iter.id == var:
        for sub in ast.walk(stmt):
            if _self_call_name(sub) == '_deref_block':
                return 'free', stmt.lineno
        return None
    if isinstance(stmt, ast.Expr):
        # free (scalar): self._deref_block(VAR)
        call = stmt.value
        if _self_call_name(call) == '_deref_block' and call.args and \
                isinstance(call.args[0], ast.Name) and \
                call.args[0].id == var:
            return 'free', stmt.lineno
    # The remaining sinks live in SIMPLE statements only — a compound
    # statement containing one deep in its body is not itself the
    # release (the walker descends and finds it with accurate states).
    if not isinstance(stmt, (ast.Expr, ast.Assign, ast.AugAssign,
                             ast.AnnAssign)):
        return None
    # radix: self._radix.insert(..., VAR, ..., own=True) — the call
    # may feed an Assign/AugAssign.
    for sub in ast.walk(stmt):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == 'insert' and \
                isinstance(sub.func.value, ast.Attribute) and \
                sub.func.value.attr == '_radix':
            owns = any(kw.arg == 'own' and
                       isinstance(kw.value, ast.Constant) and
                       kw.value.value is True
                       for kw in sub.keywords)
            if owns and any(_mentions_name(a, var) for a in sub.args):
                return 'radix', sub.lineno
    # spill: self._host_tier.spill(..., VAR, ...) — the host-RAM tier
    # adopts the blocks across the tier boundary.
    for sub in ast.walk(stmt):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == 'spill' and \
                isinstance(sub.func.value, ast.Attribute) and \
                sub.func.value.attr == '_host_tier':
            if any(_mentions_name(a, var) for a in sub.args):
                return 'spill', sub.lineno
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        tgt = stmt.targets[0]
        if isinstance(tgt, ast.Subscript) and \
                isinstance(tgt.value, ast.Attribute):
            # table: self._tables_np[...] = VAR
            if tgt.value.attr == '_tables_np' and \
                    _mentions_name(stmt.value, var):
                return 'table', stmt.lineno
            # entry: self._prefixes[...] = {... VAR ...}
            if tgt.value.attr == '_prefixes' and \
                    _mentions_name(stmt.value, var):
                return 'entry', stmt.lineno
    return None


def _may_raise(stmt: ast.stmt, raising: frozenset = RAISING_CALLS
               ) -> Optional[int]:
    """Line of the first may-raise call inside stmt (nested
    defs/lambdas excluded — they don't run here)."""
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        name = _self_call_name(node)
        if name in raising:
            return node.lineno
        stack.extend(ast.iter_child_nodes(node))
    return None


class _SiteProof:
    """Abstract interpretation of ONE allocation site: every statement
    path from function entry, tracking {INERT, OWNED, DONE} for the
    allocated list.  Findings dedupe on (line, pass, message)."""

    def __init__(self, path: str, fn_name: str, alloc_stmt: ast.stmt,
                 var: str, kinds: frozenset,
                 raising: frozenset = RAISING_CALLS) -> None:
        self.path = path
        self.fn_name = fn_name
        self.alloc_stmt = alloc_stmt
        self.var = var
        self.kinds = kinds
        self.raising = raising
        self.findings: Dict[Tuple[int, str, str], Finding] = {}

    def _emit(self, line: int, pass_id: str, msg: str) -> None:
        key = (line, pass_id, msg)
        if key not in self.findings:
            self.findings[key] = Finding(self.path, line, pass_id, msg)

    def _leak(self, line: int, how: str) -> None:
        self._emit(line, PASS_LEAK,
                   f'{self.fn_name}: blocks allocated at line '
                   f'{self.alloc_stmt.lineno} leak {how}')

    # -- statement-list walker -------------------------------------
    # run() returns the fall-through states; terminal paths (return /
    # raise routed to a handler / escaping exception) contribute none.
    # try_stack holds per-enclosing-Try collectors of raise states.

    def run(self, stmts: Sequence[ast.stmt], states: Set[str],
            try_stack: List[Set[str]]) -> Set[str]:
        cur = set(states)
        for stmt in stmts:
            if not cur:
                return cur
            cur = self._step(stmt, cur, try_stack)
        return cur

    def _raise_edge(self, states: Set[str], line: int,
                    try_stack: List[Set[str]], how: str) -> None:
        """An exception launches from here: route to the innermost
        handler, or report the owning states that escape."""
        if try_stack:
            try_stack[-1] |= states
            return
        if _OWNED in states:
            self._leak(line, how)

    def _step(self, stmt: ast.stmt, cur: Set[str],
              try_stack: List[Set[str]]) -> Set[str]:
        # The allocation itself: may raise BEFORE owning (safe), then
        # transitions INERT -> OWNED.
        if stmt is self.alloc_stmt:
            return {_OWNED if s == _INERT else s for s in cur}

        rel = _release_kind(stmt, self.var)
        if rel is not None:
            kind, line = rel
            if _DONE in cur:
                self._emit(line, PASS_DOUBLE_FREE,
                           f'{self.fn_name}: blocks allocated at line '
                           f'{self.alloc_stmt.lineno} already released '
                           f'on some path reaching this {kind} sink')
            if _OWNED in cur and kind not in self.kinds:
                self._emit(line, PASS_DOUBLE_FREE,
                           f"{self.fn_name}: sink kind '{kind}' not "
                           f'permitted by the owns-blocks annotation '
                           f'at line {self.alloc_stmt.lineno} '
                           f'(allowed: {",".join(sorted(self.kinds))})')
            return {_DONE if s == _OWNED else s for s in cur}

        # Rebinding the var while owning loses the only handle.
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == self.var
                for t in stmt.targets) and _OWNED in cur:
            self._leak(stmt.lineno, 'when the variable is rebound')
            return {_DONE if s == _OWNED else s for s in cur}

        if isinstance(stmt, ast.Return) and 'return' in self.kinds and \
                isinstance(stmt.value, ast.Name) and \
                stmt.value.id == self.var:
            # The return sink: the caller takes the refs (returning
            # them after another sink took them hands over nothing).
            return set()
        if isinstance(stmt, ast.Return):
            if _OWNED in cur:
                self._leak(stmt.lineno, 'on this return path')
            return set()
        if isinstance(stmt, ast.Raise):
            self._raise_edge(cur, stmt.lineno, try_stack,
                             'on this raise path')
            return set()

        if isinstance(stmt, ast.If):
            out = self.run(stmt.body, cur, try_stack)
            out |= self.run(stmt.orelse, cur, try_stack)
            return out
        if isinstance(stmt, ast.With):
            return self.run(stmt.body, cur, try_stack)
        if isinstance(stmt, (ast.For, ast.While)):
            contains_alloc = any(
                sub is self.alloc_stmt for sub in ast.walk(stmt))
            if contains_alloc:
                # Each iteration allocates a FRESH instance: the body
                # always enters with no live allocation, and an OWNED
                # state surviving to the iteration end is a leak (the
                # next iteration rebinds the variable).
                body_states = self.run(stmt.body, {_INERT}, try_stack)
                if _OWNED in body_states:
                    self._leak(stmt.lineno,
                               'at the end of the loop iteration that '
                               'allocated them (next iteration rebinds'
                               ' the variable)')
                    body_states = {_DONE if s == _OWNED else s
                                   for s in body_states}
                out = cur | body_states
            else:
                body_states = set(cur)
                out = set(cur)      # zero iterations
                for _ in range(3):  # fixpoint over tiny state space
                    body_states = self.run(stmt.body, body_states,
                                           try_stack)
                    if body_states <= out:
                        break
                    out |= body_states
            out |= self.run(stmt.orelse, out, try_stack)
            return out
        if isinstance(stmt, ast.Try):
            collector: Set[str] = set()
            try_stack.append(collector)
            body_out = self.run(stmt.body, cur, try_stack)
            try_stack.pop()
            out = self.run(stmt.orelse, body_out, try_stack) \
                if stmt.orelse else body_out
            for handler in stmt.handlers:
                out |= self.run(handler.body, set(collector),
                                try_stack)
            if stmt.finalbody:
                out = self.run(stmt.finalbody, out, try_stack)
            return out
        # Simple statement: a may-raise dispatch forks an exception
        # edge with the state AT this statement, then falls through.
        # (Compound statements descend instead — their inner simple
        # statements fire the edge with accurate post-release states.)
        raise_line = _may_raise(stmt, self.raising)
        if raise_line is not None:
            self._raise_edge(
                cur, raise_line, try_stack,
                'if the dispatch raises (fault injection, a kernel '
                'launch or tensor-parallel dispatch failure)')
        return cur


def _own_stmts(fn_node: ast.AST) -> List[ast.stmt]:
    """Statements belonging to ``fn_node`` itself (nested defs get
    their own proofs when the module walk reaches them)."""
    out: List[ast.stmt] = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.stmt):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _dispatch_methods(tree: ast.AST) -> Set[str]:
    """Functions of the file decorated with ``dispatch`` (``@dispatch()``
    or ``@tp.dispatch(...)``): the port's device dispatches."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            fn = dec.func if isinstance(dec, ast.Call) else dec
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name == 'dispatch':
                out.add(node.name)
    return out


def _returning_allocators(tree: ast.AST, lines: Sequence[str]
                          ) -> Set[str]:
    """Functions of the file with an allocation site whose annotation
    permits the 'return' sink: allocators of their callers' (one level
    at a time, to a fixpoint)."""
    funcs = set(ALLOC_FUNCS)
    while True:
        grown = set(funcs)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for stmt in _own_stmts(node):
                alloc = _alloc_target(stmt, frozenset(funcs))
                if alloc is None:
                    continue
                kinds = _annotation_kinds(lines, alloc[1].lineno)
                if kinds is not None and 'return' in kinds:
                    grown.add(node.name)
        if grown == funcs:
            return funcs
        funcs = grown


def check_file(path: str, text: str) -> List[Finding]:
    if path not in OWNED_FILES:
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    lines = text.splitlines()
    alloc_funcs = frozenset(_returning_allocators(tree, lines))
    raising = RAISING_CALLS | _dispatch_methods(tree) | alloc_funcs
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        for stmt in _own_stmts(node):
            alloc = _alloc_target(stmt, alloc_funcs)
            if alloc is None:
                continue
            var, call = alloc
            kinds = _annotation_kinds(lines, call.lineno)
            proof = _SiteProof(path, node.name, stmt, var,
                               kinds if kinds is not None
                               else DEFAULT_KINDS, raising)
            final = proof.run(node.body, {_INERT}, [])
            if _OWNED in final:
                proof._leak(node.body[-1].lineno,
                            'when the function falls off its end')
            findings.extend(proof.findings.values())
    findings.sort(key=lambda f: (f.line, f.pass_id, f.message))
    return findings
