"""LOCK pass: lock-guarded fields may only be mutated under their lock
(the port's twin of ``skypilot_tpu/analysis/lock_discipline.py``: the
same rule, the same annotations and the same findings on a given
source).

Conventions (all line comments, so they double as documentation at the
declaration site):

- ``self._foo = ... # guarded-by: _lock`` on an assignment (anywhere in
  the class, conventionally ``__init__``) declares ``_foo`` guarded by
  ``self._lock``.  Every later ``self._foo = / += / [k] = / del``
  outside a ``with self._lock:`` block is LOCK001.
- ``def _helper(self): # locked: _lock`` (trailing the ``def`` line or
  on the line above) asserts the CALLER holds ``_lock`` — the helper's
  body is checked as if the lock were held.  This is how "caller holds
  the lock" tribal knowledge becomes machine-checked: annotating a
  helper that some caller invokes bare is a bug the runtime lock-order
  sanitizer and review must catch, so annotate deliberately.
- ``# lock-ok: <reason>`` on a mutating line suppresses LOCK001 for an
  intentional benign race (single-writer fields read lock-free).

Checked mutations are assignments (plain/aug/ann), subscript stores and
``del`` whose target roots at ``self.<field>``.  Mutating *method*
calls (``.append``, ``.pop``, ``.clear`` ...) are NOT tracked — too
alias-prone for an AST pass — so guarded containers still rely on
review for those; the pass catches the rebinding and item-store
patterns that dominate this codebase.

``__init__`` is exempt end-to-end (construction happens-before
publication).  Nested ``def``s inherit the lexical lock context of
their definition site (optimistic: closures created under the lock are
overwhelmingly called under it here).

LOCK002 flags acquiring a lock that is already held — ``with
self._lock:`` nested inside another (lexically, or inside a helper
annotated ``# locked:``) deadlocks, because these are plain
non-reentrant ``threading.Lock``s.
"""
import ast
import re
from typing import Dict, List, Optional, Set

from skypilot_tpu_torch.analysis.findings import Finding

_GUARDED_RE = re.compile(r'#\s*guarded-by:\s*([A-Za-z_]\w*)')
_LOCKED_RE = re.compile(r'#\s*locked:\s*([A-Za-z_]\w*)')
_OK_RE = re.compile(r'#\s*lock-ok\b')

PASS_MUTATION = 'LOCK001'
PASS_REENTRY = 'LOCK002'


def _self_field(node: ast.AST) -> Optional[str]:
    """Root field name for a mutation target: self.X, self.X[...],
    self.X.attr, self.X[...][...] ... -> 'X'; anything else -> None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        parent = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(parent, ast.Name) and parent.id == 'self':
            return node.attr
        node = parent
    return None


def _with_lock_names(node: ast.With, lock_names: Set[str]) -> Set[str]:
    """Lock attrs acquired by a ``with`` statement: items of the form
    ``self.<lock>`` (optionally aliased with ``as``)."""
    out = set()
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == 'self' and expr.attr in lock_names:
            out.add(expr.attr)
    return out


class _MethodChecker(ast.NodeVisitor):

    def __init__(self, path: str, lines: List[str],
                 guarded: Dict[str, str], lock_names: Set[str],
                 held: Set[str], findings: List[Finding]):
        self.path = path
        self.lines = lines
        self.guarded = guarded
        self.lock_names = lock_names
        self.held = set(held)
        self.findings = findings

    # ------------------------------------------------------ lock scope

    def visit_With(self, node: ast.With) -> None:
        acquired = _with_lock_names(node, self.lock_names)
        for name in acquired & self.held:
            self.findings.append(Finding(
                self.path, node.lineno, PASS_REENTRY,
                f"nested 'with self.{name}' while '{name}' is already "
                "held - threading.Lock is not reentrant"))
        self.held |= acquired
        self.generic_visit(node)
        self.held -= acquired

    # Nested defs inherit the current lock context (see module doc).
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # ------------------------------------------------------- mutations

    def _check_target(self, target: ast.AST, lineno: int) -> None:
        field = _self_field(target)
        if field is None or field not in self.guarded:
            return
        lock = self.guarded[field]
        if lock in self.held:
            return
        line = self.lines[lineno - 1] if lineno <= len(self.lines) else ''
        if _OK_RE.search(line):
            return
        self.findings.append(Finding(
            self.path, lineno, PASS_MUTATION,
            f"field '{field}' (guarded by '{lock}') mutated outside "
            f"'with self.{lock}'"))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Tuple):
                for el in t.elts:
                    self._check_target(el, node.lineno)
            else:
                self._check_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_target(t, node.lineno)
        self.generic_visit(node)


def _line_annotation(lines: List[str], lineno: int,
                     regex: re.Pattern) -> Optional[str]:
    """Match ``regex`` on ``lineno`` or the line directly above."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = regex.search(lines[ln - 1])
            if m:
                return m.group(1)
    return None


def _collect_guarded(cls: ast.ClassDef,
                     lines: List[str]) -> Dict[str, str]:
    """field -> lock name, from ``# guarded-by:`` annotated
    ``self.X = ...`` assignments anywhere in the class body."""
    guarded: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        lock = None
        if node.lineno <= len(lines):
            m = _GUARDED_RE.search(lines[node.lineno - 1])
            lock = m.group(1) if m else None
        if lock is None:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == 'self':
                guarded[t.attr] = lock
    return guarded


def check_file(path: str, text: str) -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, PASS_MUTATION,
                        f'unparseable file: {e.msg}')]
    lines = text.splitlines()
    for cls in [n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)]:
        guarded = _collect_guarded(cls, lines)
        if not guarded:
            continue
        lock_names = set(guarded.values())
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name == '__init__':
                continue
            held: Set[str] = set()
            locked = _line_annotation(lines, meth.lineno, _LOCKED_RE)
            if locked is not None:
                held.add(locked)
            checker = _MethodChecker(path, lines, guarded, lock_names,
                                     held, findings)
            for stmt in meth.body:
                checker.visit(stmt)
    return findings
