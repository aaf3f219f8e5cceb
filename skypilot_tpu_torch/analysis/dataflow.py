"""Dataflow scaffolding for the port's wire and shard passes: the parts
of ``skypilot_tpu/analysis/dataflow.py`` they use, copied (the port
imports nothing of the JAX package).

- **ModuleIndex**: one parse of a file, functions indexed by dotted
  qualname (``Class.method``, ``outer.inner``).
- **local_defs**: the def-chains of a function's locals (every
  expression assigned to each name).
- **KeyModel** (`dict_key_model`): the dict-key lattice of a JSON
  payload — which string keys a function's returned / emitted /
  assigned dict carries, whether each key is produced on *every* path
  or only some branch, and a best-effort value type per key (for the
  WIRE003 type-conflict check); ``read_keys`` is the consumer side.

The JAX module's ``resolve_sources`` (source atoms through caller
arguments) and its call-site index serve only its compile-budget pass, which has no
counterpart in the port (eager PyTorch compiles no graphs), and is not
copied.

Everything here is pure ``ast`` — no imports of the analyzed modules,
so the passes run in milliseconds and never pay a torch import.
"""
import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    'FunctionInfo', 'ModuleIndex', 'KeyModel', 'dotted_name',
    'local_defs', 'dict_key_model', 'infer_value_type', 'read_keys',
]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``self.cfg.kv_block_size`` -> that string; None when the chain
    bottoms out in anything but a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    qualname: str
    node: ast.AST                 # FunctionDef / AsyncFunctionDef


class ModuleIndex:
    """One file, parsed once: functions by qualname."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.tree = ast.parse(text)
        self.lines = text.splitlines()
        self.functions: Dict[str, FunctionInfo] = {}
        self._index(self.tree.body, prefix='')

    def _index(self, body: Sequence[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f'{prefix}{node.name}'
                self.functions[qual] = FunctionInfo(qual, node)
                self._index(node.body, prefix=f'{qual}.')
            elif isinstance(node, ast.ClassDef):
                self._index(node.body, prefix=f'{prefix}{node.name}.')
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For,
                                   ast.While)):
                self._index(_suites(node), prefix=prefix)

    def find(self, name: str) -> Optional[FunctionInfo]:
        """Exact qualname, else unique ``...name`` suffix match."""
        if name in self.functions:
            return self.functions[name]
        hits = [f for q, f in self.functions.items()
                if q.endswith('.' + name)]
        return hits[0] if len(hits) == 1 else None


def _suites(node: ast.stmt) -> List[ast.stmt]:
    out: List[ast.stmt] = []
    for field in ('body', 'orelse', 'finalbody'):
        out.extend(getattr(node, field, ()) or ())
    for handler in getattr(node, 'handlers', ()) or ():
        out.extend(handler.body)
    return out


def local_defs(fn_node: ast.AST) -> Dict[str, List[ast.expr]]:
    """name -> every expression assigned to it inside the function
    (nested defs excluded).  Tuple/list unpack targets map each name to
    the whole RHS wrapped as an unknown marker unless it is the
    single-element ``[x] = rhs`` form, which maps to the RHS call."""
    defs: Dict[str, List[ast.expr]] = {}

    def add(name: str, expr: ast.expr) -> None:
        defs.setdefault(name, []).append(expr)

    for node in _walk_no_nested(fn_node):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                _bind_target(tgt, node.value, add)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            _bind_target(node.target, node.value, add)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            add(node.target.id, node)        # opaque: x op= ...
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            _bind_target(node.target, node, add)   # loop var: opaque
        elif isinstance(node, ast.withitem) and \
                node.optional_vars is not None:
            _bind_target(node.optional_vars, node.context_expr, add)
        elif isinstance(node, ast.NamedExpr) and \
                isinstance(node.target, ast.Name):
            add(node.target.id, node.value)
    return defs


def _bind_target(tgt, value, add) -> None:
    if isinstance(tgt, ast.Name):
        add(tgt.id, value)
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        if len(tgt.elts) == 1 and isinstance(tgt.elts[0], ast.Name):
            add(tgt.elts[0].id, value)       # [x] = call()
        else:
            for el in tgt.elts:
                if isinstance(el, ast.Name):
                    add(el.id, _OPAQUE)


class _Opaque(ast.expr):
    """Sentinel def expression for bindings the walk cannot model."""


_OPAQUE = _Opaque()

def _walk_no_nested(fn_node: ast.AST):
    """ast.walk over a function body that does not descend into nested
    function/class definitions."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


_DEFS_ATTR = '_skycheck_defs'


def _defs_cache(index: ModuleIndex, fn: FunctionInfo):
    cached = getattr(fn, _DEFS_ATTR, None)
    if cached is None:
        cached = local_defs(fn.node)
        setattr(fn, _DEFS_ATTR, cached)
    return cached


# ------------------------------------------------------- dict-key lattice

_TYPE_MAP = {int: 'number', float: 'number', str: 'str', bool: 'bool',
             type(None): 'none'}
_CAST_TYPES = {'int': 'number', 'float': 'number', 'len': 'number',
               'sum': 'number', 'round': 'number', 'str': 'str',
               'bool': 'bool', 'dict': 'dict', 'list': 'list',
               'sorted': 'list', 'tuple': 'list', 'set': 'list',
               'min': 'number', 'max': 'number', 'abs': 'number'}


def infer_value_type(index: ModuleIndex, fn: FunctionInfo,
                     expr: ast.expr) -> str:
    """Best-effort concrete JSON type of ``expr``; 'unknown' never
    conflicts with anything."""
    if isinstance(expr, ast.Constant):
        return _TYPE_MAP.get(type(expr.value), 'unknown')
    if isinstance(expr, ast.Dict) or isinstance(expr, ast.DictComp):
        return 'dict'
    if isinstance(expr, (ast.List, ast.ListComp, ast.Tuple)):
        return 'list'
    if isinstance(expr, ast.Compare):
        return 'bool'
    if isinstance(expr, ast.IfExp):
        a = infer_value_type(index, fn, expr.body)
        b = infer_value_type(index, fn, expr.orelse)
        if a == b:
            return a
        if 'none' in (a, b):        # Optional[x]: x or null
            return a if b == 'none' else b
        return 'unknown'
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in _CAST_TYPES:
            return _CAST_TYPES[f.id]
        if isinstance(f, ast.Attribute) and f.attr in ('get',):
            return 'unknown'
        return 'unknown'
    if isinstance(expr, ast.BinOp):
        a = infer_value_type(index, fn, expr.left)
        b = infer_value_type(index, fn, expr.right)
        if 'number' in (a, b):
            return 'number'
        return 'unknown'
    if isinstance(expr, ast.Name):
        info = _defs_cache(index, fn).get(expr.id)
        if info and len(info) == 1 and not isinstance(info[0], _Opaque):
            if isinstance(info[0], ast.stmt):
                return 'unknown'
            return infer_value_type(index, fn, info[0])
        return 'unknown'
    return 'unknown'


@dataclasses.dataclass
class KeyModel:
    """Produced keys of one payload: key -> (always, types, lines)."""
    always: Set[str] = dataclasses.field(default_factory=set)
    sometimes: Set[str] = dataclasses.field(default_factory=set)
    types: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    lines: Dict[str, int] = dataclasses.field(default_factory=dict)
    complete: bool = True          # False when **spread went unresolved

    @property
    def keys(self) -> Set[str]:
        return self.always | self.sometimes

    def merge_branch(self, other: 'KeyModel') -> None:
        """Combine two alternative branches: always = intersection."""
        self.sometimes |= ((self.always ^ other.always) |
                           other.sometimes)
        self.always &= other.always
        self.sometimes -= self.always
        for k, t in other.types.items():
            self.types.setdefault(k, set()).update(t)
        for k, ln in other.lines.items():
            self.lines.setdefault(k, ln)
        self.complete = self.complete and other.complete


def _literal_keys(index: ModuleIndex, fn: FunctionInfo,
                  node: ast.Dict, model: KeyModel,
                  conditional: bool, depth: int = 3) -> None:
    for k, v in zip(node.keys, node.values):
        if k is None:                       # {**spread}
            resolved = False
            if isinstance(v, ast.Name):
                defs = _defs_cache(index, fn).get(v.id, [])
                for d in defs:
                    if isinstance(d, ast.Dict) and depth > 0:
                        _literal_keys(index, fn, d, model,
                                      conditional, depth - 1)
                        resolved = True
            if not resolved:
                model.complete = False
            continue
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            _note_key(index, fn, model, k.value, v, conditional,
                      k.lineno)
        else:
            model.complete = False


def _note_key(index: ModuleIndex, fn: FunctionInfo, model: KeyModel,
              key: str, value: ast.expr, conditional: bool,
              lineno: int) -> None:
    if conditional:
        if key not in model.always:
            model.sometimes.add(key)
    else:
        model.always.add(key)
        model.sometimes.discard(key)
    t = infer_value_type(index, fn, value)
    if t != 'unknown':
        model.types.setdefault(key, set()).add(t)
    model.lines.setdefault(key, lineno)


def _is_conditional(fn_node: ast.AST, target: ast.AST) -> bool:
    """True when ``target`` sits under an If/Try/loop inside the
    function (i.e. does not execute on every call)."""
    for holder in ast.walk(fn_node):
        if holder is fn_node or not isinstance(
                holder, (ast.If, ast.Try, ast.For, ast.While,
                         ast.ExceptHandler)):
            continue
        if any(child is target for child in ast.walk(holder)):
            return True
    return False


def _apply_var_mutations(index: ModuleIndex, fn: FunctionInfo,
                         var: str, model: KeyModel) -> None:
    """Fold ``var['k'] = v`` / ``var.update({...})`` /
    ``var.setdefault('k', v)`` statements into the model."""
    for node in _walk_no_nested(fn.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Subscript) and \
                isinstance(node.targets[0].value, ast.Name) and \
                node.targets[0].value.id == var:
            sl = node.targets[0].slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value,
                                                           str):
                cond = _is_conditional(fn.node, node)
                _note_key(index, fn, model, sl.value, node.value,
                          cond, node.lineno)
            else:
                model.complete = False
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == var:
            cond = _is_conditional(fn.node, node)
            if node.func.attr == 'update' and node.args and \
                    isinstance(node.args[0], ast.Dict):
                _literal_keys(index, fn, node.args[0], model, cond)
            elif node.func.attr == 'setdefault' and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                val = (node.args[1] if len(node.args) > 1
                       else ast.Constant(value=None))
                _note_key(index, fn, model, node.args[0].value, val,
                          cond, node.lineno)


def _resolve_payload_expr(index: ModuleIndex, fn: FunctionInfo,
                          expr: ast.expr, conditional: bool
                          ) -> KeyModel:
    model = KeyModel()
    if isinstance(expr, ast.Dict):
        _literal_keys(index, fn, expr, model, conditional)
    elif isinstance(expr, ast.Name):
        defs = _defs_cache(index, fn).get(expr.id, [])
        dict_defs = [d for d in defs if isinstance(d, ast.Dict)]
        if dict_defs:
            branch = None
            for d in dict_defs:
                m = KeyModel()
                _literal_keys(index, fn, d, m, conditional)
                if branch is None:
                    branch = m
                else:
                    branch.merge_branch(m)
            model = branch or model
        else:
            model.complete = False
        _apply_var_mutations(index, fn, expr.id, model)
    elif isinstance(expr, ast.Call):
        dotted = dotted_name(expr.func)
        callee = index.find(dotted.rsplit('.', 1)[-1]) if dotted else \
            None
        if callee is not None:
            return dict_key_model(index, callee, ('return',))
        model.complete = False
    else:
        model.complete = False
    return model


def dict_key_model(index: ModuleIndex, fn: FunctionInfo,
                   mode: Tuple[str, ...]) -> KeyModel:
    """The produced-key lattice of a function's payload.

    mode:
      ('return',)       union of all ``return {...}`` branches
      ('var', NAME)     dict bound to NAME + its ``NAME[k]=`` mutations
      ('call', FUNC)    first argument of every ``FUNC(...)`` call
    """
    kind = mode[0]
    if kind == 'return':
        branch: Optional[KeyModel] = None
        for node in _walk_no_nested(fn.node):
            if isinstance(node, ast.Return) and node.value is not None:
                m = _resolve_payload_expr(index, fn, node.value, False)
                if branch is None:
                    branch = m
                else:
                    branch.merge_branch(m)
        return branch if branch is not None else KeyModel(complete=False)
    if kind == 'var':
        name_expr = ast.Name(id=mode[1])
        return _resolve_payload_expr(index, fn, name_expr, False)
    if kind == 'call':
        branch = None
        for node in _walk_no_nested(fn.node):
            if isinstance(node, ast.Call) and node.args:
                callee = node.func
                simple = (callee.id if isinstance(callee, ast.Name)
                          else callee.attr
                          if isinstance(callee, ast.Attribute) else None)
                if simple == mode[1]:
                    m = _resolve_payload_expr(index, fn, node.args[0],
                                              False)
                    if branch is None:
                        branch = m
                    else:
                        branch.merge_branch(m)
        return branch if branch is not None else KeyModel(complete=False)
    raise ValueError(f'unknown dict_key_model mode {mode!r}')


# ------------------------------------------------------- consumed keys

def read_keys(index: ModuleIndex, fn: FunctionInfo,
              varnames: Optional[Sequence[str]] = None,
              exclude_vars: Sequence[str] = ()) -> Dict[str, int]:
    """String keys the function READS: ``X['k']`` loads and
    ``X.get('k'...)`` calls, restricted to receivers named in
    ``varnames`` (None = any receiver, except names in
    ``exclude_vars`` — receivers holding some *other* surface's
    document).  Returns key -> first line."""
    out: Dict[str, int] = {}

    def receiver_ok(node: ast.expr) -> bool:
        if varnames is None:
            if isinstance(node, ast.Name) and node.id in exclude_vars:
                return False
            return True
        if isinstance(node, ast.Name):
            return node.id in varnames
        return False

    for node in _walk_no_nested(fn.node):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                receiver_ok(node.value):
            out.setdefault(node.slice.value, node.lineno)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ('get', 'pop') and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                receiver_ok(node.func.value):
            out.setdefault(node.args[0].value, node.lineno)
        elif isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Constant) and \
                isinstance(node.left.value, str) and \
                len(node.ops) == 1 and \
                isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                receiver_ok(node.comparators[0]):
            out.setdefault(node.left.value, node.lineno)
    return out
