"""JIT pass: host-sync hygiene on the dispatch paths (the port's twin of
``skypilot_tpu/analysis/jit_boundary.py``; the name is kept because it
names the counterpart: in the port "jit" means "sync").

Serving on the card is host-bound, and every host-device
synchronization on the dispatch path stalls the host until the card
has drained the stream: the next window cannot be queued behind the
one in flight, and a CUDA graph captured over a decode window fails on
any sync inside it.  This pass builds a per-class call graph
(``self.<meth>()`` edges; for module-level roots, bare calls of the
module's functions) from configured hot roots — the engine's decode /
prefill dispatch methods, the tensor-parallel dispatch protocol and the
flash-attention kernel wrapper — and inside every reachable function
flags JIT001, a host sync:

- ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` on any value;
- ``bool``/``int``/``float`` of a tensor expression, and a tensor
  expression as an ``if``/``while``/``assert`` test (implicit bool);
- ``torch.cuda.synchronize()`` and ``.synchronize()`` of an ``Event``
  or ``Stream``;
- ``.to('cpu')`` / ``.to(device='cpu')`` without ``non_blocking=True``;
- ``np.asarray``/``np.array`` of a tensor expression.

A tensor expression is known by name, not by type: a parameter or
function annotated ``torch.Tensor`` (a tuple of them included), a
``torch.<fn>(...)`` call, a method of a tensor expression that returns
one, a subscript or arithmetic of one, and locals assigned from any of
these.  A line is one site: it gives at most one finding.

A deliberate readback is allowlisted inline with ``# jit-ok: <reason>``
— the reason doubles as documentation of WHY it is cold (or why it is
the one readback a window must make).  ``sync_sites`` returns the
reported and the allowlisted sites together: the smoke run's
``host_sync`` phase holds every sync CUDA's sync debug mode sees on the
card to them.

JIT002 (array constructors with a Python-varying shape) has no
counterpart: eager PyTorch does not compile per shape, so a varying
shape costs no recompile.
"""
import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from skypilot_tpu_torch.analysis.findings import Finding

_OK_RE = re.compile(r'#\s*jit-ok\b')

PASS_HOST_SYNC = 'JIT001'

# The class name of a module's top-level functions in HOT_ROOTS.
MODULE = '<module>'

# Hot roots per repo-relative path: class (or MODULE) -> dispatch-path
# functions.  Reachability closes over self.<method>() calls within the
# class, and over bare calls of the module's own functions for MODULE.
HOT_ROOTS: Dict[str, Dict[str, List[str]]] = {
    'skypilot_tpu_torch/infer/engine.py': {
        'InferenceEngine': [
            '_step', '_decode_step', '_spec_step', '_chunk_round',
            '_dispatch_decode', '_maybe_dispatch_ahead',
            '_consume_window', '_start_batch',
        ],
    },
    'skypilot_tpu_torch/infer/tp.py': {
        'TensorParallel': ['call', '_settle', '_encode'],
    },
    'skypilot_tpu_torch/ops/flash_attention.py': {
        MODULE: ['flash_attention_fwd'],
    },
}

_NP_MODULES = {'np', 'numpy'}
# Methods that read a value back to the host.
_SYNC_METHODS = {'item', 'tolist', 'cpu', 'numpy'}
# torch.<fn>(...) calls that do not return a tensor.
_TORCH_NON_TENSOR = {
    'device', 'Generator', 'Size', 'dtype', 'finfo', 'iinfo',
    'is_tensor', 'is_floating_point', 'is_complex', 'numel',
    'get_default_dtype', 'manual_seed', 'inference_mode', 'no_grad',
    'enable_grad', 'set_grad_enabled', 'get_num_threads',
    'set_num_threads', 'compile', 'load', 'save',
}
# Methods of a tensor that do not return a tensor.
_NON_TENSOR_METHODS = {
    'item', 'tolist', 'numpy', 'dim', 'size', 'numel', 'nelement',
    'data_ptr', 'is_contiguous', 'element_size', 'stride',
    'get_device', 'storage_offset', 'is_pinned', 'untyped_storage',
    'record_stream', 'register_hook', 'backward',
}
# Attributes of a tensor that are tensors.
_TENSOR_ATTRS = {'T', 'mT', 'H', 'mH', 'data', 'grad', 'real', 'imag'}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def _mentions_tensor(annotation: Optional[ast.AST]) -> bool:
    return annotation is not None and 'Tensor' in ast.unparse(annotation)


def _walk_no_nested(fn_node: ast.AST):
    """The function's own nodes: nested defs, classes and lambdas are
    left out."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _Tensors:
    """Which expressions of one function are tensors (see the module
    docstring): ``returns`` names the functions (self methods or module
    functions, by simple name) annotated to return a tensor."""

    def __init__(self, fn: ast.AST, returns: Set[str]):
        self.returns = returns
        args = fn.args
        self.names: Set[str] = {
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)
            if _mentions_tensor(a.annotation)}
        assigns = [n for n in _walk_no_nested(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for _ in range(3):          # a fixpoint over chained locals
            before = len(self.names)
            for node in assigns:
                if isinstance(node, ast.AnnAssign):
                    if isinstance(node.target, ast.Name) and (
                            _mentions_tensor(node.annotation) or
                            (node.value is not None and
                             self.is_tensor(node.value))):
                        self.names.add(node.target.id)
                    continue
                if not self.is_tensor(node.value):
                    continue
                for tgt in node.targets:
                    for el in (tgt.elts if isinstance(tgt, (ast.Tuple,
                                                            ast.List))
                               else [tgt]):
                        if isinstance(el, ast.Name):
                            self.names.add(el.id)
            if len(self.names) == before:
                break

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            f = node.func
            dotted = _dotted(f)
            if dotted is not None:
                parts = dotted.split('.')
                if len(parts) == 2 and parts[0] == 'torch':
                    return (parts[1] not in _TORCH_NON_TENSOR and
                            parts[1][:1].islower())
                if dotted.startswith(('torch.nn.functional.', 'F.')):
                    return True
                if len(parts) == 2 and parts[0] == 'self' and \
                        parts[1] in self.returns:
                    return True
                if len(parts) == 1 and parts[0] in self.returns:
                    return True
            if isinstance(f, ast.Attribute) and self.is_tensor(f.value):
                return f.attr not in _NON_TENSOR_METHODS
            return False
        if isinstance(node, ast.Attribute):
            return node.attr in _TENSOR_ATTRS and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            # Identity and membership tests give a Python bool.
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(
                self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False


def _is_cpu(node: ast.AST) -> bool:
    """'cpu' or torch.device('cpu')."""
    if isinstance(node, ast.Constant):
        return node.value == 'cpu'
    return (isinstance(node, ast.Call) and
            _dotted(node.func) in ('torch.device', 'device') and
            bool(node.args) and isinstance(node.args[0], ast.Constant) and
            node.args[0].value == 'cpu')


def _sync_of(node: ast.AST, tensors: _Tensors) -> Optional[str]:
    """What makes `node` a host sync, else None."""
    if isinstance(node, (ast.If, ast.While, ast.Assert)):
        test = node.test
        if tensors.is_tensor(test):
            return 'implicit bool of a tensor expression'
        return None
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    dotted = _dotted(f)
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_METHODS and not (
                isinstance(f.value, ast.Name) and
                f.value.id in _NP_MODULES | {'torch'}):
            return f'.{f.attr}()'
        if f.attr == 'synchronize':
            return f'{dotted}()' if dotted else '.synchronize()'
        if f.attr == 'to':
            blocking = not any(
                kw.arg == 'non_blocking' and
                isinstance(kw.value, ast.Constant) and kw.value.value
                for kw in node.keywords)
            to_cpu = ((node.args and _is_cpu(node.args[0])) or any(
                kw.arg == 'device' and _is_cpu(kw.value)
                for kw in node.keywords))
            if to_cpu and blocking:
                return ".to('cpu') without non_blocking=True"
    if dotted is not None and '.' in dotted:
        mod, attr = dotted.split('.', 1)
        if mod in _NP_MODULES and attr in ('asarray', 'array') and \
                node.args and tensors.is_tensor(node.args[0]):
            return f'{dotted}(<tensor>)'
    if isinstance(f, ast.Name) and f.id in ('bool', 'int', 'float') and \
            node.args and tensors.is_tensor(node.args[0]):
        return f'{f.id}(<tensor>)'
    return None


def _functions(tree: ast.Module, cls_name: str) -> Dict[str, ast.AST]:
    """name -> def of the class's methods (MODULE: the module's
    top-level functions)."""
    body = tree.body if cls_name == MODULE else next(
        (n.body for n in ast.walk(tree)
         if isinstance(n, ast.ClassDef) and n.name == cls_name), [])
    return {n.name: n for n in body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _callee(call: ast.Call, module_level: bool) -> Optional[str]:
    f = call.func
    if module_level:
        return f.id if isinstance(f, ast.Name) else None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == 'self':
        return f.attr
    return None


def _reachable(funcs: Dict[str, ast.AST], roots: Iterable[str],
               module_level: bool) -> Set[str]:
    edges: Dict[str, Set[str]] = {}
    for name, fn in funcs.items():
        edges[name] = {c for c in (_callee(n, module_level)
                                   for n in ast.walk(fn)
                                   if isinstance(n, ast.Call))
                       if c in funcs}
    seen: Set[str] = set()
    stack = [r for r in roots if r in funcs]
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(edges.get(cur, ()) - seen)
    return seen


def _tensor_returns(funcs: Dict[str, ast.AST]) -> Set[str]:
    return {name for name, fn in funcs.items()
            if _mentions_tensor(fn.returns)}


def _scan(path: str, text: str, roots: Optional[Dict[str, List[str]]]
          ) -> Tuple[List[Finding], Dict[int, str]]:
    """(findings, {line: 'jit-ok'} of the allowlisted sites)."""
    if roots is None:
        roots = HOT_ROOTS.get(path)
    if not roots:
        return [], {}
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return [], {}
    lines = text.splitlines()
    findings: List[Finding] = []
    allowed: Dict[int, str] = {}
    seen_lines: Set[int] = set()
    for cls_name, names in roots.items():
        funcs = _functions(tree, cls_name)
        module_level = cls_name == MODULE
        returns = _tensor_returns(funcs)
        if not module_level:
            returns |= _tensor_returns(_functions(tree, MODULE))
        for name in sorted(_reachable(funcs, names, module_level)):
            fn = funcs[name]
            tensors = _Tensors(fn, returns)
            where = f"dispatch-reachable '{name}'"
            nodes = sorted((n for n in _walk_no_nested(fn)
                            if isinstance(n, (ast.Call, ast.If, ast.While,
                                              ast.Assert))),
                           key=lambda n: (n.lineno, n.col_offset))
            for node in nodes:
                what = _sync_of(node, tensors)
                line = getattr(node, 'test', node).lineno
                if what is None or line in seen_lines:
                    continue
                seen_lines.add(line)
                if line <= len(lines) and _OK_RE.search(lines[line - 1]):
                    allowed[line] = 'jit-ok'
                    continue
                findings.append(Finding(
                    path, line, PASS_HOST_SYNC,
                    f'host sync {what} inside {where} (blocks the host '
                    'until the card drains the stream; mark deliberate '
                    "readbacks '# jit-ok: <reason>')"))
    findings.sort()
    return findings, allowed


def check_file(path: str, text: str,
               roots: Optional[Dict[str, List[str]]] = None
               ) -> List[Finding]:
    """``roots``: class (or MODULE) -> root functions; defaults to
    HOT_ROOTS[path]."""
    return _scan(path, text, roots)[0]


def sync_sites(path: str, text: str,
               roots: Optional[Dict[str, List[str]]] = None
               ) -> Dict[int, str]:
    """Every host-sync site on the file's dispatch paths: line -> 'JIT001'
    (reported) or 'jit-ok' (allowlisted)."""
    findings, allowed = _scan(path, text, roots)
    return {**allowed, **{f.line: f.pass_id for f in findings}}
