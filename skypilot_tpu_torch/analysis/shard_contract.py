"""Sharding & mesh contracts (skycheck pass ``shard``): the port's twin
of ``skypilot_tpu/analysis/shard_contract.py``, SHARD001 and SHARD004.

The mesh vocabulary lives in ONE place (``parallel/mesh.py``:
``MESH_AXES`` + ``_BASE_RULES``), but the axis names the parallel paths
pass to ``Mesh.size``/``coord``/``group``, ``MeshSpec`` keywords,
``axis_name=`` arguments and the parameter table's logical axes are
scattered across the engine, the models, the trainer and the
collectives.  This pass parses the vocabulary straight out of
``parallel/mesh.py`` (pure ast — no torch import) and checks them
against it, plus a declarative registry of the sharded dimensions and
the divisibility proofs they need:

- **SHARD001** — an axis string names a mesh axis ``MESH_AXES`` does not
  define (``Mesh.size('tensr')`` is a KeyError at best; an unknown
  logical axis in the parameter table silently replicates the
  parameter), or a ``_BASE_RULES`` entry maps to an undefined mesh axis.
- **SHARD004** — a registry-declared sharded dim whose symbolic size
  (``num_kv_heads``-style) has no divisibility guard against the mesh
  axis it is split over: a ``sym % <axis size>`` test (the axis size
  read from ``Mesh.size('<axis>')``, ``tensor_degree(...)``,
  ``.shape['<axis>']`` or ``.get('<axis>')``) or a ``split(sym, ...)``
  call (``parallel.mesh.split`` replicates an indivisible dim, as the
  JAX engine's ``_fit_sharding`` does), in the module or in one of its
  declared guard modules (the engine's is ``infer/tp.py``'s
  ``validate_mesh``), and no ``# shard-spec: SYM % AXIS`` assertion.

No counterpart:

- SHARD002 (a registry buffer reaching a jit root with no
  ``NamedSharding`` on its def-chain) reads JAX ``PartitionSpec``s and
  ``device_put`` def-chains.  The port shards by construction: each rank
  builds its model from ``rank_config`` and its KV cache from the
  rank-local config, so no buffer can miss a placement call on its way
  to a dispatch; the runtime shard sanitizer (``SKYTPU_SHARD_SANITIZER``,
  ``analysis/sanitizers.py``) holds every cache leaf and parameter to its
  rank-local shape.
- SHARD003 (a host transfer of a ``NamedSharding`` value, a hidden
  all-gather) has no sharded value to read: a rank's tensors are plain
  local tensors, and a host read of one moves that rank's slice alone.
  Every host read on the dispatch paths is JIT001's already.

Escape hatches (plain line comments, reviewed like code):

- ``# shard-ok: <reason>`` — suppress any SHARD finding on that line.
- ``# shard-spec: SYM % AXIS`` — asserts SYM is divisible by the size
  of mesh axis AXIS (satisfies SHARD004 where the guard lives behind an
  abstraction the pass cannot see through).
"""
import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from skypilot_tpu_torch.analysis import dataflow
from skypilot_tpu_torch.analysis.findings import Finding

PASS_UNKNOWN_AXIS = 'SHARD001'
PASS_INDIVISIBLE_DIM = 'SHARD004'

# The single source of truth for the mesh vocabulary.
MESH_FILE = 'skypilot_tpu_torch/parallel/mesh.py'

# Fallback vocabulary for unit fixtures that do not ship a mesh.py.
DEFAULT_MESH_AXES = ('stage', 'data', 'fsdp', 'seq', 'tensor')

_OK_RE = re.compile(r'#\s*shard-ok\b')
_SPEC_RE = re.compile(r'#\s*shard-spec:\s*(\w+)\s*%\s*(\w+)')

# Methods of the port's Mesh whose string arguments are mesh axes (on a
# receiver named *mesh*: ``mesh.size``, ``self.mesh.group``).
_MESH_AXIS_METHODS = frozenset({'size', 'coord', 'group'})


@dataclasses.dataclass(frozen=True)
class DimSpec:
    """One registry-declared sharded dimension: ``symbol``'s size is
    split over mesh axis ``axis``."""
    name: str
    symbol: str
    axis: str


@dataclasses.dataclass(frozen=True)
class ModuleContract:
    """Declared sharding contract of one mesh-using module: its sharded
    dims, the token whose presence marks the module as sharding (a mesh
    attribute or the tensor-degree read), and the modules holding its
    guards besides itself."""
    marker: str
    dims: Tuple[DimSpec, ...]
    guard_files: Tuple[str, ...] = ()


# The sharded dims of tensor-parallel serving and the model: the KV
# cache's kv heads (dim 1 dense and paged), the attention's heads and the
# MLP's hidden units.
REGISTRY: Dict[str, ModuleContract] = {
    'skypilot_tpu_torch/infer/engine.py': ModuleContract(
        marker='self._mesh',
        dims=(DimSpec('cache', 'num_kv_heads', 'tensor'),),
        guard_files=('skypilot_tpu_torch/infer/tp.py',)),
    'skypilot_tpu_torch/models/llama.py': ModuleContract(
        marker='tensor_degree(',
        dims=(DimSpec('attention heads', 'num_kv_heads', 'tensor'),
              DimSpec('mlp', 'intermediate_size', 'tensor'))),
}


# --------------------------------------------------------- vocabulary

def mesh_vocabulary(mesh_text: Optional[str]):
    """(MESH_AXES, rule entries) out of parallel/mesh.py; rule entries
    are (logical, target, line) with target a mesh axis string, a tuple
    of them, or None."""
    if mesh_text is None:
        return DEFAULT_MESH_AXES, []
    tree = ast.parse(mesh_text)
    axes: Tuple[str, ...] = ()
    rules: List[Tuple[str, object, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        value = node.value
        if value is None:
            continue
        if 'MESH_AXES' in names and isinstance(value, ast.Tuple):
            axes = tuple(e.value for e in value.elts
                         if isinstance(e, ast.Constant) and
                         isinstance(e.value, str))
        if '_BASE_RULES' in names and isinstance(value, ast.List):
            for elt in value.elts:
                if not (isinstance(elt, ast.Tuple) and
                        len(elt.elts) == 2 and
                        isinstance(elt.elts[0], ast.Constant)):
                    continue
                tgt = elt.elts[1]
                if isinstance(tgt, ast.Constant):
                    target = tgt.value
                elif isinstance(tgt, ast.Tuple):
                    target = tuple(e.value for e in tgt.elts
                                   if isinstance(e, ast.Constant))
                else:
                    continue
                rules.append((elt.elts[0].value, target, elt.lineno))
    return axes or DEFAULT_MESH_AXES, rules


def _str_args(node: ast.Call) -> List[Tuple[str, int]]:
    return [(a.value, a.lineno) for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)]


def _param_axes_entries(tree: ast.AST) -> List[Tuple[str, int]]:
    """Logical axis strings of the parameter table (``_PARAM_AXES``): the
    second element of each ``((suffix...), (axes...))`` pair."""
    out: List[Tuple[str, int]] = []
    table = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == '_PARAM_AXES'
                   for t in targets) and isinstance(node.value, ast.List):
                table += node.value.elts
    for node in table:
        if not (isinstance(node, ast.Tuple) and len(node.elts) == 2):
            continue
        suffix, axes = node.elts
        if not (isinstance(suffix, ast.Tuple) and suffix.elts and
                all(isinstance(e, ast.Constant) and
                    isinstance(e.value, str) for e in suffix.elts)):
            continue
        if not (isinstance(axes, ast.Tuple) and all(
                isinstance(e, ast.Constant) and
                (e.value is None or isinstance(e.value, str))
                for e in axes.elts)):
            continue
        out += [(e.value, e.lineno) for e in axes.elts
                if isinstance(e.value, str)]
    return out


# ------------------------------------------------------------ checks

def _check_axes(rel: str, tree: ast.AST, lines: Sequence[str],
                mesh_axes: Sequence[str], logical: Set[str]
                ) -> List[Finding]:
    findings: List[Finding] = []

    def ok(lineno: int) -> bool:
        return 0 < lineno <= len(lines) and \
            bool(_OK_RE.search(lines[lineno - 1]))

    def mesh_check(ax: str, lineno: int, ctx: str) -> None:
        if ax not in mesh_axes and not ok(lineno):
            findings.append(Finding(
                rel, lineno, PASS_UNKNOWN_AXIS,
                f"{ctx} names mesh axis '{ax}' which no constructed "
                f'Mesh defines (MESH_AXES={tuple(mesh_axes)})'))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            pos = args.posonlyargs + args.args
            for arg, dflt in zip(pos[len(pos) - len(args.defaults):],
                                 args.defaults):
                if arg.arg == 'axis_name' and \
                        isinstance(dflt, ast.Constant) and \
                        isinstance(dflt.value, str):
                    mesh_check(dflt.value, dflt.lineno,
                               f"default of '{node.name}(axis_name=)'")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        last = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        if isinstance(f, ast.Attribute) and last in _MESH_AXIS_METHODS \
                and 'mesh' in (dataflow.dotted_name(f.value) or '').rsplit(
                    '.', 1)[-1].lower():
            for ax, ln in _str_args(node):
                mesh_check(ax, ln, f'{last}()')
        if last == 'MeshSpec':
            for kw in node.keywords:
                if kw.arg is not None:
                    mesh_check(kw.arg, kw.value.lineno, 'MeshSpec(...)')
        for kw in node.keywords:
            if kw.arg == 'axis_name' and \
                    isinstance(kw.value, ast.Constant) and \
                    isinstance(kw.value.value, str):
                mesh_check(kw.value.value, kw.value.lineno,
                           f'{last or "call"}(axis_name=)')
    if rel == MESH_FILE:
        for ax, ln in _param_axes_entries(tree):
            if ax not in logical and not ok(ln):
                findings.append(Finding(
                    rel, ln, PASS_UNKNOWN_AXIS,
                    f"parameter table names logical axis '{ax}' with no "
                    'rule in _BASE_RULES; the parameter silently '
                    'replicates'))
    return findings


def _axis_size_vars(tree: ast.AST,
                    mesh_axes: Sequence[str]) -> Dict[str, str]:
    """Local/attr names holding a mesh-axis size: assigned from
    ``mesh.size('<axis>')``, ``tensor_degree(...)``, ``....get('<axis>')``
    or ``...shape['<axis>']``."""
    out: Dict[str, str] = {}

    def axis_of(expr: ast.AST) -> Optional[str]:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                f = node.func
                last = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else None
                if last == 'tensor_degree':
                    return 'tensor'
                if last in ('size', 'get') and len(node.args) == 1 and \
                        isinstance(node.args[0], ast.Constant) and \
                        node.args[0].value in mesh_axes:
                    return node.args[0].value
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.slice, ast.Constant) and \
                    node.slice.value in mesh_axes:
                name = dataflow.dotted_name(node.value)
                if name and name.endswith('shape'):
                    return node.slice.value
        return None

    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        axis = axis_of(node.value)
        if axis is None:
            continue
        for tgt in node.targets:
            name = dataflow.dotted_name(tgt)
            if name:
                out[name] = axis
    return out


def _divisibility_guards(tree: ast.AST, axis_vars: Dict[str, str]
                         ) -> Set[Tuple[str, str]]:
    """(symbol, axis) pairs guarded by ``sym % axis_size`` or split by
    ``split(sym, axis_size)`` anywhere in the module."""
    guards: Set[Tuple[str, str]] = set()

    def axes_in(expr: ast.AST) -> Set[str]:
        found = set()
        for sub in ast.walk(expr):
            name = dataflow.dotted_name(sub)
            if name in axis_vars:
                found.add(axis_vars[name])
            if isinstance(sub, ast.Call) and \
                    dataflow.dotted_name(sub.func) == 'tensor_degree':
                found.add('tensor')
        return found

    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            left = dataflow.dotted_name(node.left)
            if left is not None:
                for axis in axes_in(node.right):
                    guards.add((left.rsplit('.', 1)[-1], axis))
        elif isinstance(node, ast.Call) and len(node.args) == 2 and \
                dataflow.dotted_name(node.func) in ('split', 'mesh.split'):
            sym = dataflow.dotted_name(node.args[0])
            if sym is not None:
                for axis in axes_in(node.args[1]):
                    guards.add((sym.rsplit('.', 1)[-1], axis))
    return guards


def _check_contract(rel: str, files: Dict[str, str],
                    contract: ModuleContract, mesh_axes: Sequence[str]
                    ) -> List[Finding]:
    text = files[rel]
    if contract.marker not in text:
        return []
    guards: Set[Tuple[str, str]] = set()
    annotated: Set[Tuple[str, str]] = set()
    for path in (rel,) + contract.guard_files:
        src = files.get(path)
        if src is None:
            continue
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        guards |= _divisibility_guards(tree,
                                       _axis_size_vars(tree, mesh_axes))
        annotated |= {(m.group(1), m.group(2))
                      for m in _SPEC_RE.finditer(src)}
    lines = text.splitlines()
    line = next((i for i, ln in enumerate(lines, 1)
                 if contract.marker in ln), 1)
    findings: List[Finding] = []
    for dim in contract.dims:
        key = (dim.symbol, dim.axis)
        if key in guards or key in annotated or \
                _OK_RE.search(lines[line - 1]):
            continue
        findings.append(Finding(
            rel, line, PASS_INDIVISIBLE_DIM,
            f"'{dim.name}' splits symbolic dim '{dim.symbol}' over mesh "
            f"axis '{dim.axis}' with no divisibility guard "
            f"('{dim.symbol} % <{dim.axis} size>' check or split()) and "
            f"no '# shard-spec: {dim.symbol} % {dim.axis}' assertion: an "
            'indivisible dim mis-shards at placement'))
    return findings


# ------------------------------------------------------------- driver

def check_tree(files: Dict[str, str],
               registry: Optional[Dict[str, ModuleContract]] = None
               ) -> List[Finding]:
    """The skycheck ``shard`` tree pass: vocabulary from mesh.py, then
    every module of the port checked against it and the registry."""
    if registry is None:
        registry = REGISTRY
    mesh_axes, rules = mesh_vocabulary(files.get(MESH_FILE))
    logical = {name for name, _, _ in rules}
    findings: List[Finding] = []
    for name, target, line in rules:
        targets = target if isinstance(target, tuple) else (target,)
        for ax in targets:
            if ax is not None and ax not in mesh_axes:
                findings.append(Finding(
                    MESH_FILE, line, PASS_UNKNOWN_AXIS,
                    f"logical rule '{name}' maps to mesh axis '{ax}' "
                    f'which MESH_AXES does not define '
                    f'({tuple(mesh_axes)})'))
    for rel in sorted(files):
        if not rel.startswith('skypilot_tpu_torch/'):
            continue
        try:
            tree = ast.parse(files[rel])
        except SyntaxError:
            continue
        findings.extend(_check_axes(rel, tree, files[rel].splitlines(),
                                    mesh_axes, logical))
        if rel in registry:
            findings.extend(_check_contract(rel, files, registry[rel],
                                            mesh_axes))
    return findings
