"""LAYER pass: enforce the port's package dependency DAG (the twin of
``skypilot_tpu/analysis/layering.py``, with one rule the port adds).

- ``skypilot_tpu_torch/infer`` never imports a serve plane — the
  engine/replica plane must run without the control plane on the
  machine.  The port's replicas sit behind the JAX package's unchanged
  serve plane (``skypilot_tpu.serve``), which the rule below already
  forbids; ``skypilot_tpu_torch.serve`` is the name a serve plane of the
  port's own would take.  Declared exemption, as in the JAX rule:
  ``infer/chaos.py``, the chaos harness whose JOB is to wire killable
  replicas to the real LB (it takes the LB from a factory the caller
  passes; the serve plane is imported by ``scripts/chaos_smoke_torch.py``).
- ``skypilot_tpu_torch/serve`` never imports
  ``skypilot_tpu_torch.infer.engine`` internals.
- ``skypilot_tpu_torch/ops`` imports neither — kernels are leaf modules.
- The port's own rule: no module of ``skypilot_tpu_torch``, and neither
  ``chip_smoke.py``, ``bench_torch.py``, an ``examples/*_torch.py`` twin
  nor ``scripts/skycheck_torch.py``, imports ``skypilot_tpu`` (the JAX
  package), ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``orbax``.  The
  bench and chaos twins under ``scripts/*_torch.py`` compose the port
  with the JAX package's (JAX-free) serve plane, so for them only the
  JAX libraries are forbidden.  The static twin of
  ``tests/test_torch_imports.py``, which also runs the imports.

Both absolute and relative imports are resolved; module- and
function-level imports are treated alike (a lazy import is still a
dependency).
"""
import ast
from typing import Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.analysis.findings import Finding

PASS_ID = 'LAYER001'

# (source path prefix, forbidden module prefixes, {exempt path: reason})
Rule = Tuple[str, Sequence[str], Dict[str, str]]

JAX_LIBRARIES = ('jax', 'jaxlib', 'flax', 'optax', 'orbax')
JAX_PACKAGE = ('skypilot_tpu',) + JAX_LIBRARIES

RULES: List[Rule] = [
    ('skypilot_tpu_torch/infer/', ('skypilot_tpu_torch.serve',), {
        'skypilot_tpu_torch/infer/chaos.py':
            'chaos harness drives the real serve plane by design',
    }),
    ('skypilot_tpu_torch/serve/', ('skypilot_tpu_torch.infer.engine',), {}),
    ('skypilot_tpu_torch/ops/', ('skypilot_tpu_torch.infer',
                                 'skypilot_tpu_torch.serve'), {}),
    ('skypilot_tpu_torch/', JAX_PACKAGE, {}),
    ('chip_smoke.py', JAX_PACKAGE, {}),
    ('bench_torch.py', JAX_PACKAGE, {}),
    ('scripts/skycheck_torch.py', JAX_PACKAGE, {}),
    ('examples/', JAX_PACKAGE, {}),
    ('scripts/', JAX_LIBRARIES, {}),
]


def _applies(path: str, prefix: str) -> bool:
    """A rule's prefix covers `path`; the examples/ and scripts/ rules
    hold the port's twins (``*_torch.py``) only."""
    if not path.startswith(prefix):
        return False
    if prefix in ('examples/', 'scripts/'):
        return path.endswith('_torch.py')
    return True


def _module_of(path: str) -> str:
    """'skypilot_tpu_torch/infer/engine.py' -> its dotted module."""
    mod = path[:-3] if path.endswith('.py') else path
    if mod.endswith('/__init__'):
        mod = mod[:-len('/__init__')]
    return mod.replace('/', '.')


def _resolve_relative(path: str, level: int,
                      module: Optional[str]) -> str:
    """Absolute module named by ``from <dots><module> import ...``."""
    parts = _module_of(path).split('.')
    if not path.endswith('/__init__.py'):
        parts = parts[:-1]                 # containing package
    parts = parts[:len(parts) - (level - 1)] if level > 1 else parts
    if module:
        parts = parts + module.split('.')
    return '.'.join(parts)


def _imported_modules(tree: ast.AST, path: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _resolve_relative(path, node.level, node.module)
            else:
                base = node.module or ''
            yield node.lineno, base
            # `from pkg import engine` imports pkg.engine the module —
            # check one level deeper so renamed-module imports of a
            # forbidden submodule don't slip through.
            for alias in node.names:
                yield node.lineno, f'{base}.{alias.name}'


def _violates(mod: str, forbidden: Sequence[str]) -> Optional[str]:
    """The forbidden prefix `mod` falls under: the package itself or a
    submodule (``skypilot_tpu_torch`` is not under ``skypilot_tpu``)."""
    for prefix in forbidden:
        if mod == prefix or mod.startswith(prefix + '.'):
            return prefix
    return None


def check_file(path: str, text: str,
               rules: Optional[List[Rule]] = None) -> List[Finding]:
    rules = RULES if rules is None else rules
    active = [r for r in rules if _applies(path, r[0])
              and path not in r[2]]
    if not active:
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    findings: List[Finding] = []
    seen = set()
    for lineno, mod in _imported_modules(tree, path):
        for src_prefix, forbidden, _ in active:
            hit = _violates(mod, forbidden)
            if hit and (lineno, hit) not in seen:
                seen.add((lineno, hit))
                findings.append(Finding(
                    path, lineno, PASS_ID,
                    f"layering violation: '{src_prefix}' must not "
                    f"import '{hit}' (import of '{mod}')"))
    return findings
