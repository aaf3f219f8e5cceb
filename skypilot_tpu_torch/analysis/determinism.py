"""DET pass: no bare clocks or ambient randomness in replayable code
(the port's twin of ``skypilot_tpu/analysis/determinism.py``).

The chaos harness replays: ``FaultPlan`` schedules, chaos seeds and
episode traces only reproduce if the fault machinery draws time and
randomness through injected seams.  This pass bans, inside the port's
``infer/faults.py`` and ``infer/chaos.py``, the chaos twin
``scripts/chaos_smoke_torch.py`` and ``skypilot_tpu_torch/serve/`` (the
JAX pass's seams; the port has no serve plane of its own yet: its
replicas sit behind the JAX package's):

- DET001: bare ``time.time()`` / ``time.monotonic()`` calls.  Route
  through an injected ``now``/``clock`` callable or a ``_now()`` test
  hook.
- DET002: ambient ``random.*`` module calls and the numpy equivalents
  (``np.random.<fn>`` and argument-less ``np.random.default_rng()``).
  Seeded generator construction — ``random.Random(seed)``,
  ``np.random.default_rng(seed)`` — is allowed: that IS the seam.

``# det-ok: <reason>`` on the call line allowlists a deliberate bare
clock (e.g. a wall-clock test hook that tests monkeypatch, or a
harness-side wait loop that never feeds replayed state).
"""
import ast
import re
from typing import List, Optional, Sequence

from skypilot_tpu_torch.analysis.findings import Finding

_OK_RE = re.compile(r'#\s*det-ok\b')

PASS_CLOCK = 'DET001'
PASS_RANDOM = 'DET002'

# Repo-relative prefixes/paths where determinism is load-bearing.
SCOPE: Sequence[str] = (
    'skypilot_tpu_torch/serve/',
    'skypilot_tpu_torch/infer/faults.py',
    'skypilot_tpu_torch/infer/chaos.py',
    'scripts/chaos_smoke_torch.py',
)

_CLOCK_FNS = {'time', 'monotonic', 'monotonic_ns', 'time_ns',
              'perf_counter', 'perf_counter_ns'}
# random-module functions that draw from the ambient global generator.
_AMBIENT_RANDOM = {
    'random', 'randint', 'randrange', 'choice', 'choices', 'shuffle',
    'sample', 'uniform', 'gauss', 'normalvariate', 'expovariate',
    'betavariate', 'gammavariate', 'triangular', 'seed', 'getrandbits',
}


def in_scope(path: str, scope: Optional[Sequence[str]] = None) -> bool:
    scope = SCOPE if scope is None else scope
    return any(path == s or (s.endswith('/') and path.startswith(s))
               for s in scope)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


class _Visitor(ast.NodeVisitor):

    def __init__(self, path: str, lines: List[str],
                 findings: List[Finding]):
        self.path = path
        self.lines = lines
        self.findings = findings

    def _allowlisted(self, lineno: int) -> bool:
        return (lineno <= len(self.lines)
                and _OK_RE.search(self.lines[lineno - 1]) is not None)

    def _add(self, lineno: int, pass_id: str, msg: str) -> None:
        if not self._allowlisted(lineno):
            self.findings.append(Finding(self.path, lineno, pass_id,
                                         msg))

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted is not None:
            parts = dotted.split('.')
            if len(parts) == 2 and parts[0] == 'time' and \
                    parts[1] in _CLOCK_FNS:
                self._add(node.lineno, PASS_CLOCK,
                          f'bare clock {dotted}() - inject a '
                          "now/clock callable (or mark the seam "
                          "'# det-ok: <reason>')")
            elif len(parts) == 2 and parts[0] == 'random' and \
                    parts[1] in _AMBIENT_RANDOM:
                self._add(node.lineno, PASS_RANDOM,
                          f'ambient randomness {dotted}() - use a '
                          'seeded random.Random instance')
            elif len(parts) == 3 and parts[0] in ('np', 'numpy') and \
                    parts[1] == 'random':
                if parts[2] == 'default_rng':
                    if not node.args and not node.keywords:
                        self._add(node.lineno, PASS_RANDOM,
                                  f'{dotted}() without a seed - pass '
                                  'an explicit seed')
                else:
                    self._add(node.lineno, PASS_RANDOM,
                              f'ambient randomness {dotted}() - use a '
                              'seeded np.random.default_rng(seed)')
        self.generic_visit(node)


def check_file(path: str, text: str,
               scope: Optional[Sequence[str]] = None) -> List[Finding]:
    if not in_scope(path, scope):
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    findings: List[Finding] = []
    _Visitor(path, text.splitlines(), findings).visit(tree)
    return findings
