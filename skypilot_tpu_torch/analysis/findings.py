"""Finding type + baseline handling for the port's skycheck (the twin of
``skypilot_tpu/analysis/findings.py``).

A finding renders as ``path:line: [PASS-ID] message``.  The baseline
file (``skycheck_torch_baseline.txt``) stores rendered findings
verbatim, but comparison keys on ``(path, pass_id, message)`` — NOT the
line number — so an unrelated edit that shifts a pinned finding by a
few lines does not churn the baseline or break CI.  Two identical
findings in one file (same message, different lines) are counted: the
baseline absorbs as many as it pins, and any excess is new.
"""
import collections
import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

_RENDERED = re.compile(r'^(?P<path>.+?):(?P<line>\d+): '
                       r'\[(?P<pass_id>[A-Z]+\d+)\] (?P<message>.*)$')

Key = Tuple[str, str, str]          # (path, pass_id, message)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    pass_id: str
    message: str

    def render(self) -> str:
        return f'{self.path}:{self.line}: [{self.pass_id}] {self.message}'

    @property
    def key(self) -> Key:
        return (self.path, self.pass_id, self.message)


def load_baseline(path: str) -> Dict[Key, int]:
    """Parse a baseline file into a key -> pinned-count map.  Blank
    lines and ``#`` comments are skipped; a malformed line is an error
    (a silently ignored pin would un-pin a finding)."""
    counts: Dict[Key, int] = collections.Counter()
    try:
        with open(path, encoding='utf-8') as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return {}
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        m = _RENDERED.match(line)
        if m is None:
            raise ValueError(
                f'{path}:{i}: unparseable baseline line: {line!r}')
        counts[(m.group('path'), m.group('pass_id'),
                m.group('message'))] += 1
    return dict(counts)


def new_findings(findings: Iterable[Finding],
                 baseline: Dict[Key, int]
                 ) -> Tuple[List[Finding], int]:
    """Split findings against the baseline.  Returns
    ``(new, fixed_count)``: findings beyond their pinned count (sorted),
    and how many pinned findings no longer occur (candidates for
    shrinking the baseline)."""
    seen: Dict[Key, int] = collections.Counter()
    new: List[Finding] = []
    for f in sorted(findings):
        seen[f.key] += 1
        if seen[f.key] > baseline.get(f.key, 0):
            new.append(f)
    fixed = sum(max(0, pinned - seen.get(key, 0))
                for key, pinned in baseline.items())
    return new, fixed
