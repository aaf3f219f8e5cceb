#!/usr/bin/env python3
"""skycheck for the PyTorch port: the static passes of
skypilot_tpu_torch/analysis over the port's sources, against a
checked-in baseline (the twin of scripts/skycheck.py):

    python scripts/skycheck_torch.py --baseline skycheck_torch_baseline.txt

Runs the lock-discipline, host-sync (jit), layering, determinism,
block-lifecycle, wire-contract and sharding-contract passes over
skypilot_tpu_torch/, chip_smoke.py, bench_torch.py, scripts/*_torch.py,
examples/*_torch.py, tests/test_torch_*.py and tests/helpers_torch*.py.
The wire pass also reads the serve plane's load balancer and policies,
and the JAX replica's server and engine, as source text (never
imported): they are the consumers and the schema twin of the port's
documents.

Exit status is non-zero iff findings NOT pinned by the baseline exist
(comparison keys on (path, pass-id, message), so pure line shifts do
not churn).  Regenerate the baseline after deliberately accepting or
fixing findings:

    python scripts/skycheck_torch.py --write-baseline skycheck_torch_baseline.txt

The baseline is a RATCHET: rewriting it with MORE pinned findings than
it already holds is refused (exit 3) unless ``--allow-grow`` is given.

``--passes lock,jit,...`` restricts which passes run; ``--all`` prints
baselined findings too; ``--changed`` restricts the per-file passes to
files git reports as modified (tree passes still read the whole tree);
``--json FILE`` (``-`` for stdout) emits machine-readable results with
per-pass seconds.
"""
import argparse
import glob
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from skypilot_tpu_torch.analysis import block_lifecycle  # noqa: E402
from skypilot_tpu_torch.analysis import determinism  # noqa: E402
from skypilot_tpu_torch.analysis import jit_boundary  # noqa: E402
from skypilot_tpu_torch.analysis import layering  # noqa: E402
from skypilot_tpu_torch.analysis import lock_discipline  # noqa: E402
from skypilot_tpu_torch.analysis import shard_contract  # noqa: E402
from skypilot_tpu_torch.analysis import wire_contract  # noqa: E402
from skypilot_tpu_torch.analysis.findings import load_baseline  # noqa: E402
from skypilot_tpu_torch.analysis.findings import new_findings  # noqa: E402
from skypilot_tpu_torch.analysis.walker import iter_py_files  # noqa: E402

# Per-file passes: check_file(rel_path, text) -> [Finding].
PASSES = {
    'lock': lock_discipline.check_file,
    'jit': jit_boundary.check_file,
    'layer': layering.check_file,
    'det': determinism.check_file,
    'block': block_lifecycle.check_file,
}

# Whole-tree passes: check_tree({rel_path: text}) -> [Finding].
TREE_PASSES = {
    'wire': wire_contract.check_tree,
    'shard': shard_contract.check_tree,
}

ALL_PASSES = tuple(PASSES) + tuple(TREE_PASSES)

# The port's sources: its package, and the port's files beside the JAX
# package's (globs relative to the root).
PACKAGE_DIRS = ('skypilot_tpu_torch',)
PORT_GLOBS = ('chip_smoke.py', 'bench_torch.py', 'scripts/*_torch.py',
              'examples/*_torch.py', 'tests/test_torch_*.py',
              'tests/helpers_torch*.py')


def port_files(root):
    """Repo-relative paths of the port's sources, sorted."""
    out = set(iter_py_files(root, subdirs=PACKAGE_DIRS))
    for pattern in PORT_GLOBS:
        for path in glob.glob(os.path.join(root, pattern)):
            out.add(os.path.relpath(path, root).replace(os.sep, '/'))
    return sorted(out)


def changed_files(root):
    """Repo-relative paths git reports as modified (vs HEAD) or
    untracked; None (full sweep) without a git work tree."""
    import subprocess
    out = set()
    for args in (['git', '-C', root, 'diff', '--name-only', 'HEAD'],
                 ['git', '-C', root, 'ls-files', '--others',
                  '--exclude-standard']):
        try:
            proc = subprocess.run(args, capture_output=True, text=True,
                                  timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return out


def _read(root, rel):
    with open(os.path.join(root, rel.replace('/', os.sep)),
              encoding='utf-8') as f:
        return f.read()


def run(root, pass_names, only=None):
    """-> (findings, files_checked, {pass: seconds}).  only: optional set
    of rel paths restricting the PER-FILE passes (--changed)."""
    findings = []
    checked = 0
    timings = {name: 0.0 for name in pass_names}
    file_passes = [n for n in pass_names if n in PASSES]
    tree_passes = [n for n in pass_names if n in TREE_PASSES]
    files = {}
    for rel in port_files(root):
        try:
            text = _read(root, rel)
        except OSError as e:
            print(f'skycheck_torch: cannot read {rel}: {e}',
                  file=sys.stderr)
            continue
        files[rel] = text
        if only is not None and rel not in only:
            continue
        checked += 1
        for name in file_passes:
            t0 = time.monotonic()
            findings.extend(PASSES[name](rel, text))
            timings[name] += time.monotonic() - t0
    # The JAX package's consumers and twin producers, as text.
    for rel in wire_contract.CONSUMER_TEXT_FILES:
        try:
            files.setdefault(rel, _read(root, rel))
        except OSError:
            pass
    for name in tree_passes:
        t0 = time.monotonic()
        findings.extend(TREE_PASSES[name](files))
        timings[name] += time.monotonic() - t0
    return findings, checked, timings


def _write_baseline(path, findings, allow_grow):
    """Ratcheted rewrite: refuse growth unless explicitly allowed."""
    if os.path.exists(path) and not allow_grow:
        try:
            old = load_baseline(path)
        except ValueError as e:
            print(f'skycheck_torch: existing baseline unreadable: {e}',
                  file=sys.stderr)
            return 2
        grown, _ = new_findings(findings, old)
        if grown:
            print(f'skycheck_torch: refusing to GROW the baseline by '
                  f'{len(grown)} finding(s) (ratchet); fix them or '
                  're-run with --allow-grow to accept deliberately:',
                  file=sys.stderr)
            for fd in grown[:20]:
                print(f'  {fd.render()}', file=sys.stderr)
            if len(grown) > 20:
                print(f'  ... and {len(grown) - 20} more',
                      file=sys.stderr)
            return 3
    with open(path, 'w', encoding='utf-8') as f:
        f.write('# skycheck_torch pinned findings -- regenerate with:\n'
                '#   python scripts/skycheck_torch.py --write-baseline '
                f'{os.path.basename(path)}\n')
        for fd in findings:
            f.write(fd.render() + '\n')
    print(f'skycheck_torch: wrote {len(findings)} finding(s) to {path}')
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=_REPO,
                    help='repo root to analyze (default: this repo)')
    ap.add_argument('--baseline', default=None,
                    help='pinned-findings file; new findings fail')
    ap.add_argument('--write-baseline', default=None, metavar='FILE',
                    help='write current findings as the new baseline '
                         '(refuses growth without --allow-grow)')
    ap.add_argument('--allow-grow', action='store_true',
                    help='let --write-baseline pin MORE findings than '
                         'the existing file (deliberate ratchet bump)')
    ap.add_argument('--passes', default=','.join(ALL_PASSES),
                    help=f'comma list of passes ({",".join(ALL_PASSES)})')
    ap.add_argument('--all', action='store_true',
                    help='print baselined findings too, not just new')
    ap.add_argument('--changed', action='store_true',
                    help='per-file passes only on git-modified files '
                         '(tree passes still read the whole tree)')
    ap.add_argument('--json', default=None, metavar='FILE',
                    help='write machine-readable results (per-pass '
                         "seconds, counts, new findings); '-' = stdout")
    args = ap.parse_args(argv)

    pass_names = [p.strip() for p in args.passes.split(',') if p.strip()]
    unknown = [p for p in pass_names if p not in PASSES
               and p not in TREE_PASSES]
    if unknown:
        ap.error(f'unknown pass(es): {", ".join(unknown)} '
                 f'(available: {", ".join(ALL_PASSES)})')
    only = None
    if args.changed:
        only = changed_files(args.root)
        if only is None:
            print('skycheck_torch: --changed needs a git work tree; '
                  'running the full sweep', file=sys.stderr)

    t0 = time.monotonic()
    findings, checked, timings = run(args.root, pass_names, only=only)
    findings.sort()
    elapsed = time.monotonic() - t0

    if args.write_baseline:
        return _write_baseline(args.write_baseline, findings,
                               args.allow_grow)

    baseline = {}
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except ValueError as e:
            print(f'skycheck_torch: {e}', file=sys.stderr)
            return 2
    new, fixed = new_findings(findings, baseline)

    per_pass_findings = {name: 0 for name in pass_names}
    for fd in findings:
        for name in pass_names:
            if fd.pass_id.startswith(name.upper()):
                per_pass_findings[name] += 1
                break

    payload = {
        'files_checked': checked,
        'elapsed_seconds': round(elapsed, 3),
        'passes': {name: {'seconds': round(timings[name], 3),
                          'findings': per_pass_findings[name]}
                   for name in pass_names},
        'total_findings': len(findings),
        'baselined': len(findings) - len(new),
        'new': [fd.render() for fd in new],
        'fixed': fixed,
    }
    if args.json == '-':
        print(json.dumps(payload, indent=2))
    elif args.json:
        with open(args.json, 'w', encoding='utf-8') as f:
            json.dump(payload, f, indent=2)
            f.write('\n')

    if args.json != '-':
        if args.all:
            for fd in findings:
                marker = 'NEW ' if fd in new else ''
                print(f'{marker}{fd.render()}')
        else:
            for fd in new:
                print(fd.render())
        pinned = len(findings) - len(new)
        print(f'skycheck_torch: {checked} files, {len(findings)} '
              f'finding(s) ({pinned} baselined, {len(new)} new, {fixed} '
              f'fixed) in {elapsed:.2f}s [{",".join(pass_names)}]')
        if fixed:
            print('skycheck_torch: baseline has stale entries - shrink '
                  'it with --write-baseline')
    return 1 if new else 0


if __name__ == '__main__':
    sys.exit(main())
