"""Source-file discovery for the port's skycheck (the twin of
``skypilot_tpu/analysis/walker.py``): ``scripts/skycheck_torch.py`` finds
the Python sources to analyze with it, skipping generated and vendored
directories (``__pycache__``, ``build`` and the like).
"""
import os
from typing import Iterable, Iterator, Optional

# Directory basenames that never contain hand-written sources.
EXCLUDED_DIR_NAMES = frozenset({
    '__pycache__', '.git', '.hg', '.pytest_cache', '.mypy_cache',
    '.ruff_cache', '.ipynb_checkpoints', 'build', 'dist', 'node_modules',
    '.eggs', '.venv', 'venv', '.tox',
})


def _excluded_dir(name: str) -> bool:
    return (name in EXCLUDED_DIR_NAMES or name.endswith('.egg-info')
            or name.startswith('.'))


def iter_py_files(root: str,
                  subdirs: Optional[Iterable[str]] = None
                  ) -> Iterator[str]:
    """Yield repo-relative paths ('/'-separated) of every ``.py`` file
    under ``root`` (or under ``root/<subdir>`` for each of ``subdirs``),
    skipping generated/vendored directories.  Deterministic order.
    """
    tops = ([os.path.join(root, s) for s in subdirs]
            if subdirs is not None else [root])
    for top in tops:
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames
                                 if not _excluded_dir(d))
            for fn in sorted(filenames):
                if not fn.endswith('.py'):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                yield rel.replace(os.sep, '/')
