"""Builds the port's CUDA sources (``ops/csrc/*.cu``) with ``nvcc`` into
shared libraries with a plain C interface, loaded through ``ctypes``.

Each library is built at first use from the sources in the checkout
alone, for ``sm_90a`` (Hopper), into ``build/kernels/`` at the root of
the checkout, under a name keyed by a hash of every file in ``csrc/``
and the compiler flags, so an edited source rebuilds and an unchanged
one is reused.  ``nvcc``'s output (including ``-Xptxas -v``'s register
and spill report) is kept beside each library as ``<name>.log``.
"""
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (looked on PATH and in '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be '
                       'built')


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built to, keyed by the sources' hash."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0.0 for a library already built).  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [compiler, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'{name} (nvcc exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def swap(name: str, lib: ctypes.CDLL) -> None:
    """Make ``load(name)`` return `lib`, a build of a modified copy of the
    source (a planted fault), so that the usual wrapper runs it."""
    _loaded[name] = lib
