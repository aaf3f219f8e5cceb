"""The port's skycheck (skypilot_tpu_torch/analysis, scripts/skycheck_torch.py)
held against the JAX package's passes: tests/test_skycheck.py's fixture
snippets of the idiom-neutral passes give the same findings through both
(pass ID, line and message, with the path prefix swapped), the host-sync
pass finds each JAX fixture's sync in its torch translation at the same
line, and the driver catches planted faults in a copy of the port."""
import ast
import contextlib
import importlib.util
import io
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from skypilot_tpu.analysis import (block_lifecycle as jax_block,
                                   determinism as jax_det,
                                   jit_boundary as jax_jit,
                                   layering as jax_layer,
                                   lock_discipline as jax_lock,
                                   wire_contract as jax_wire)
from skypilot_tpu_torch.analysis import (block_lifecycle, determinism,
                                         jit_boundary, layering,
                                         lock_discipline, shard_contract,
                                         wire_contract)
from skypilot_tpu_torch.analysis.findings import Finding

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TESTS = ROOT / 'tests' / 'test_skycheck.py'
DRIVER = ROOT / 'scripts' / 'skycheck_torch.py'
BASELINE = ROOT / 'skycheck_torch_baseline.txt'

# The port's word for the JAX pass's where the idiom differs: a block
# allocation's exception edge is a dispatch's, not a jitted call's.
PORT_WORDS = {
    'if the jitted dispatch raises (fault injection, shape-bucket miss, '
    'runtime XLA failure)':
        'if the dispatch raises (fault injection, a kernel launch or '
        'tensor-parallel dispatch failure)',
}


def _to_port(text: str) -> str:
    """A path, source or message of the JAX package's, the port's."""
    text = text.replace('skypilot_tpu/', 'skypilot_tpu_torch/')
    text = text.replace('skypilot_tpu.', 'skypilot_tpu_torch.')
    for jax_words, port_words in PORT_WORDS.items():
        text = text.replace(jax_words, port_words)
    return text


def _ported(findings):
    return sorted(Finding(_to_port(f.path), f.line, f.pass_id,
                          _to_port(f.message)) for f in findings)


# ------------------------------------------- the JAX fixtures, extracted

def _jax_fixture_cases():
    """(pass, test name, path, source[, consumer source]) of every
    fixture tests/test_skycheck.py runs through the lock, layering,
    determinism, block and wire passes, read from its source."""
    tree = ast.parse(JAX_TESTS.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = node.value.value

    def value(expr, local):
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            return local.get(expr.id, consts.get(expr.id))
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            a, b = value(expr.left, local), value(expr.right, local)
            return None if a is None or b is None else a + b
        if isinstance(expr, ast.Call) and \
                ast.unparse(expr.func) == 'textwrap.dedent' and expr.args:
            inner = value(expr.args[0], local)
            return None if inner is None else textwrap.dedent(inner)
        return None

    passes = {'lock_discipline': 'lock', 'layering': 'layer',
              'determinism': 'det'}
    cases = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and
                fn.name.startswith('test_')):
            continue
        local = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = value(node.value, local)
                if v is not None:
                    local[node.targets[0].id] = v
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = ast.unparse(node.func)
            mod = callee.split('.')[0]
            if callee.endswith('.check_file') and mod in passes and \
                    len(node.args) == 2:
                path, src = (value(a, local) for a in node.args)
                if path is not None and src is not None:
                    cases.append((passes[mod], fn.name, path, src))
            elif callee == '_block' and len(node.args) == 1:
                body = value(node.args[0], local)
                cases.append(('block', fn.name, consts['BLOCK_PATH'],
                              'class E:\n' + textwrap.indent(
                                  textwrap.dedent(body), '    ')))
            elif callee == '_wire_fixture' and len(node.args) == 2:
                prod, cons = (value(a, local) for a in node.args)
                cases.append(('wire', fn.name, '', prod, cons))
    return cases


CASES = _jax_fixture_cases()
PASSES = {'lock': (jax_lock, lock_discipline),
          'layer': (jax_layer, layering),
          'det': (jax_det, determinism),
          'block': (jax_block, block_lifecycle)}


def test_every_idiom_neutral_pass_has_fixtures():
    kinds = {c[0] for c in CASES}
    assert kinds == {'lock', 'layer', 'det', 'block', 'wire'}
    assert len(CASES) >= 30


def _wire(module, prod, cons, prefix):
    files = {f'{prefix}/infer/prod.py': textwrap.dedent(prod),
             f'{prefix}/serve/cons.py': textwrap.dedent(cons)}
    spec = module.SurfaceSpec(
        'test.surface',
        (module.Producer(f'{prefix}/infer/prod.py', 'make', ('return',)),),
        (module.Consumer(f'{prefix}/serve/cons.py', 'use', vars=('doc',)),))
    return module.check_tree(files, (spec,))


@pytest.mark.parametrize(
    'case', CASES,
    ids=[f'{c[0]}-{c[1]}-{i}' for i, c in enumerate(CASES)])
def test_port_pass_gives_the_jax_passes_findings(case):
    kind = case[0]
    if kind == 'wire':
        _, _, _, prod, cons = case
        jax = _wire(jax_wire, prod, cons, 'skypilot_tpu')
        port = _wire(wire_contract, _to_port(prod), _to_port(cons),
                     'skypilot_tpu_torch')
    else:
        _, _, path, src = case
        jax_mod, port_mod = PASSES[kind]
        jax = jax_mod.check_file(path, src)
        port = port_mod.check_file(_to_port(path), _to_port(src))
    assert sorted(port) == _ported(jax)


# ------------------------------------------------------- host syncs

JIT_PATH = 'skypilot_tpu/infer/fixture.py'
PORT_JIT_PATH = 'skypilot_tpu_torch/infer/fixture.py'
JIT_ROOTS = {'E': ['_step']}

# Each JAX fixture's torch translation, line for line: np.asarray(x) ->
# x.cpu().numpy(), jax.device_get(x) -> x.cpu(), .block_until_ready() ->
# torch.cuda.synchronize(); JIT002's constructors need no counterpart.
TRANSLATIONS = {
    'test_jit_host_sync_flagged_and_allowlisted': '''\
        class E:
            def _step(self):
                x = self.dev.cpu().numpy()
                y = self.dev.cpu().numpy()  # jit-ok: cold error path
                z = self.head.item()

            def _cold(self):
                return self.dev.cpu().numpy()
    ''',
    'test_jit_reachability_via_self_calls': '''\
        class E:
            def _step(self):
                self._inner()

            def _inner(self):
                self.dev.cpu()
    ''',
    'test_jit_varying_shape_flagged_constant_clean': '''\
        class E:
            def _step(self, n):
                a = torch.zeros((4, 8), dtype=torch.int32)
                b = torch.zeros((n, 8), dtype=torch.int32)
                c = torch.full((n,), -1)
    ''',
}


def _jax_jit_fixtures():
    """{test name: its fixture source} of the JAX jit tests."""
    tree = ast.parse(JAX_TESTS.read_text())
    out = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and \
                fn.name.startswith('test_jit_'):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        ast.unparse(node.func) == 'textwrap.dedent':
                    out[fn.name] = textwrap.dedent(node.args[0].value)
    return out


def test_every_jax_jit_fixture_is_translated():
    assert set(_jax_jit_fixtures()) == set(TRANSLATIONS)


@pytest.mark.parametrize('name', sorted(TRANSLATIONS))
def test_jit001_same_lines_as_the_jax_fixture(name):
    jax = [f.line for f in jax_jit.check_file(
        JIT_PATH, _jax_jit_fixtures()[name], roots=JIT_ROOTS)
        if f.pass_id == 'JIT001']
    port = jit_boundary.check_file(
        PORT_JIT_PATH, textwrap.dedent(TRANSLATIONS[name]),
        roots=JIT_ROOTS)
    assert [f.line for f in port] == jax
    assert {f.pass_id for f in port} <= {'JIT001'}


def test_jit001_block_until_ready_is_cuda_synchronize():
    jax_src = textwrap.dedent('''\
        class E:
            def _step(self):
                self.out.block_until_ready()
                self.out.block_until_ready()  # jit-ok: timing only
    ''')
    port_src = textwrap.dedent('''\
        class E:
            def _step(self):
                torch.cuda.synchronize()
                torch.cuda.synchronize()  # jit-ok: timing only
    ''')
    jax = jax_jit.check_file(JIT_PATH, jax_src, roots=JIT_ROOTS)
    port = jit_boundary.check_file(PORT_JIT_PATH, port_src,
                                   roots=JIT_ROOTS)
    assert [f.line for f in port] == [f.line for f in jax] == [3]


def test_jit001_no_roots_for_path_clean():
    src = 'class E:\n    def _step(self):\n        x = t.item()\n'
    assert jit_boundary.check_file('tests/fixture.py', src) == []


def test_jit001_torch_catalogue():
    """The port's catalogue: int/float/bool and implicit bool of a tensor
    expression, a blocking .to('cpu'), np.asarray of a tensor, Event and
    Stream waits; a host value, an identity test and a non-blocking copy
    are clean."""
    src = textwrap.dedent('''\
        class E:
            def _step(self, t: torch.Tensor, n: int, ev):
                a = int(t.sum())
                b = float(n)
                if t.max() > 0:
                    pass
                if t is None:
                    pass
                c = t.to('cpu')
                d = t.to('cpu', non_blocking=True)
                e = np.asarray(t)
                f = np.asarray([n])
                ev.synchronize()
                g = self._head()
                h = bool(g[0])
                k = t.to(device=torch.device('cpu'))

            def _head(self) -> torch.Tensor:
                return self.x
    ''')
    found = jit_boundary.check_file(PORT_JIT_PATH, src, roots=JIT_ROOTS)
    assert [f.line for f in found] == [3, 5, 9, 11, 13, 15, 16]
    assert all(f.pass_id == 'JIT001' for f in found)


def test_jit001_module_roots_close_over_bare_calls():
    src = textwrap.dedent('''\
        def launch(q: torch.Tensor):
            _check(q)

        def _check(q: torch.Tensor):
            if bool(q.isnan().any()):
                raise ValueError(q)

        def cold(q: torch.Tensor):
            return q.item()
    ''')
    found = jit_boundary.check_file(
        PORT_JIT_PATH, src, roots={jit_boundary.MODULE: ['launch']})
    assert [f.line for f in found] == [5]
    assert "'_check'" in found[0].message


def test_tp_settle_flag_is_jit_ok_with_its_reason():
    """infer/tp.py's failure flag readback is a deliberate sync: the
    pass lists it as jit-ok, with a reason; the same line without the
    comment is JIT001."""
    rel = 'skypilot_tpu_torch/infer/tp.py'
    text = (ROOT / rel).read_text()
    lines = text.splitlines()
    [line] = [i for i, ln in enumerate(lines, 1)
              if 'return bool(flag.item())' in ln]
    reason = lines[line - 1].split('# jit-ok:', 1)[1].strip()
    assert reason
    assert jit_boundary.sync_sites(rel, text)[line] == 'jit-ok'
    assert jit_boundary.check_file(rel, text) == []
    bare = text.replace(lines[line - 1],
                        lines[line - 1].split('  # jit-ok:')[0])
    [f] = [f for f in jit_boundary.check_file(rel, bare) if f.line == line]
    assert f.pass_id == 'JIT001' and "'_settle'" in f.message


def test_sync_sites_of_the_dispatch_paths():
    """Every sync site on the engine's dispatch path is a deliberate,
    annotated readback: the window's event wait and its pinned buffer."""
    rel = 'skypilot_tpu_torch/infer/engine.py'
    text = (ROOT / rel).read_text()
    sites = jit_boundary.sync_sites(rel, text)
    lines = text.splitlines()
    assert set(sites.values()) == {'jit-ok'}
    assert any('ev.synchronize()' in lines[n - 1] for n in sites)
    fa = 'skypilot_tpu_torch/ops/flash_attention.py'
    assert jit_boundary.sync_sites(fa, (ROOT / fa).read_text()) == {}


# ------------------------------------------------- port-only semantics

def test_layer_no_jax_package_in_the_port():
    src = 'import jax\nfrom skypilot_tpu.serve import load_balancer\n'
    found = layering.check_file('skypilot_tpu_torch/ops/fixture.py', src)
    assert [f.line for f in found] == [1, 2]
    assert "'jax'" in found[0].message
    assert "'skypilot_tpu'" in found[1].message
    # The twins compose the port with the (JAX-free) serve plane.
    assert layering.check_file('scripts/bench_x_torch.py', src)[0].line == 1
    assert len(layering.check_file('scripts/bench_x_torch.py', src)) == 1
    assert layering.check_file('chip_smoke.py', src) != []
    assert layering.check_file('scripts/skycheck.py', src) == []
    assert layering.check_file(
        'skypilot_tpu_torch/ops/fixture.py',
        'from skypilot_tpu_torch.device import resolve_device\n') == []


def test_block_return_sink_makes_an_allocator():
    src = 'class E:\n' + textwrap.indent(textwrap.dedent('''
        def _capture(self, n):
            ids = self._alloc_blocks(n)  # owns-blocks: return
            try:
                self._paged_prefill(ids)
            except BaseException:
                for b in ids:
                    self._deref_block(b)
                raise
            return ids

        def register(self, key, n):
            blocks = self._capture(n)  # owns-blocks: entry
            self._prefixes[key] = {'blocks': blocks}

        def leaky(self, n):
            blocks = self._capture(n)  # owns-blocks: entry
            return None
    '''), '    ')
    found = block_lifecycle.check_file(
        'skypilot_tpu_torch/infer/engine.py', src)
    assert [(f.pass_id, f.line) for f in found] == [('BLOCK001', 19)]


def test_shard_axes_and_divisibility_guards():
    files = {p: (ROOT / p).read_text() for p in (
        shard_contract.MESH_FILE, 'skypilot_tpu_torch/infer/engine.py',
        'skypilot_tpu_torch/infer/tp.py',
        'skypilot_tpu_torch/models/llama.py')}
    assert shard_contract.check_tree(files) == []
    typo = dict(files)
    typo['skypilot_tpu_torch/infer/tp.py'] = files[
        'skypilot_tpu_torch/infer/tp.py'].replace(
            "mesh.size('tensor')", "mesh.size('tensr')", 1)
    assert [f.pass_id for f in shard_contract.check_tree(typo)] == \
        ['SHARD001']
    unguarded = dict(files)
    unguarded['skypilot_tpu_torch/infer/tp.py'] = files[
        'skypilot_tpu_torch/infer/tp.py'].replace(
            'model_config.num_kv_heads % tp', 'False')
    [f] = shard_contract.check_tree(unguarded)
    assert f.pass_id == 'SHARD004' and "'num_kv_heads'" in f.message


# ------------------------------------------------------------- wire

def _wire_files():
    files = {}
    for spec in wire_contract.SURFACES:
        for ep in (list(spec.producers) + list(spec.consumers) +
                   ([spec.twin] if spec.twin else [])):
            files.setdefault(ep.path, (ROOT / ep.path).read_text())
    return files


def test_wire_clean_against_the_serve_plane_and_the_jax_schema():
    findings = wire_contract.check_tree(_wire_files())
    assert findings == [], [f.render() for f in findings]
    sc = {c.name: c for c in wire_contract.contract(_wire_files())}
    # The LB and the policies read the port's documents.
    assert {'status', 'draining', 'kv'} <= set(sc['/healthz'].consumed)
    assert {'block_size', 'occupancy', 'host_tier', 'tp'} <= \
        set(sc['/healthz.kv'].consumed)
    assert sc['/healthz.kv.host_tier'].consumed
    assert sc['/healthz.kv'].twin_keys.keys() == \
        sc['/healthz.kv'].produced.always


def test_wire001_on_a_dropped_kv_health_key():
    files = _wire_files()
    eng = 'skypilot_tpu_torch/infer/engine.py'
    start = files[eng].index('    def kv_health(')
    end = files[eng].index('    def stats(')
    body = files[eng][start:end]
    assert body.count("'blocks_free'") == 2
    files[eng] = (files[eng][:start] +
                  body.replace("'blocks_free'", "'free_blocks'") +
                  files[eng][end:])
    found = [f for f in wire_contract.check_tree(files)
             if f.pass_id == 'WIRE001']
    assert len(found) == 1 and "'blocks_free'" in found[0].message
    assert found[0].path == eng and "'/healthz.kv'" in found[0].message


# ----------------------------------------------------------- driver

def _driver(*args, cwd=ROOT):
    return subprocess.run([sys.executable, str(DRIVER), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def _main(*args):
    """The driver's main() in this process: (exit code, stdout)."""
    spec = importlib.util.spec_from_file_location('skycheck_torch', DRIVER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = mod.main(list(args))
    return rc, out.getvalue()


def test_driver_clean_against_its_baseline_with_pass_seconds():
    r = _driver('--baseline', str(BASELINE), '--json', '-')
    assert r.returncode == 0, r.stdout + r.stderr
    payload = __import__('json').loads(r.stdout)
    assert payload['new'] == [] and payload['files_checked'] > 100
    assert set(payload['passes']) == {'lock', 'jit', 'layer', 'det',
                                      'block', 'wire', 'shard'}
    assert all('seconds' in p for p in payload['passes'].values())


def test_driver_catches_planted_faults_in_a_copy(tmp_path):
    shutil.copytree(ROOT / 'skypilot_tpu_torch',
                    tmp_path / 'skypilot_tpu_torch',
                    ignore=shutil.ignore_patterns('__pycache__', 'csrc'))
    eng = tmp_path / 'skypilot_tpu_torch' / 'infer' / 'engine.py'
    text = eng.read_text()
    step = '        if self._ahead is not None:\n            handle, chain'
    assert text.count(step) == 1
    text = text.replace(step, '        probe = self.cache[0][0].sum().item()\n'
                        + step)
    anchor = '    def _step(self) -> None:'
    text = text.replace(anchor, '    def _clear_slots(self) -> None:\n'
                        '        self._slots = [None] * len(self._slots)\n\n'
                        + anchor)
    eng.write_text(text)
    ops = tmp_path / 'skypilot_tpu_torch' / 'ops' / 'flash_attention.py'
    ops.write_text('import jax\n' + ops.read_text())
    passes = ('--passes', 'lock,jit,layer')
    rc, out = _main('--root', str(tmp_path), '--baseline', str(BASELINE),
                    *passes)
    assert rc == 1, out
    assert "[JIT001] host sync .item() inside dispatch-reachable " \
        "'_decode_step'" in out
    assert "[LOCK001] field '_slots'" in out
    assert "ops/flash_attention.py:1: [LAYER001]" in out and \
        "import 'jax'" in out
    # The ratchet: pinning a finding over the clean baseline is refused
    # ... (the layering pass alone: the cheapest with a finding)
    base = tmp_path / 'base.txt'
    shutil.copy(BASELINE, base)
    layer = ('--passes', 'layer')
    rc, out = _main('--root', str(tmp_path), '--write-baseline', str(base),
                    *layer)
    assert rc == 3, out
    # ... unless asked for, and then it is pinned.
    rc, out = _main('--root', str(tmp_path), '--write-baseline', str(base),
                    '--allow-grow', *layer)
    assert rc == 0, out
    rc, out = _main('--root', str(tmp_path), '--baseline', str(base),
                    *layer)
    assert rc == 0, out


def test_driver_rejects_unknown_pass():
    with pytest.raises(SystemExit) as e:
        _main('--passes', 'lock,compile')
    assert e.value.code == 2


def test_engine_annotations_cover_the_jax_engines():
    """The port's engine carries the JAX engine's 24 guarded fields and 29
    locked helpers (and guards its own), and the lock pass reports
    nothing on them."""
    def annotated(path):
        text = (ROOT / path).read_text()
        tree = ast.parse(text)
        lines = text.splitlines()
        [cls] = [n for n in tree.body if isinstance(n, ast.ClassDef) and
                 n.name == 'InferenceEngine']
        guarded = set(lock_discipline._collect_guarded(cls, lines))
        # The annotation may trail any line of a wrapped def header.
        locked = {m.name for m in cls.body
                  if isinstance(m, ast.FunctionDef) and any(
                      lock_discipline._LOCKED_RE.search(ln) for ln in
                      lines[m.lineno - 2:m.body[0].lineno - 1])}
        return guarded, locked
    jax_guarded, jax_locked = annotated('skypilot_tpu/infer/engine.py')
    guarded, locked = annotated('skypilot_tpu_torch/infer/engine.py')
    assert (len(jax_guarded), len(jax_locked)) == (24, 29)
    assert jax_guarded <= guarded and jax_locked <= locked
    rel = 'skypilot_tpu_torch/infer/engine.py'
    assert lock_discipline.check_file(rel, (ROOT / rel).read_text()) == []


def test_analysis_imports_nothing_of_jax():
    for path in sorted((ROOT / 'skypilot_tpu_torch' / 'analysis').glob(
            '*.py')) + [DRIVER]:
        rel = str(path.relative_to(ROOT))
        assert layering.check_file(
            rel if not rel.startswith('scripts/') else
            'scripts/skycheck_torch.py', path.read_text()) == [], rel
    assert os.path.exists(BASELINE)
