"""scripts/bench_decode_micro_torch.py held against the reference script
(scripts/bench_decode_micro.py, loaded by path) on the CPU:

- the analytic reports of --paged, --tp and --kv-tier with --no-measure
  equal the reference's JSON exactly, at its defaults and at the H100's
  memory with other geometries, and write no file without --out;
- --radix gives the reference's sweep (every field but the timings, the
  radix counters included) with both engines' warm-ups off, since the two
  warm-ups send different requests;
- the least-squares fit is the reference's own code's F and s on fixed
  inputs.

tests/test_torch_bench_decode_micro_measured.py runs the measured modes."""
import contextlib
import importlib.util
import inspect
import io
import json
import os
import pathlib
import textwrap

import pytest

from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu_torch.infer import InferenceEngine as PortEngine

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_decode_micro', 'scripts/bench_decode_micro.py')
TWIN = _load('bench_decode_micro_torch', 'scripts/bench_decode_micro_torch.py')
TIMINGS = ('ttft_ms_radix_off', 'ttft_ms_radix_on', 'ttft_reduction')


def _ref_json(fn, args) -> dict:
    """The reference report's JSON line (it prints, returns nothing)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(args)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith('{')][-1])


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


@pytest.mark.parametrize('flags', [
    [],
    ['--hbm-gb', '80', '--weights-gb', '16', '--model', 'llama3-8b',
     '--cache-dtype', 'bf16', '--block-size', '32',
     '--max-cache-len', '2048', '--typical-len', '700'],
    ['--model', 'mixtral-8x7b', '--tp-sweep', '1', '3', '8',
     '--ws-sweep', '1', '16', '--host-kv-gb', '256', '--h2d-gbps', '25',
     '--tflops', '989', '--fill-sweep', '0', '17', '900'],
], ids=['defaults', 'h100-llama3', 'mixtral'])
@pytest.mark.parametrize('mode', ['paged', 'tp', 'kv_tier'])
def test_analytic_reports_equal_the_reference(mode, flags, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = TWIN.parser().parse_args(
        ['--' + mode.replace('_', '-'), '--no-measure'] + flags)
    want = _ref_json(getattr(REF, f'{mode}_report'), args)
    got = _quiet(getattr(TWIN, f'{mode}_report'), args)
    assert json.loads(json.dumps(got)) == want
    assert not os.listdir(tmp_path)         # no --out: no file


def test_radix_sweep_equals_the_reference(monkeypatch):
    """Every field but the timings, and the final radix counters, with the
    engines' warm-ups off on both sides (they send other requests)."""
    monkeypatch.setattr(JaxEngine, 'warmup', lambda self: None)
    monkeypatch.setattr(PortEngine, 'warmup', lambda self: None)
    args = TWIN.parser().parse_args(['--radix', '--reps', '1',
                                     '--device', 'cpu'])
    want = _ref_json(REF.radix_report, args)
    got = json.loads(json.dumps(_quiet(TWIN.radix_report, args)))
    for doc in (want, got):
        for row in doc['overlap_sweep']:
            for key in TIMINGS:
                assert row.pop(key) >= 0
    assert got == want
    assert sum(r['radix_hits'] for r in got['overlap_sweep']) > 0


def _reference_fit(ks, ts):
    """The reference main()'s least-squares lines, run as they are on
    (ks, ts): its fit is inline, so its source is cut out and executed."""
    src = inspect.getsource(REF.main)
    start = src.index('    ks = sorted(results)')
    end = src.index('    f = mt - s * mk') + len('    f = mt - s * mk')
    scope = {'results': {k: {'dispatch_s': t} for k, t in zip(ks, ts)}}
    exec(textwrap.dedent(src[start:end]), scope)  # noqa: S102
    return scope['f'], scope['s']


@pytest.mark.parametrize('ts', [
    [0.0305, 0.0411, 0.0623, 0.1049, 0.1902],
    [0.25, 0.19, 0.31, 0.29, 0.61],
])
def test_fit_is_the_references(ts):
    ks = [1, 2, 4, 8, 16]
    f, s = TWIN.fit_dispatch_cost(ks, ts)
    rf, rs = _reference_fit(ks, ts)
    assert (f, s) == (rf, rs)
