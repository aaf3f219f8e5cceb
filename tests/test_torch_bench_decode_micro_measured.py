"""scripts/bench_decode_micro_torch.py's measured modes on the CPU at tiny
size, through the port engine's dispatch functions: the default fit (every
window timed, the device columns null off the card, --out writes the line
and nothing is written without it), the paged and kv-tier sweeps, and the
tp=2 sweep over two gloo ranks.  tests/test_torch_bench_decode_micro.py
holds the analytic reports, --radix and the fit against the reference."""
import contextlib
import importlib.util
import io
import json
import os
import pathlib

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TWIN = _load('bench_decode_micro_torch', 'scripts/bench_decode_micro_torch.py')


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def test_default_mode_fits_and_times_every_part(tmp_path, monkeypatch):
    """The fit at tiny size on the CPU: every window timed, F and s
    finite, the device columns null (not measured off the card), the
    prefill and the stall comparison present; --out writes the line."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / 'fit.json'
    args = ['--device', 'cpu', '--model', 'llama-debug',
            '--weight-dtype', 'bf16', '--cache-dtype', 'float32',
            '--num-slots', '2', '--max-cache-len', '256',
            '--prompt-len', '40', '--windows', '1', '2', '4',
            '--reps', '2']
    assert _quiet(TWIN.main, args) == 0
    assert not os.listdir(tmp_path)
    assert _quiet(TWIN.main, args + ['--out', str(out)]) == 0
    doc = json.loads(out.read_text())
    assert sorted(doc['windows']) == ['1', '2', '4']
    for row in doc['windows'].values():
        assert row['dispatch_s'] > 0 and row['chained_s'] > 0
        assert row['device_ms'] is None and row['idle_share'] is None
    assert doc['device_fit'] is None
    assert all(isinstance(doc[k], float)
               for k in ('fit_fixed_ms', 'fit_per_step_ms'))
    assert doc['prefill_bucket256_p1_ms'] > 0
    assert doc['chunk_stall']['prefill_lanes'] == 4


def test_measured_sweeps_run_through_the_port_engine():
    """--paged and --kv-tier measured at tiny size: rows at every fill and
    working set, the tier-on engine restoring blocks."""
    args = TWIN.parser().parse_args(
        ['--paged', '--device', 'cpu', '--fill-sweep', '32', '200'])
    paged = _quiet(TWIN.paged_report, args)['measured_tiny_sweep']
    assert [r['filled_len'] for r in paged['rows']] == [32, 200, 511]
    assert [r['table_blocks'] for r in paged['rows']] == [4, 16, 32]
    assert all(r['paged_device_ms'] is None for r in paged['rows'])
    args = TWIN.parser().parse_args(['--kv-tier', '--device', 'cpu',
                                     '--ws-sweep', '2'])
    tier = _quiet(TWIN.kv_tier_report, args)['measured_tiny_sweep']
    [row] = tier['rows']
    assert row['families'] == 2 and row['restored_blocks'] > 0
    assert row['radix_hits_tier_on'] == 2


def test_tp_sweep_runs_two_ranks(monkeypatch):
    """The tp=2 engine over two gloo ranks (rank 1 spawned as run()
    spawns it): greedy identity and half the pool bytes a rank."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')     # the spawned rank's
    args = TWIN.parser().parse_args(['--tp', '--device', 'cpu',
                                     '--tp-sweep', '1', '2'])
    measured = _quiet(TWIN.tp_report, args)['measured_tiny_sweep']
    assert measured['greedy_identity']
    single, tp2 = measured['rows']
    assert (single['tp'], tp2['tp']) == (1, 2)
    assert tp2['pool_bytes_per_chip'] * 2 == tp2['pool_bytes_total']
    assert single['pool_bytes_total'] == tp2['pool_bytes_total']
