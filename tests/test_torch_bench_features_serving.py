"""The speculative and fault-containment sections of
scripts/bench_features_torch.py held against the reference script's
(scripts/bench_features.py, loaded by path) on the CPU, both scripts'
engine factory swapped for a tiny f32 llama over one set of numpy
weights:

- speculation: spec_stats of the windowed and draft_len 4 engines, and
  the dispatch-cost section's shape (one windowed and one verify dispatch
  timed, the break-even derived), with the reference's prompt lookup
  restored after it;
- fault containment: the fault counters, one failed request and the
  survivors, armed-but-unfired and clean batches finishing."""
import contextlib
import functools
import importlib.util
import io
import json
import pathlib

import pytest

from helpers_torch import engine_factories, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRY = dict(name='features-test', vocab_size=32000, hidden_size=32,
                intermediate_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2, max_seq_len=2048, tie_embeddings=True)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_features', 'scripts/bench_features.py')
TWIN = _load('bench_features_torch', 'scripts/bench_features_torch.py')


@pytest.fixture
def engines(monkeypatch):
    jax_factory, port_factory, _ = engine_factories(GEOMETRY)
    monkeypatch.setattr(REF, '_engine', jax_factory)
    monkeypatch.setattr(TWIN, '_engine', port_factory)
    monkeypatch.setattr(TWIN, 'DEVICE', 'cpu')
    # The reference's dispatch-cost section at 3 timed iterations (its
    # own code; only the count of timed dispatches is cut).
    monkeypatch.setattr(REF, 'bench_dispatch_cost', functools.partial(
        REF.bench_dispatch_cost, iters=3))


def _both(name, ref_kw, twin_kw):
    out = []
    for mod, kw in ((REF, ref_kw), (TWIN, twin_kw)):
        with contextlib.redirect_stdout(io.StringIO()):
            out.append(json.loads(json.dumps(getattr(mod, name)(**kw))))
    return out


def test_spec_section_counters(engines):
    kw = dict(num_requests=4, prompt_len=24, new_tokens=40)
    plain = TWIN.engine_mod.prompt_lookup_draft
    want, got = _both('bench_spec', kw, dict(kw, dispatch_iters=3))
    assert TWIN.engine_mod.prompt_lookup_draft is plain
    for doc in (want, got):
        cost = doc.pop('dispatch_cost')
        assert cost['windowed_tokens_per_dispatch'] == 8
        assert cost['windowed_ms_per_dispatch'] > 0
        assert cost['verify_ms_per_dispatch'] > 0
        for row in doc.values():
            assert row.pop('output_tokens_per_second') > 0
            assert row.pop('requests_per_second') > 0
    assert got == want
    assert got['draft_len_0_random']['spec']['dispatches'] == 0


def test_fault_containment_counters(engines):
    kw = dict(num_requests=4, prompt_len=16, new_tokens=32)
    want, got = _both('bench_fault_containment', kw, kw)
    for doc in (want, got):
        for key in ('wall_clean_s', 'wall_armed_unfired_s',
                    'wall_faulted_s'):
            assert doc.pop(key) > 0
        doc.pop('armed_overhead_pct')
    assert got == want
    assert got['failed_requests'] == 1
    assert got['survivors_completed'] == 3
    assert got['counters']['internal_errors'] == 1
