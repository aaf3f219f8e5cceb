"""The KV-occupancy and radix sections of scripts/bench_features_torch.py
held against the reference script's (scripts/bench_features.py, loaded
by path) on the CPU, both scripts' engine factory swapped for a tiny f32
llama over one set of numpy weights: the four stats() snapshots whole
(but the wall-clock service rate), and the radix tree's counters."""
import contextlib
import importlib.util
import io
import json
import pathlib

import pytest

from helpers_torch import engine_factories, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Vocabulary of the sections' prompts (0..32000); caches up to 1152 rows.
GEOMETRY = dict(name='features-test', vocab_size=32000, hidden_size=32,
                intermediate_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2, max_seq_len=2048, tie_embeddings=True)
TIMINGS = {'prefill_ms_full', 'prefill_ms_prefix_reuse', 'ttft_reduction',
           'ttft_ms_chunked', 'ttft_ms_monolithic', 'ttft_overhead',
           'ttft_ms_no_overlap', 'ttft_ms_shared_system_prompt'}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_features', 'scripts/bench_features.py')
TWIN = _load('bench_features_torch', 'scripts/bench_features_torch.py')


@pytest.fixture(scope='module')
def engines():
    """Both scripts' _engine over the same tiny weights; the reference's
    engines recorded as they are built."""
    jax_factory, port_factory, _ = engine_factories(GEOMETRY)
    built = []

    def ref_engine(**kw):
        built.append(jax_factory(**kw))
        return built[-1]

    saved = REF._engine, TWIN._engine, TWIN.DEVICE
    REF._engine, TWIN._engine, TWIN.DEVICE = ref_engine, port_factory, 'cpu'
    yield built
    REF._engine, TWIN._engine, TWIN.DEVICE = saved


def _both(name, **kw):
    out = []
    for mod in (REF, TWIN):
        with contextlib.redirect_stdout(io.StringIO()):
            out.append(json.loads(json.dumps(getattr(mod, name)(**kw))))
    return out


def _drop_timings(doc: dict) -> dict:
    assert all(doc[k] > 0 for k in TIMINGS & set(doc) if '_ms_' in k)
    return {k: v for k, v in doc.items() if k not in TIMINGS}


def test_kv_occupancy_snapshots(engines):
    want, got = _both('bench_kv_occupancy')
    for doc in (want, got):
        for snap in doc.values():
            assert snap['qos'].pop('service_rate_tokens_per_s') is None
    assert got == want
    assert got['mid_flight_4_slots_sharing']['kv']['blocks']['shared'] > 0


def test_radix_section_counters(engines):
    want, got = _both('bench_radix', reps=1)
    assert _drop_timings(got) == _drop_timings(want)
    assert got['radix_hits'] > 0
