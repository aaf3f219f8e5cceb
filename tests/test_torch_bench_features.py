"""scripts/bench_features_torch.py held against the reference script
(scripts/bench_features.py, loaded by path) on the CPU, each engine
section with both scripts' engine factory swapped for a tiny f32 llama
over one set of numpy weights (the sections keep their own prompt
lengths, caches and options):

- prefix caching: prefix_stats and the prefix hits;
- chunked prefill: chunk_stats;
- the model-free sections: TP capacity and the LB-affinity replay equal
  the reference's exactly, and the QoS scheduler section's pop order and
  shares (through the port's scheduler copies) too;
- --qos-only with no --out writes no file.

tests/test_torch_bench_features_kv.py holds the KV-occupancy and radix
sections, tests/test_torch_bench_features_serving.py the speculative and
fault-containment ones."""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
from types import SimpleNamespace

import pytest

from helpers_torch import engine_factories, one_torch_thread  # noqa: F401
from skypilot_tpu.infer.qos import WfqScheduler as JaxWfq

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


def test_prefix_section_counters(engines):
    want, got = _both('bench_prefix', reps=1)
    assert got.pop('prefix_stats') == dict(engines[-1].prefix_stats)
    assert _drop_timings(got) == _drop_timings(want)
    assert got['prefix_hits'] == 2


def test_chunked_prefill_section_counters(engines):
    want, got = _both('bench_chunked_prefill', reps=1)
    assert _drop_timings(got) == _drop_timings(want)
    assert got['chunk_stats']['requests'] == 2


def test_model_free_sections_equal_the_reference():
    for name, kw in (('bench_tp_capacity', {}),
                     ('bench_tp_capacity', dict(hbm_gb=80.0,
                                                tp_sweep=(1, 3, 4))),
                     ('bench_lb_affinity', dict(n_replicas_sweep=(1, 3),
                                                groups=7, per_group=5))):
        want, got = _both(name, **kw)
        assert got == want


def test_qos_section_and_pop_order():
    want, got = _both('bench_qos_scheduler', backlog=300, reps=1)
    for doc in (want, got):
        assert all(v > 0 for v in doc.pop('push_pop_ops_per_s').values())
    assert got == want
    # The pop order of a mixed trace through both WFQ schedulers.
    orders = []
    for make in (JaxWfq, TWIN.WfqScheduler):
        sched = make(weights={'gold': 3.0, 'silver': 1.0})
        for i in range(60):
            sched.push(SimpleNamespace(
                tokens=[1] * (8 + i % 7), max_new_tokens=1 + i % 3,
                priority=('batch', 'interactive')[i % 5 == 0],
                tenant_id=('gold', 'silver', 'bronze')[i % 3], i=i))
        order = []
        while (r := sched.pop()) is not None:
            order.append(r.i)
        orders.append(order)
    assert orders[0] == orders[1] and len(orders[0]) == 60


def test_qos_only_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert TWIN.main(['--qos-only']) == 0
    assert not os.listdir(tmp_path)
