"""scripts/bench_serve_lb_torch.py's sweep row and affinity section held
against the reference script (scripts/bench_serve_lb.py, loaded by path)
on the CPU, with port replicas behind the serve plane's unchanged load
balancer:

- a sweep row through a port fleet's LB counts what the same row through
  a JAX fleet's LB counts (completed, errors 0, sheds 0, every token);
- the affinity section's arms give the JAX engine's tokens for every
  prompt, and write no file without --out."""
import contextlib
import importlib.util
import io
import os
import pathlib

import pytest

from helpers_torch import (GEOMETRY, engine_factories,  # noqa: F401
                           jax_engine, make_params, one_torch_thread,
                           port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import chaos as jax_chaos

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT_LEN, NEW_TOKENS = 20, 12     # the sweep's shape, cut to the cache


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_serve_lb', 'scripts/bench_serve_lb.py')
TWIN = _load('bench_serve_lb_torch', 'scripts/bench_serve_lb_torch.py')


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(autouse=True)
def _probe_interval(monkeypatch):
    monkeypatch.setenv('SKYTPU_SERVE_LB_PROBE_INTERVAL', '0.2')
    monkeypatch.setattr(TWIN, 'DEVICE', 'cpu')


def test_sweep_row_counts_equal_the_jax_fleet(params, monkeypatch):
    """One Poisson row (16 requests) through each fleet's LB: the same
    completed, zero errors and sheds, every request's tokens."""
    for mod in (REF, TWIN):
        monkeypatch.setattr(mod, 'PROMPT_LEN', PROMPT_LEN)
        monkeypatch.setattr(mod, 'NEW_TOKENS', NEW_TOKENS)
    opts = dict(max_new_tokens=16, decode_steps=4)
    rows = {}
    for name, fleet, mod in (
            ('jax', jax_chaos.ChaosFleet(
                lambda: jax_engine(params, **opts), 1), REF),
            ('port', TWIN._fleet(lambda: port_engine(params, **opts), 1),
             TWIN)):
        fleet.start()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rows[name] = mod.run_sweep_row(
                    f'http://127.0.0.1:{fleet.lb.port}', 40.0, 16,
                    vocab=GEOMETRY['vocab_size'])
        finally:
            fleet.stop()
    for row in rows.values():
        assert (row['completed'], row['errors'], row['shed_429']) == \
            (16, 0, 0)
    assert rows['port']['output_tokens'] == 16 * NEW_TOKENS
    jax_tokens = rows['jax']['output_tokens_per_second'] * \
        rows['jax']['elapsed_s']
    assert round(jax_tokens) == 16 * NEW_TOKENS


def test_affinity_arms_give_the_jax_tokens(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jax_factory, port_factory, _ = engine_factories(
        {**TWIN.AFFINITY_GEOMETRY, 'tie_embeddings': True})
    infer = dict(TWIN.AFFINITY_INFER, decode_steps=4)

    def make_engine():
        eng = port_factory(**infer)
        eng.warmup()
        return eng

    with contextlib.redirect_stdout(io.StringIO()):
        doc = TWIN.run_affinity_bench(n_replicas=2, groups=2, per_group=2,
                                      overlaps=(0.5,),
                                      make_engine=make_engine)
    specs = REF._affinity_prompts(2, 2, 0.5)
    want = jax_factory(**infer).generate(
        [JaxRequest(tokens=s['tokens'], max_new_tokens=8) for s in specs])
    got = doc['outputs'][0.5]
    assert {(s['group'], s['req']): w.output_tokens
            for s, w in zip(specs, want)} == got
    assert [r['requests'] for r in doc['rows']] == [4, 4, 4]
    assert [r['arm'] for r in doc['rows']] == \
        ['single_replica', 'least_load', 'prefix_affinity']
    assert doc['rows'][0]['fleet_radix_hits'] > 0
    assert not os.listdir(tmp_path)
