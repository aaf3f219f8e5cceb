"""scripts/bench_serve_lb_torch.py held against the reference script
(scripts/bench_serve_lb.py, loaded by path) on the CPU, with port
replicas behind the serve plane's unchanged load balancer:

- the serve-up replica command is the reference's with only the module
  changed, and the port's command line parses it;
- a failover iteration resumes a killed stream byte-identical to the JAX
  engine's greedy tokens on the same weights, the drain hands its hot
  prefix to the survivor, and no file is written without --out;
- C10: the port's warm-up runs the top bucket the JAX warm-up cannot.

tests/test_torch_bench_serve_lb_fleet.py holds the sweep row and the
affinity section."""
import contextlib
import importlib.util
import io
import os
import pathlib
import shlex
import sys

import pytest

from helpers_torch import (jax_engine, make_params,  # noqa: F401
                           one_torch_thread, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch import cli as port_cli
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
from skypilot_tpu_torch.infer import Request as PortRequest

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


class _Up(Exception):
    pass


def _reference_command(flags, monkeypatch) -> str:
    """The reference main()'s replica command: serve up is stopped where
    it would start the service."""
    import skypilot_tpu.serve.core as serve_core
    from skypilot_tpu import state
    seen = []

    def up(task, service_name=None):
        seen.append(task.run)
        raise _Up

    monkeypatch.setattr(serve_core, 'up', up)
    monkeypatch.setattr(state, 'set_enabled_clouds', lambda clouds: None)
    monkeypatch.setattr(sys, 'argv', ['bench_serve_lb.py'] + flags)
    with pytest.raises(_Up):
        REF.main()
    return seen[0]


@pytest.mark.parametrize('flags', [
    [],
    ['--profile', 'latency'],
    ['--profile', 'throughput', '--num-slots', '16', '--decode-steps', '4',
     '--max-ttft', '2.5', '--max-queue', '64'],
])
def test_replica_command_is_the_references(flags, monkeypatch):
    want = _reference_command(flags, monkeypatch)
    got = TWIN.replica_command(TWIN.parser().parse_args(flags))
    assert got == want.replace('skypilot_tpu.cli', 'skypilot_tpu_torch.cli')
    argv = shlex.split(got.replace('$SKYTPU_SERVE_REPLICA_PORT', '8123'))
    assert argv[:3] == ['python', '-m', 'skypilot_tpu_torch.cli']
    args = port_cli._parser().parse_args(argv[3:])
    assert (args.model, args.weight_dtype, args.cache_dtype,
            args.max_cache_len, args.port) == \
        ('llama2-7b', 'int8', 'fp8', 512, 8123)
    knobs = port_cli._knobs(args)
    if not flags:
        assert knobs['num_slots'] == 48


def test_failover_iteration_resumes_the_jax_tokens(params, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    infer = {k: v for k, v in TWIN.FAILOVER_INFER.items()}

    def make_engine():
        eng = port_engine(params, **infer)
        eng.warmup()
        eng.arm_faults(FaultPlan(seed=0, specs=[
            FaultSpec(site='stall', prob=1.0, stall_s=0.04)]))
        return eng

    with contextlib.redirect_stdout(io.StringIO()):
        row = TWIN.run_failover_bench(1, make_engine=make_engine)
    [want] = jax_engine(params, **infer).generate(
        [JaxRequest(tokens=[3, 14, 15, 9, 2, 6], max_new_tokens=24)])
    assert row['output_tokens'] == want.output_tokens
    assert row['streams_resumed'] >= 1 and row['failovers'] >= 1
    assert row['drain_handoff']['adopted_blocks'] > 0
    assert row['handoff_prefixes'] >= 1
    assert row['drain_handoff']['survivor_hot_radix_hits'] == 4
    assert not os.listdir(tmp_path)


def test_c10_warmup_runs_the_top_bucket(params):
    """C10: the JAX validation refuses what its warm-up sends for the
    bucket equal to max_cache_len (max_cache_len - 1 tokens + 2 new); the
    port's warm-up serves that bucket, and with the radix cache on its
    prompt ([5] * 62 here) stays in the tree -- why the twin's failover
    section takes another hot prefix than the reference's [5] * 24."""
    opts = dict(kv_block_size=8, auto_prefix_cache=True)
    jeng = jax_engine(params, **opts)
    m = jeng.cfg.max_cache_len
    assert list(jeng.cfg.prefill_buckets) == [8, 16, 32, m]
    with pytest.raises(ValueError, match='exceeds cache'):
        jeng._validate_request(JaxRequest(tokens=[5] * (m - 1),
                                          max_new_tokens=2))
    peng = port_engine(params, **opts)
    peng.warmup()
    hits = peng.radix_stats['hits']
    [res] = peng.generate([PortRequest(tokens=[5] * 24 + [9],
                                       max_new_tokens=1)])
    assert res.finish_reason == 'length'
    assert peng.radix_stats['hits'] == hits + 1
    [res] = peng.generate([PortRequest(tokens=[61] * 24 + [9],
                                       max_new_tokens=1)])
    assert peng.radix_stats['hits'] == hits + 1
