"""The port's `infer` command line (skypilot_tpu_torch/cli.py, argparse)
held against the reference's click group (skypilot_tpu/cli.py): the
profile presets and the precedence of explicit flags, the arguments
`infer serve` forwards to run() (each side's run stubbed), the engine
configuration `infer bench` builds, and the metric keys it prints."""
import json

import numpy as np
import pytest
from click.testing import CliRunner

from skypilot_tpu import cli as jax_cli
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu_torch import cli
from skypilot_tpu_torch.infer import engine as port_engine_mod
from skypilot_tpu_torch.infer import server as port_server

SMALL = ['--model', 'llama-debug', '--num-requests', '2', '--prompt-len',
         '8', '--new-tokens', '4', '--max-cache-len', '64', '--num-slots',
         '2']


def test_profiles_are_the_references():
    assert cli._INFER_PROFILES == jax_cli._INFER_PROFILES


def _jax_serve(monkeypatch, args):
    got = {}
    monkeypatch.setattr(jax_server, 'run', lambda **kw: got.update(kw))
    res = CliRunner().invoke(jax_cli.cli, ['infer', 'serve', *args])
    assert res.exit_code == 0, res.output
    return got


def _port_serve(monkeypatch, args):
    got = {}
    monkeypatch.setattr(port_server, 'run', lambda **kw: got.update(kw))
    assert cli.main(['infer', 'serve', *args]) == 0
    return got


@pytest.mark.parametrize('args', [
    [],
    ['--profile', 'latency'],
    ['--profile', 'throughput'],
    ['--profile', 'latency', '--num-slots', '4', '--no-adaptive-window',
     '--prefills-per-gap', '3'],
    ['--profile', 'throughput', '--decode-steps', '2', '--adaptive-window',
     '--decode-lookahead'],
    ['--model', 'llama-debug', '--port', '8201', '--host', '127.0.0.1',
     '--num-slots', '3', '--max-cache-len', '512', '--tokenizer', 'tok',
     '--eos-id', '2', '--decode-steps', '4', '--hf-model', 'ckpt',
     '--cache-dtype', 'fp8', '--tensor-parallel', '2', '--weight-dtype',
     'int8', '--prefills-per-gap', '1', '--max-ttft', '2.5',
     '--max-queue', '7', '--draft-len', '3', '--ngram-max', '2',
     '--max-prefixes', '5', '--lora-rank', '8', '--lora-max-adapters',
     '3', '--adapter-dir', 'adapters', '--adaptive-window',
     '--decode-lookahead', '--auto-prefix', '--qos',
     '--qos-tenant-weights', 'a=3,b=1', '--PLATFORM', 'cpu'],
], ids=['defaults', 'latency', 'throughput', 'latency-overridden',
        'throughput-overridden', 'every-flag'])
def test_serve_forwards_the_references_arguments(monkeypatch, args):
    """The same command line on both: run() gets the same keywords, the
    reference's --platform arriving as the port's --device."""
    jax_args = [a.replace('--PLATFORM', '--platform') for a in args]
    port_args = [a.replace('--PLATFORM', '--device') for a in args]
    want = _jax_serve(monkeypatch, jax_args)
    got = _port_serve(monkeypatch, port_args)
    assert got.pop('device') == want.pop('platform')
    assert got == want


def test_explicit_flags_beat_the_preset(monkeypatch):
    got = _port_serve(monkeypatch, ['--profile', 'latency', '--num-slots',
                                    '4', '--no-decode-lookahead'])
    assert (got['num_slots'], got['decode_steps'],
            got['prefills_per_gap'], got['adaptive_window'],
            got['decode_lookahead']) == (4, 16, 2, True, False)


class _FakeEngine:
    """Records the engine's configuration; benchmarks return nothing."""
    built = []
    spec_stats = {'dispatches': 0, 'drafted': 0, 'accepted': 0}

    def __init__(self, model_config, cfg, **kw):
        self.built.append((model_config, cfg))

    def benchmark(self, **kw):
        return {}

    def benchmark_serving(self, **kw):
        return {}


@pytest.mark.parametrize('args', [
    [], ['--profile', 'latency'],
    ['--profile', 'throughput', '--num-slots', '5', '--adaptive-window'],
    ['--serving', '--draft-len', '3', '--ngram-max', '2',
     '--cache-dtype', 'fp8', '--decode-steps', '4', '--decode-lookahead',
     '--weight-dtype', 'int8']])
def test_bench_builds_the_references_engine(monkeypatch, args):
    import skypilot_tpu.infer as jax_infer
    monkeypatch.setattr(jax_infer, 'InferenceEngine', _FakeEngine)
    monkeypatch.setattr(port_engine_mod, 'InferenceEngine', _FakeEngine)
    _FakeEngine.built = []
    res = CliRunner().invoke(jax_cli.cli, ['infer', 'bench', *args])
    assert res.exit_code == 0, res.output
    assert cli.main(['infer', 'bench', '--device', 'cpu', *args]) == 0
    (jmc, jcfg), (pmc, pcfg) = _FakeEngine.built
    for field in ('model', 'num_slots', 'max_cache_len', 'decode_steps',
                  'prefills_per_gap', 'draft_len', 'ngram_max',
                  'adaptive_decode_window', 'decode_lookahead'):
        assert getattr(pcfg, field) == getattr(jcfg, field), field
    assert str(pcfg.cache_dtype).removeprefix('torch.') == \
        np.dtype(jcfg.cache_dtype).name
    assert (pmc.name, pmc.weight_dtype) == (jmc.name, jmc.weight_dtype)


@pytest.mark.parametrize('extra', [[], ['--serving', '--draft-len', '2']],
                         ids=['offline', 'serving-spec'])
def test_bench_prints_the_references_metric_keys(capsys, extra):
    res = CliRunner().invoke(jax_cli.cli, ['infer', 'bench', *SMALL,
                                           *extra])
    assert res.exit_code == 0, res.output
    want = json.loads(res.output.strip().splitlines()[-1])
    assert cli.main(['infer', 'bench', *SMALL, *extra,
                     '--device', 'cpu']) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    if extra:
        assert {'spec_dispatches', 'spec_drafted', 'spec_accepted'} <= \
            set(got)
