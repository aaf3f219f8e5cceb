"""bench_torch.py, the port's twin of bench.py, and the FLOPs accounting
it rests on: num_params and flops_per_token equal the JAX package's for
every causal-LM config (llama family, GPT-2, Mixtral), measure() runs the trainer at a
sequence past the config's max_seq_len (as the headline point runs
llama-800m at 8192 past its 4096), and main()'s JSON line has bench.py's
keys."""
import json
import math

import pytest
import torch

import bench_torch
from skypilot_tpu.models import registry as jax_registry
from skypilot_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.models.llama import LlamaConfig

JAX_LLAMAS = [n for n in jax_registry.list_models()
              if type(jax_registry.get_model_config(n)) is JaxLlamaConfig]
# Every causal LM of the JAX registry: the llama family, GPT-2, Mixtral.
JAX_CAUSAL = [n for n in jax_registry.list_models()
              if jax_registry.is_causal_lm(jax_registry.get_model_config(n))]

# The keys of bench.py's JSON line, written out (bench.py is not run).
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'detail'}
BENCH_DETAIL_KEYS = {'bench_model', 'devices', 'platform',
                     'headline_seq_len', 'seq8192', 'seq2048', 'baseline'}
BENCH_POINT_KEYS = {'batch_per_chip', 'raw_tokens_per_sec_per_chip',
                    'window_spread_tok_s_per_chip',
                    'achieved_tflops_per_chip', 'mfu', 'final_loss'}


def test_the_port_has_every_llama_family_config():
    """The port's llama-family configs are the JAX registry's; its causal
    LMs are the JAX registry's causal LMs, and the whole registry holds
    every name of the JAX registry (the encoder and vision families
    too), no more."""
    llamas = [n for n, c in registry._CONFIGS.items()
              if isinstance(c, LlamaConfig)]
    assert sorted(llamas) == JAX_LLAMAS
    assert sorted(n for n, c in registry._CONFIGS.items()
                  if registry.is_causal_lm(c)) == JAX_CAUSAL
    assert sorted(registry._CONFIGS) == jax_registry.list_models()


@pytest.mark.parametrize('name', JAX_CAUSAL)
def test_flops_accounting_equals_the_reference(name):
    ref = jax_registry.get_model_config(name)
    cfg = registry.get_model_config(name)
    assert cfg.num_params == ref.num_params
    for s in (2048, 8192):
        assert cfg.flops_per_token(s) == ref.flops_per_token(s)


def test_measure_past_max_seq_len_on_the_cpu():
    """llama-debug (max_seq_len 256) trained at seq 512: finite
    throughput, loss and TFLOP/s; no kernel launch on the CPU."""
    cfg = registry.get_model_config('llama-debug')
    assert cfg.max_seq_len < 512
    tps, spread, loss, tflops, launches = bench_torch.measure(
        'llama-debug', seq_len=512, batch_per_chip=2, steps=1, windows=1,
        device='cpu')
    assert tps > 0 and math.isfinite(tps) and len(spread) == 1
    assert math.isfinite(loss) and 0 < loss < 2 * math.log(cfg.vocab_size)
    assert tflops == pytest.approx(tps * cfg.flops_per_token(512) / 1e12)
    assert launches == (0, 0, 0)


def test_json_line_has_bench_py_keys(monkeypatch, capsys):
    """main() with measure() and the card stubbed: bench.py's keys at
    every level, plus the card's name, power limit, peak, MFU, the f32
    matmul precision and the kernels' launch counts; the value is the
    llama3-8b equivalent of the seq-8192 point."""
    from skypilot_tpu_torch import device as device_mod
    points = {8192: (24000.0, [23900.0, 24000.0, 24100.0], 10.4, 195.5,
                     (64, 32, 32)),
              2048: (33000.0, [33000.0] * 3, 10.4, 190.0, (64, 32, 32))}
    monkeypatch.setattr(bench_torch, 'measure',
                        lambda model, seq_len, batch_per_chip: points[seq_len])
    monkeypatch.setattr(device_mod, 'resolve_device',
                        lambda device=None: torch.device('cpu'))
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda device=None: 'NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(bench_torch, 'card_identity',
                        lambda: 'NVIDIA H100 80GB HBM3, 700.00 W')
    precision = torch.get_float32_matmul_precision()
    try:
        bench_torch.main()
    finally:
        torch.set_float32_matmul_precision(precision)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == BENCH_KEYS
    assert out['metric'] == 'llama3_8b_equiv_train_tokens_per_sec_per_chip'
    detail = out['detail']
    assert BENCH_DETAIL_KEYS <= set(detail)
    assert set(detail) - BENCH_DETAIL_KEYS == {
        'device_kind', 'nvidia_smi', 'peak_tflops', 'f32_matmul_precision'}
    assert detail['platform'] == 'gpu' and detail['peak_tflops'] == 989.0
    assert detail['nvidia_smi'].endswith('700.00 W')
    assert detail['f32_matmul_precision'] == bench_torch.F32_MATMUL_PRECISION
    for key, batch in (('seq8192', 6), ('seq2048', 24)):
        pt = detail[key]
        assert set(pt) - BENCH_POINT_KEYS == {'flash_launches_fwd_dq_dkv'}
        assert pt['batch_per_chip'] == batch
        assert 0 < pt['mfu'] < 1.05
    want = 195.5e12 / registry.get_model_config(
        'llama3-8b').flops_per_token(8192)
    assert out['value'] == round(want, 2)
    assert out['vs_baseline'] == round(want / (0.476 * 8192 / 8), 3)
