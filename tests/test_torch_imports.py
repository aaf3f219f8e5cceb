"""The port (skypilot_tpu_torch, with bench_torch.py and chip_smoke.py)
stands alone: it imports neither JAX nor anything of the JAX package,
and its entry points need a card unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'skypilot_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'skypilot_tpu')
# The PyTorch twins of the JAX examples, imported as modules of examples/.
EXAMPLES = ['examples.finetune_bert_torch', 'examples.train_resnet_torch',
            'examples.train_llama_torch', 'examples.finetune_llama31_torch']
# The twins of the JAX package's bench scripts, examples and skycheck
# driver, by path.
TWINS = ['scripts/bench_decode_micro_torch.py',
         'scripts/bench_speculative_torch.py',
         'scripts/bench_features_torch.py',
         'scripts/bench_serve_lb_torch.py',
         'examples/mnist_torch.py', 'examples/allreduce_bench_torch.py',
         'scripts/skycheck_torch.py']
# The only functions of a twin that import the JAX package's (JAX-free)
# serve plane: the LB and serve-up sections, which run where its
# dependencies are installed.
LB_SECTIONS = {'scripts/bench_features_torch.py': {'bench_lb_affinity'},
               'scripts/bench_serve_lb_torch.py': {'serve_up', 'run_sweep',
                                                   'run_batch_bench'}}


def _port_modules():
    return sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts).removesuffix(
            '.__init__')
        for p in PACKAGE.rglob('*.py'))


def _forbidden(name: str) -> bool:
    """True for a forbidden top-level package or any of its submodules;
    skypilot_tpu_torch shares a prefix with skypilot_tpu and is allowed."""
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def test_forbidden_matcher_spares_the_port():
    assert _forbidden('skypilot_tpu') and _forbidden('skypilot_tpu.ops')
    assert _forbidden('jax.numpy') and _forbidden('flax')
    assert not _forbidden('skypilot_tpu_torch')
    assert not _forbidden('skypilot_tpu_torch.ops.flash_attention')
    assert not _forbidden('jaxtyping')


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter: import every module of the port, then no
    jax/flax/optax and no skypilot_tpu(.*) may be in sys.modules."""
    modules = _port_modules() + ['bench_torch'] + EXAMPLES
    assert 'skypilot_tpu_torch.ops.flash_attention' in modules
    assert 'skypilot_tpu_torch.infer.engine' in modules
    assert 'skypilot_tpu_torch.train.trainer' in modules
    assert 'skypilot_tpu_torch.train.lora' in modules
    assert {'skypilot_tpu_torch.train.tasks',
            'skypilot_tpu_torch.models.bert',
            'skypilot_tpu_torch.models.resnet'} <= set(modules)
    assert {'skypilot_tpu_torch.infer.server',
            'skypilot_tpu_torch.infer.scheduler',
            'skypilot_tpu_torch.infer.faults',
            'skypilot_tpu_torch.infer.radix',
            'skypilot_tpu_torch.infer.block_pool',
            'skypilot_tpu_torch.infer.qos',
            'skypilot_tpu_torch.models.quantize',
            'skypilot_tpu_torch.models.hf_import'} <= set(modules)
    assert {'skypilot_tpu_torch.parallel.mesh',
            'skypilot_tpu_torch.parallel.pipeline',
            'skypilot_tpu_torch.ops.ring_attention',
            'skypilot_tpu_torch.data.loader'} <= set(modules)
    assert {'skypilot_tpu_torch.analysis.sanitizers',
            'skypilot_tpu_torch.infer.chaos',
            'skypilot_tpu_torch.cli'} <= set(modules)
    assert {f'skypilot_tpu_torch.analysis.{m}' for m in (
        'findings', 'walker', 'lock_discipline', 'jit_boundary',
        'layering', 'determinism', 'dataflow', 'block_lifecycle',
        'wire_contract', 'shard_contract')} <= set(modules)
    code = (
        'import importlib, json, sys\n'
        f'for m in {modules!r}:\n'
        '    importlib.import_module(m)\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = set(__import__('json').loads(out.stdout.splitlines()[-1]))
    assert set(modules) <= loaded
    assert not sorted(m for m in loaded if _forbidden(m))


def test_chaos_twin_loads_no_jax():
    """scripts/chaos_smoke_torch.py composes the port with the serve
    plane (imported inside its replica and batch legs): importing it, and
    the serve plane it hands to ChaosFleet, loads no jax* module."""
    code = (
        'import importlib.util, json, sys\n'
        'spec = importlib.util.spec_from_file_location(\n'
        "    'chaos_smoke_torch', 'scripts/chaos_smoke_torch.py')\n"
        'mod = importlib.util.module_from_spec(spec)\n'
        'spec.loader.exec_module(mod)\n'
        'mod.lb_factory()\n'
        'import skypilot_tpu.serve.batch\n'
        'import skypilot_tpu_torch.infer.chaos\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = set(__import__('json').loads(out.stdout.splitlines()[-1]))
    assert 'skypilot_tpu_torch.infer.chaos' in loaded
    assert 'skypilot_tpu.serve.load_balancer' in loaded
    assert not sorted(m for m in loaded
                      if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                             'optax'))


@pytest.mark.parametrize('path', sorted(
    [str(p.relative_to(ROOT)) for p in PACKAGE.rglob('*.py')] +
    ['bench_torch.py', 'chip_smoke.py', 'tests/test_torch_card.py',
     'scripts/skycheck_torch.py'] +
    [m.replace('.', '/') + '.py' for m in EXAMPLES]))
def test_sources_import_no_jax(path):
    """No import statement anywhere in the file -- including ones inside
    functions -- names a forbidden package."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_entry_points_need_a_card():
    """device=None means the card; without one every entry point raises
    RuntimeError instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is visible')
    import bench_torch
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.entry import entry
    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.infer.engine import (InferConfig,
                                                 InferenceEngine,
                                                 engine_from_name)
    from skypilot_tpu_torch.models import get_model_config
    from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  synthetic_data)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        engine_from_name('llama-debug', InferConfig(max_cache_len=64))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        InferenceEngine(get_model_config('llama-debug'),
                        InferConfig(max_cache_len=64))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        InferenceEngine(get_model_config('llama-debug'),
                        InferConfig(max_cache_len=64, kv_block_size=16,
                                    auto_prefix_cache=True,
                                    host_kv_bytes=1 << 20))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.run(model='llama-debug', max_cache_len=64)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.run(model='llama-debug', max_cache_len=64,
                   kv_block_size=16, auto_prefix_cache=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(TrainConfig(model='llama-debug'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(TrainConfig(model='llama-debug'), dataclasses.replace(
            get_model_config('llama-debug'), lora_rank=4))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.run(model='llama-debug', max_cache_len=64, lora_rank=4,
                   adapter_dir='.')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.run(model='llama-debug', max_cache_len=64,
                   weight_dtype='int8')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.run(model='llama-debug', max_cache_len=64, qos=True,
                   qos_tenant_weights='a=3,b=1')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        next(synthetic_data(1, 8, 16))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench_torch.measure('llama-debug', seq_len=64, batch_per_chip=1)
    from skypilot_tpu_torch.train import tasks
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tasks.finetune_bert('bert-debug', steps=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tasks.train_resnet('resnet18-debug', steps=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(TrainConfig(model='mixtral-debug'), dataclasses.replace(
            get_model_config('mixtral-debug'), lora_rank=4))
    from skypilot_tpu_torch.entry import dryrun_multichip
    from skypilot_tpu_torch.parallel.mesh import (MeshSpec,
                                                  ensure_process_group)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(TrainConfig(model='llama-debug', mesh=MeshSpec()))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ensure_process_group()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dryrun_multichip(1)
    assert resolve_device('cpu') == torch.device('cpu')


def test_bench_torch_refuses_to_run_without_a_card():
    """python3 bench_torch.py exits non-zero and prints no JSON line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is visible')
    out = subprocess.run([sys.executable, 'bench_torch.py'], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"metric"' not in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is visible')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _loaded_after(code: str, timeout: float = 240) -> set:
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(__import__('json').loads(out.stdout.splitlines()[-1]))


def test_twins_import_no_jax_nor_the_jax_package():
    """Each twin, imported by path in a fresh interpreter, loads no jax*
    module and nothing of skypilot_tpu."""
    code = (
        'import importlib.util, json, sys\n'
        f'for i, path in enumerate({TWINS!r}):\n'
        "    spec = importlib.util.spec_from_file_location(f'twin{i}', path)\n"
        '    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    loaded = _loaded_after(code)
    assert 'skypilot_tpu_torch.infer.engine' in loaded
    assert not sorted(m for m in loaded if _forbidden(m))


@pytest.mark.parametrize('path', TWINS)
def test_twins_import_the_serve_plane_only_in_lb_sections(path):
    """No import statement of a twin names jax, flax or optax; skypilot_tpu
    only inside its LB sections' functions."""
    tree = ast.parse((ROOT / path).read_text())
    allowed = LB_SECTIONS.get(path, set())
    for fn in [None] + [n for n in ast.walk(tree)
                        if isinstance(n, ast.FunctionDef)]:
        body = tree.body if fn is None else fn.body
        names = []
        for node in (ast.walk(ast.Module(body=body, type_ignores=[]))
                     if fn is not None else body):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        bad = [n for n in names if _forbidden(n)]
        if fn is not None and fn.name in allowed:
            bad = [n for n in bad if not n.startswith('skypilot_tpu')]
        assert not bad, (fn and fn.name, bad)


def test_card_capable_modes_load_no_jax_package():
    """The modes that run on the card, driven on the CPU at tiny size in
    one fresh interpreter: the decode-micro fit and paged sweep, the
    speculation bench, the feature sections but LB affinity, the sweep
    through --endpoint against a port server, MNIST and the all-reduce on
    one rank.  Afterwards no jax* module and nothing of skypilot_tpu is
    loaded."""
    code = """
import contextlib, importlib.util, io, json, sys, threading, time
import torch
from urllib.request import urlopen
torch.set_num_threads(1)

def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

from skypilot_tpu_torch.infer import engine, server
from skypilot_tpu_torch.infer.chaos import free_port
from skypilot_tpu_torch.models.llama import LlamaConfig
quiet = contextlib.redirect_stdout(io.StringIO())
with quiet:
    micro = load('micro', 'scripts/bench_decode_micro_torch.py')
    assert micro.main(['--device', 'cpu', '--model', 'llama-debug',
                       '--weight-dtype', 'bf16', '--cache-dtype', 'float32',
                       '--num-slots', '2', '--max-cache-len', '256',
                       '--prompt-len', '40', '--windows', '1', '2',
                       '--reps', '1', '--prefill-chunk', '0']) == 0
    assert micro.main(['--paged', '--device', 'cpu', '--fill-sweep',
                       '32']) == 0
    spec = load('spec', 'scripts/bench_speculative_torch.py')
    assert spec.main(['--model', 'llama-debug', '--device', 'cpu',
                      '--steps', '1', '--requests', '1']) == 0
    feat = load('feat', 'scripts/bench_features_torch.py')
    feat._model_config = lambda: LlamaConfig(
        name='t', vocab_size=32000, hidden_size=16, intermediate_size=32,
        num_layers=1, num_heads=2, num_kv_heads=1, max_seq_len=2048,
        tie_embeddings=True, dtype=torch.float32, weight_dtype='int8')
    assert feat.main(['--device', 'cpu', '--no-lb', '--reps', '1',
                      '--prefill-chunk', '0', '--spec-requests', '2',
                      '--spec-new-tokens', '8']) == 0
    eng = engine.InferenceEngine(
        LlamaConfig(name='t', vocab_size=32000, hidden_size=16,
                    intermediate_size=32, num_layers=1, num_heads=2,
                    num_kv_heads=1, max_seq_len=128, dtype=torch.float32),
        engine.InferConfig(max_cache_len=64, num_slots=4,
                           cache_dtype=torch.float32), device='cpu')
    port = free_port()
    t = threading.Thread(target=server.serve, args=(eng,), daemon=True,
                         kwargs=dict(host='127.0.0.1', port=port))
    t.start()
    for _ in range(600):
        try:
            urlopen(f'http://127.0.0.1:{port}/healthz', timeout=5)
            break
        except OSError:
            time.sleep(0.05)
    lb = load('lb', 'scripts/bench_serve_lb_torch.py')
    lb.PROMPT_LEN, lb.NEW_TOKENS = 8, 4
    assert lb.main(['--endpoint', f'http://127.0.0.1:{port}', '--qps',
                    '100', '--requests-per-qps', '1']) == 0
    load('mnist', 'examples/mnist_torch.py').main(
        ['--device', 'cpu', '--steps', '1', '--batch-size', '8',
         '--hidden', '4'])
    load('allreduce', 'examples/allreduce_bench_torch.py').main(
        ['--device', 'cpu', '--payload-mb', '1', '--trials', '1'])
print(json.dumps(sorted(sys.modules)))
"""
    loaded = _loaded_after(code, timeout=600)
    assert 'skypilot_tpu_torch.infer.server' in loaded
    assert not sorted(m for m in loaded if _forbidden(m))
