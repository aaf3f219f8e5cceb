"""scripts/bench_speculative_torch.py held against the reference script
(scripts/bench_speculative.py, loaded by path) on the CPU:

- induction_batches, grounded_requests and random_requests give the
  reference's bytes;
- two train steps of a tiny model on the induction batches, from the JAX
  state's params, give the JAX make_train_step's losses within 1e-5
  relative (both f32);
- the script's main runs end to end at llama-debug size and writes no
  file without --out.

tests/test_torch_bench_speculative_engine.py holds run_engine."""
import contextlib
import importlib.util
import io
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import LlamaConfig

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_LOSS = 1e-5
# A tiny llama the run_engine config fits (max_cache_len 256).
GEOMETRY = dict(name='induct-test', vocab_size=101, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=256, tie_embeddings=True)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('bench_speculative', 'scripts/bench_speculative.py')
TWIN = _load('bench_speculative_torch', 'scripts/bench_speculative_torch.py')


@pytest.fixture
def tiny(monkeypatch):
    """Both scripts' model_config give the f32 tiny llama."""
    jcfg = JaxLlamaConfig(**GEOMETRY, dtype='float32')
    pcfg = LlamaConfig(**GEOMETRY, dtype=torch.float32)
    for mod, cfg in ((REF, jcfg), (TWIN, pcfg)):
        monkeypatch.setattr(mod, 'MODEL', GEOMETRY['name'])
        monkeypatch.setattr(mod, 'model_config', lambda name, c=cfg: c)
    return jcfg, pcfg


@pytest.mark.parametrize('batch,vocab,seed', [(32, 32000, 0), (3, 101, 5)])
def test_induction_batches_are_the_references(batch, vocab, seed):
    want, got = (mod.induction_batches(batch, vocab, seed)
                 for mod in (REF, TWIN))
    for _ in range(6):
        a, b = next(want)['tokens'], next(got)['tokens']
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert a.shape == (batch, 2 * REF.SEG + 1)


@pytest.mark.parametrize('fn', ['grounded_requests', 'random_requests'])
def test_requests_are_the_references(fn):
    want = getattr(REF, fn)(32, 32000)
    got = getattr(TWIN, fn)(32, 32000)
    assert [(r.tokens, r.max_new_tokens) for r in got] == \
        [(r.tokens, r.max_new_tokens) for r in want]


def test_two_train_steps_match_jax(tiny, monkeypatch):
    """The twin's train() from the JAX state's params against the
    reference's own pieces (its config, TrainConfig, create_sharded_state
    and make_train_step(loss_chunk=128)) on its induction batches."""
    jcfg, pcfg = tiny
    for mod in (REF, TWIN):
        monkeypatch.setattr(mod, 'SEG', 16)
    batch = 4
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    tcfg = jt.TrainConfig(model=REF.MODEL, batch_size=batch,
                          seq_len=2 * REF.SEG, learning_rate=6e-4,
                          warmup_steps=100, total_steps=2)
    state, _ = jt.create_sharded_state(jcfg, tcfg, mesh,
                                       jax.random.PRNGKey(0))
    sd = convert.state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), state.params),
        pcfg)
    step = jt.make_train_step(mesh, loss_chunk=128)
    data = REF.induction_batches(batch, jcfg.vocab_size)
    want = []
    with mesh:
        for _ in range(2):
            state, metrics = step(state, next(data))
            want.append(float(metrics['loss']))
    with contextlib.redirect_stdout(io.StringIO()):
        params, losses, info = TWIN.train(2, device='cpu', batch=batch,
                                          params=sd)
    got = [loss for _, loss in info['step_losses']]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert losses == [round(x, 3) for x in got]
    assert info['flash_launches_per_step'] == [[0, 0, 0]] * 2  # CPU
    assert all(v.dtype == torch.bfloat16 for v in params.values())


def test_main_runs_and_writes_no_file(tmp_path, monkeypatch):
    """llama-debug end to end on the CPU: train, four engine rows, the
    last stdout line the whole report; nothing written without --out."""
    monkeypatch.chdir(tmp_path)
    for name in ('SEG', 'DOC', 'NEW', 'MODEL'):
        monkeypatch.setattr(TWIN, name, getattr(TWIN, name))
    monkeypatch.setattr(TWIN, 'BATCH', 4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TWIN.main(['--model', 'llama-debug', '--device', 'cpu',
                          '--steps', '2', '--requests', '2']) == 0
    assert not os.listdir(tmp_path)
    doc = json.loads(buf.getvalue().splitlines()[-1])
    assert doc['train_steps'] == 2 and len(doc['train_loss_trajectory']) == 2
    assert doc['flash_launches_fwd_dq_dkv'] == [0, 0, 0]
    for label in ('grounded_draft_0', 'grounded_draft_4', 'grounded_draft_7',
                  'ungrounded_draft_4'):
        st = doc[label]['spec']
        assert st['accepted'] <= st['drafted']
    assert 'copy_fidelity' in doc['grounded_draft_7']
