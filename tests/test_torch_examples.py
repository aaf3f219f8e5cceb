"""The example twins held against the JAX examples on the CPU:

- examples/mnist_torch.py's ConvNet over the flax ConvNet's weights
  (examples/mnist_jax.py, loaded by path) gives its logits within 1e-5,
  and three Adam steps on the reference's synthetic batches give optax's
  losses within 1e-5 relative; the twin's batches are the reference's;
- the MNIST twin's main trains 3 steps on one rank and prints the
  reference's lines;
- examples/allreduce_bench_torch.py over 2 gloo ranks (torchrun) prints
  the reference's algbw/busbw lines with busbw > 0;
- neither writes a file."""
import contextlib
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load('mnist_jax', 'examples/mnist_jax.py')
TWIN = _load('mnist_torch', 'examples/mnist_torch.py')


def _port_state(params) -> dict:
    """The flax ConvNet's params as the twin's state_dict: conv kernels
    [kh, kw, in, out] -> [out, in, kh, kw], dense [in, out] -> [out, in]."""
    def t(x, perm):
        return torch.from_numpy(np.asarray(x, np.float32).transpose(perm)
                                .copy())
    sd = {}
    for flax_name, name, perm in (('Conv_0', 'conv1', (3, 2, 0, 1)),
                                  ('Conv_1', 'conv2', (3, 2, 0, 1)),
                                  ('Dense_0', 'dense1', (1, 0)),
                                  ('Dense_1', 'dense2', (1, 0))):
        sd[f'{name}.weight'] = t(params[flax_name]['kernel'], perm)
        sd[f'{name}.bias'] = t(params[flax_name]['bias'], (0,))
    return sd


def test_synthetic_batches_are_the_references():
    for (xa, ya), (xb, yb), _ in zip(REF.synthetic_batches(8, seed=3),
                                     TWIN.synthetic_batches(8, seed=3),
                                     range(3)):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


def test_convnet_and_three_adam_steps_match_flax():
    hidden = 8
    model = REF.ConvNet(hidden=hidden)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 28, 28, 1)))['params']
    net = TWIN.ConvNet(hidden=hidden)
    net.load_state_dict(_port_state(params))
    x, y = next(REF.synthetic_batches(16, seed=1))
    want = np.asarray(model.apply({'params': params}, x))
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())

    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            logits = model.apply({'params': p}, x)
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, 10)).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    port_step = TWIN.make_step(net, torch.optim.Adam(net.parameters(),
                                                     lr=1e-3))
    data = REF.synthetic_batches(16, seed=2)
    for _ in range(3):
        x, y = next(data)
        params, opt_state, loss = step(params, opt_state, x, y)
        mine = port_step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(mine.item(), float(loss), rtol=TOL)
    want = np.asarray(model.apply({'params': params}, x))
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_mnist_main_trains_and_prints_the_reference_lines(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TWIN.main(['--device', 'cpu', '--steps', '3', '--batch-size', '32',
                   '--hidden', '8'])
    lines = buf.getvalue().splitlines()
    assert re.fullmatch(r'step 3: loss \d+\.\d{4}', lines[0])
    assert re.fullmatch(r'throughput: [\d,]+ images/s on 1 device\(s\)',
                        lines[1])
    assert not os.listdir(tmp_path)


def test_allreduce_over_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    out = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', '2',
         str(ROOT / 'examples' / 'allreduce_bench_torch.py'),
         '--device', 'cpu', '--payload-mb', '2', '--trials', '2'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '(2 trials, 2 devices, bfloat16)' in out.stdout
    algbw = float(re.search(r' algbw: ([\d.]+) GBps', out.stdout).group(1))
    busbw = float(re.search(r' busbw: ([\d.]+) GBps', out.stdout).group(1))
    assert algbw > 0 and busbw == pytest.approx(algbw, rel=1e-2)
    assert not os.listdir(tmp_path)
