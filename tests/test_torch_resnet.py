"""The port's ResNet (skypilot_tpu_torch/models/resnet.py) and its task
loop (train/tasks.py) held against the JAX package on the CPU, in f32: the
eval and train forwards and the running statistics of a three-stage
bottleneck net on odd and even image sizes; lax's SAME padding at stride 2
(convolution and max pool); the HWIO -> OIHW carry of a flax tree; the
init distributions; and three steps of examples/train_resnet.py's step
(Nesterov SGD under optax's cosine decay) with the batch statistics
after the first and the third."""
import dataclasses
import importlib.util
import math
import pathlib

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models.resnet import ResNet as JaxResNet
from skypilot_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.models.resnet import (BatchNorm, Conv, ResNet,
                                              ResNetConfig, _pad_same,
                                              same_padding)
from skypilot_tpu_torch.train import tasks

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 on both sides; only summation order differs.  The train forward
# normalises with the one-pass batch variance, whose cancellation on a
# small batch at 1x1 spatial size reads up to 2.2e-5 of logits near 1.5.
TOL_EVAL = 1e-5          # absolute, eval logits
TOL_TRAIN = 5e-5         # absolute, train logits
TOL_STATS = 1e-5         # absolute, running mean and variance
TOL_LOSS = 1e-5          # relative, per-step loss
TOL_PARAMS = 1e-5        # absolute, parameters after three SGD steps
SMALL = dict(stage_sizes=(1, 1, 1), width=8, num_classes=5)


def _configs(**kw):
    kw = {**SMALL, **kw}
    return (JaxResNetConfig(name='t', dtype=jnp.float32, **kw),
            ResNetConfig(name='t', dtype=torch.float32, **kw))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _variables(jcfg, images, seed=0, perturb=True):
    """The flax init's params and batch_stats; with `perturb`, every
    BatchNorm scale and running statistic moved off its init (a zero bn3
    scale would hide the residual branch, unit statistics the
    normalisation)."""
    v = _np_tree(flax.linen.meta.unbox(JaxResNet(jcfg).init(
        jax.random.PRNGKey(seed), jnp.asarray(images), train=True)))
    if not perturb:
        return v
    rng = np.random.default_rng(seed + 1)

    def move(path, x):
        key = jax.tree_util.keystr(path)
        if 'scale' in key or 'mean' in key:
            return x + rng.normal(0, 0.3, x.shape).astype(np.float32)
        if "'var'" in key:
            return x * rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, v)


def _port(tcfg, v):
    model = ResNet(tcfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(
        v['params'], tcfg, v['batch_stats']))
    return model


def _running(model):
    return {k: v for k, v in model.state_dict().items() if 'running' in k}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('size', [16, 15])
def test_forward_and_running_statistics_match_flax(size, train):
    """Logits against the flax module's (SAME padding asymmetric at even
    sizes, symmetric at odd); with train=True the batch statistics
    normalise and the running ones become flax's mutated batch_stats
    (momentum 0.9, the biased variance), and with train=False they stay
    as they were."""
    jcfg, tcfg = _configs()
    images = np.random.default_rng(size).normal(
        size=(3, size, size, 3)).astype(np.float32)
    v = _variables(jcfg, images)
    model = _port(tcfg, v)
    before = {k: t.clone() for k, t in _running(model).items()}
    if train:
        want, mutated = JaxResNet(jcfg).apply(
            v, jnp.asarray(images), train=True, mutable=['batch_stats'])
        stats = convert.state_dict_from_jax(
            v['params'], tcfg, _np_tree(mutated['batch_stats']))
    else:
        want = JaxResNet(jcfg).apply(v, jnp.asarray(images), train=False)
        stats = before
    with torch.no_grad():
        got = model(torch.from_numpy(images), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_TRAIN if train else TOL_EVAL)
    for key, t in _running(model).items():
        np.testing.assert_allclose(t.numpy(), stats[key].numpy(), rtol=0,
                                   atol=TOL_STATS, err_msg=key)
    assert train != all(torch.equal(t, before[k])
                        for k, t in _running(model).items())


@pytest.mark.parametrize('size', [8, 9, 2, 1])
def test_same_padding_at_stride_2(size):
    """A 3x3 stride-2 convolution and the stem's max pool on an even or
    odd size against lax's SAME (flax nn.Conv and nn.max_pool): (0, 1) at
    even sizes, where torch's padding=1 would shift every window; an HWIO
    kernel with distinct entries carried as OIHW; the 1x1 stride-2
    projection."""
    assert same_padding(16, 3, 2) == (0, 1)
    assert same_padding(15, 3, 2) == (1, 1)
    assert same_padding(16, 1, 2) == (0, 0)
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    for k in (3, 1):
        kernel = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
        want = nn.Conv(6, (k, k), (2, 2), use_bias=False,
                       dtype=jnp.float32).apply(
            {'params': {'kernel': kernel}}, jnp.asarray(x))
        conv = Conv(4, 6, k, 2, torch.float32, torch.float32)
        conv.weight.data = convert.state_dict_from_jax(
            {'conv_init': {'kernel': kernel}}, ResNetConfig(name='c'),
            batch_stats={})['conv_init.weight']
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding='SAME')
    got = torch.nn.functional.max_pool2d(_pad_same(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, value=-math.inf), 3, 2)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_batchnorm_keeps_flax_semantics():
    """One train forward of BatchNorm against flax nn.BatchNorm
    (momentum 0.9, epsilon 1e-5): the output, and the running variance
    updated with the biased batch variance, where nn.BatchNorm2d's
    unbiased one reads otherwise."""
    x = np.random.default_rng(0).normal(1.0, 2.0, (4, 3, 3, 5)).astype(
        np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mutated = bn.apply(v, jnp.asarray(x), mutable=['batch_stats'])
    mine = BatchNorm(5)
    got = mine(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(mine.running_var.numpy(),
                               np.asarray(mutated['batch_stats']['var']),
                               rtol=1e-6)
    torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1, eps=1e-5)
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.detach().numpy(),
                           mine.running_var.numpy(), rtol=1e-4)


@pytest.mark.parametrize('name', ['small', 'resnet18-debug'])
def test_init_distributions(name):
    """init_params gives the flax init's tensors (names and shapes of the
    converted tree, statistics included): lecun_normal convolutions and
    head (std sqrt(1/fan_in), truncated at 2 sigma of the underlying
    normal), zero head bias, BatchNorm scale 1 (bn3: 0), bias 0, running
    mean 0, variance 1."""
    if name == 'small':
        jcfg, tcfg = _configs()
    else:
        jcfg = dataclasses.replace(jax_model_config(name), dtype=jnp.float32)
        tcfg = dataclasses.replace(registry.get_model_config(name),
                                   dtype=torch.float32)
    images = np.zeros((1, 32, 32, 3), np.float32)
    v = _variables(jcfg, images, perturb=False)
    want = convert.state_dict_from_jax(v['params'], tcfg, v['batch_stats'])
    got = convert.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: t.shape for k, t in got.items()} == \
        {k: t.shape for k, t in want.items()}
    for key, t in got.items():
        if key.endswith('weight'):
            fan_in = math.prod(t.shape[1:])
            std = fan_in ** -0.5
            for w in (t, want[key]):
                n = w.numel()
                assert w.abs().max() <= 2 * std / 0.87962566 + 1e-7, key
                if n >= 64:
                    assert abs(w.std().item() / std - 1) < 6 / n ** 0.5, key
        else:
            assert torch.equal(t, want[key]), key
    ResNet(tcfg, device='cpu').load_state_dict(got)


def _jax_train_step(jcfg, lr, steps, momentum=0.9):
    """examples/train_resnet.py's step, as its main() builds it."""
    model = JaxResNet(jcfg)
    opt = optax.sgd(optax.cosine_decay_schedule(lr, steps),
                    momentum=momentum, nesterov=True)

    def loss_fn(params, batch_stats, images, labels):
        logits, mutated = model.apply(
            {'params': params, 'batch_stats': batch_stats}, images,
            train=True, mutable=['batch_stats'])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        acc = (jnp.argmax(logits, -1) == labels).mean()
        return loss, (acc, mutated['batch_stats'])

    @jax.jit
    def step(state, opt_state, batch):
        (loss, (acc, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state['params'], state['batch_stats'],
                                   batch['images'], batch['labels'])
        updates, opt_state = opt.update(grads, opt_state, state['params'])
        params = optax.apply_updates(state['params'], updates)
        return ({'params': params, 'batch_stats': stats}, opt_state,
                loss, acc)

    return opt, step


def test_three_sgd_steps_match_the_example():
    """tasks.resnet_step against the JAX example's step from the same
    variables and batches (tasks.synthetic_resnet_batches, checked equal
    to the example's generator): loss and accuracy each step, the running
    statistics after the first and the third, every parameter after the
    third; the three updates ran at lr * 0.5 * (1 + cos(pi t / steps)) for
    t = 0, 1, 2."""
    jcfg, tcfg = _configs(num_classes=4)
    lr, steps = 0.1, 5
    spec = importlib.util.spec_from_file_location(
        'train_resnet', ROOT / 'examples' / 'train_resnet.py')
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    mine = tasks.synthetic_resnet_batches(0, 0, 6, 16, 4)
    theirs = example.synthetic_batches(0, 0, 6, 16, 4)
    batches = [next(mine) for _ in range(3)]
    for b in batches:
        ref = next(theirs)
        assert all(np.array_equal(b[k], ref[k]) for k in ref)
    v = _variables(jcfg, batches[0]['images'], seed=2, perturb=False)
    state = tasks.resnet_setup(tcfg, lr, 0.9, steps, device='cpu',
                               params=convert.state_dict_from_jax(
                                   v['params'], tcfg, v['batch_stats']))
    opt, jstep = _jax_train_step(jcfg, lr, steps)
    jstate = jax.tree.map(jnp.asarray, v)
    js = opt.init(jstate['params'])
    rates = []
    for i, batch in enumerate(batches):
        rates.append(state.optimizer.param_groups[0]['lr'])
        jstate, js, jloss, jacc = jstep(jstate, js,
                                        jax.tree.map(jnp.asarray, batch))
        loss, acc = tasks.resnet_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL_LOSS)
        assert acc.item() == float(jacc)
        if i in (0, 2):
            want = convert.state_dict_from_jax(
                _np_tree(jstate['params']), tcfg,
                _np_tree(jstate['batch_stats']))
            for key, t in _running(state.model).items():
                np.testing.assert_allclose(t.numpy(), want[key].numpy(),
                                           rtol=0, atol=TOL_STATS,
                                           err_msg=key)
    np.testing.assert_allclose(rates, [
        lr * 0.5 * (1 + math.cos(math.pi * t / steps)) for t in range(3)])
    for key, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=0, atol=TOL_PARAMS, err_msg=key)


def test_train_loop_prints_the_example_lines(capsys):
    """train_resnet on the CPU at resnet18-debug: the example's lines, a
    loss that falls on the learnable synthetic classes, and an env that
    claims more than one process with no address to join refused (the
    loop runs data-parallel over a process group:
    tests/test_torch_tasks_dist.py)."""
    out = tasks.train_resnet('resnet18-debug', steps=11, batch_size=8,
                             image_size=16, num_classes=4, device='cpu')
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in lines] == \
        ['step 0', 'step 10', 'done']
    assert 'images/s, final acc' in lines[-1]
    assert out['history'][-1][1] < out['history'][0][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('WORLD_SIZE', '2')
        mp.delenv('MASTER_ADDR', raising=False)
        with pytest.raises(ValueError, match='MASTER_ADDR'):
            tasks.train_resnet('resnet18-debug', steps=1, device='cpu')
