"""The port's GPT-2 (skypilot_tpu_torch/models/gpt2.py) held against the
JAX package's on the CPU, in f32: the LayerNorm against flax's and
torch's, the logits and hidden states (the no-cache path attends through
the flash kernel's plain version), the cached forward, the over-long
ValueError, positions past the ``wpe`` table (clamped as the JAX gather
clamps them), the engine's greedy streams against the JAX engine's
(dense, chunked prefill, the fp8 cache, a lane decoding past the last
position), three train steps against JAX ``make_train_step`` and a
checkpoint resume."""
import dataclasses
import itertools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from helpers_torch import features_match
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.models import get_model_config as jax_model_config
from skypilot_tpu.models import gpt2 as jgpt2
from skypilot_tpu.models.llama import init_cache as jax_init_cache
from skypilot_tpu.parallel.mesh import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert, gpt2, llama, registry
from skypilot_tpu_torch.train import trainer as tt

# f32 on both sides: only summation order differs.
TOL_LOGITS = 1e-5
TOL_LOGPROB = 1e-4
TOL_LOSS = 1e-5          # relative, loss and grad_norm
TOL_PARAMS = 1e-6        # absolute, after three AdamW steps
# LayerNorm on f32 inputs of mean 3 and std 1: flax's one-pass variance
# E[x^2] - E[x]^2 cancels ~10 against ~9, so an ulp of E[x^2] (~1e-6) is
# ~1e-6 of the variance; each one-pass implementation (flax's, the port's)
# lands ~3e-6 from the float64 value, the two apart by up to twice that,
# and torch's two-pass layer_norm within 1e-6 of it.  Zero-mean inputs
# cancel nothing: there the port and flax agree to 1e-6.
TOL_LN_MEAN3 = 1e-5
TOL_LN = 1e-6

JAX_CFG = dataclasses.replace(jax_model_config('gpt2-debug'),
                              dtype=jnp.float32)
PORT_CFG = dataclasses.replace(registry.get_model_config('gpt2-debug'),
                               dtype=torch.float32)
WEIGHT_SCALE = 10.0
ENGINE = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16),
              max_new_tokens=8, decode_steps=1)
PROMPT_LENS = (3, 7, 12, 5, 30)
MAX_NEW = (8, 6, 8, 1, 8)


@pytest.fixture(scope='module')
def params():
    """numpy params['params'] of gpt2-debug at std 0.02 * WEIGHT_SCALE
    (LayerNorm scales and biases drawn too)."""
    shapes = flax.linen.meta.unbox(jax.eval_shape(
        jgpt2.GPT2(JAX_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))['params']
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda x: rng.normal(
        0, 0.02 * WEIGHT_SCALE, x.shape).astype(np.float32), shapes)


def _port_model(params, cfg=PORT_CFG):
    model = gpt2.GPT2(cfg, device='cpu')
    model.load_state_dict(convert.state_dict_from_jax(params, cfg))
    return model


def test_layer_norm_matches_flax_and_torch():
    """gpt2.layer_norm (f32 out) against flax's LayerNorm(dtype=float32)
    and torch's layer_norm on f32 and bf16 inputs: zero-mean within
    TOL_LN, mean 3 within TOL_LN_MEAN3 (see there)."""
    rng = np.random.default_rng(0)
    scale = rng.normal(1.0, 0.3, 64).astype(np.float32)
    bias = rng.normal(0.0, 0.3, 64).astype(np.float32)
    ln = flax.linen.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
    p = {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}}
    args = (torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    for mean, tol in ((0.0, TOL_LN), (3.0, TOL_LN_MEAN3)):
        x = (mean + rng.normal(size=(4, 64))).astype(np.float32)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            xt = torch.from_numpy(x).to(dt)
            want = np.asarray(ln.apply(p, jnp.asarray(x).astype(jdt)))
            got = gpt2.layer_norm(xt, *args)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
            ref = F.layer_norm(xt.float(), (64,), *args)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=tol)


def test_logits_and_hidden_match_jax(params):
    tokens = np.random.default_rng(4).integers(0, 256, (2, 40))
    model = _port_model(params)
    jm = jgpt2.GPT2(JAX_CFG)
    with torch.no_grad():
        for hidden_only in (False, True):
            want = np.asarray(jm.apply({'params': params},
                                       jnp.asarray(tokens),
                                       hidden_only=hidden_only))
            got = model(torch.from_numpy(tokens), hidden_only=hidden_only)
            assert got.dtype == torch.float32
            assert 1.0 < np.abs(want).max() < 50.0
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=TOL_LOGITS)


def test_over_long_input_raises_the_jax_error(params):
    tokens = np.zeros((1, 129), np.int64)
    texts = []
    for call in (lambda: jgpt2.GPT2(JAX_CFG).apply({'params': params},
                                                   jnp.asarray(tokens)),
                 lambda: _port_model(params)(torch.from_numpy(tokens))):
        with pytest.raises(ValueError) as e:
            call()
        texts.append(str(e.value))
    assert texts[0] == texts[1] == \
        'sequence length 129 exceeds max_seq_len 128'


def test_cached_forward_and_positions_past_the_table(params):
    """Prefill 12 tokens, then single steps, through the cache against
    the flax module's cached forward and the no-cache logits; then a lane
    at positions past max_seq_len (126..131) and negative ones (-1, -130),
    which the jitted JAX gather wraps and clamps (as the JAX engine runs
    it; eager indexing raises), against the flax module."""
    tokens = np.random.default_rng(5).integers(0, 256, (2, 14))
    jm = jgpt2.GPT2(JAX_CFG)
    model = _port_model(params)
    jcache = jax_init_cache(JAX_CFG, 2, 136, jnp.float32)
    cache = llama.init_cache(PORT_CFG, 2, 136, torch.float32)
    got, want = [], []
    for lo, hi in ((0, 12), (12, 13), (13, 14)):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo)).copy()
        jl, jcache = jm.apply({'params': params},
                              jnp.asarray(tokens[:, lo:hi]),
                              jnp.asarray(pos), jcache)
        with torch.no_grad():
            tl, cache = model(torch.from_numpy(tokens[:, lo:hi]),
                              torch.from_numpy(pos), cache)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    got = np.concatenate(got, 1)
    np.testing.assert_allclose(got, np.concatenate(want, 1), rtol=0,
                               atol=TOL_LOGITS)
    with torch.no_grad():
        full = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=TOL_LOGITS)
    for pos in (np.arange(126, 132)[None].repeat(2, 0),
                np.array([[-1, 0, 1, 2, 3, 4], [-130, 5, 6, 7, 8, 9]])):
        jcache = jax_init_cache(JAX_CFG, 2, 136, jnp.float32)
        cache = llama.init_cache(PORT_CFG, 2, 136, torch.float32)
        jl, _ = jax.jit(jm.apply)({'params': params},
                                  jnp.asarray(tokens[:, :6]),
                                  jnp.asarray(pos), jcache)
        with torch.no_grad():
            tl, _ = model(torch.from_numpy(tokens[:, :6]),
                          torch.from_numpy(pos), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL_LOGITS)


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


ENGINE_CASES = {
    'dense': ({}, {}),
    'chunked_decode_steps_4': (dict(prefill_chunk=8, decode_steps=4),
                               dict(prefill_chunk=8, decode_steps=4)),
    'fp8': (dict(cache_dtype=torch.float8_e4m3fn, decode_steps=4),
            dict(cache_dtype=jnp.float8_e4m3fn, decode_steps=4)),
    # The cache as long as the wpe table: the last request (121 + 7
    # tokens) fills it and its second window runs dead steps at positions
    # 127 and 128, the second past the table.
    'cache_at_the_table_end': (
        dict(max_cache_len=128, prefill_buckets=(16, 128), decode_steps=4),
        dict(max_cache_len=128, prefill_buckets=(16, 128), decode_steps=4)),
}


@pytest.mark.parametrize('case', list(ENGINE_CASES))
def test_engine_matches_the_jax_engine(params, prompts, case):
    """Greedy tokens, finish reasons and logprobs against the JAX engine on
    the same weights."""
    mine_kw, jax_kw = ENGINE_CASES[case]
    reqs = list(zip(prompts, MAX_NEW))
    if case == 'cache_at_the_table_end':
        reqs.append((list(range(1, 122)), 7))
    jeng = JaxEngine(JAX_CFG, JaxInferConfig(
        **{**ENGINE, 'cache_dtype': jnp.float32, **jax_kw}),
        params={'params': params})
    want = jeng.generate([JaxRequest(tokens=p, max_new_tokens=m)
                          for p, m in reqs])
    eng = port.InferenceEngine(
        PORT_CFG, port.InferConfig(
            **{**ENGINE, 'cache_dtype': torch.float32, **mine_kw}),
        params=convert.state_dict_from_jax(params, PORT_CFG), device='cpu',
        generator=torch.Generator().manual_seed(0))
    got = eng.generate([port.Request(tokens=p, max_new_tokens=m)
                        for p, m in reqs])
    assert len({tuple(r.output_tokens) for r in got}) > 1
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                   atol=TOL_LOGPROB)


def test_serving_features_match_the_jax_engine(params, prompts):
    """Registered prefixes, prompt logprobs, prompt-lookup speculation
    (draft_len 3) and QoS, all on one engine of each package over the
    same weights: the same tokens, finish reasons, prefix hits, logprobs
    and prompt logprobs (helpers_torch.features_match)."""
    kw = dict(ENGINE, decode_steps=4, draft_len=3, qos=True)
    jeng = JaxEngine(JAX_CFG, JaxInferConfig(**kw, cache_dtype=jnp.float32),
                     params={'params': params})
    eng = port.InferenceEngine(
        PORT_CFG, port.InferConfig(**kw, cache_dtype=torch.float32),
        params=convert.state_dict_from_jax(params, PORT_CFG), device='cpu',
        generator=torch.Generator().manual_seed(0))
    # Each prompt three times over: the lookup finds its n-grams.
    features_match(jeng, eng, [p * 3 for p in prompts[:4]],
                   prefix=[9, 8, 7, 6, 5, 4, 3, 2])
    assert eng.spec_stats['dispatches'] > 0


def test_train_steps_match_jax():
    """Three make_train_step steps of gpt2-debug (f32, remat full, the
    chunked loss over the tied wte) against JAX make_train_step on a
    one-device mesh from the JAX state's params: loss and grad_norm each
    step, every parameter after the third."""
    cfg_kwargs = dict(model='gpt2-debug', batch_size=4, seq_len=32,
                      learning_rate=3e-4, warmup_steps=2, total_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate, _ = jt.create_sharded_state(JAX_CFG, jt.TrainConfig(**cfg_kwargs),
                                        mesh, jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    model = gpt2.GPT2(PORT_CFG, device='cpu', param_dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_jax(to_np(jstate.params),
                                                      PORT_CFG))
    opt, sched = tt.make_optimizer(tt.TrainConfig(**cfg_kwargs),
                                   model.parameters())
    state = tt.TrainState(0, model, opt, sched)
    assert tt.output_projection(model) is not None
    jstep, step = jt.make_train_step(mesh), tt.make_train_step()
    for i in range(3):
        tokens = np.random.default_rng(10 + i).integers(0, 256, (4, 33))
        with mesh:
            jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        m = step(state, {'tokens': torch.from_numpy(tokens)})
        assert set(m) == {'loss', 'grad_norm'}
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL_LOSS)
    want = convert.state_dict_from_jax(to_np(jstate.params), PORT_CFG)
    for key, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=key)


def test_checkpoint_resume_equals_straight_run(tmp_path):
    """The managed-spot recipe's recovery: 2 steps, a checkpoint, a fresh
    Trainer restored from it and 2 more steps give the losses and the
    parameters of 4 steps straight, bit for bit."""
    cfg = tt.TrainConfig(model='gpt2-debug', batch_size=4, seq_len=32,
                         warmup_steps=1, total_steps=10)
    batches = list(itertools.islice(tt.synthetic_data(
        4, 32, 256, seed=3, device='cpu'), 4))

    def trainer(ckpt=None):
        t = tt.Trainer(dataclasses.replace(
            cfg, checkpoint_dir=ckpt, checkpoint_every=2), device='cpu')
        t.setup(seed=0)
        return t

    straight = trainer()
    straight.train(iter(batches), num_steps=4, log_every=1)
    trainer(str(tmp_path)).train(iter(batches[:2]), num_steps=2)
    resumed = trainer(str(tmp_path))
    assert resumed.state.step == 2
    resumed.train(iter(batches[2:]), num_steps=2, log_every=1)
    assert resumed.history == straight.history[2:]
    want = straight.state.model.state_dict()
    for name, p in resumed.state.model.state_dict().items():
        assert torch.equal(p, want[name]), name
