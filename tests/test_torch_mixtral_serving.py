"""The port's Mixtral served by its engine, held against the JAX engine
on the CPU in f32 over tests/test_torch_mixtral.py's tiny MoE and
weights: greedy streams (dense, chunked prefill with four-step windows,
the fp8 cache), registered prefixes with prompt logprobs, speculation and
QoS on one engine, the engine against a drop-free no-cache scorer, and
the refusals (the paged cache, multi-LoRA, LoRA training) with the JAX
texts."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import features_match
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.train import trainer as tt
from test_torch_mixtral import (JAX_CFG, PORT_CFG, _port_model,
                                params)  # noqa: F401 (a fixture)

# f32 on both sides, the same routing: logprobs differ by sum order only.
TOL_LOGPROB = 1e-4
ENGINE = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16),
              max_new_tokens=8, decode_steps=1)
PROMPT_LENS = (3, 7, 12, 5, 30)
MAX_NEW = (8, 6, 8, 1, 8)


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 101, n).tolist() for n in PROMPT_LENS]


ENGINE_CASES = {
    'dense': ({}, {}),
    'chunked_decode_steps_4': (dict(prefill_chunk=8, decode_steps=4),
                               dict(prefill_chunk=8, decode_steps=4)),
    'fp8': (dict(cache_dtype=torch.float8_e4m3fn, decode_steps=4),
            dict(cache_dtype=jnp.float8_e4m3fn, decode_steps=4)),
}


@pytest.mark.parametrize('case', list(ENGINE_CASES))
def test_engine_matches_the_jax_engine(params, prompts, case):
    """Greedy tokens, finish reasons and logprobs of five requests (one
    past the largest bucket) against the JAX engine on the same weights."""
    mine_kw, jax_kw = ENGINE_CASES[case]
    jeng = JaxEngine(JAX_CFG, JaxInferConfig(
        **{**ENGINE, 'cache_dtype': jnp.float32, **jax_kw}),
        params={'params': params})
    want = jeng.generate([JaxRequest(tokens=p, max_new_tokens=m)
                          for p, m in zip(prompts, MAX_NEW)])
    eng = port.InferenceEngine(
        PORT_CFG, port.InferConfig(
            **{**ENGINE, 'cache_dtype': torch.float32, **mine_kw}),
        params=convert.state_dict_from_jax(params, PORT_CFG), device='cpu',
        generator=torch.Generator().manual_seed(0))
    got = eng.generate([port.Request(tokens=p, max_new_tokens=m)
                        for p, m in zip(prompts, MAX_NEW)])
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


def test_engine_matches_a_drop_free_scorer(params):
    """The analogue of tests/test_infer.py's drop-free check: at the
    training capacity factor (1.25) the engine's greedy stream equals
    greedy decoding by the drop-free (cf = E/k) no-cache forward of the
    same weights, four slots busy."""
    eng = port.InferenceEngine(
        PORT_CFG, port.InferConfig(num_slots=4, max_cache_len=64,
                                   prefill_buckets=(8,), max_new_tokens=6,
                                   cache_dtype=torch.float32),
        params=convert.state_dict_from_jax(params, PORT_CFG), device='cpu')
    seqs = [[7, 8, 9], [40, 2, 77, 13, 5], [1, 1, 1], [99, 3]]
    results = eng.generate([port.Request(tokens=s, max_new_tokens=6)
                            for s in seqs])
    scorer = _port_model(dataclasses.replace(PORT_CFG, capacity_factor=2.0),
                         params)
    for res, seq in zip(results, seqs):
        seq = list(seq)
        for _ in range(6):
            with torch.no_grad():
                logits = scorer(torch.tensor([seq]))
            seq.append(int(logits[0, -1].argmax()))
        assert res.output_tokens == seq[-6:]


def test_refusals_match_the_jax_texts(params):
    """The paged cache and multi-LoRA serve the llama family only (the JAX
    engine's TypeErrors, word for word); LoRA training on Mixtral, ported
    since, sets up with the adapters as its only trainable tensors."""
    sd = convert.state_dict_from_jax(params, PORT_CFG)
    for extra in (dict(kv_block_size=8), dict(lora_rank=4)):
        texts = []
        for make in (
                lambda: JaxEngine(JAX_CFG, JaxInferConfig(
                    **{**ENGINE, 'cache_dtype': jnp.float32, **extra}),
                    params={'params': params}),
                lambda: port.InferenceEngine(
                    PORT_CFG, port.InferConfig(**{
                        **ENGINE, 'cache_dtype': torch.float32, **extra}),
                    params=sd, device='cpu')):
            with pytest.raises(TypeError) as e:
                make()
            texts.append(str(e.value))
        assert texts[0] == texts[1] and 'llama family' in texts[0]
    trainer = tt.Trainer(tt.TrainConfig(model='mixtral-debug'),
                         dataclasses.replace(PORT_CFG, lora_rank=4),
                         device='cpu')
    trainer.setup()
    trainable = [n for n, p in trainer.state.model.named_parameters()
                 if p.requires_grad]
    assert trainable and all('_lora.' in n for n in trainable)
