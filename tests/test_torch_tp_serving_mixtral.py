"""Tensor-parallel serving of Mixtral on the CPU: at tp=2 each rank holds
two of the tiny MoE's four whole experts and runs them on the replicated
tokens, the router replicated; greedy tokens against the JAX TP engine
over ``tp_mesh(2)`` and the port's single-rank engine, drop-free (the
engine's exact routing).  (The dryrun's serving legs are held in
tests/test_torch_dryrun.py, beside the JAX dryrun's lines.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch_dist as hd
from skypilot_tpu.infer import InferConfig as JaxInferConfig
from skypilot_tpu.infer import InferenceEngine as JaxEngine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.parallel import tp_mesh
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.models import convert
from test_torch_mixtral import GEOMETRY, JAX_CFG, PORT_CFG, params  # noqa: F401

# f32 on both sides, the same routing: logprobs differ by sum order only
# (the tests of the single-rank Mixtral engine hold 1e-4).
TOL = 1e-4
ENGINE = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16),
              max_new_tokens=8, decode_steps=4, prefill_chunk=8)
PROMPTS = [dict(tokens=p, max_new_tokens=m) for p, m in (
    ([5, 9, 17, 33, 2], 8), ([71, 8, 3], 6),
    ([(7 * j) % 97 + 1 for j in range(30)], 8), ([4, 4, 4, 4], 5))]


@pytest.fixture(scope='module')
def runs(params, tmp_path_factory):  # noqa: F811
    """Mixtral on 2 ranks, started first; the JAX TP engine meanwhile."""
    sd = {k: v.numpy()
          for k, v in convert.state_dict_from_jax(params, PORT_CFG).items()}
    serve_run = hd.ServeRun(
        'mixtral', 'mixtral', GEOMETRY,
        {**ENGINE, 'cache_dtype': torch.float32}, sd,
        [('generate', PROMPTS), ('stats',), ('shard',)])
    mixtral = hd.Workers(hd.tp_serving, 2,
                         tmp_path_factory.mktemp('tp_mixtral'), [serve_run])
    jeng = JaxEngine(JAX_CFG, JaxInferConfig(
        **{**ENGINE, 'cache_dtype': jnp.float32}), params={'params': params},
        mesh=tp_mesh(2))
    want = jeng.generate([JaxRequest(**r) for r in PROMPTS])
    return {'mixtral': [r[0] for r in mixtral.join()], 'jax': want,
            'jax_stats': jeng.stats()}


def test_mixtral_tp2_gives_the_jax_tp_engines_tokens(runs, params):  # noqa: F811
    """Greedy tokens, finish reasons and logprobs of the tp=2 Mixtral
    engine against the JAX TP engine's, and the single-rank port
    engine's tokens; each rank holds half the kv heads and its experts
    are sliced (sharded weights in the shard report)."""
    got = runs['mixtral'][0]['values'][0]
    single = port.InferenceEngine(
        PORT_CFG, port.InferConfig(**{**ENGINE,
                                      'cache_dtype': torch.float32}),
        params=convert.state_dict_from_jax(params, PORT_CFG),
        device='cpu').generate([port.Request(**r) for r in PROMPTS])
    for g, w, s in zip(got, runs['jax'], single):
        assert g['tokens'] == list(w.output_tokens) == s.output_tokens
        assert g['finish'] == w.finish_reason
        np.testing.assert_allclose(g['logprobs'], w.logprobs, rtol=0,
                                   atol=TOL)
    assert [r['cache_heads'] for r in runs['mixtral']] == [1, 1]
    stats, report = runs['mixtral'][0]['values'][1:]
    assert stats['kv']['bytes'] == runs['jax_stats']['kv']['bytes']
    assert report['tensor_degree'] == 2
    assert report['param_leaves_sharded'] >= 3 * GEOMETRY['num_layers']
