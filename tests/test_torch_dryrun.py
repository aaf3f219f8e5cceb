"""The port's multi-rank dryrun (skypilot_tpu_torch/entry.py
``dryrun_multichip``) held against the JAX package's on the CPU: the
dryrun over 4 gloo ranks against ``__graft_entry__.dryrun_multichip(4)``
on 4 devices, from the JAX legs' weights (bf16 legs, as the reference
runs them)."""
import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import helpers_torch_dist as hd
from skypilot_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from skypilot_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.entry import dryrun_config, serve_legs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.mixtral import MixtralConfig

# The dryrun's legs run bf16 (the reference's default dtype) on both
# sides: XLA's and torch's CPU bf16 products round differently, so the
# printed losses (3 decimals, near 5) are held to 2e-2.
TOL_DRYRUN = 2e-2


def _dryrun_params():
    """The JAX dryrun legs' weights (create_sharded_state at the
    reference's keys: dp and sp PRNGKey(0), pp 1, ep 2) in the port's
    layout."""
    cfg = dryrun_config(torch.device('cpu'))
    jcfg = JaxLlamaConfig(name='dryrun', vocab_size=512, hidden_size=128,
                          intermediate_size=256, num_layers=2, num_heads=8,
                          num_kv_heads=4, max_seq_len=128,
                          tie_embeddings=True)
    ep = dict(name='dryrun-moe', vocab_size=512, hidden_size=128,
              intermediate_size=256, num_layers=2, num_heads=8,
              num_kv_heads=4, num_experts=2, experts_per_token=2,
              max_seq_len=128, tie_embeddings=True)
    mesh = jm.make_mesh(jm.MeshSpec(), devices=jax.devices()[:1])
    tcfg = jt.TrainConfig(model='dryrun', batch_size=8, seq_len=64)

    def params(c, key):
        state, _ = jt.create_sharded_state(c, tcfg, mesh,
                                           jax.random.PRNGKey(key))
        return jax.tree.map(lambda x: np.array(x, np.float32), state.params)

    out = {}
    for leg, c, tc, key in (('dp', jcfg, cfg, 0), ('pp', jcfg, cfg, 1),
                            ('ep', JaxMixtralConfig(**ep),
                             MixtralConfig(**ep), 2)):
        out[leg] = {k: v.float().numpy() for k, v in
                    convert.state_dict_from_jax(params(c, key), tc).items()}
    out['sp'] = out['dp']
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The port's dryrun on 4 ranks, started first; the JAX dryrun on 4
    devices meanwhile, its printed lines kept."""
    tmp = tmp_path_factory.mktemp('dryrun')
    dry = hd.Workers(hd.dryrun, 4, tmp, _dryrun_params())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        __graft_entry__.dryrun_multichip(4)
    serve1: list = []
    serve_legs(1, torch.device('cpu'), dryrun_config(torch.device('cpu')),
               log=serve1.append)
    port = dry.join()[0]
    return {'dryrun': port['losses'], 'jax_lines': printed.getvalue(),
            'serve4': [line for line in port['lines']
                       if line.startswith('dryrun serve-tp')],
            'serve1': serve1}


def test_dryrun_legs_match_the_reference(runs):
    """Every leg of the JAX dryrun at 4 devices runs in the port at 4
    ranks (dp/fsdp/tp with accumulation 2, sp, pp, ep), each loss finite
    and within TOL_DRYRUN of the JAX leg's printed loss from the same
    weights."""
    lines = runs['jax_lines']
    want = {
        'dp': re.search(r'dryrun_multichip ok: .* loss=([\d.]+)', lines),
        'sp': re.search(r'dryrun sp ok: .* loss=([\d.]+)', lines),
        'pp': re.search(r'dryrun pp ok: .* loss=([\d.]+)', lines),
        'ep': re.search(r'dryrun ep ok: .* loss=([\d.]+)', lines)}
    got = runs['dryrun']
    assert set(got) == set(want)
    for leg, m in want.items():
        assert np.isfinite(got[leg])
        assert abs(got[leg] - float(m.group(1))) <= TOL_DRYRUN, (
            leg, got[leg], m.group(0))


def test_dryrun_serving_legs_print_the_reference_lines(runs):
    """At 4 ranks (fsdp 2 x tensor 2, the reference's layout) the port's
    serve-tp and serve-tp-lookahead legs pass -- half the heads in the q
    projection and the cache, the single engine's tokens, the shard
    check at tensor degree 2, the serving loop with lookahead and the
    adaptive window under the sanitizer -- and print the JAX dryrun's
    lines (tokens from the port's own draws); at 1 rank both are skipped
    with the reason."""
    lines = runs['serve4']
    assert len(lines) == 2
    assert lines[0].startswith('dryrun serve-tp ok: mesh=')
    assert "'tensor': 2" in lines[0] and "'fsdp': 2" in lines[0]
    assert "'tensor_degree': 2" in lines[0]
    assert lines[1].startswith('dryrun serve-tp-lookahead ok: window=4 '
                               'adaptive+lookahead tokens=')
    for line in lines:
        assert line.split(': ')[0] + ': ' in runs['jax_lines'], line
    assert runs['serve1'] == [
        'dryrun serve-tp skipped: 1 rank(s); tensor=2 needs an even count',
        'dryrun serve-tp-lookahead skipped: 1 rank(s); tensor=2 needs an '
        'even count']
