"""Multi-LoRA serving over HTTP: the port's server
(skypilot_tpu_torch.infer.server) beside the JAX server, both with
--adapter-dir over one directory of adapter files -- POST /load_adapter's
answers, /v1/models and adapter selection by the "adapter" and OpenAI
"model" fields -- and a mixed JAX + port fleet behind the unchanged LB
serving one adapter with identical tokens (CPU, the tiny f32 model of
helpers_torch)."""
import dataclasses
import json
import os
import threading
import time
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import flax
import jax
import jax.numpy as jnp
import pytest

from helpers_torch import JAX_CFG, jax_engine, make_params, port_engine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.infer.chaos import (KillableReplica, _TrackingHTTPServer,
                                      free_port)
from skypilot_tpu.models.llama import Llama as JaxLlama
from skypilot_tpu.serve.load_balancer import SkyTpuLoadBalancer
from skypilot_tpu.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu.train import lora as jlora
from skypilot_tpu_torch.infer import server as port_server
from skypilot_tpu_torch.infer.chaos import KillableReplica as PortReplica
from skypilot_tpu_torch.train import lora
from test_torch_lora_serving import LORA, PROMPTS, _tree


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Adapter 'a' written by the JAX package, 'c' by the port."""
    root = tmp_path_factory.mktemp('adapters')
    jlora.save_adapter_npz(_tree(1), str(root / 'a.npz'))
    lora.save_adapter_npz(_tree(3), str(root / 'c.npz'))
    return root


def _http(port, method, path, body=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


class _Live:
    """An InferenceServer behind its own listener on 127.0.0.1:0."""

    def __init__(self, mod, engine, **kw):
        self.srv = mod.InferenceServer(engine, **kw)
        self.srv.start()
        assert self.srv.ready.wait(120)
        self.httpd = ThreadingHTTPServer(('127.0.0.1', 0),
                                         mod._make_handler(self.srv))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.stop()


def test_load_adapter_and_selection_match_the_jax_server(params, files,
                                                         tmp_path):
    """POST /load_adapter on both servers (one adapter directory): the
    same 400 bodies for a missing field, an escaping path, a missing
    file and a rank mismatch, the same {'adapter', 'slot'} on success;
    /v1/models lists the adapters; the "adapter" field and the OpenAI
    "model" field select them with the JAX server's tokens."""
    wrong = tmp_path / 'wrong.npz'
    big = dataclasses.replace(JAX_CFG, lora_rank=8)
    jlora.save_adapter_npz(jlora.extract_adapter_tree(
        flax.linen.meta.unbox(JaxLlama(big).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
        ['params']), str(files / 'rank8.npz'))
    servers = [_Live(jax_server, jax_engine(params, **LORA),
                     adapter_dir=str(files)),
               _Live(port_server, port_engine(params, **LORA),
                     adapter_dir=str(files))]
    try:
        def both(method, path, body=None):
            j, p = (_http(s.port, method, path, body) for s in servers)
            assert p == j, (path, body, j, p)
            return j

        assert both('POST', '/load_adapter', {'name': 'x'})[0] == 400
        assert both('POST', '/load_adapter',
                    {'name': 'x', 'path': '../a.npz'})[0] == 400
        assert both('POST', '/load_adapter',
                    {'name': 'x', 'path': 'missing.npz'})[0] == 400
        code, doc = both('POST', '/load_adapter',
                         {'name': 'x', 'path': 'rank8.npz'})
        assert code == 400 and 'rank mismatch' in doc['error']
        assert both('POST', '/load_adapter',
                    {'name': 'tuned', 'path': 'a.npz'}) == \
            (200, {'adapter': 'tuned', 'slot': 0})
        assert both('POST', '/load_adapter',
                    {'name': 'other', 'path': str(files / 'c.npz')}) == \
            (200, {'adapter': 'other', 'slot': 1})
        models = both('GET', '/v1/models')[1]
        assert [m['id'] for m in models['data']] == [
            JAX_CFG.name, 'other', 'tuned']
        for body in ({'tokens': PROMPTS[3], 'adapter': 'tuned',
                      'max_new_tokens': 6},
                     {'tokens': PROMPTS[3], 'max_new_tokens': 6}):
            j, p = (_http(s.port, 'POST', '/generate', body)[1]
                    for s in servers)
            assert p['output_tokens'] == j['output_tokens']
        outs = []
        for model in ('other', JAX_CFG.name):
            body = {'model': model, 'prompt': PROMPTS[3], 'max_tokens': 6,
                    'temperature': 0}
            j, p = (_http(s.port, 'POST', '/v1/completions', body)
                    for s in servers)
            assert p[0] == j[0] == 200
            assert p[1]['model'] == j[1]['model'] == model
            outs.append(p[1]['choices'][0]['tokens'])
            assert outs[-1] == j[1]['choices'][0]['tokens']
        assert outs[0] != outs[1]
        j, p = (_http(s.port, 'POST', '/v1/completions',
                      {'model': 'nope', 'prompt': [1, 2]})
                for s in servers)
        assert p[0] == j[0] == 404
    finally:
        for s in servers:
            s.close()


def test_mixed_fleet_serves_one_adapter_identically(params, files):
    """One JAX and one port replica with the same adapter registered,
    behind the unchanged LB (round robin, so both serve): requests naming
    it, by the "adapter" field and by the OpenAI "model" field, plain
    and streamed, get the JAX engine's tokens from either replica."""
    old = os.environ.get('SKYTPU_SERVE_LB_PROBE_INTERVAL')
    os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = '0.2'
    path = str(files / 'a.npz')

    def make_jax():
        eng = jax_engine(params, max_new_tokens=16, **LORA)
        eng.register_adapter('tuned', jlora.load_adapter_npz(path))
        return eng

    def make_port():
        eng = port_engine(params, max_new_tokens=16, **LORA)
        eng.register_adapter('tuned', lora.load_adapter_npz(path))
        return eng

    reps = [KillableReplica(make_jax, free_port()),
            PortReplica(make_port, free_port())]
    for rep in reps:
        rep.start()
    policy = LoadBalancingPolicy.make('round_robin')
    policy.set_ready_replicas([r.url for r in reps])
    lb = SkyTpuLoadBalancer(None, free_port(), policy,
                            server_cls=_TrackingHTTPServer)
    threading.Thread(target=lb.run, daemon=True).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                HTTPConnection('127.0.0.1', lb.port, timeout=1).connect()
                break
            except OSError:
                time.sleep(0.05)
        [ref] = make_jax().generate([JaxRequest(
            tokens=PROMPTS[0], max_new_tokens=16, adapter='tuned')])
        for i in range(4):
            if i % 2:
                code, doc = _http(lb.port, 'POST', '/v1/completions', {
                    'model': 'tuned', 'prompt': PROMPTS[0],
                    'max_tokens': 16, 'temperature': 0})
                assert code == 200
                assert doc['choices'][0]['tokens'] == ref.output_tokens
            else:
                code, doc = _http(lb.port, 'POST', '/generate', {
                    'tokens': PROMPTS[0], 'adapter': 'tuned',
                    'max_new_tokens': 16})
                assert code == 200
                assert doc['output_tokens'] == ref.output_tokens
        for rep in reps:
            rows = rep.server.engine.stats()['qos']['tenants']
            assert rows['_default']['admitted'] >= 1
    finally:
        lb.stop()
        for rep in reps:
            rep.kill()
        if old is None:
            del os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL']
        else:
            os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = old
