"""The port's HTTP server (skypilot_tpu_torch.infer.server) held against
the JAX server, route by route: the same requests go to a live JAX
InferenceServer and a live port server over the same tiny f32 weights,
and the answers must agree -- status codes, header names, JSON key sets
at every depth and every SSE event, token ids and finish reasons
exactly, logprobs within TOL.  Only timings and ids may differ.  Then a
mixed fleet: the unchanged SkyTpuLoadBalancer over one JAX replica and
one port replica returns the JAX engine's greedy tokens byte for byte,
including a stream resumed after the port replica dies mid-stream."""
import json
import re
import os
import threading
import time
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from helpers_openai import Tok
from helpers_torch import jax_engine, key_sets, make_params, port_engine
from skypilot_tpu.infer import FaultPlan as JaxFaultPlan
from skypilot_tpu.infer import FaultSpec as JaxFaultSpec
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.infer.chaos import (KillableReplica, _TrackingHTTPServer,
                                      free_port)
from skypilot_tpu.serve.load_balancer import SkyTpuLoadBalancer
from skypilot_tpu.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec
from skypilot_tpu_torch.infer import server as port_server
from skypilot_tpu_torch.infer.chaos import KillableReplica as PortReplica

# f32 on both sides: logprobs differ by summation order only.
TOL = 1e-5
SERVE = dict(decode_steps=4)


class _Live:
    """An InferenceServer behind its own HTTP listener on 127.0.0.1:0
    (no drain-exit hook, so /drain can be undone between tests)."""

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


def _call(port, method, path, body=None, raw=None):
    """(status, header names, parsed body or list of SSE events)."""
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    conn.request(method, path, body=data,
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    names = {k.lower() for k, _ in resp.getheaders()}
    payload = resp.read()
    conn.close()
    if resp.getheader('Content-Type') == 'text/event-stream':
        events = []
        for line in payload.split(b'\n'):
            if line.startswith(b'data: '):
                events.append(line[6:].decode() if line[6:] == b'[DONE]'
                              else json.loads(line[6:]))
        return resp.status, names, events, dict(resp.getheaders())
    return resp.status, names, json.loads(payload), dict(resp.getheaders())


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def pair(params):
    """(JAX server, port server): same weights, tokenizer and limits."""
    kw = dict(tokenizer=Tok(), max_projected_ttft_s=5.0)
    jax_live = _Live(jax_server, jax_engine(params, **SERVE), **kw)
    port_live = _Live(port_server, port_engine(params, **SERVE), **kw)
    yield jax_live, port_live
    jax_live.close()
    port_live.close()


def _both(pair, method, path, body=None, raw=None):
    """The same call to both servers; asserts equal status codes, header
    names and JSON key sets; returns (JAX answer, port answer)."""
    jax_live, port_live = pair
    j = _call(jax_live.port, method, path, body, raw)
    p = _call(port_live.port, method, path, body, raw)
    assert p[0] == j[0], (path, body, j[2], p[2])
    assert p[1] == j[1], (path, j[1] ^ p[1])
    assert key_sets(p[2]) == key_sets(j[2]), (path, j[2], p[2])
    return j, p


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=0, atol=TOL)


PROMPT = [11, 27, 5, 64, 3, 90, 42]


def test_health_routes(pair):
    (_, _, jh, _), (_, _, ph, _) = _both(pair, 'GET', '/health')
    assert jh == ph == {'status': 'ok'}
    (code, _, jdoc, jhead), (_, _, pdoc, phead) = _both(pair, 'GET',
                                                       '/healthz')
    assert code == 200 and pdoc['status'] == jdoc['status'] == 'ok'
    assert pdoc['kv'] == jdoc['kv']
    assert 'X-SkyTpu-Draining' not in phead
    (_, _, jm, _), (_, _, pm, _) = _both(pair, 'GET', '/v1/models')
    assert pm == jm
    (_, _, jx, _), (_, _, px, _) = _both(pair, 'GET', '/hot_prefixes')
    assert px == jx and px['prefixes'] == []
    _both(pair, 'GET', '/no_such_route')


def test_generate_plain_and_sse(pair):
    body = {'tokens': PROMPT, 'max_new_tokens': 10, 'logprobs': True}
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', '/generate', body)
    assert code == 200
    assert p['output_tokens'] == j['output_tokens']
    assert p['finish_reason'] == j['finish_reason'] == 'length'
    assert p['text'] == j['text']
    _close(j['logprobs'], p['logprobs'])
    (code, _, je, _), (_, _, pe, _) = _both(
        pair, 'POST', '/generate', {**body, 'stream': True})
    assert code == 200 and len(pe) == len(je) > 2
    for a, b in zip(je, pe):
        assert b.get('tokens') == a.get('tokens')
        assert b.get('text') == a.get('text')
    done_j, done_p = je[-1], pe[-1]
    assert done_p['output_tokens'] == done_j['output_tokens'] == \
        j['output_tokens']
    assert [t for e in pe[:-1] for t in e['tokens']] == \
        done_p['output_tokens']
    _close(done_j['logprobs'], done_p['logprobs'])


def test_sse_done_event_carries_prompt_logprobs(pair):
    """ROADMAP C12: a streamed /generate that asks for prompt_logprobs gets
    them in its done event from a port replica as from a JAX one (the
    port dropped them until the wire pass's schema twin caught it)."""
    body = {'tokens': PROMPT, 'max_new_tokens': 4,
            'prompt_logprobs': True, 'stream': True}
    (code, _, je, _), (_, _, pe, _) = _both(pair, 'POST', '/generate', body)
    assert code == 200
    done_j, done_p = je[-1], pe[-1]
    assert len(done_p['prompt_logprobs']) == len(PROMPT)
    assert done_p['prompt_logprobs'][0] is None
    assert done_j['prompt_logprobs'][0] is None
    _close(done_j['prompt_logprobs'][1:], done_p['prompt_logprobs'][1:])


def _stop_across_windows(pair):
    """A stop string of the greedy text that begins in one decode window
    and ends in the next: the first window after the prefill token holds
    tokens 1-4, so the string spans characters 4 and 5 (one per token)."""
    (_, _, j, _), _ = _both(pair, 'POST', '/v1/completions', {
        'prompt': PROMPT, 'max_tokens': 12, 'temperature': 0})
    text = j['choices'][0]['text']
    for start, end in [(3, 6), (2, 6), (4, 6), (3, 7), (4, 7)]:
        if text.find(text[start:end]) == start:
            return text[start:end]
    raise AssertionError(f'no stop string across windows in {text!r}')


def test_completions_stop_string_across_windows(pair):
    stop = _stop_across_windows(pair)
    body = {'prompt': PROMPT, 'max_tokens': 12, 'temperature': 0,
            'stop': [stop], 'logprobs': 2}
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', '/v1/completions',
                                          body)
    assert code == 200
    jc, pc = j['choices'][0], p['choices'][0]
    assert pc['text'] == jc['text'] and pc['finish_reason'] == 'stop'
    assert p['usage'] == j['usage']
    assert pc['logprobs']['tokens'] == jc['logprobs']['tokens']
    _close(jc['logprobs']['token_logprobs'],
           pc['logprobs']['token_logprobs'])
    for a, b in zip(jc['logprobs']['top_logprobs'],
                    pc['logprobs']['top_logprobs']):
        assert b.keys() == a.keys()
        _close([a[k] for k in a], [b[k] for k in a])
    del body['logprobs']
    (code, _, je, _), (_, _, pe, _) = _both(
        pair, 'POST', '/v1/completions', {**body, 'stream': True})
    assert code == 200 and pe[-1] == je[-1] == '[DONE]'
    assert len(pe) == len(je)
    assert [e['choices'] for e in pe[:-1]] == \
        [e['choices'] for e in je[:-1]]
    assert ''.join(e['choices'][0]['text'] for e in pe[:-1]) == \
        pc['text']


def test_completions_token_only_sse_and_max_tokens_zero(pair):
    """Token-array prompt, temperature 0, streamed: every SSE chunk
    carries the same token ids; max_tokens=0 scores nothing and
    generates nothing."""
    jax_live, port_live = pair
    tok = (jax_live.srv.tokenizer, port_live.srv.tokenizer)
    jax_live.srv.tokenizer = port_live.srv.tokenizer = None
    try:
        body = {'prompt': PROMPT, 'max_tokens': 9, 'temperature': 0,
                'stream': True}
        (code, _, je, _), (_, _, pe, _) = _both(
            pair, 'POST', '/v1/completions', body)
        assert code == 200 and len(pe) == len(je)
        assert [e['choices'] for e in pe[:-1]] == \
            [e['choices'] for e in je[:-1]]
    finally:
        jax_live.srv.tokenizer, port_live.srv.tokenizer = tok
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', '/v1/completions', {
        'prompt': PROMPT, 'max_tokens': 0, 'temperature': 0})
    assert code == 200
    assert p['choices'] == j['choices'] and p['usage'] == j['usage']
    assert p['choices'][0]['text'] == ''


def test_chat_completions(pair):
    body = {'messages': [{'role': 'user', 'content': 'hello there'}],
            'max_tokens': 6, 'temperature': 0, 'logprobs': True,
            'top_logprobs': 2}
    (code, _, j, _), (_, _, p, _) = _both(
        pair, 'POST', '/v1/chat/completions', body)
    assert code == 200
    jc, pc = j['choices'][0], p['choices'][0]
    assert pc['message'] == jc['message']
    assert pc['finish_reason'] == jc['finish_reason']
    for a, b in zip(jc['logprobs']['content'], pc['logprobs']['content']):
        assert b['token'] == a['token']
        _close([a['logprob']], [b['logprob']])
    del body['logprobs'], body['top_logprobs']
    (code, _, je, _), (_, _, pe, _) = _both(
        pair, 'POST', '/v1/chat/completions', {**body, 'stream': True})
    assert code == 200 and len(pe) == len(je)
    assert [e['choices'] for e in pe[:-1]] == \
        [e['choices'] for e in je[:-1]]


@pytest.mark.parametrize('path,body,raw', [
    ('/generate', None, b'{not json'),
    ('/generate', {'tokens': 'abc'}, None),
    ('/generate', {'tokens': [1, 2], 'deadline_s': -1}, None),
    ('/generate', {'tokens': [1, 2], 'priority': 'vip'}, None),
    ('/generate', {'tokens': [1] * 70}, None),
    ('/v1/completions', {'prompt': PROMPT, 'n': 99}, None),
    ('/v1/completions', {'prompt': PROMPT, 'model': 'other'}, None),
    ('/drain', {'deadline_s': 0}, None),
    ('/adopt_blocks', {'version': 1}, None),
])
def test_client_errors(pair, path, body, raw):
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', path, body, raw)
    assert code in (400, 404)
    if path == '/adopt_blocks':
        assert 'no radix cache' in p['error'] and \
            'no radix cache' in j['error']


@pytest.mark.parametrize('trigger', ['ttft_bound', 'queue_cap'])
def test_overload_sheds_with_429_and_retry_after(pair, monkeypatch,
                                                 trigger):
    """A server with every slot busy and a backlog sheds -- past its TTFT
    bound, or at its queue cap: 429 + Retry-After on the plain and the
    streaming path."""
    for live in pair:
        monkeypatch.setattr(live.srv.engine, 'has_free_slot',
                            lambda: False)
        with live.srv._adm_lock:
            live.srv._recent_ttfts.clear()
            if trigger == 'ttft_bound':
                live.srv._recent_ttfts.extend(
                    (14.0, 15.0, 16.0, 15.0, 14.0))
            else:
                monkeypatch.setattr(live.srv, 'max_queue', 8)
            live.srv._awaiting_first.update(f'fake{i}' for i in range(20))
    try:
        for stream in (False, True):
            (code, names, j, jh), (_, _, p, ph) = _both(
                pair, 'POST', '/generate',
                {'tokens': PROMPT, 'max_new_tokens': 2, 'stream': stream})
            assert code == 429 and 'retry-after' in names
            assert ph['Retry-After'] == jh['Retry-After']
            assert p['shed'] is j['shed'] is True
    finally:
        for live in pair:
            with live.srv._adm_lock:
                live.srv._recent_ttfts.clear()
                live.srv._awaiting_first.clear()


def test_stats_route(pair):
    (code, _, j, _), (_, _, p, _) = _both(pair, 'GET', '/stats')
    assert code == 200
    assert p['faults'] == j['faults']
    assert p['kv']['bytes'] == j['kv']['bytes']
    assert p['shed_count'] == j['shed_count']


def test_drain_refuses_new_work_then_undrains(pair):
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', '/drain',
                                          {'deadline_s': 30})
    assert code == 200 and p['status'] == j['status'] == 'draining'
    try:
        (code, names, j, jh), (_, _, p, ph) = _both(
            pair, 'POST', '/generate', {'tokens': PROMPT})
        assert code == 503 and p == j
        assert ph['Retry-After'] == jh['Retry-After'] == '1'
        assert ph['X-SkyTpu-Draining'] == '1'
        (code, names, _, _), _ = _both(pair, 'GET', '/healthz')
        assert code == 503 and 'x-skytpu-draining' in names
    finally:
        (code, _, _, _), (_, _, p, _) = _both(pair, 'POST', '/drain',
                                              {'cancel': True})
    assert code == 200 and p['status'] == 'ok'


@pytest.mark.parametrize('path,body', [
    ('/cache_prefix', {'tokens': [97, 98, 99, 96, 95]}),
    ('/load_adapter', {'name': 'a', 'path': 'a.npz'}),
])
def test_unported_routes_answer_501(pair, path, body):
    """Both routes once refused are ported and answer as the JAX server
    does: /cache_prefix (a prefix no other test of this module's prompts
    starts with), and /load_adapter on a server started without
    --adapter-dir: the same 403 body."""
    (code, _, j, _), (_, _, p, _) = _both(pair, 'POST', path, body)
    if path == '/cache_prefix':
        assert code == 200
        assert p == j == {'cached_prefix_len': len(body['tokens'])}
        return
    assert code == 403 and p == j
    assert '--adapter-dir' in p['error']


def test_unported_options_fail_at_startup(params, tmp_path, monkeypatch):
    """--tensor-parallel past the visible devices fails at startup with
    the JAX server's type and text (GPT-2 under it serves since:
    tests/test_torch_tp_serving_gpt2.py); --auto-prefix, the fp8 cache
    and --adapter-dir (with --lora-rank),
    ported since, start; and so do int8 weights, QoS and --hf-model
    (tests/test_torch_hf_import.py serves a checkpoint): run() builds
    engines like the JAX server's for the same flags, and a checkpoint
    path that does not exist fails in both with the same error type."""
    eng = port_engine(params)
    assert port_server.InferenceServer(eng, auto_prefix=True).auto_prefix
    lora = port_engine(params, lora_rank=4, lora_max_adapters=2)
    srv = port_server.InferenceServer(lora, adapter_dir=str(tmp_path))
    assert srv.adapter_dir == str(tmp_path) and lora.adapters == {}
    # --tensor-parallel past the visible devices: the JAX server's type
    # and text, before any weight is read (no engine is built).
    texts = []
    for mod, kw in ((port_server, {'device': 'cpu'}), (jax_server, {})):
        monkeypatch.setattr(mod, 'InferenceEngine', None)
        with pytest.raises(ValueError) as e:
            mod.run(model='llama-debug', tensor_parallel=99, **kw)
        texts.append(re.sub(r'the \d+ visible', 'the N visible',
                            str(e.value)))
    assert texts[0] == texts[1] == (
        '--tensor-parallel 99 exceeds the N visible device(s); a mesh '
        'needs one chip per shard')
    monkeypatch.undo()
    engines = []
    for mod in (port_server, jax_server):
        monkeypatch.setattr(mod, 'serve',
                            lambda engine, **_: engines.append(engine))
    for kw in ({'weight_dtype': 'int8'},
               {'qos': True, 'qos_tenant_weights': 'a=3,b=1'}):
        engines.clear()
        port_server.run(model='llama-debug', device='cpu',
                        max_cache_len=128, **kw)
        jax_server.run(model='llama-debug', max_cache_len=128, **kw)
        mine, ref = engines
        assert mine.model_config.weight_dtype == \
            ref.model_config.weight_dtype == kw.get('weight_dtype', 'bf16')
        assert mine.cfg.qos_tenant_weights == ref.cfg.qos_tenant_weights
        assert mine.stats()['qos'] == ref.stats()['qos']
    raised = []
    for mod, extra in ((port_server, {'device': 'cpu'}), (jax_server, {})):
        with pytest.raises(Exception) as e:
            mod.run(hf_model=str(tmp_path / 'missing'), **extra)
        raised.append(type(e.value))
    assert raised[0] is raised[1]
    fp8 = port_engine(params, cache_dtype=port_server.resolve_cache_dtype(
        'fp8'))
    assert fp8.cache[0][0].dtype == torch.float8_e4m3fn


@pytest.mark.parametrize('model', ['gpt2-debug', 'mixtral-debug'])
def test_run_serves_the_other_causal_families(model, monkeypatch):
    """run(model='gpt2-debug' | 'mixtral-debug') on both servers (random
    weights: each package's own draw from seed 0, so tokens differ): the
    engines' configs agree, and /v1/models, /generate (plain and SSE) and
    /v1/completions answer with the JAX server's status codes, header
    names, key sets, finish reasons and token counts."""
    engines = []
    for mod in (port_server, jax_server):
        monkeypatch.setattr(mod, 'serve',
                            lambda engine, **_: engines.append(engine))
    port_server.run(model=model, device='cpu', num_slots=2,
                    max_cache_len=64, decode_steps=4)
    jax_server.run(model=model, num_slots=2, max_cache_len=64,
                   decode_steps=4)
    mine, ref = engines
    assert type(mine.model_config).__name__ == \
        type(ref.model_config).__name__
    assert mine.model_config.num_params == ref.model_config.num_params
    pair = (_Live(jax_server, ref), _Live(port_server, mine))
    try:
        (_, _, jm, _), (_, _, pm, _) = _both(pair, 'GET', '/v1/models')
        assert pm == jm
        for body in ({'tokens': PROMPT, 'max_new_tokens': 6},
                     {'tokens': PROMPT, 'max_new_tokens': 6,
                      'stream': True}):
            (code, _, j, _), (_, _, p, _) = _both(pair, 'POST',
                                                   '/generate', body)
            assert code == 200
            if isinstance(j, dict):
                assert p['finish_reason'] == j['finish_reason'] == 'length'
                assert len(p['output_tokens']) == len(j['output_tokens'])
        body = {'prompt': PROMPT, 'max_tokens': 5}
        (code, _, j, _), (_, _, p, _) = _both(pair, 'POST',
                                               '/v1/completions', body)
        assert code == 200
        assert [c['finish_reason'] for c in p['choices']] == \
            [c['finish_reason'] for c in j['choices']]
    finally:
        for live in pair:
            live.close()


# --------------------------------------------------------- mixed fleet

FLEET_PROMPT = [3, 14, 15, 9, 2, 6]
FLEET_MAX_NEW = 24


@pytest.fixture(scope='module')
def fleet(params):
    """One JAX and one port replica behind a standalone LB (round robin,
    so both take traffic), each loop pass slowed by a stall fault so a
    kill lands mid-stream (the stall only sleeps)."""
    old = os.environ.get('SKYTPU_SERVE_LB_PROBE_INTERVAL')
    os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = '0.2'

    def make_jax():
        eng = jax_engine(params, max_new_tokens=32, **SERVE)
        eng.arm_faults(JaxFaultPlan(seed=0, specs=[
            JaxFaultSpec(site='stall', prob=1.0, stall_s=0.05)]))
        return eng

    def make_port():
        eng = port_engine(params, max_new_tokens=32, **SERVE)
        eng.arm_faults(FaultPlan(seed=0, specs=[
            FaultSpec(site='stall', prob=1.0, stall_s=0.05)]))
        return eng

    jax_rep = KillableReplica(make_jax, free_port())
    port_rep = PortReplica(make_port, free_port())
    jax_rep.start()
    port_rep.start()
    policy = LoadBalancingPolicy.make('round_robin')
    policy.set_ready_replicas([jax_rep.url, port_rep.url])
    lb = SkyTpuLoadBalancer(None, free_port(), policy,
                            server_cls=_TrackingHTTPServer)
    threading.Thread(target=lb.run, daemon=True).start()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            HTTPConnection('127.0.0.1', lb.port, timeout=1).connect()
            break
        except OSError:
            time.sleep(0.05)
    [ref] = jax_engine(params).generate([JaxRequest(
        tokens=FLEET_PROMPT, max_new_tokens=FLEET_MAX_NEW)])
    yield lb, jax_rep, port_rep, ref.output_tokens
    lb.stop()
    for rep in (jax_rep, port_rep):
        rep.kill()
    if old is None:
        del os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL']
    else:
        os.environ['SKYTPU_SERVE_LB_PROBE_INTERVAL'] = old


def _post_stream(port, payload, on_first_event=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request('POST', '/generate', body=json.dumps(payload).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    buf, events, fired = b'', [], False
    try:
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b'\n\n' in buf:
                ev, buf = buf.split(b'\n\n', 1)
                if ev.startswith(b'data: '):
                    events.append(json.loads(ev[6:]))
            if events and not fired and on_first_event is not None:
                fired = True
                on_first_event()
    finally:
        conn.close()
    return events


def test_mixed_fleet_returns_the_jax_engines_tokens(fleet):
    lb, jax_rep, port_rep, ref = fleet
    for i in range(4):
        body = {'tokens': FLEET_PROMPT, 'max_new_tokens': FLEET_MAX_NEW}
        if i % 2:
            events = _post_stream(lb.port, {**body, 'stream': True})
            done = events[-1]
            assert [t for e in events[:-1] for t in e['tokens']] == ref
        else:
            code, _, done, _ = _call(lb.port, 'POST', '/generate', body)
            assert code == 200
        assert done['output_tokens'] == ref
    # Both replicas served some of them.
    for rep in (jax_rep, port_rep):
        rows = rep.server.engine.stats()['qos']['tenants']
        assert rows['_default']['admitted'] >= 1


def test_mixed_fleet_resumes_a_stream_the_port_replica_dropped(fleet):
    """Kill the port replica after the first relayed chunk: the LB
    resumes on the JAX replica and the stitched stream equals the
    fault-free greedy tokens."""
    lb, _, port_rep, ref = fleet
    killed = []

    def kill_port_if_serving():
        if port_rep.busy():
            port_rep.kill()
            killed.append(True)

    for _ in range(4):       # round robin: one of two lands on the port
        events = _post_stream(lb.port, {'tokens': FLEET_PROMPT,
                                        'max_new_tokens': FLEET_MAX_NEW,
                                        'stream': True},
                              on_first_event=kill_port_if_serving)
        if killed:
            break
    assert killed, 'no stream reached the port replica'
    done = events[-1]
    assert done.get('resumed') is True
    assert done['output_tokens'] == ref
    assert [t for e in events[:-1] for t in e['tokens']] == ref
    assert lb.lb_stats()['streams_resumed'] >= 1
