"""Prompt scoring in the port (``Request.want_prompt_logprobs``; the
/generate ``prompt_logprobs`` field; /v1/completions ``echo`` with
``logprobs``, the lm-eval-harness loglikelihood contract) held against
the JAX engine and server on the same f32 weights: the scores within
TOL, the top-k alternatives, the radix bypass, the reply key sets, and
``scripts/lm_eval_loglikelihood.loglikelihood`` against a live port
server."""
import importlib.util
import json
import pathlib
import threading
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from helpers_openai import Tok
from helpers_torch import jax_engine, key_sets, make_params, port_engine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu_torch.infer import engine as port
from skypilot_tpu_torch.infer import server as port_server

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
# Chunking on, so a scored prompt past the largest bucket (32) is the
# JAX engine's client error and an in-bucket one is never chunked.
ENGINE = dict(prefill_chunk=8)
LAYOUTS = {'dense': {},
           'paged_radix': dict(kv_block_size=8, auto_prefix_cache=True)}


@pytest.fixture(scope='module')
def params():
    return make_params()


def _requests(mod):
    """Scored prompts of 1, 7, 20 and 32 tokens, an unscored one sharing
    the 32-token prompt's first 24 (a radix hit if scored requests were
    adopted), and a scored one past the largest bucket."""
    rng = np.random.default_rng(8)
    toks = [rng.integers(0, 101, n).tolist() for n in (1, 7, 20, 32)]
    plain = toks[3][:24] + rng.integers(0, 101, 3).tolist()
    return ([mod(tokens=t, max_new_tokens=4, want_prompt_logprobs=True)
             for t in toks] +
            [mod(tokens=plain, max_new_tokens=4),
             mod(tokens=rng.integers(0, 101, 40).tolist(), max_new_tokens=2,
                 want_prompt_logprobs=True)])


def _assert_tops_close(ref, got):
    """Top-k logprobs within TOL; ids where the values are distinct (tie
    order differs between lax.top_k and torch.topk)."""
    rv = np.array([lp for _, lp in ref])
    np.testing.assert_allclose([lp for _, lp in got], rv, rtol=0, atol=TOL)
    gaps = -np.diff(rv)
    for r, (a, b) in enumerate(zip(ref, got)):
        if (r == 0 or gaps[r - 1] > TOL) and \
                (r == len(rv) - 1 or gaps[r] > TOL):
            assert a[0] == b[0]


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_prompt_logprobs_match_the_jax_engine(params, layout):
    kw = {**ENGINE, **LAYOUTS[layout]}
    jax_eng, eng = jax_engine(params, **kw), port_engine(params, **kw)
    ref = jax_eng.generate(_requests(JaxRequest))
    got = eng.generate(_requests(port.Request))
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.finish_reason == a.finish_reason, (i, a, b)
        assert b.output_tokens == a.output_tokens, i
        if a.prompt_logprobs is None:
            assert b.prompt_logprobs is None and b.prompt_top_logprobs is None
            continue
        assert len(b.prompt_logprobs) == len(b.prompt_tokens)
        assert b.prompt_logprobs[0] is None and b.prompt_top_logprobs[0] is None
        np.testing.assert_allclose(b.prompt_logprobs[1:],
                                   a.prompt_logprobs[1:], rtol=0, atol=TOL)
        for ta, tb in zip(a.prompt_top_logprobs[1:],
                          b.prompt_top_logprobs[1:]):
            assert len(tb) == eng.cfg.logprob_topk
            _assert_tops_close(ta, tb)
    assert got[-1].finish_reason == 'error'
    assert 'prompt_logprobs requires the prompt' in got[-1].error
    assert got[-1].error == ref[-1].error
    assert eng.chunk_stats == jax_eng.chunk_stats
    # Scored requests neither look up nor join the radix tree.
    assert eng.radix_stats == jax_eng.radix_stats
    if eng._radix is not None:
        assert eng.radix_stats['lookups'] == 1
        assert eng.radix_stats['hits'] == 0


def test_out_of_range_prompt_id_scores_as_the_jax_gather(params):
    """A prompt id of V scores NaN at its position (the JAX gather fills
    it), -1 scores as V - 1; the request is still served."""
    req = dict(tokens=[3, 101, -1, 7], max_new_tokens=2,
               want_prompt_logprobs=True)
    [a] = jax_engine(params).generate([JaxRequest(**req)])
    [b] = port_engine(params).generate([port.Request(**req)])
    assert b.output_tokens == a.output_tokens
    assert np.isnan(a.prompt_logprobs[1]) and np.isnan(b.prompt_logprobs[1])
    np.testing.assert_allclose(b.prompt_logprobs[2:], a.prompt_logprobs[2:],
                               rtol=0, atol=TOL)


class _Live:
    """An InferenceServer behind its own HTTP listener on 127.0.0.1:0."""

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


@pytest.fixture(scope='module')
def pair(params):
    """(JAX server, port server): same weights and tokenizer."""
    live = (_Live(jax_server, jax_engine(params, decode_steps=4),
                  tokenizer=Tok()),
            _Live(port_server, port_engine(params, decode_steps=4),
                  tokenizer=Tok()))
    yield live
    for x in live:
        x.close()


def _post(port, path, body):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request('POST', path, body=json.dumps(body).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _both(pair, path, body):
    (cj, j), (cp, p) = (_post(x.port, path, body) for x in pair)
    assert cp == cj, (j, p)
    assert key_sets(p) == key_sets(j), (j, p)
    return cj, j, p


def _close(a, b):
    np.testing.assert_allclose(
        np.asarray([np.nan if x is None else x for x in b], np.float64),
        np.asarray([np.nan if x is None else x for x in a], np.float64),
        rtol=0, atol=TOL)


PROMPT = [11, 27, 5, 64, 3, 90, 42]


@pytest.mark.parametrize('body', [
    {'prompt': PROMPT, 'max_tokens': 0, 'echo': True, 'logprobs': 1,
     'temperature': 0},
    {'prompt': PROMPT, 'max_tokens': 4, 'echo': True, 'logprobs': 3,
     'temperature': 0, 'n': 2},
    {'prompt': 'abcde', 'max_tokens': 0, 'echo': True, 'logprobs': 1},
], ids=['score_only', 'echo_n2', 'text_prompt'])
def test_completions_echo_logprobs_match_the_jax_server(pair, body):
    code, j, p = _both(pair, '/v1/completions', body)
    assert code == 200
    assert p['usage'] == j['usage']
    assert len(p['choices']) == body.get('n', 1)
    for jc, pc in zip(j['choices'], p['choices']):
        assert pc['text'] == jc['text']
        assert pc['finish_reason'] == jc['finish_reason']
        jl, pl = jc['logprobs'], pc['logprobs']
        assert pl['tokens'] == jl['tokens']
        assert pl['text_offset'] == jl['text_offset']
        assert pl['token_logprobs'][0] is None
        _close(jl['token_logprobs'], pl['token_logprobs'])
        assert pl['top_logprobs'][0] is None
        for a, b in zip(jl['top_logprobs'][1:], pl['top_logprobs'][1:]):
            assert len(b) == len(a)
            _close(sorted(a.values()), sorted(b.values()))
    n_prompt = len(p['choices'][0]['logprobs']['tokens']) - \
        p['usage']['completion_tokens'] // body.get('n', 1)
    assert n_prompt == p['usage']['prompt_tokens']


def test_generate_prompt_logprobs_and_stream_refusal(pair):
    body = {'tokens': PROMPT, 'max_new_tokens': 3, 'logprobs': True,
            'prompt_logprobs': True}
    code, j, p = _both(pair, '/generate', body)
    assert code == 200 and p['output_tokens'] == j['output_tokens']
    assert p['prompt_logprobs'][0] is None
    _close(j['prompt_logprobs'], p['prompt_logprobs'])
    _close(j['logprobs'], p['logprobs'])
    code, j, p = _both(pair, '/v1/completions', {
        'prompt': PROMPT, 'echo': True, 'logprobs': 1, 'stream': True})
    assert code == 400 and 'stream' in p['error']['message']


def _lm_eval_client():
    spec = importlib.util.spec_from_file_location(
        'lm_eval_loglikelihood', ROOT / 'scripts' / 'lm_eval_loglikelihood.py')
    client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(client)
    return client


def test_lm_eval_loglikelihood_against_a_port_server(pair, params):
    """The lm-eval client's (sum, is_greedy) from a port server equal the
    JAX server's: sums within 1e-4, the same is_greedy, for the JAX
    engine's greedy continuation (greedy) and a diverged one."""
    client = _lm_eval_client()
    jax_live, port_live = pair
    context = [3, 1, 4, 1, 5]
    [res] = jax_engine(params).generate([JaxRequest(tokens=context,
                                                    max_new_tokens=3)])
    greedy = res.output_tokens
    diverged = [(greedy[0] + 1) % 101] + greedy[1:]
    for cont, want_greedy in [(greedy, True), (diverged, False),
                              ([9, 2, 6], None)]:
        ref = client.loglikelihood(f'http://127.0.0.1:{jax_live.port}',
                                   context, cont)
        got = client.loglikelihood(f'http://127.0.0.1:{port_live.port}',
                                   context, cont)
        assert abs(got[0] - ref[0]) <= 1e-4, (cont, ref, got)
        assert got[1] == ref[1]
        if want_greedy is not None:
            assert got[1] is want_greedy
