"""The port's prompt-lookup speculative decoding (draft_len > 0) held
against the JAX engine and server, on the tiny f32 model of
helpers_torch (CPU):

- prompt_lookup_draft fuzzed against the reference function;
- the spec engine against the JAX spec engine -- dense, paged and radix:
  tokens, logprobs and spec_stats dicts equal, and greedy tokens equal
  windowed decode's, with the conservation law after every dispatch on
  the paged paths;
- oracle drafts (the windowed engine's own greedy output) accepted in
  full, EOS and max_new_tokens, sampled and greedy slots in one batch,
  a slot near the cache end falling back to windowed decode, and spec
  composed with a registered prefix and with chunked prefill;
- decode lookahead gated off under speculation, warm-up leaving the
  counters and the acceptance EMA alone, and --draft-len over HTTP
  against the JAX server."""
import contextlib
import json
import threading
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from helpers_torch import WindowAudit, jax_engine, make_params, port_engine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import engine as jax_engine_mod
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.infer import engine as port_engine_mod
from skypilot_tpu_torch.infer import server as port_server

TOL = 1e-5
SPEC = dict(draft_len=3, max_new_tokens=16)
LAYOUTS = {'dense': {}, 'paged': dict(kv_block_size=8),
           'radix': dict(kv_block_size=8, auto_prefix_cache=True)}


@pytest.fixture(scope='module')
def params():
    return make_params()


def _small_vocab_prompts(seed=3, n=5):
    """Prompts over tokens 1..4: n-gram drafts fire often."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 5, int(rng.integers(6, 20))).tolist()
            for _ in range(n)]


def _assert_same(ref, out):
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason == a.finish_reason
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=TOL)


def _both(jeng, peng, prompts, max_new=12, temps=None):
    temps = temps or [0.0] * len(prompts)
    r_j = jeng.generate([JaxRequest(tokens=list(p), max_new_tokens=max_new,
                                    temperature=t)
                         for p, t in zip(prompts, temps)])
    r_p = peng.generate([Request(tokens=list(p), max_new_tokens=max_new,
                                 temperature=t)
                         for p, t in zip(prompts, temps)])
    return r_j, r_p


def test_prompt_lookup_draft_fuzzed_against_the_reference():
    ref = jax_engine_mod.prompt_lookup_draft
    ours = port_engine_mod.prompt_lookup_draft
    assert ours([7, 8, 9, 1, 2, 3, 7, 8], 3, 4) == [9, 1, 2]
    assert ours([1, 2, 7, 5, 1, 2, 8, 5, 1, 2], 1, 2) == [8]
    assert ours([5], 3, 4) == ours([], 3, 4) == ours([1, 2], 0, 4) == []
    rng = np.random.default_rng(0)
    for _ in range(3000):
        hist = rng.integers(0, int(rng.integers(2, 8)),
                            int(rng.integers(0, 40))).tolist()
        k, nmax = int(rng.integers(0, 6)), int(rng.integers(1, 6))
        assert ours(hist, k, nmax) == ref(hist, k, nmax), (hist, k, nmax)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_spec_matches_the_jax_spec_engine_and_windowed(params, layout):
    kw = LAYOUTS[layout]
    jeng = jax_engine(params, **SPEC, **kw)
    peng = port_engine(params, **SPEC, **kw)
    prompts = _small_vocab_prompts()
    if layout == 'radix':      # a shared head, so verify reads shared rows
        prompts = [[1, 2, 3, 4] * 4 + p[:5] for p in prompts]
    # The dense layout has no pool to audit.
    with WindowAudit(peng) if kw else contextlib.nullcontext() as audit:
        r_j, r_p = _both(jeng, peng, prompts)
    _assert_same(r_j, r_p)
    assert peng.spec_stats == jeng.spec_stats
    assert peng.spec_stats['dispatches'] > 0
    assert peng.spec_stats['accepted'] <= peng.spec_stats['drafted']
    assert peng._accept_ema == pytest.approx(jeng._accept_ema, abs=1e-12)
    if kw:
        assert audit.errors == []
    windowed = port_engine(params, max_new_tokens=16, **kw).generate(
        [Request(tokens=list(p), max_new_tokens=12) for p in prompts])
    assert [r.output_tokens for r in r_p] == \
        [r.output_tokens for r in windowed]


@pytest.mark.parametrize('layout', ['dense', 'paged'])
def test_oracle_drafts_are_accepted(params, layout, monkeypatch):
    """Drafts taken from the windowed engine's own greedy output: every
    verify yields 1 + D tokens, so 12 tokens take at most 4 dispatches,
    and the tokens and counters are the JAX engine's under the same
    oracle."""
    kw = LAYOUTS[layout]
    prompt = [11, 12, 13, 14]
    expected = port_engine(params, **kw).generate(
        [Request(tokens=prompt, max_new_tokens=12)])[0].output_tokens

    def oracle(hist, k, nmax):
        done = len(hist) - len(prompt)
        return expected[done:done + k]

    monkeypatch.setattr(port_engine_mod, 'prompt_lookup_draft', oracle)
    monkeypatch.setattr(jax_engine_mod, 'prompt_lookup_draft', oracle)
    jeng = jax_engine(params, **SPEC, **kw)
    peng = port_engine(params, **SPEC, **kw)
    r_j, r_p = _both(jeng, peng, [prompt])
    _assert_same(r_j, r_p)
    assert r_p[0].output_tokens == expected
    st = peng.spec_stats
    assert st == jeng.spec_stats
    assert 0 < st['accepted'] <= st['drafted']
    assert st['dispatches'] <= 4


def test_eos_max_new_and_mixed_sampled_slots(params):
    """An EOS met mid-draft ends the stream there, max_new_tokens=1
    still gives one token, and a sampled slot rides the verify at one
    token a dispatch while the greedy slot beside it keeps the JAX
    engine's tokens."""
    probe = port_engine(params).generate(
        [Request(tokens=[9, 8, 7], max_new_tokens=10)])[0]
    eos = probe.output_tokens[3]
    jeng = jax_engine(params, eos_id=eos, **SPEC)
    peng = port_engine(params, eos_id=eos, **SPEC)
    r_j, r_p = _both(jeng, peng, [[9, 8, 7], [4, 5]], max_new=10)
    _assert_same(r_j, r_p)
    assert r_p[0].finish_reason == 'eos' and r_p[0].output_tokens[-1] == eos
    [one] = peng.generate([Request(tokens=[4, 5], max_new_tokens=1)])
    assert len(one.output_tokens) == 1
    greedy = [5, 6, 7, 8, 5, 6, 7, 8]
    r_j, r_p = _both(jax_engine(params, **SPEC), port_engine(params, **SPEC),
                     [greedy, [1, 2, 3]], max_new=8, temps=[0.0, 0.9])
    _assert_same(r_j[:1], r_p[:1])
    assert len(r_p[1].output_tokens) == 8


def test_near_cache_end_falls_back_to_windowed(params):
    """A 16-row cache: once the slot is within draft_len + 1 of the end
    the dispatch is windowed (a clamped 4-row write would land on live
    rows); tokens as the JAX engine's and windowed decode's, through
    the cache-length finish."""
    kw = dict(max_cache_len=16, draft_len=3)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    prompt = [4, 3, 3, 2, 2, 1, 1, 1]       # drafts fire early
    r_j, r_p = _both(jeng, peng, [prompt], max_new=8)
    _assert_same(r_j, r_p)
    assert r_p[0].finish_reason == 'length'
    assert peng.spec_stats == jeng.spec_stats
    assert peng.spec_stats['dispatches'] >= 1
    windowed = port_engine(params, max_cache_len=16).generate(
        [Request(tokens=prompt, max_new_tokens=8)])[0]
    assert r_p[0].output_tokens == windowed.output_tokens


def test_spec_with_a_prefix_and_with_chunked_prefill(params):
    """Spec behind a registered prefix, then beside a prompt past the
    largest bucket that chunks while the others verify (the chunking
    lane's frontier rides every verify): the JAX engine's tokens and
    counters."""
    jeng, peng = jax_engine(params, **SPEC), port_engine(params, **SPEC)
    prefix = [5, 6, 7, 8, 5, 6, 7, 8]
    for eng in (jeng, peng):
        eng.register_prefix(prefix)
    r_j, r_p = _both(jeng, peng, [prefix + [5, 6]])
    _assert_same(r_j, r_p)
    assert peng.prefix_stats == jeng.prefix_stats == {
        'hits': 1, 'tokens_reused': 8}
    assert peng.spec_stats == jeng.spec_stats
    kw = dict(prefill_buckets=(8, 16), prefill_chunk=8, **SPEC)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    prompts = [[1, 2, 3, 1, 2, 3, 1], [3, 4] * 15]
    r_j, r_p = _both(jeng, peng, prompts)
    _assert_same(r_j, r_p)
    assert peng.chunk_stats == jeng.chunk_stats
    assert peng.chunk_stats['requests'] == 1
    assert peng.spec_stats == jeng.spec_stats


def test_lookahead_gated_off_and_warmup_leaves_counters(params):
    """decode_lookahead with draft_len: the serving loop never queues a
    window ahead (a verify needs the host's drafts), and the tokens are
    those of the offline spec engine.  warmup() runs the verify once
    and restores spec_stats and the acceptance EMA."""
    kw = dict(decode_lookahead=True, **SPEC)
    eng = port_engine(params, **kw)
    eng.warmup()
    assert eng.spec_stats == {'dispatches': 0, 'drafted': 0, 'accepted': 0}
    assert eng._accept_ema == 0.5
    ahead = []
    orig = eng._maybe_dispatch_ahead

    def spy(*a, **k):
        orig(*a, **k)
        ahead.append(eng._ahead is not None)

    eng._maybe_dispatch_ahead = spy
    prompts = _small_vocab_prompts(seed=5, n=4)
    reqs = [Request(request_id=str(i), tokens=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    served = eng.generate_served(reqs)
    assert ahead and not any(ahead)
    offline = port_engine(params, **SPEC).generate(
        [Request(tokens=p, max_new_tokens=12) for p in prompts])
    assert [r.output_tokens for r in served] == \
        [r.output_tokens for r in offline]
    assert eng.spec_stats['dispatches'] > 0


def _live(mod, engine):
    srv = mod.InferenceServer(engine)
    srv.start()
    assert srv.ready.wait(120)
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), mod._make_handler(srv))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd


def _post(port, path, body=None):
    conn = HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request('POST' if body is not None else 'GET', path,
                 body=None if body is None else json.dumps(body).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_draft_len_over_http_matches_the_jax_server(params):
    """Servers built with draft_len=3: /generate gives the JAX server's
    tokens and logprobs, and /stats the same spec counters."""
    live = [_live(jax_server, jax_engine(params, **SPEC)),
            _live(port_server, port_engine(params, **SPEC))]
    try:
        body = {'tokens': [1, 4, 3, 4, 3, 3, 4, 3, 3, 3],
                'max_new_tokens': 12, 'logprobs': True}
        outs = [_post(h.server_address[1], '/generate', body)
                for _, h in live]
        assert outs[0][0] == outs[1][0] == 200
        assert outs[0][1]['output_tokens'] == outs[1][1]['output_tokens']
        np.testing.assert_allclose(outs[1][1]['logprobs'],
                                   outs[0][1]['logprobs'], atol=TOL)
        stats = [_post(h.server_address[1], '/stats')[1] for _, h in live]
        assert stats[0]['spec'] == stats[1]['spec']
        assert stats[1]['spec']['accepted'] > 0
    finally:
        for srv, httpd in live:
            httpd.shutdown()
            httpd.server_close()
            srv.stop()
