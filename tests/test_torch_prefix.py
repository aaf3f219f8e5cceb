"""The port's registered prefixes (register_prefix, POST /cache_prefix,
--auto-prefix) held against the JAX engine and server, on the tiny f32
model of helpers_torch (CPU):

- dense: a prompt that starts with a registered prefix prefills only its
  suffix and gives the JAX engine's tokens (and a prefix-free engine's
  greedy tokens), the prompt == prefix edge reusing all rows but one, a
  prompt inside a prefix, the longest match, a lane-batched burst, LRU
  eviction, and a prefixed prompt whose suffix has no bucket (it chunks);
- paged: the prefix's full blocks shared by reference and its partial
  tail block copied, the pool's counters and the conservation law after
  every window, offline and in the serving loop, and _force_admit_blocks
  evicting prefixes for an offline request in a tight pool;
- radix: registration pins the prefix's nodes through eviction waves;
- HTTP: /cache_prefix's cached_prefix_len, /stats, and --auto-prefix
  registering a head on its second sighting, an OpenAI n clone counted
  once, and off by default."""
import json
import queue
import threading
import time
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from helpers_torch import (WindowAudit, conservation_errors, jax_engine,
                           make_params, port_engine)
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu_torch.infer import Request
from skypilot_tpu_torch.infer import server as port_server

# f32 on both sides: logprobs differ by summation order only.
TOL = 1e-5
PREFIX = [7, 3, 9, 9, 2, 5, 1, 4, 4, 8]


@pytest.fixture(scope='module')
def params():
    return make_params()


def _run(jeng, peng, prompts, max_new=6):
    """The same greedy requests through both engines; asserts equal
    tokens, finish reasons and logprobs; returns the port's results."""
    r_j = jeng.generate([JaxRequest(tokens=list(p), max_new_tokens=max_new)
                         for p in prompts])
    r_p = peng.generate([Request(tokens=list(p), max_new_tokens=max_new)
                         for p in prompts])
    for a, b in zip(r_j, r_p):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason == a.finish_reason
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=TOL)
    return r_p


# ------------------------------------------------------------- dense

def test_dense_prefix_matches_jax_and_full_prefill(params):
    """Suffixes of 2, 1 and 19 tokens behind a 10-token prefix, the
    prefix itself (start 9), a prompt inside it (full prefill, no hit)
    and one that diverges at token 0: the JAX engine's tokens and
    counters, and a prefix-free engine's greedy tokens."""
    jeng, peng = jax_engine(params), port_engine(params)
    plain = port_engine(params)
    assert jeng.register_prefix(PREFIX) == peng.register_prefix(PREFIX) == 10
    prompts = [PREFIX + [11, 12], PREFIX + [42], PREFIX + list(range(20, 39)),
               list(PREFIX), PREFIX[:5], [9, 9, 9, 1, 2]]
    out = _run(jeng, peng, prompts)
    assert peng.prefix_stats == jeng.prefix_stats == {
        'hits': 4, 'tokens_reused': 3 * 10 + 9}
    ref = plain.generate([Request(tokens=list(p), max_new_tokens=6)
                          for p in prompts])
    assert [r.output_tokens for r in out] == [r.output_tokens for r in ref]
    assert peng.stats()['kv']['prefix'] == jeng.stats()['kv']['prefix']


def test_dense_longest_match_burst_and_lru(params):
    """Two nested prefixes: the longer wins.  Six prompts behind it start
    in two lane-batched dispatches.  With max_prefixes=2 a third
    registration evicts the least recently used entry -- a hit is a
    touch -- and max_prefixes=0 refuses registration, as in JAX."""
    jeng = jax_engine(params, max_prefixes=2)
    peng = port_engine(params, max_prefixes=2)
    long = PREFIX + [30, 31, 32, 33, 34, 35]
    for eng in (jeng, peng):
        eng.register_prefix(PREFIX)
        eng.register_prefix(long)
    burst = [long + [40 + i] * (i + 1) for i in range(6)]
    _run(jeng, peng, burst)
    assert peng.prefix_stats == jeng.prefix_stats == {
        'hits': 6, 'tokens_reused': 6 * 16}
    # The long prefix was touched last: registering a third evicts PREFIX.
    for eng in (jeng, peng):
        eng.register_prefix([1, 2, 3])
    assert list(peng._prefixes) == list(jeng._prefixes) == [
        (None, tuple(long)), (None, (1, 2, 3))]
    for make in (jax_engine, port_engine):
        with pytest.raises(ValueError, match='disabled'):
            make(params, max_prefixes=0).register_prefix([1, 2])


def test_prefixed_prompt_without_a_suffix_bucket_chunks(params):
    """Buckets (8, 16) with 8-token chunks: behind a 16-token prefix a
    5-token suffix takes the prefixed prefill, a 20-token one has no
    suffix bucket, so the whole 36-token prompt chunks -- as in JAX."""
    kw = dict(prefill_buckets=(8, 16), prefill_chunk=8)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    prefix = PREFIX + [21, 22, 23, 24, 25, 26]
    for eng in (jeng, peng):
        eng.register_prefix(prefix)
    _run(jeng, peng, [prefix + [50, 51, 52, 53, 54],
                      prefix + list(range(60, 80))])
    assert peng.prefix_stats == jeng.prefix_stats == {
        'hits': 1, 'tokens_reused': 16}
    assert peng.chunk_stats == jeng.chunk_stats
    assert peng.chunk_stats['requests'] == 1


# ------------------------------------------------------------- paged

def test_paged_prefix_sharing_counters_and_conservation(params):
    """An 11-token prefix over 8-row blocks: one full block shared by
    reference, the 3-row tail copied into each lane's private block.
    Tokens, prefix and pool counters as the JAX paged engine's, the
    conservation law after every window (offline, then in the serving
    loop), and the sharing visible mid-flight."""
    kw = dict(kv_block_size=8, kv_blocks=64, max_prefixes=2)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    prefix = [7] * 11
    for eng in (jeng, peng):
        eng.register_prefix(prefix)
    assert peng.stats()['blocks_prefix'] == 2
    rng = np.random.default_rng(1)
    prompts = [prefix + rng.integers(1, 101, int(n)).tolist()
               for n in rng.integers(1, 10, 5)] + [list(prefix)]
    with WindowAudit(peng) as audit:
        _run(jeng, peng, prompts)
        assert peng.prefix_stats == jeng.prefix_stats
        assert peng.prefix_stats['hits'] == 6
        assert peng.paged_stats == jeng.paged_stats
        for key in ('blocks_prefix', 'blocks_allocated', 'blocks_shared'):
            assert peng.stats()[key] == jeng.stats()[key]
        assert peng.stats()['blocks_allocated'] == 2   # the entry's own
        # The serving loop: the same prompts, the law after each window.
        results, done = {}, threading.Event()
        q = queue.Queue()
        for i, p in enumerate(prompts):
            q.put(Request(request_id=str(i), tokens=list(p),
                          max_new_tokens=6))

        def deliver(res):
            results[res.request_id] = res
            if len(results) == len(prompts):
                done.set()

        stop = threading.Event()
        t = threading.Thread(target=peng.generate_stream,
                             args=(q, deliver, stop), daemon=True)
        t.start()
        assert done.wait(60)
        stop.set()
        t.join(10)
    assert audit.errors == [] and audit.windows >= 4
    assert all(r.finish_reason == 'length' for r in results.values())
    # Mid-flight: two matched requests started by hand share the full
    # block (three references: the entry and two tables).
    items = []
    for slot in range(2):
        req = Request(tokens=prefix + [50 + slot], max_new_tokens=4)
        items.append((req, slot, 0.0, *peng._validate_request(req)))
    with peng._lock:
        peng._start_batch(items)
        st = peng.stats()
        assert st['blocks_shared'] == 1 and st['shared_refs_saved'] == 2
        assert conservation_errors(peng) == []
        for i in range(2):
            peng._finish_slot(i, 'cancelled')
    assert peng.stats()['blocks_allocated'] == 2
    assert conservation_errors(peng) == []


def test_paged_force_admit_evicts_prefixes_in_a_tight_pool(params):
    """Eleven usable blocks, three registered 16-token prefixes holding
    six: a request needing eight blocks is not admissible, nothing runs,
    so _force_admit_blocks evicts prefixes (LRU first) until it fits --
    offline as in JAX, and in the serving loop."""
    kw = dict(kv_block_size=8, kv_blocks=12, max_prefixes=4)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    prefixes = [[i + 1] * 16 for i in range(3)]
    for eng in (jeng, peng):
        for p in prefixes:
            eng.register_prefix(p)
    assert peng.stats()['blocks_prefix'] == 6
    big = list(range(30, 60))
    with WindowAudit(peng) as audit:
        _run(jeng, peng, [big], max_new=30)
    assert audit.errors == []
    assert list(peng._prefixes) == list(jeng._prefixes) == [
        (None, tuple(prefixes[2]))]
    assert peng.stats()['kv']['admission'] == \
        jeng.stats()['kv']['admission']
    # The serving loop reaches it too.
    serve = port_engine(params, **kw)
    for p in prefixes:
        serve.register_prefix(p)
    [res] = serve.generate_served([Request(request_id='big', tokens=big,
                                           max_new_tokens=30)])
    assert res.finish_reason == 'length' and len(res.output_tokens) == 30
    assert len(serve._prefixes) == 1
    assert conservation_errors(serve) == []


# ------------------------------------------------------------- radix

def test_radix_registration_pins_through_eviction_waves(params):
    """Under auto_prefix_cache registering pins: the 16-token prefix's
    two nodes survive waves that evict every other leaf of a 19-block
    pool, the next prompt behind it is a radix hit, and the tokens and
    radix counters are the JAX engine's."""
    kw = dict(kv_block_size=8, kv_blocks=20, auto_prefix_cache=True)
    jeng, peng = jax_engine(params, **kw), port_engine(params, **kw)
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 101, 16).tolist()
    assert jeng.register_prefix(prefix + [5]) == \
        peng.register_prefix(prefix + [5]) == 16
    assert peng._radix.pinned == 2
    with WindowAudit(peng) as audit:
        for _ in range(3):
            wave = [rng.integers(1, 101, int(rng.integers(12, 30))).tolist()
                    for _ in range(4)]
            _run(jeng, peng, wave, max_new=4)
        assert peng.radix_stats['evictions'] > 0
        assert peng._radix.pinned == 2
        hits = peng.radix_stats['hits']
        _run(jeng, peng, [prefix + [3, 4]], max_new=3)
    assert audit.errors == []
    assert peng.radix_stats['hits'] == hits + 1
    assert peng.radix_stats == jeng.radix_stats
    with pytest.raises(ValueError, match='shorter than one KV block'):
        peng.register_prefix([1, 2, 3])


# -------------------------------------------------------------- HTTP

class _Live:
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

    def call(self, path, body=None):
        conn = HTTPConnection('127.0.0.1', self.port, timeout=60)
        conn.request('POST' if body is not None else 'GET', path,
                     body=None if body is None else json.dumps(body).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.stop()


def _pair(params, engine_kw, **server_kw):
    return (_Live(jax_server, jax_engine(params, **engine_kw), **server_kw),
            _Live(port_server, port_engine(params, **engine_kw),
                  **server_kw))


def test_cache_prefix_route_matches_jax(params):
    """POST /cache_prefix answers {"cached_prefix_len": n} (a 400 without
    tokens), and a prompt behind the prefix generates the JAX server's
    tokens with the same /stats prefix counters."""
    servers = _pair(params, {})
    try:
        got = [s.call('/cache_prefix', {'tokens': PREFIX}) for s in servers]
        assert got[0] == got[1] == (200, {'cached_prefix_len': 10})
        assert servers[1].call('/cache_prefix', {})[0] == 400
        outs = [s.call('/generate', {'tokens': PREFIX + [2, 6],
                                     'max_new_tokens': 8})
                for s in servers]
        assert outs[0][1]['output_tokens'] == outs[1][1]['output_tokens']
        stats = [s.call('/stats')[1] for s in servers]
        assert stats[0]['prefix'] == stats[1]['prefix'] == {
            'hits': 1, 'tokens_reused': 10}
        assert stats[0]['resident_prefixes'] == \
            stats[1]['resident_prefixes'] == 1
    finally:
        for s in servers:
            s.close()


def _resident(eng, n, timeout=30.0):
    deadline = time.time() + timeout
    while len(eng._prefixes) < n and time.time() < deadline:
        time.sleep(0.02)
    return len(eng._prefixes)


def test_auto_prefix_second_sighting_and_n_clone(params):
    """--auto-prefix: a 70-token prompt's 64-token head (the longest
    bucket inside it) registers on its second sighting; an OpenAI
    request with n=2 counts its head once.  The same on both servers,
    and the third prompt behind the head is a prefix hit."""
    engine_kw = dict(max_cache_len=128, prefill_buckets=(8, 16, 32, 64))
    servers = _pair(params, engine_kw, auto_prefix=True)
    head = [(3 * j) % 97 + 1 for j in range(64)]
    other = [(5 * j) % 97 + 2 for j in range(64)]
    try:
        for s in servers:
            body = {'prompt': other + [1, 2, 3, 4, 5, 6], 'max_tokens': 2,
                    'n': 2}
            assert s.call('/v1/completions', body)[0] == 200
        time.sleep(0.3)
        assert [len(s.srv.engine._prefixes) for s in servers] == [0, 0]
        for k in range(2):
            for s in servers:
                assert s.call('/generate', {
                    'tokens': head + [10 + k] * 6,
                    'max_new_tokens': 2})[0] == 200
        assert [_resident(s.srv.engine, 1) for s in servers] == [1, 1]
        # The second request may or may not land behind its own
        # registration (a background thread): count hits from here.
        hits = [s.srv.engine.prefix_stats['hits'] for s in servers]
        outs = [s.call('/generate', {'tokens': head + [40] * 6,
                                     'max_new_tokens': 4})[1]
                for s in servers]
        assert outs[0]['output_tokens'] == outs[1]['output_tokens']
        for s, h in zip(servers, hits):
            st = s.srv.engine.prefix_stats
            assert st['hits'] == h + 1
            assert st['tokens_reused'] == 64 * st['hits']
        assert list(servers[1].srv.engine._prefixes) == [(None, tuple(head))]
    finally:
        for s in servers:
            s.close()
    # Off by default: the same head three times counts nothing.
    off = port_server.InferenceServer(port_engine(params, **engine_kw))
    for k in range(3):
        off._maybe_auto_prefix(Request(tokens=head + [10 + k] * 6))
    assert off._auto_counts == {} and not off.engine._prefixes
