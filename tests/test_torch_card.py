"""Checks of the port that need a CUDA card; each skips without one.

This file imports torch and numpy only, so that it runs on a machine with
a card and no JAX, with the JAX-pinning conftest switched off:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""
import dataclasses
import json
import threading
import time
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.infer import server
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request)
from skypilot_tpu_torch.models.registry import get_model_config
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.train import lora

# f32 kernels against their plain versions: summation order only.
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  ).to('cuda', dtype) for s in shapes)


def _counts():
    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches)


def test_cuda_path_differentiates_through_the_kernels(card):
    """The CUDA path differentiates through the autograd Function: one
    forward launch, then one launch of each backward kernel."""
    q, k, v = _inputs([(1, 2, 64, 64)] * 3, torch.bfloat16, seed=8)
    q.requires_grad_(True)
    before = _counts()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


@pytest.mark.parametrize('window', [None, 48])
def test_backward_kernels_match_plain_versions(card, window):
    """Each backward kernel against its plain version (f32, ragged S 200,
    GQA 4/2), and two calls bit-identical."""
    q, k, v, do = _inputs([(1, 4, 200, 64), (1, 2, 200, 64),
                           (1, 2, 200, 64), (1, 4, 200, 64)],
                          torch.float32, seed=11)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125, window)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, True, 0.125, window)
    got = (fa.flash_attention_bwd_dq(*args),
           *fa.flash_attention_bwd_dkv(*args))
    want = (fa.attention_bwd_dq_reference(*args),
            *fa.attention_bwd_dkv_reference(*args))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)
    again = (fa.flash_attention_bwd_dq(*args),
             *fa.flash_attention_bwd_dkv(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_backward_kernels_f32_head_dim_256_mqa(card):
    """The f32 (SIMT) backward kernels at head_dim 256, one kv head for
    eight q heads (the GQA fold of 8 inside dK/dV), ragged S 200 and a
    window, against their plain versions."""
    q, k, v, do = _inputs([(1, 8, 200, 256), (1, 1, 200, 256),
                           (1, 1, 200, 256), (1, 8, 200, 256)],
                          torch.float32, seed=13)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 256 ** -0.5, 48)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, True, 256 ** -0.5, 48)
    got = (fa.flash_attention_bwd_dq(*args),
           *fa.flash_attention_bwd_dkv(*args))
    want = (fa.attention_bwd_dq_reference(*args),
            *fa.attention_bwd_dkv_reference(*args))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)


def test_function_gradients_match_plain_on_the_card(card):
    """FlashAttentionFunction on CUDA tensors against the same Function on
    CPU tensors (the plain versions), f32."""
    q, k, v, do = _inputs([(2, 8, 130, 128), (2, 2, 130, 128),
                           (2, 2, 130, 128), (2, 8, 130, 128)],
                          torch.float32, seed=3)
    grads = {}
    for dev in ('cuda', 'cpu'):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = fa.FlashAttentionFunction.apply(*leaves, True, 128 ** -0.5,
                                              None)
        grads[dev] = torch.autograd.grad(out, leaves, do.to(dev))
    for g, w in zip(grads['cuda'], grads['cpu']):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=TOL)


# (b, hq, hkv, s, d, causal, window): the bf16 forward works in 128-row
# tiles (64-row kv tiles at head_dim 256), so these leave the last q and
# kv tiles part full (S 200, 1088) and start the kv loop past tile 0
# (window 300).
FWD_CASES = {
    'ragged_200': (1, 4, 2, 200, 128, True, None),
    'ragged_1088': (1, 16, 8, 1088, 128, True, None),
    # the int8 llama2-7b no-cache forward: MHA 32:32, ragged
    'llama2_7b_mha_281': (1, 32, 32, 281, 128, True, None),
    'non_causal_ragged_200': (1, 4, 2, 200, 128, False, None),
    'window_48': (2, 8, 2, 256, 128, True, 48),
    'window_300_d64': (1, 8, 2, 1088, 64, True, 300),
    'ragged_200_d256': (1, 4, 2, 200, 256, True, None),
    'ragged_1088_d256_mqa': (1, 8, 1, 1088, 256, True, None),
    'non_causal_ragged_200_d256': (1, 4, 4, 200, 256, False, None),
    'window_300_d256_mqa': (1, 8, 1, 1088, 256, True, 300),
    # batch x q heads = 65,552 blocks, past gridDim.y's 65,535 (the grid
    # puts them on x)
    'grid_4097x16': (4097, 16, 8, 128, 64, True, None),
    # head dims run in a wider tile, zeros past d: all-MiniLM's 32
    # non-causal, danube-1.8b's 80 with a window, danube3-500m's 96 GQA,
    # open_llama_3b's 100 (rows padded to 104 around the launch)
    'd32_non_causal_ragged_200': (1, 12, 12, 200, 32, False, None),
    'd80_window_300_gqa': (1, 8, 2, 1088, 80, True, 300),
    'd96_gqa_ragged_1088': (1, 16, 8, 1088, 96, True, None),
    'd100_ragged_200': (1, 4, 4, 200, 100, True, None),
}


@pytest.mark.parametrize('case', list(FWD_CASES), ids=list(FWD_CASES))
def test_forward_kernel_within_its_bound(card, case):
    """The bf16 forward against its plain version: O element by element
    within attention_fwd_bound, the LSE (f32 both sides) within 1e-4."""
    b, hq, hkv, s, d, causal, window = FWD_CASES[case]
    q, k, v = _inputs([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)],
                      torch.bfloat16, seed=5)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
    ref_out, ref_lse = fa.attention_fwd_reference(q, k, v, causal, scale,
                                                  window)
    bound = fa.attention_fwd_bound(q, k, v, causal, scale, window, ref_out)
    assert ((out.float() - ref_out.float()).abs() <= bound).all()
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL)


# (b, hq, hkv, s, d, causal, window): the bf16 backward kernels work in
# 128-row tiles (dK/dV: KV tiles, dQ: q tiles) of two 64-row warpgroups,
# 64-row tiles at head_dim 256: these leave tiles part full (S 200,
# 1088), start the q (KV) loop past tile 0 (window 300), run every tile
# unmasked but the edge (non-causal) and fold eight q heads into one kv
# head (MQA).
BWD_CASES = {
    'ragged_200': (1, 4, 2, 200, 128, True, None),
    'ragged_1088': (1, 16, 8, 1088, 128, True, None),
    'window_48': (2, 8, 2, 256, 128, True, 48),
    'window_300_d64': (1, 8, 2, 1088, 64, True, 300),
    'non_causal_1088': (1, 16, 8, 1088, 128, False, None),
    'ragged_200_d256': (1, 4, 2, 200, 256, True, None),
    'ragged_1088_d256_mqa': (1, 8, 1, 1088, 256, True, None),
    'window_300_d256_mqa': (1, 8, 1, 1088, 256, True, 300),
    'non_causal_1088_d256': (1, 8, 8, 1088, 256, False, None),
    # head dims run in a wider tile (FWD_CASES')
    'd32_non_causal_ragged_200': (1, 12, 12, 200, 32, False, None),
    'd80_window_300_gqa': (1, 8, 2, 1088, 80, True, 300),
    'd96_gqa_ragged_1088': (1, 16, 8, 1088, 96, True, None),
    'd100_ragged_200': (1, 4, 4, 200, 100, True, None),
}


@pytest.mark.parametrize('case', list(BWD_CASES), ids=list(BWD_CASES))
def test_backward_kernels_within_their_bounds(card, case):
    """The bf16 dQ and dK/dV kernels against their plain versions: each
    gradient element by element within attention_bwd_bound, and two calls
    bit-identical."""
    b, hq, hkv, s, d, causal, window = BWD_CASES[case]
    q, k, v, do = _inputs([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                           (b, hq, s, d)], torch.bfloat16, seed=6)
    scale = d ** -0.5
    out, lse = fa.attention_fwd_reference(q, k, v, causal, scale, window)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale, window)
    got = (fa.flash_attention_bwd_dq(*args),
           *fa.flash_attention_bwd_dkv(*args))
    again = (fa.flash_attention_bwd_dq(*args),
             *fa.flash_attention_bwd_dkv(*args))
    ref = (fa.attention_bwd_dq_reference(*args),
           *fa.attention_bwd_dkv_reference(*args))
    bounds = fa.attention_bwd_bound(*args, ref)
    for g, r, bound in zip(got, ref, bounds):
        assert ((g.float() - r.float()).abs() <= bound).all()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize('d', [32, 80, 96, 100])
def test_f32_kernels_at_head_dims_in_a_wider_tile(card, d):
    """The f32 (SIMT) forward and both backward kernels at head dims that
    fill part of their tile, GQA 4/2, ragged S 200, a window of 48,
    against their plain versions."""
    q, k, v, do = _inputs([(1, 4, 200, d), (1, 2, 200, d), (1, 2, 200, d),
                           (1, 4, 200, d)], torch.float32, seed=d)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale, 48)
    ref_out, ref_lse = fa.attention_fwd_reference(q, k, v, True, scale, 48)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale, 48)
    got = (fa.flash_attention_bwd_dq(*args),
           *fa.flash_attention_bwd_dkv(*args))
    want = (fa.attention_bwd_dq_reference(*args),
            *fa.attention_bwd_dkv_reference(*args))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize('name', ['llama-debug', 'gemma-debug'])
def test_debug_configs_train_on_the_card_as_on_the_cpu(card, name):
    """llama-debug (head_dim 16) and gemma-debug (32), whose head dims the
    kernels took last, in f32 through the Trainer on the card and the CPU
    from the same weights and batches: three steps' losses and grad
    norms, every parameter after the third, and 4/2/2 launches a step
    on the card (2 layers, remat)."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train import trainer as tt
    cfg = dataclasses.replace(get_model_config(name), dtype=torch.float32)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
               for _ in range(3)]
    out = {}
    for dev in ('cuda', 'cpu'):
        tr = tt.Trainer(tt.TrainConfig(model=name, batch_size=4, seq_len=64,
                                       warmup_steps=1, learning_rate=1e-3),
                        cfg, device=dev)
        tr.setup(params=sd)
        before = _counts()
        metrics = [tr._step_fn(tr.state, {'tokens': b}) for b in batches]
        launches = [a - b for a, b in zip(_counts(), before)]
        out[dev] = ([(m['loss'].item(), m['grad_norm'].item())
                     for m in metrics],
                    {k: v.cpu() for k, v in
                     tr.state.model.state_dict().items()}, launches)
    (mc, pc, nc), (mx, px, _) = out['cuda'], out['cpu']
    assert nc == [12, 6, 6]
    np.testing.assert_allclose(mc, mx, rtol=TOL)
    for n, p in pc.items():
        assert (p - px[n]).abs().max().item() <= \
            TOL * max(px[n].abs().max().item(), 1e-3), n


def _post(port, body):
    conn = HTTPConnection('127.0.0.1', port, timeout=120)
    conn.request('POST', '/generate', body=json.dumps(body).encode(),
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    assert resp.status == 200, data
    if resp.getheader('Content-Type') == 'text/event-stream':
        return [json.loads(ev[6:]) for ev in data.split(b'\n\n')
                if ev.startswith(b'data: ')]
    return json.loads(data)


def test_server_on_the_card_streams_what_it_returns(card):
    """The port's server over a depth-2 llama-1b (bf16) on the card: a
    plain and an SSE /generate of one greedy prompt give the same tokens,
    and the stream's chunks concatenate to its final result."""
    cfg = dataclasses.replace(get_model_config('llama-1b'), num_layers=2)
    engine = InferenceEngine(cfg, InferConfig(
        num_slots=2, max_cache_len=256, prefill_buckets=(64,),
        decode_steps=4), generator=torch.Generator('cuda').manual_seed(0))
    srv = server.InferenceServer(engine)
    srv.start()
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), server._make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert srv.ready.wait(120)
        body = {'tokens': list(range(1, 40)), 'max_new_tokens': 16}
        plain = _post(httpd.server_address[1], body)
        events = _post(httpd.server_address[1], {**body, 'stream': True})
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    done = events[-1]
    assert done['done'] and done['finish_reason'] == 'length'
    assert [t for e in events[:-1] for t in e['tokens']] == \
        done['output_tokens'] == plain['output_tokens']
    assert len(plain['output_tokens']) == 16 and len(events) > 2


# ------------------------------------------------------ the paged pool

def _depth2_engine(dtype, **options):
    cfg = dataclasses.replace(get_model_config('llama-1b'), num_layers=2,
                              dtype=dtype)
    # One draw of the weights (load_state_dict casts them to the model's
    # dtype), so every engine of these tests serves the same model.
    kw = dict(num_slots=4, max_cache_len=256, prefill_buckets=(64, 128, 256),
              decode_steps=4, max_new_tokens=16, cache_dtype=dtype)
    kw.update(options)
    eng = InferenceEngine(cfg, InferConfig(**kw),
                          params=_depth2_engine.params,
                          generator=torch.Generator('cuda').manual_seed(0))
    if _depth2_engine.params is None:
        _depth2_engine.params = eng.model.state_dict()
    return eng


_depth2_engine.params = None


def _teacher_forced_gap(model, results) -> float:
    """Max |logprob| gap between each generated token's reported logprob
    and the no-cache forward over prompt + output."""
    gap = 0.0
    for r in results:
        seq = torch.tensor([r.prompt_tokens + r.output_tokens[:-1]],
                           device='cuda')
        with torch.inference_mode():
            lp = torch.log_softmax(model(seq)[0].float(), dim=-1)
        n = len(r.prompt_tokens)
        rows = torch.arange(n - 1, n - 1 + len(r.output_tokens),
                            device='cuda')
        ref = lp[rows, torch.tensor(r.output_tokens, device='cuda')].cpu()
        gap = max(gap, (ref - torch.tensor(r.logprobs)).abs().max().item())
    return gap


def test_paged_matches_dense_on_the_card(card):
    """llama-1b at depth 2, f32, on the card: the paged engine (16-token
    blocks, radix cache on, two waves) against the dense engine and the
    no-cache forward -- teacher-forced gap <= 2e-3 nats (the serve
    phase's f32 bound: summation order only), and up to any first
    differing greedy token the two engines' logprobs agree as closely."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 32000, 40).tolist()
    prompts = [system + rng.integers(0, 32000, int(n)).tolist()
               for n in rng.integers(5, 80, 6)]
    dense = _depth2_engine(torch.float32)
    paged = _depth2_engine(torch.float32, kv_block_size=16,
                           auto_prefix_cache=True)
    for _ in range(2):
        reqs = [Request(tokens=p, max_new_tokens=16) for p in prompts]
        want, got = dense.generate(reqs), paged.generate(reqs)
        assert _teacher_forced_gap(paged.model, got) <= 2e-3
        for a, b in zip(want, got):
            assert b.finish_reason == a.finish_reason == 'length'
            k = next((i for i, (x, y) in enumerate(
                zip(a.output_tokens, b.output_tokens)) if x != y),
                len(a.output_tokens))
            np.testing.assert_allclose(b.logprobs[:k], a.logprobs[:k],
                                       atol=2e-3)
    assert paged.radix_stats['hits'] >= 6


def test_spill_recycle_restore_on_a_real_stream(card):
    """The host tier on the card, bf16: the hot prefix's blocks spill
    (copies queued into pinned memory on the serving stream) and are
    recycled by the very next prefill; the restore brings back the rows
    bit for bit, and the hot request's greedy tokens equal those of an
    engine whose pool never evicted them."""
    hot = [(5 * j) % 997 + 1 for j in range(48)]          # 3 blocks

    def churn(i):
        return Request(tokens=[(7 * j + 11 * i) % 997 + 1
                               for j in range(50)], max_new_tokens=4)

    roomy = _depth2_engine(torch.bfloat16, kv_block_size=16,
                           auto_prefix_cache=True)
    tier = _depth2_engine(torch.bfloat16, kv_block_size=16, kv_blocks=25,
                          auto_prefix_cache=True, host_kv_bytes=64 << 20)
    for eng in (roomy, tier):
        eng.generate([Request(tokens=hot + [50], max_new_tokens=4)])
    blocks = tier._radix.peek(None, hot, len(hot))
    before = [torch.stack([kp[b] for kp, _ in tier.cache]).clone()
              for b in blocks]
    for i in range(20):
        if not tier._radix.peek(None, hot, len(hot)):
            break
        for eng in (roomy, tier):
            eng.generate([churn(i)])
    assert tier._host_tier.stats['spills'] >= 3
    assert any(not torch.equal(a, torch.stack([kp[b] for kp, _ in
                                                tier.cache]))
               for a, b in zip(before, blocks))      # recycled, rewritten
    probe = [Request(tokens=hot + [60, 61], max_new_tokens=8)]
    got, want = tier.generate(probe)[0], roomy.generate(probe)[0]
    assert tier._host_tier.stats['restores'] == 3
    restored = tier._radix.peek(None, hot, len(hot))
    for a, b in zip(before, restored):
        assert torch.equal(a, torch.stack([kp[b] for kp, _ in tier.cache]))
    assert got.output_tokens == want.output_tokens


# ------------------------------------- chunked prefill, prompt scoring

@pytest.mark.parametrize('paged', [False, True])
def test_chunked_matches_monolithic_on_the_card(card, paged):
    """llama-1b at depth 2, f32, on the card: prompts of 150-230 tokens
    past the largest bucket (128) chunk 32 rows a round, dense and paged;
    their greedy tokens equal the monolithic engine's, and the
    teacher-forced gap stays within the f32 bound (2e-3 nats)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, int(n)).tolist()
               for n in rng.integers(150, 231, 5)]
    layout = dict(kv_block_size=16) if paged else {}
    mono = _depth2_engine(torch.float32, max_new_tokens=12, **layout)
    chunked = _depth2_engine(torch.float32, max_new_tokens=12,
                             prefill_buckets=(64, 128), prefill_chunk=32,
                             **layout)
    reqs = [Request(tokens=p, max_new_tokens=12) for p in prompts]
    want, got = mono.generate(reqs), chunked.generate(reqs)
    assert chunked.chunk_stats['requests'] == len(prompts)
    for a, b in zip(want, got):
        assert b.finish_reason == a.finish_reason == 'length'
        assert b.output_tokens == a.output_tokens
    assert _teacher_forced_gap(chunked.model, got) <= 2e-3


def test_prompt_logprobs_on_the_card_match_the_cpu(card):
    """Prompt scores and their top-k from the card within 2e-3 of the
    same f32 engine's on the CPU (summation order only)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 32000, n).tolist() for n in (9, 70, 128)]
    gpu = _depth2_engine(torch.float32)
    cpu = InferenceEngine(
        gpu.model_config, InferConfig(**{
            **dataclasses.asdict(gpu.cfg), 'prefill_buckets': (64, 128, 256)}),
        params={k: v.cpu() for k, v in gpu.model.state_dict().items()},
        generator=torch.Generator().manual_seed(0), device='cpu')
    reqs = [Request(tokens=p, max_new_tokens=2, want_prompt_logprobs=True)
            for p in prompts]
    for a, b in zip(cpu.generate(reqs), gpu.generate(reqs)):
        assert b.prompt_logprobs[0] is None
        np.testing.assert_allclose(b.prompt_logprobs[1:],
                                   a.prompt_logprobs[1:], atol=2e-3)
        for ta, tb in zip(a.prompt_top_logprobs[1:],
                          b.prompt_top_logprobs[1:]):
            np.testing.assert_allclose([lp for _, lp in tb],
                                       [lp for _, lp in ta], atol=2e-3)


# ------------------------------- fp8 cache, prefixes, speculative decode

def _fp8_sweep() -> np.ndarray:
    """The range e4m3 rounds into, the overflow band past 464, the
    rounding ties near 448-480, +-inf, NaN and subnormals, both signs."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 1, 20000), rng.normal(0, 300, 20000),
        np.linspace(440, 1000, 5601), [464, 465, 480, 1e6, np.inf, np.nan],
        np.linspace(0, 2 ** -6, 2001), [2 ** -9, 2 ** -10, 3 * 2 ** -11]])
    x = x.astype(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fp8_cast_on_the_card_gives_the_cpu_bytes(card, dtype):
    """models.llama.to_fp8 on the card gives the CPU's bytes (which
    tests/test_torch_fp8.py holds against the JAX cast), the overflow
    band included: the card's own conversion saturates or not, the
    helper's mask decides."""
    from skypilot_tpu_torch.models.llama import to_fp8
    x = torch.from_numpy(_fp8_sweep()).to(dtype)
    want = to_fp8(x).view(torch.uint8)
    got = to_fp8(x.cuda()).view(torch.uint8).cpu()
    assert torch.equal(got, want)
    assert int((want == 0x7F).sum()) > 1000


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_int8_quantization_on_the_card_gives_the_cpu_bytes(card, dtype):
    """models.quantize on the card gives the CPU's int8 bytes and f32
    scales for the same weights (which tests/test_torch_int8.py holds
    against the JAX package's quantize_params), and QuantLinear's bf16
    product on the card is within the bf16 bound of the CPU's f32 one:
    the product, the scale and the bias each round once to bf16 (2^-9
    relative), so 2^-6 of the output's largest magnitude."""
    from skypilot_tpu_torch.models import quantize
    from skypilot_tpu_torch.models.llama import QuantLinear
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(0, 0.02, (1024, 2048)).astype(
        np.float32)).to(dtype)
    w[3] = 0                                 # an all-zero channel
    q, scale = quantize.quantize_weight(w)
    got_q, got_scale = quantize.quantize_weight(w.cuda())
    assert torch.equal(got_q.cpu(), q) and torch.equal(got_scale.cpu(),
                                                       scale)
    assert int(q.abs().max()) == 127 and not q[3].any()
    bias = torch.from_numpy(rng.normal(0, 0.1, 1024).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (4, 2048)).astype(np.float32))
    lin = QuantLinear(2048, 1024, True, torch.bfloat16, torch.bfloat16,
                      device='cuda')
    with torch.no_grad():
        lin.weight_q.copy_(q)
        lin.scale.copy_(scale)
        lin.bias.copy_(bias)
        got = lin(x.cuda().to(torch.bfloat16)).float().cpu()
    want = (x.to(torch.bfloat16).float() @ q.float().T) * scale + \
        bias.to(torch.bfloat16).float()
    assert (got - want).abs().max().item() <= 2 ** -6 * want.abs().max()


def test_spec_and_prefix_on_the_card(card, monkeypatch):
    """llama-1b at depth 2, f32, on the card, dense and paged: a
    registered 70-token prefix and speculation (draft_len 4) with oracle
    drafts -- each prompt's windowed greedy continuation -- so the verify
    dispatches and accepts: every prompt a prefix hit, and the reported
    logprobs within the f32 bound (2e-3 nats) of the no-cache forward."""
    from skypilot_tpu_torch.infer import engine as engine_mod
    rng = np.random.default_rng(5)
    system = rng.integers(0, 32000, 70).tolist()
    prompts = [system + rng.integers(0, 32000, 6).tolist() for _ in range(4)]
    for layout in ({}, dict(kv_block_size=16)):
        windowed = _depth2_engine(torch.float32, **layout).generate(
            [Request(tokens=p, max_new_tokens=16) for p in prompts])
        by_prompt = {tuple(r.prompt_tokens): r.output_tokens
                     for r in windowed}

        def oracle(hist, k, nmax, by_prompt=by_prompt):
            for prompt, out in by_prompt.items():
                if tuple(hist[:len(prompt)]) == prompt:
                    done = len(hist) - len(prompt)
                    return out[done:done + k]
            return []

        monkeypatch.setattr(engine_mod, 'prompt_lookup_draft', oracle)
        eng = _depth2_engine(torch.float32, draft_len=4, **layout)
        assert eng.register_prefix(system) == 70
        got = eng.generate([Request(tokens=p, max_new_tokens=16)
                            for p in prompts])
        assert all(r.finish_reason == 'length' for r in got)
        assert eng.prefix_stats == {'hits': 4, 'tokens_reused': 280}
        st = eng.spec_stats
        assert 0 < st['accepted'] <= st['drafted']
        assert _teacher_forced_gap(eng.model, got) <= 2e-3


ALL_TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj', 'gate_proj',
               'up_proj', 'down_proj')


def _lora_sd(cfg, b_std, seed=0):
    """init_params of `cfg` with every lora_b drawn at `b_std`, so the
    adapters move the output."""
    from skypilot_tpu_torch.models.convert import init_params
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=gen) * b_std
                if k.endswith('lora_b') else v)
            for k, v in init_params(cfg, gen).items()}


def test_stacked_adapter_forward_on_the_card_matches_the_cpu(card):
    """llama-1b at depth 2, f32, adapters stacked 3 deep on every target
    with B drawn non-zero: the no-cache and the cached forward with
    per-row ids (-1, a base row, among them) on the card against the
    CPU, within the forward phase's f32 bound (2e-3: summation order
    over a 2048-wide stream and a 32000-way logit product)."""
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(get_model_config('llama-1b'), num_layers=2,
                              dtype=torch.float32, lora_rank=16,
                              lora_targets=ALL_TARGETS, lora_num_adapters=3)
    sd = _lora_sd(cfg, b_std=0.02)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 48)))
    ids = torch.tensor([1, -1, 2])
    outs = {}
    for dev in ('cuda', 'cpu'):
        model = llama.Llama(cfg, device=dev).eval()
        model.load_state_dict(sd)
        t = tokens.to(dev)
        with torch.inference_mode():
            full = model(t, adapter_ids=ids.to(dev))
            cache = llama.init_cache(cfg, 3, 48, torch.float32, dev)
            pos = torch.arange(48, device=dev).expand(3, 48)
            cached, _ = model(t, pos, cache, adapter_ids=ids.to(dev))
        outs[dev] = (full.cpu(), cached.cpu())
    for got, want in zip(outs['cuda'], outs['cpu']):
        assert (got - want).abs().max().item() <= 2e-3
    # The adapters move every adapter row, and the base row is the base.
    plain = dataclasses.replace(cfg, lora_rank=0)
    model = llama.Llama(plain, device='cuda').eval()
    model.load_state_dict({k: v for k, v in sd.items()
                           if not lora.is_lora_path(k)})
    with torch.inference_mode():
        base = model(tokens.cuda()).cpu()
    assert (outs['cuda'][0][1] - base[1]).abs().max().item() <= 2e-3
    assert (outs['cuda'][0][0] - base[0]).abs().max().item() > 1e-2


def test_register_adapter_from_a_second_thread_while_windows_run(card):
    """The serving loop decodes a base and an adapter stream on its own
    thread while this thread registers a new adapter into the stacked
    parameters (copy_ under the engine lock, on the engine's stream):
    the streams in flight and a request for the new adapter, queued
    once registration returned, give the tokens of an engine that had
    both adapters before serving (f32, depth 2)."""
    import queue
    cfg = dataclasses.replace(get_model_config('llama-1b'), num_layers=2,
                              dtype=torch.float32)
    sd = _lora_sd(dataclasses.replace(cfg, lora_rank=16,
                                      lora_num_adapters=2), b_std=0.5)
    base = {k: v for k, v in sd.items() if not lora.is_lora_path(k)}
    trees = [lora.nest({lora.flax_path(k): v[slot].numpy()
                        for k, v in sd.items() if lora.is_lora_path(k)})
             for slot in range(2)]

    def engine():
        return InferenceEngine(
            cfg, InferConfig(num_slots=4, max_cache_len=256,
                             prefill_buckets=(64,), decode_steps=4,
                             max_new_tokens=48, cache_dtype=torch.float32,
                             lora_rank=16, lora_max_adapters=2),
            params=base, generator=torch.Generator('cuda').manual_seed(0))

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 32000, 30).tolist() for _ in range(3)]
    reqs = lambda: [Request(tokens=prompts[0], adapter='x',  # noqa: E731
                            request_id='x'),
                    Request(tokens=prompts[1], request_id='base'),
                    Request(tokens=prompts[2], adapter='y',
                            max_new_tokens=16, request_id='y')]
    ref = engine()
    ref.register_adapter('x', trees[0])
    ref.register_adapter('y', trees[1])
    want = {r.request_id: r.output_tokens for r in ref.generate(reqs())}
    del ref
    live = engine()
    live.register_adapter('x', trees[0])
    q, results, stop = queue.Queue(), {}, threading.Event()
    loop = threading.Thread(target=live.generate_stream, args=(
        q, lambda r: results.__setitem__(r.request_id, r), stop),
        daemon=True)
    loop.start()
    first, second, third = reqs()
    q.put(first)
    q.put(second)
    deadline = time.time() + 60
    while sum(s is not None and len(s.generated) > 8
              for s in live._slots) < 2 and time.time() < deadline:
        time.sleep(0.001)
    assert live.register_adapter('y', trees[1]) == 1
    q.put(third)
    while len(results) < 3 and time.time() < deadline:
        loop.join(timeout=0.01)
    stop.set()
    loop.join(timeout=30)
    assert all(r.finish_reason == 'length' for r in results.values())
    assert {k: r.output_tokens for k, r in results.items()} == want


@pytest.mark.parametrize('name', ['gpt2-debug', 'mixtral-debug'])
def test_new_families_on_the_card_match_the_cpu(card, name):
    """gpt2-debug and mixtral-debug, widened to 256 (head_dim 64, which
    the kernels take), in f32 with the same weights on the card and the
    CPU: the no-cache logits (the f32 flash kernel; capacity
    routing for Mixtral), one train objective's gradients (both backward
    kernels; the router's gradient through the aux loss), and the
    engine's greedy tokens (the cached path; Mixtral routes exactly)."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.train import trainer as tt
    wide = {'hidden_size': 256}
    if name == 'mixtral-debug':
        wide['intermediate_size'] = 256
    cfg = dataclasses.replace(get_model_config(name), dtype=torch.float32,
                              **wide)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    sd = {k: v * (1.0 if v.dim() < 2 else 5.0) for k, v in sd.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)))
    out = {}
    for dev in ('cuda', 'cpu'):
        model = registry.build_model(cfg, device=dev,
                                     param_dtype=torch.float32)
        model.load_state_dict(sd)
        t = toks.to(dev)
        with torch.no_grad():
            logits = model(t[:, :-1]).cpu()
        loss = tt.loss_fn(model, t[:, :-1], t[:, 1:])
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        eng = InferenceEngine(cfg, InferConfig(
            num_slots=2, max_cache_len=64, prefill_buckets=(16,),
            max_new_tokens=8, cache_dtype=torch.float32), params=sd,
            device=dev)
        res = eng.generate([Request(tokens=toks[i, :9].tolist())
                            for i in range(2)])
        out[dev] = (logits, loss.item(), grads,
                    [r.output_tokens for r in res])
    (lc, fc, gc, tc), (lx, fx, gx, tx) = out['cuda'], out['cpu']
    assert (lc - lx).abs().max().item() <= TOL * max(1.0, lx.abs().max())
    assert abs(fc - fx) <= TOL * abs(fx)
    for n, g in gc.items():
        assert (g - gx[n]).abs().max().item() <= \
            TOL * max(gx[n].abs().max().item(), 1e-3), n
    if name == 'mixtral-debug':
        assert gx['layers.0.moe.router.weight'].abs().sum() > 0
    assert tc == tx


def test_bert_base_width_on_the_card_matches_the_cpu(card):
    """bert-base's width at depth 2 in f32, the classifier head, the same
    weights and batch on the card and the CPU: the logits, the loss and
    every gradient without a mask (the f32 kernels non-causal at head_dim
    64: 4/2/2 launches under remat) and the logits with a padding mask
    (the plain masked path, no launch)."""
    from skypilot_tpu_torch.models import convert, registry
    cfg = dataclasses.replace(get_model_config('bert-base'), num_layers=2,
                              dtype=torch.float32)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0),
                             head='classify')
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    labels = torch.tensor([0, 1])
    mask = torch.ones((2, 128), dtype=torch.long)
    mask[1, 100:] = 0
    out = {}
    for dev in ('cuda', 'cpu'):
        model = registry.build_model(cfg, head='classify', device=dev,
                                     param_dtype=torch.float32)
        model.load_state_dict(sd)
        before = _counts()
        logits = model(tokens.to(dev))
        loss = torch.nn.functional.cross_entropy(logits, labels.to(dev))
        loss.backward()
        launched = [b - a for a, b in zip(before, _counts())]
        with torch.no_grad():
            masked = model(tokens.to(dev), None, mask.to(dev)).cpu()
        masked_launched = [b - a for a, b in zip(before, _counts())]
        out[dev] = (logits.detach().cpu(), loss.item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    masked, launched, masked_launched)
    (lc, fc, gc, mc, nc, mnc), (lx, fx, gx, mx, _, _) = \
        out['cuda'], out['cpu']
    assert nc == [4, 2, 2] and mnc == nc
    assert (lc - lx).abs().max().item() <= TOL * max(1.0, lx.abs().max())
    assert (mc - mx).abs().max().item() <= TOL * max(1.0, mx.abs().max())
    assert abs(fc - fx) <= TOL * abs(fx)
    for n, g in gc.items():
        assert (g - gx[n]).abs().max().item() <= \
            TOL * max(gx[n].abs().max().item(), 1e-3), n


def test_resnet_step_on_the_card_matches_the_cpu(card):
    """A small f32 ResNet (resnet18-debug, 32x32) through one task-loop
    step on the card and the CPU from the same weights and batch, TF32
    off (cuDNN runs f32 convolutions in TF32 by default): the loss, every
    parameter after the SGD step and the running statistics."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train import tasks
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_model_config('resnet18-debug'),
                              dtype=torch.float32)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    batch = next(tasks.synthetic_resnet_batches(0, 0, 16, 32,
                                                cfg.num_classes))
    out = {}
    for dev in ('cuda', 'cpu'):
        state = tasks.resnet_setup(cfg, 0.1, 0.9, 10, device=dev,
                                   params=sd)
        loss, _ = tasks.resnet_step(state, batch)
        out[dev] = (loss.item(), {k: v.cpu() for k, v in
                                  state.model.state_dict().items()})
    (fc, sc), (fx, sx) = out['cuda'], out['cpu']
    assert abs(fc - fx) <= TOL * abs(fx)
    for k, v in sc.items():
        assert (v - sx[k]).abs().max().item() <= \
            TOL * max(sx[k].abs().max().item(), 1e-3), k


def test_one_rank_mesh_trainer_on_the_card_matches_the_no_mesh_trainer(card):
    """The trainer with MeshSpec(fsdp=1) -- FSDP2 over a one-rank NCCL
    process group, the card host's one card -- against the no-mesh
    trainer at depth 2 in f32, from the same weights and batches: the
    loss of each of 2 steps and every gradient of the last (the f32
    kernels at head_dim 64, 4/2/2 launches a step under remat)."""
    from torch.distributed.tensor import DTensor

    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    from skypilot_tpu_torch.train import trainer as tt
    cfg = dataclasses.replace(get_model_config('llama-debug'),
                              hidden_size=256, dtype=torch.float32)
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)))
               for _ in range(2)]
    out = {}
    for name, mesh in (('no_mesh', None), ('mesh', MeshSpec(fsdp=1))):
        tr = tt.Trainer(tt.TrainConfig(model='llama-debug', batch_size=2,
                                       seq_len=128, warmup_steps=1,
                                       mesh=mesh), cfg, device='cuda')
        tr.setup(params=sd)
        before = _counts()
        losses = [tr._step_fn(tr.state, {'tokens': b})['loss'].item()
                  for b in batches]
        launches = [a - b for a, b in zip(_counts(), before)]
        grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                     else p.grad).cpu()
                 for n, p in tr.state.model.named_parameters()}
        out[name] = (losses, grads, launches)
    torch.distributed.destroy_process_group()
    (lm, gm, nm), (ln, gn, nn_) = out['mesh'], out['no_mesh']
    assert nm == nn_ == [8, 4, 4]
    np.testing.assert_allclose(lm, ln, rtol=1e-6)
    for n, g in gm.items():
        assert (g - gn[n]).abs().max().item() <= \
            TOL * max(gn[n].abs().max().item(), 1e-3), n


def test_f32_forward_past_the_old_grid_limit(card):
    """The f32 forward at batch 4,097 x 16 q heads (the SIMT path's grid
    puts them on x too) against its plain version."""
    q, k, v = _inputs([(4097, 16, 32, 64), (4097, 8, 32, 64),
                       (4097, 8, 32, 64)], torch.float32, seed=6)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125, None)
    ref_out, ref_lse = fa.attention_fwd_reference(q, k, v, True, 0.125, None)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL)


def _tp_rank(rank: int, init: str, out_dir: str) -> None:
    """A rank of the two-rank card test: llama2-7b's widths at depth 2 in
    f32, tp=2 over a gloo group on card 0; rank 0 writes its tokens and
    logprobs, and the tp=1 engine's."""
    import pathlib
    import traceback

    from skypilot_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    res = {}
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.distributed.init_process_group('gloo', init_method=init,
                                             rank=rank, world_size=2)
        cfg = dataclasses.replace(get_model_config('llama2-7b'),
                                  num_layers=2, dtype=torch.float32)
        icfg = dict(num_slots=4, max_cache_len=256, max_new_tokens=12,
                    prefill_buckets=(64, 128, 256),
                    cache_dtype=torch.float32)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (17, 90, 150, 33)]

        def engine(mesh=None):
            return InferenceEngine(cfg, InferConfig(**icfg), device='cuda',
                                   mesh=mesh, generator=torch.Generator(
                                       device='cuda').manual_seed(0))

        eng = engine(make_mesh(MeshSpec(tensor=2), 'cuda'))
        res['heads'] = int(eng.cache[0][0].shape[1])
        if rank == 0:
            got = eng.generate([Request(tokens=p) for p in prompts])
            eng.shutdown()
            del eng
            want = engine().generate([Request(tokens=p) for p in prompts])
            res['got'] = [(r.output_tokens, r.logprobs) for r in got]
            res['want'] = [(r.output_tokens, r.logprobs) for r in want]
        else:
            eng.serve_worker()
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 -- shipped to the test
        res['error'] = traceback.format_exc()
    pathlib.Path(out_dir, f'rank{rank}.json').write_text(json.dumps(res))


def test_tensor_parallel_engine_on_the_card_matches_tp1(card, tmp_path):
    """Two ranks on the one card (a gloo group over CUDA tensors: NCCL
    refuses two ranks on one card), llama2-7b's widths at depth 2 in f32:
    each rank holds half the kv heads, and the tp=2 engine's greedy
    tokens equal the tp=1 engine's, logprobs within 2e-3 (f32, another
    summation order)."""
    import multiprocessing as mproc
    ctx = mproc.get_context('spawn')
    init = 'file://' + str(tmp_path / 'store')
    procs = [ctx.Process(target=_tp_rank, args=(r, init, str(tmp_path)))
             for r in range(2)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(600)
        assert not proc.is_alive()
    ranks = [json.loads((tmp_path / f'rank{r}.json').read_text())
             for r in range(2)]
    for rank in ranks:
        assert 'error' not in rank, rank['error']
        assert rank['heads'] == 16
    for (g, glp), (w, wlp) in zip(ranks[0]['got'], ranks[0]['want']):
        assert g == w
        np.testing.assert_allclose(glp, wlp, rtol=0, atol=2e-3)
