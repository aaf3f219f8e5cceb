"""The two faults of the JAX engine's multi-LoRA serving that the port
does not copy (ROADMAP.md C3 and C4), each shown beside the JAX engine's
answer on the tiny f32 model of helpers_torch (CPU):

- C3: re-registering an adapter leaves the KV computed under its old
  weights in the radix tree and the host tier, and the JAX engine serves
  from it; the port drops it and serves a fresh engine's tokens.
- C4: a non-finite adapter in stack slot 0 reaches every base row as
  inf * 0 = NaN and the JAX engine kills base requests; the port masks
  base rows and serves the clean base tokens."""
import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from helpers_torch import WindowAudit, jax_engine, make_params, port_engine
from skypilot_tpu.infer import Request as JaxRequest
from skypilot_tpu.train import lora as jlora
from skypilot_tpu_torch.infer import FaultPlan, FaultSpec, Request
from skypilot_tpu_torch.train import lora
from test_torch_lora_serving import (LORA, PROMPTS, RADIX, TIGHT, _churn,
                                     _pair, _same, _tree)


@pytest.fixture(scope='module')
def params():
    return make_params()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Adapters 'a' and 'b' as the JAX package writes them."""
    root = tmp_path_factory.mktemp('adapters')
    jlora.save_adapter_npz(_tree(1), str(root / 'a.npz'))
    jlora.save_adapter_npz(_tree(2), str(root / 'b.npz'))
    return root


@pytest.mark.parametrize('where', ['radix', 'host-tier'])
def test_c3_reregistration_drops_stale_kv(params, files, where):
    """ROADMAP.md C3.  A 17-token prompt served under 't', 't'
    re-registered with other weights, the prompt served again: the JAX
    engine reuses the KV computed under the old weights (from the radix
    tree, or restored from the host tier after a churn spilled it) and
    its tokens differ from a fresh engine's with the new weights; the
    port's equal the fresh engine's, and its pool stays conserved."""
    kw = RADIX if where == 'radix' else TIGHT
    prompt = [(3 * j + 7) % 97 + 1 for j in range(17)]
    je, pe = _pair(params, files, names=('t',), **kw)
    fresh = jax_engine(params, **LORA, **kw)
    fresh.register_adapter('t', jlora.load_adapter_npz(
        str(files / 'b.npz')))
    want = fresh.generate([JaxRequest(tokens=prompt, max_new_tokens=8,
                                      adapter='t')])[0]
    with WindowAudit(pe) as audit:
        for eng, cls, mod in ((je, JaxRequest, jlora), (pe, Request, lora)):
            eng.generate([cls(tokens=prompt, max_new_tokens=8,
                              adapter='t')])
            if where == 'host-tier':
                for i in range(4):
                    eng.generate([_churn(cls, i)])
            eng.register_adapter('t', mod.load_adapter_npz(
                str(files / 'b.npz')))
        [stale] = je.generate([JaxRequest(tokens=prompt, max_new_tokens=8,
                                          adapter='t')])
        [got] = pe.generate([Request(tokens=prompt, max_new_tokens=8,
                                     adapter='t')])
    assert je.radix_stats['hits'] == 1 and pe.radix_stats['hits'] == 0
    assert stale.output_tokens != want.output_tokens
    _same([want], [got])
    assert audit.errors == []
    if where == 'radix':
        assert pe._radix.peek('t', prompt, 16) != []   # the new rows


def test_c3_slot_admitted_under_old_weights_is_not_cached(params, files):
    """A slot admitted under 't' that finishes after 't' is re-registered
    inserts nothing into the radix tree (its prompt rows are the old
    weights'), and the pool stays conserved after every window."""
    pe = port_engine(params, **LORA, **RADIX)
    pe.register_adapter('t', lora.load_adapter_npz(str(files / 'a.npz')))
    pe.arm_faults(FaultPlan(seed=0, specs=[
        FaultSpec(site='stall', prob=1.0, stall_s=0.01)]))
    q, results, stop = queue.Queue(), [], threading.Event()
    loop = threading.Thread(target=pe.generate_stream,
                            args=(q, results.append, stop), daemon=True)
    prompt = [(3 * j + 7) % 97 + 1 for j in range(17)]
    with WindowAudit(pe) as audit:
        loop.start()
        q.put(Request(tokens=prompt, max_new_tokens=30, adapter='t',
                      request_id='old'))
        deadline = time.time() + 30
        while pe._slots[0] is None and time.time() < deadline:
            time.sleep(0.002)
        pe.register_adapter('t', lora.load_adapter_npz(
            str(files / 'b.npz')))
        while not results and time.time() < deadline:
            time.sleep(0.01)
        stop.set()
        loop.join(timeout=30)
    assert [r.finish_reason for r in results] == ['length']
    assert pe._radix.peek('t', prompt, 16) == []
    assert pe.radix_stats['inserts'] == 0
    assert audit.errors == [] and audit.windows > 0


def test_c3_prefix_captured_across_reregistration_is_recaptured(params,
                                                                files):
    """A dense register_prefix captures outside the engine lock: when 't'
    is re-registered between the capture and the insert, the rows of its
    old weights are not kept.  The prefix is captured again, so its rows
    equal a fresh engine's with the new weights, and a request under 't'
    gets that fresh JAX engine's tokens."""
    pe = port_engine(params, **LORA)
    pe.register_adapter('t', lora.load_adapter_npz(str(files / 'a.npz')))
    capture, calls = pe._prefill_capture, []

    def reregister_after_first(*args, **kw):
        rows = capture(*args, **kw)
        calls.append(len(calls))
        if len(calls) == 1:
            pe.register_adapter('t', lora.load_adapter_npz(
                str(files / 'b.npz')))
        return rows

    pe._prefill_capture = reregister_after_first
    prefix = PROMPTS[0][:5]
    assert pe.register_prefix(prefix, adapter='t') == 5
    assert len(calls) == 2
    fresh = port_engine(params, **LORA)
    fresh.register_adapter('t', lora.load_adapter_npz(
        str(files / 'b.npz')))
    fresh.register_prefix(prefix, adapter='t')
    key = ('t', tuple(prefix))
    for (k, v), (fk, fv) in zip(pe._prefixes[key], fresh._prefixes[key]):
        assert torch.equal(k, fk) and torch.equal(v, fv)
    want = jax_engine(params, **LORA)
    want.register_adapter('t', jlora.load_adapter_npz(str(files / 'b.npz')))
    req = dict(tokens=PROMPTS[0], max_new_tokens=8, adapter='t')
    hits = pe.prefix_stats['hits']
    _same(want.generate([JaxRequest(**req)]), pe.generate([Request(**req)]))
    assert pe.prefix_stats['hits'] == hits + 1


def test_c4_nonfinite_adapter_in_slot_0_spares_base_rows(params, files):
    """ROADMAP.md C4.  An all-inf adapter registered first (stack slot 0)
    beside a good one: a base request served in the same batch gets the
    clean base tokens from the port, where the JAX engine kills its lane
    (inf * 0 = NaN reaches every base row); the request naming the
    broken adapter ends 'error' in both, and the good one matches."""
    good = jlora.load_adapter_npz(str(files / 'a.npz'))
    inf = jax.tree.map(lambda x: np.full_like(x, np.inf), good)
    je = jax_engine(params, **LORA)
    pe = port_engine(params, **LORA)
    clean = port_engine(params).generate([Request(tokens=PROMPTS[0],
                                                  max_new_tokens=8)])[0]
    for eng in (je, pe):
        assert eng.register_adapter('bad', inf) == 0
        assert eng.register_adapter('good', good) == 1
    mk = lambda cls: [cls(tokens=PROMPTS[0], max_new_tokens=8,  # noqa
                          adapter=a) for a in (None, 'bad', 'good')]
    jres, pres = je.generate(mk(JaxRequest)), pe.generate(mk(Request))
    assert jres[0].finish_reason == 'error'
    assert 'non-finite' in jres[0].error
    assert pres[0].output_tokens == clean.output_tokens
    assert pres[0].finish_reason == clean.finish_reason == 'length'
    np.testing.assert_allclose(pres[0].logprobs, clean.logprobs, rtol=0,
                               atol=0)
    assert jres[1].finish_reason == pres[1].finish_reason == 'error'
    _same(jres[2:], pres[2:])
