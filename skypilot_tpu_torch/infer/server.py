"""HTTP inference server: the process a serve-plane replica runs -- the
port's twin of ``skypilot_tpu/infer/server.py``, over the port's engine.

    python3 -m skypilot_tpu_torch.infer.server --model llama-1b --port 8100

The routes, status codes, headers and JSON keys are the JAX server's, so
the unchanged load balancer (``skypilot_tpu/serve/load_balancer.py``)
routes over a fleet that mixes both:

  GET  /health, /    200 {"status": "ok"} once warm, else 503 "starting"
  GET  /healthz      the readiness document (status ok / starting /
                     draining / dead, inflight, kv): 200 only for "ok";
                     503 with X-SkyTpu-Draining: 1 while draining
  GET  /stats        slots, queue, shed, drain, fault and KV counters
  GET  /v1/models    the served model
  GET  /hot_prefixes the drain-time hot-prefix export: the hottest radix
                     prefixes' KV rows in the JAX replica's wire form
                     (a replica without the radix cache: no prefixes)
  POST /drain        {"deadline_s": s} stop admitting, finish in-flight;
                     {"cancel": true} undo
  POST /generate     {"tokens": [...], "max_new_tokens": N,
                      "temperature": T, "stream": bool, "deadline_s": s,
                      "logprobs": bool, "prompt_logprobs": bool}
  POST /generate_text            with --tokenizer
  POST /v1/completions           prompt (string or token array),
                                 max_tokens (0 = generate nothing),
                                 temperature, stop, logprobs, echo (with
                                 logprobs: the prompt's scores, the
                                 lm-eval-harness loglikelihood pattern),
                                 n, stream (SSE + [DONE])
  POST /v1/chat/completions      messages, via the tokenizer
  POST /adopt_blocks adopt a peer's /hot_prefixes payload into the radix
                     cache; 400 on a malformed or mismatched payload
                     (model, block size, cache dtype, layers) or without
                     a radix cache
  POST /cache_prefix {"tokens": [...]} (or "prompt" with a tokenizer):
                     register a system prompt's KV rows, so prompts that
                     start with it prefill only their suffix; answers
                     {"cached_prefix_len": n} (under --auto-prefix-cache
                     it pins the prefix's blocks, n block-aligned)
  POST /load_adapter {"name": ..., "path": "adapter.npz"}: load a trained
                     LoRA adapter (``train.lora.save_adapter_npz``, either
                     package's) from under --adapter-dir into a stack
                     slot (--lora-rank, --lora-max-adapters); requests
                     select it by the "adapter" field or the OpenAI
                     "model" field, and share batches with the base

--auto-prefix registers a prompt's bucket-length head the second time it
is seen; --draft-len turns on prompt-lookup speculative decoding and
--cache-dtype fp8 the e4m3 KV cache.  --hf-model serves a causal-LM
transformers checkpoint (llama, qwen2, mistral, gemma, gpt2, mixtral) in
bf16; for the llama family --weight-dtype int8 quantizes it, or draws
random int8 weights for a registered --model; --qos turns on priority
classes, per-tenant WFQ (--qos-tenant-weights), the deadline shed and
chunk-boundary preemption, with a "qos" section on /stats.

stdlib only (ThreadingHTTPServer): each request blocks its handler
thread while the one engine thread runs continuous batching across all
in-flight requests.  The tokenizer is optional: ``transformers`` is
imported only when ``--tokenizer`` is given.
"""
import argparse
import collections
import dataclasses
import json
import math
import os
import queue
import signal
import statistics
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch
from torch import distributed as dist
from torch import multiprocessing as mp

from skypilot_tpu_torch.analysis import sanitizers
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request, RequestResult,
                                             resolve_cache_dtype)
from skypilot_tpu_torch.infer.qos import PRIORITY_CLASSES
from skypilot_tpu_torch.infer import tp as tp_lib
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.models.registry import get_model_config
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel.mesh import tp_mesh
from skypilot_tpu_torch.train.lora import load_adapter_npz


class DrainingError(Exception):
    """Request refused because the replica is draining (graceful
    shutdown): it stopped admitting new generate work and is finishing
    what it already accepted.  The HTTP layer turns this into a 503
    with Retry-After and an ``X-SkyTpu-Draining: 1`` header so the load
    balancer retries elsewhere instead of surfacing the 503."""


class AdmissionError(Exception):
    """Request shed at admission (TTFT bound exceeded or queue full)."""

    def __init__(self, projected_s: float, bound_s: float,
                 retry_after_s: Optional[int] = None,
                 message: Optional[str] = None):
        self.projected_s = projected_s
        self.bound_s = bound_s
        # Explicit Retry-After override (the queue-cap shed computes its
        # own drain estimate; the TTFT shed derives one from the bound).
        self.retry_after_s = retry_after_s
        super().__init__(
            message or
            f'overloaded: recent TTFT {projected_s:.1f}s exceeds the '
            f'{bound_s:.1f}s admission bound')


class InferenceServer:

    def __init__(self, engine: InferenceEngine,
                 tokenizer: Optional[object] = None,
                 max_projected_ttft_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 adapter_dir: Optional[str] = None,
                 auto_prefix: bool = False,
                 warmup: bool = False):
        """max_projected_ttft_s: admission bound -- shed (AdmissionError
        -> HTTP 429 + Retry-After) instead of queueing while the median
        OBSERVED time-to-first-token of recent completions exceeds it
        and a queue actually exists.  None = admit everything.

        max_queue: hard first-token backlog cap -- sheds the moment the
        backlog reaches it while every slot is busy.  The TTFT bound
        reacts to what happened; the queue cap bounds what can happen.

        adapter_dir: the directory POST /load_adapter may read adapter
        files from; None (the default) answers it 403.  The API is
        unauthenticated, so a path must resolve inside this directory.

        auto_prefix: a prompt head (quantized to a prefill bucket
        length) seen twice registers itself as a prefix in a background
        thread, so later prompts with it prefill only their suffix.

        warmup: run engine.warmup() (every prefill bucket and the decode
        windows) before declaring ready; else one short request."""
        self.engine = engine
        self.adapter_dir = adapter_dir
        self.tokenizer = tokenizer
        self.max_projected_ttft_s = max_projected_ttft_s
        self.max_queue = max_queue
        self.auto_prefix = auto_prefix
        self._auto_lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.server._auto_lock')
        self._auto_counts: Dict[tuple, int] = {}
        self._auto_inflight: set = set()
        self._auto_failed: set = set()
        self.warmup = warmup
        self.ready = threading.Event()
        self._queue: 'queue.Queue[Request]' = queue.Queue()
        self._results: Dict[str, RequestResult] = {}
        self._events: Dict[str, threading.Event] = {}
        self._stream_queues: Dict[str, 'queue.Queue'] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        # Admission bookkeeping: requests admitted but first-token-less,
        # and the observed TTFTs of recent completions.
        self._adm_lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.server._adm_lock')
        self._awaiting_first: set = set()
        self._recent_ttfts: 'collections.deque' = collections.deque(
            maxlen=16)
        self.shed_count = 0
        # Graceful drain (POST /drain, SIGTERM): once draining, new
        # generate requests are refused with 503 + Retry-After while
        # the ones already in flight run to completion; `drained` fires
        # when the last one leaves (or the drain deadline passes).
        # _gen_inflight counts generate-endpoint HTTP requests between
        # begin_generate/end_generate -- the unit a drain must finish.
        self.draining = threading.Event()
        self.drained = threading.Event()
        self._gen_inflight = 0
        self.drain_refused = 0          # 503s answered while draining
        self._on_drained = None         # callback once drain completes

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        # Warm before declaring ready so the first real request does not
        # pay for cuBLAS handles, workspaces and allocator growth.
        if self.warmup:
            self.engine.warmup()
        else:
            self.engine.warmup_decode([1, 2, 3])
        self.ready.set()
        self.engine.generate_stream(self._queue, self._deliver, self._stop)

    def _deliver(self, res: RequestResult) -> None:
        rid = res.request_id
        if rid is None:
            return
        sq = self._stream_queues.get(rid)
        if sq is not None:          # streaming request: sentinel in-band
            sq.put(('done', res))
            return
        # Store BEFORE checking the event: if the waiter times out
        # between our check and store, it pops _results after popping
        # _events, so either it takes the result or we remove it below.
        self._results[rid] = res
        ev = self._events.get(rid)
        if ev is None:
            self._results.pop(rid, None)   # abandoned: drop
            return
        ev.set()

    # ---------------------------------------------------------- admission

    _ADMIT_BACKLOG_FLOOR = 4

    def _admit(self, rid: str) -> None:
        """Raise AdmissionError while the server is past its TTFT bound
        or its queue cap; otherwise record the request as awaiting its
        first token.  The TTFT shed needs (a) the median observed TTFT
        of recent completions over the bound and (b) a queue: every slot
        busy and the first-token backlog past a small floor (a hot TTFT
        window with free slots is the echo of a drained queue)."""
        bound = self.max_projected_ttft_s
        with self._adm_lock:
            backlog = len(self._awaiting_first)
            saturated = (self.engine is None or
                         not self.engine.has_free_slot())
            if (self.max_queue is not None and saturated and
                    backlog >= self.max_queue):
                self.shed_count += 1
                # Drain estimate: the recent TTFT is how long the queue
                # has been making requests wait.
                est = (statistics.median(self._recent_ttfts)
                       if self._recent_ttfts else None)
                retry = max(1, math.ceil(est)) if est is not None else 5
                raise AdmissionError(
                    est if est is not None else 0.0,
                    bound if bound is not None else 0.0,
                    retry_after_s=retry,
                    message=f'overloaded: admission queue full '
                            f'({backlog} requests waiting, cap '
                            f'{self.max_queue})')
            if (bound is not None and saturated and
                    backlog >= self._ADMIT_BACKLOG_FLOOR and
                    len(self._recent_ttfts) >= 4):
                med = statistics.median(self._recent_ttfts)
                if med > bound:
                    self.shed_count += 1
                    raise AdmissionError(med, bound)
            self._awaiting_first.add(rid)

    def _note_first_token(self, rid: str,
                          ttft_s: Optional[float] = None) -> None:
        with self._adm_lock:
            if rid in self._awaiting_first:
                self._awaiting_first.discard(rid)
                if ttft_s is not None:
                    self._recent_ttfts.append(ttft_s)

    def _drop_admitted(self, rid: str) -> None:
        """Request left the system without a first token (error/timeout):
        remove from the backlog WITHOUT counting a service completion."""
        with self._adm_lock:
            self._awaiting_first.discard(rid)

    # ------------------------------------------------------ graceful drain

    def begin_generate(self) -> bool:
        """Admit one generate-endpoint HTTP request into the drain
        accounting; False = draining (caller answers 503)."""
        with self._adm_lock:
            if self.draining.is_set():
                self.drain_refused += 1
                return False
            self._gen_inflight += 1
            return True

    def end_generate(self) -> None:
        with self._adm_lock:
            self._gen_inflight = max(0, self._gen_inflight - 1)
            done = (self.draining.is_set() and self._gen_inflight == 0
                    and not self.drained.is_set())
            if done:
                self.drained.set()
        if done:
            self._fire_on_drained()

    @property
    def gen_inflight(self) -> int:
        with self._adm_lock:
            return self._gen_inflight

    def _fire_on_drained(self) -> None:
        cb = self._on_drained
        if cb is not None:
            # Off-thread: the callback typically shuts the HTTP server
            # down, which must not deadlock against the handler thread
            # that delivered the last in-flight completion.
            threading.Thread(target=cb, daemon=True).start()

    def drain(self, deadline_s: Optional[float] = None) -> None:
        """Stop admitting generate work (503 + Retry-After); finish
        what is in flight, then fire `drained` (and _on_drained).  With
        a deadline, `drained` fires after deadline_s even if stragglers
        remain.  Idempotent."""
        with self._adm_lock:
            already = self.draining.is_set()
            self.draining.set()
            empty = self._gen_inflight == 0 and not self.drained.is_set()
            if empty:
                self.drained.set()
        if empty:
            self._fire_on_drained()
        if already:
            return
        if deadline_s is not None and not self.drained.is_set():
            def watchdog():
                if not self.drained.wait(deadline_s):
                    self.drained.set()
                    self._fire_on_drained()
            threading.Thread(target=watchdog, daemon=True).start()

    def undrain(self) -> None:
        """Cancel a drain (tests; an operator changing their mind
        before teardown).  Admission resumes immediately."""
        with self._adm_lock:
            self.draining.clear()
            self.drained.clear()

    def health(self) -> Dict[str, object]:
        """The /healthz readiness document.  status: 'ok' (route traffic
        here), 'starting' (still warming up), 'draining' (finishing
        in-flight, admit nothing new), 'dead' (the engine's serving-loop
        supervisor gave up)."""
        model_ready = self.ready.is_set()
        serving = bool(self.engine.serving)
        # Before ready fires the loop has legitimately not started yet;
        # only a loop that died AFTER readiness means 'dead'.
        loop_alive = serving or not model_ready
        if not model_ready:
            status = 'starting'
        elif not serving:
            status = 'dead'
        elif self.draining.is_set():
            status = 'draining'
        else:
            status = 'ok'
        doc: Dict[str, object] = {
            'status': status,
            'model_ready': model_ready,
            'loop_alive': loop_alive,
            'draining': self.draining.is_set(),
            'drained': self.drained.is_set(),
            'inflight': self.gen_inflight,
            # Stable key set: None until the engine can answer.
            'kv': None,
        }
        if model_ready:
            doc['kv'] = self.engine.kv_health()
        return doc

    _AUTO_PREFIX_MIN = 64        # shortest head worth caching
    _AUTO_PREFIX_TRACKED = 256   # tracked heads (a simple size cap)

    def _maybe_auto_prefix(self, req: Request) -> None:
        """Count the request's prompt head, quantized to the longest
        prefill bucket inside the prompt; on its second sighting,
        register it as a prefix in a background thread.  No-op unless
        auto_prefix and the engine has prefix slots, and under the radix
        cache (which caches every prompt's blocks already)."""
        if self.engine._radix is not None:
            return
        if not self.auto_prefix or not self.engine.cfg.max_prefixes:
            return
        if req.want_prompt_logprobs:
            return                        # scoring bypasses prefix reuse
        n = len(req.tokens)
        starts = [b for b in self.engine.cfg.prefill_buckets
                  if self._AUTO_PREFIX_MIN <= b < n]
        if not starts:
            return
        b = starts[-1]
        key = (req.adapter, b, tuple(req.tokens[:b]))
        with self._auto_lock:
            if len(self._auto_counts) >= self._AUTO_PREFIX_TRACKED and \
                    key not in self._auto_counts:
                self._auto_counts.clear()     # a cheap reset beats an LRU
            self._auto_counts[key] = self._auto_counts.get(key, 0) + 1
            hot = self._auto_counts[key] >= 2
            if (not hot or key in self._auto_inflight or
                    key in self._auto_failed):
                return
            if (req.adapter, key[2]) in self.engine._prefixes:
                return                      # already resident
            # Auto-registration only fills free prefix slots, never
            # evicts (more hot heads than slots would thrash the LRU);
            # registrations in flight count as occupied.
            if (len(self.engine._prefixes) + len(self._auto_inflight)
                    >= self.engine.cfg.max_prefixes):
                return
            self._auto_inflight.add(key)

        def register():
            ok = False
            try:
                self.engine.register_prefix(list(key[2]),
                                            adapter=req.adapter)
                ok = True
            except Exception:  # noqa: BLE001 -- a best-effort cache warm
                pass
            finally:
                with self._auto_lock:
                    self._auto_inflight.discard(key)
                    if not ok:
                        # A capture that keeps failing must not cost a
                        # forward per sighting.
                        self._auto_failed.add(key)

        threading.Thread(target=register, daemon=True).start()

    def submit(self, req: Request, timeout: float = 300.0,
               pre_admitted: bool = False,
               count_prefix: bool = True) -> Optional[RequestResult]:
        rid = req.request_id or uuid.uuid4().hex
        req.request_id = rid
        if req.arrival_time is None:   # TTFT counts slot-queue wait
            req.arrival_time = time.time()
        # pre_admitted: the caller already holds this rid's admission
        # (the n>1 handler admits the whole batch atomically up front).
        if not pre_admitted:
            self._admit(rid)
        # count_prefix=False: an OpenAI `n` clone -- one HTTP request's
        # prompt head counts once, else a single n >= 2 request would
        # register a one-off prompt as seen twice.
        if count_prefix:
            self._maybe_auto_prefix(req)
        ev = threading.Event()
        self._events[rid] = ev
        self._queue.put(req)
        ev.wait(timeout)
        # Pop the event FIRST so a racing _deliver either stored the
        # result before this pop (we return it) or sees no event and
        # drops it (no leak).
        self._events.pop(rid, None)
        res = self._results.pop(rid, None)
        if res is not None and res.finish_reason not in ('error',
                                                         'cancelled'):
            self._note_first_token(rid, res.ttft_s)
        else:
            # Errors, timeouts and cancels leave the backlog without
            # feeding the admission TTFT window.
            self._drop_admitted(rid)
        if res is None:
            # Timed out: cancel INTO the engine so the slot frees now
            # instead of decoding to max_new_tokens for nobody.  A finish
            # racing this cancel is dropped by _deliver (no event).
            self.engine.cancel(rid)
        return res

    def submit_stream(self, req: Request, timeout: float = 300.0,
                      pre_admitted: bool = False):
        """Submit and yield ('tokens', [ids]) chunks as they decode,
        terminated by ('done', RequestResult) -- or ('timeout', None) if
        `timeout` passes with no new chunk.

        `timeout` is an INACTIVITY bound: the deadline resets on every
        received chunk.  One queue carries both chunks and the terminal
        sentinel: the engine enqueues every chunk (under its lock)
        before _deliver runs, so ('done', res) follows the last chunk.
        """
        rid = req.request_id or uuid.uuid4().hex
        req.request_id = rid
        if req.arrival_time is None:   # TTFT counts slot-queue wait
            req.arrival_time = time.time()
        if not pre_admitted:
            # NB: generator body -- deferred to first next().  The HTTP
            # handler pre-admits instead, so the 429 can go out before
            # the SSE response line.
            self._admit(rid)
        self._maybe_auto_prefix(req)
        chunks: 'queue.Queue' = queue.Queue()
        req.stream_cb = lambda toks: chunks.put(('tokens', toks))
        self._stream_queues[rid] = chunks
        self._queue.put(req)
        finished = False
        try:
            while True:
                try:
                    item = chunks.get(timeout=timeout)
                except queue.Empty:
                    self._drop_admitted(rid)
                    yield ('timeout', None)
                    return
                if item[0] == 'tokens':
                    self._note_first_token(
                        rid, time.time() - req.arrival_time)
                elif item[0] == 'done':
                    # Prefill-only/error finishes never streamed a chunk.
                    finished = True
                    self._drop_admitted(rid)
                yield item
                if item[0] == 'done':
                    return
        finally:
            # The stream queue stays registered through the cancel below:
            # a racing natural finish must land in `chunks`, where the
            # stale-mark re-drain can see it.
            if not finished:
                # The generation may have finished with its 'done' unread
                # (client gone at the end): cancelling then would leave a
                # stale mark that could poison a retry with the same id.
                try:
                    while True:
                        if chunks.get_nowait()[0] == 'done':
                            finished = True
                except queue.Empty:
                    pass
            if not finished:
                # The consumer stopped early -- client disconnected, stop
                # string satisfied, or timeout: free the slot now.
                if not self.engine.cancel(rid):
                    # Not in a slot: still queued (the mark drops it at
                    # dequeue), or it finished between the drain above
                    # and cancel().  The engine delivers under the lock
                    # cancel() takes, so such a finish is in `chunks`
                    # now, and its mark is stale.
                    try:
                        while True:
                            if chunks.get_nowait()[0] == 'done':
                                self.engine.uncancel(rid)
                                break
                    except queue.Empty:
                        pass
            self._stream_queues.pop(rid, None)
            self._drop_admitted(rid)


def _make_handler(server: InferenceServer):

    class Handler(BaseHTTPRequestHandler):

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict,
                  extra_headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _shed(self, e: 'AdmissionError') -> None:
            """429 + Retry-After: wait long enough that the queue
            plausibly drains back under the bound."""
            retry_after = (e.retry_after_s if e.retry_after_s is not None
                           else max(1, math.ceil(e.projected_s -
                                                 e.bound_s)))
            self._json(429, {'error': str(e), 'shed': True,
                             'projected_ttft_s': round(e.projected_s, 2),
                             'bound_s': e.bound_s},
                       extra_headers={'Retry-After': str(retry_after)})

        def _sse_begin(self):
            """200 + SSE headers; returns the `data:`-line emitter
            (shared by the native and OpenAI streaming paths)."""
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.end_headers()

            def emit(payload: dict) -> None:
                self.wfile.write(
                    b'data: ' + json.dumps(payload).encode() + b'\n\n')
                self.wfile.flush()

            return emit

        def _stream(self, req: Request) -> None:
            """Server-sent events: one `data:` line per token chunk, a
            final `data:` with the full result, then connection close
            (no Content-Length -- SSE semantics)."""
            emit = self._sse_begin()
            streamed: list = []
            prev_text = ''
            try:
                for kind, value in server.submit_stream(
                        req, pre_admitted=True):
                    if kind == 'tokens':
                        streamed.extend(value)
                        out = {'tokens': value}
                        if server.tokenizer is not None:
                            # Decode the full prefix and emit the suffix
                            # delta: chunk-local decoding breaks BPE
                            # merges at window boundaries.
                            text = server.tokenizer.decode(streamed)
                            out['text'] = text[len(prev_text):]
                            prev_text = text
                        emit(out)
                    elif kind == 'done':
                        final = {
                            'done': True,
                            'output_tokens': value.output_tokens,
                            'ttft_s': value.ttft_s,
                            'latency_s': value.latency_s,
                            'finish_reason': value.finish_reason,
                        }
                        if value.logprobs is not None:
                            final['logprobs'] = value.logprobs
                        if value.error:
                            final['error'] = value.error
                        if value.error_class:
                            final['error_class'] = value.error_class
                        if server.tokenizer is not None:
                            final['text'] = server.tokenizer.decode(
                                value.output_tokens)
                        emit(final)
                    else:   # timeout -- acknowledge what was streamed
                        emit({'done': True, 'error': 'timed out',
                              'finish_reason': 'error',
                              'output_tokens': streamed,
                              'ttft_s': 0.0, 'latency_s': 0.0})
            except (BrokenPipeError, ConnectionResetError):
                # Client went away mid-stream: closing the generator
                # runs submit_stream's finally, which cancels into the
                # engine -- the slot frees now.
                pass

        def do_GET(self):
            if self.path in ('/health', '/'):
                if server.ready.is_set():
                    self._json(200, {'status': 'ok'})
                else:
                    self._json(503, {'status': 'starting'})
            elif self.path == '/healthz':
                # Readiness for the LB's active prober: 200 only while
                # the replica should receive traffic; 'starting',
                # 'draining' and 'dead' answer 503 with the document.
                doc = server.health()
                code = 200 if doc['status'] == 'ok' else 503
                headers = ({'X-SkyTpu-Draining': '1'}
                           if doc['draining'] else None)
                self._json(code, doc, extra_headers=headers)
            elif self.path == '/hot_prefixes':
                # Warm-failover export: the draining replica's hottest
                # radix prefixes, [L, Hkv, bs, D] rows in base64.  The LB
                # fetches it during drain and POSTs it to a survivor's
                # /adopt_blocks.
                try:
                    self._json(200, server.engine.export_hot_prefixes())
                except Exception as e:  # noqa: BLE001 -- drain path:
                    # degrade to cold failover, never crash the handler.
                    self._json(500, {'error': str(e)})
            elif self.path == '/v1/models':
                name = server.engine.model_config.name
                rows = [{'id': name, 'object': 'model', 'created': 0,
                         'owned_by': 'skypilot_tpu'}]
                rows += [{'id': a, 'object': 'model', 'created': 0,
                          'owned_by': 'skypilot_tpu', 'parent': name}
                         for a in sorted(server.engine.adapters)]
                self._json(200, {'object': 'list', 'data': rows})
            elif self.path == '/stats':
                eng = server.engine
                st = eng.stats()
                self._json(200, {
                    'slots_active': sum(s is not None for s in eng._slots),
                    'num_slots': eng.cfg.num_slots,
                    'queue_depth': server._queue.qsize(),
                    'awaiting_first_token': len(server._awaiting_first),
                    'shed_count': server.shed_count,
                    'draining': server.draining.is_set(),
                    'gen_inflight': server.gen_inflight,
                    'drain_refused': server.drain_refused,
                    'spec': dict(eng.spec_stats),
                    'kv': st['kv'],
                    # Deprecated aliases of kv.* (old dashboards):
                    'prefix': dict(eng.prefix_stats),
                    'resident_prefixes': len(eng._prefixes),
                    'kv_cache': st,
                    'adapters': sorted(eng.adapters),
                    'prefill_chunk': eng.cfg.prefill_chunk,
                    'chunking_slots': len(eng._chunking),
                    'chunk': dict(eng.chunk_stats),
                    'faults': dict(eng.fault_stats),
                    'qos': st.get('qos'),
                })
            else:
                self._json(404, {'error': 'not found'})

        # ----------------------------------------- OpenAI-compatible API

        def _openai_request(self, payload, chat: bool):
            """Parse a /v1/* body into (Request, stop, opts) or answer
            the error and return None.  opts: logprobs (bool), echo
            (bool), zero_max (max_tokens=0 -- the lm-eval-harness
            loglikelihood pattern: score the prompt, generate
            nothing)."""
            try:
                max_new = payload.get('max_tokens', 16)
                max_new = None if max_new is None else int(max_new)
                # OpenAI/vLLM default: sample at temperature 1.0 (the
                # native /generate API keeps its greedy default).
                temperature = float(payload.get('temperature', 1.0))
                stop = payload.get('stop') or []
                if isinstance(stop, str):
                    stop = [stop]
                stop = [str(s) for s in stop]
                # Completions `logprobs` is an int (alternatives per
                # position, OpenAI caps it at 5); bool True reads as 1.
                # Chat uses `logprobs: true` + `top_logprobs: 0..k`.
                lp_raw = payload.get('logprobs')
                if chat:
                    if payload.get('top_logprobs') is not None and \
                            not lp_raw:
                        self._json(400, {'error': {
                            'message': 'top_logprobs requires logprobs '
                                       'to be true',
                            'type': 'invalid_request_error'}})
                        return None
                    lp_k = (int(payload.get('top_logprobs', 0))
                            if lp_raw else None)
                elif lp_raw is None or lp_raw is False:
                    lp_k = None
                elif lp_raw is True:
                    lp_k = 1
                else:
                    lp_k = int(lp_raw)
                echo = bool(payload.get('echo'))
                n_raw = payload.get('n')
                n_choices = 1 if n_raw is None else int(n_raw)
                # Extension fields: server-side deadline, QoS class and
                # tenant key.
                deadline_raw = payload.get('deadline_s')
                deadline_s = (None if deadline_raw is None
                              else float(deadline_raw))
                priority_raw = payload.get('priority')
                priority = (None if priority_raw is None
                            else str(priority_raw))
                tenant_raw = payload.get('tenant_id')
                tenant_id = (None if tenant_raw is None
                             else str(tenant_raw))
            except (TypeError, ValueError) as e:
                self._json(400, {'error': {'message': f'bad field: {e}',
                                           'type': 'invalid_request_error'}})
                return None
            if deadline_s is not None and deadline_s <= 0:
                self._json(400, {'error': {
                    'message': 'deadline_s must be > 0',
                    'type': 'invalid_request_error'}})
                return None
            if priority is not None and priority not in PRIORITY_CLASSES:
                self._json(400, {'error': {
                    'message': (
                        f'unknown priority {priority!r}; expected one '
                        f'of {list(PRIORITY_CLASSES)}'),
                    'type': 'invalid_request_error'}})
                return None
            max_n = max(1, min(8, server.engine.cfg.num_slots))
            if not 1 <= n_choices <= max_n:
                self._json(400, {'error': {
                    'message': f'n must be between 1 and {max_n}',
                    'type': 'invalid_request_error'}})
                return None
            if n_choices > 1 and payload.get('stream'):
                self._json(400, {'error': {
                    'message': 'n > 1 is not supported with stream',
                    'type': 'invalid_request_error'}})
                return None
            want_lp = lp_k is not None
            max_k = min(5, server.engine.cfg.logprob_topk)
            if want_lp and not 0 <= lp_k <= max_k:
                field = 'top_logprobs' if chat else 'logprobs'
                self._json(400, {'error': {
                    'message': f'{field} must be between 0 and {max_k}',
                    'type': 'invalid_request_error'}})
                return None
            opts = {'logprobs': want_lp, 'logprob_k': lp_k or 0,
                    'echo': echo, 'zero_max': max_new == 0,
                    'n': n_choices}
            if opts['zero_max']:
                # The engine always produces the prefill token; trim it
                # from the response instead of rejecting the request.
                max_new = 1
            if chat and echo:
                self._json(400, {'error': {
                    'message': 'echo is supported on /v1/completions '
                               'only',
                    'type': 'invalid_request_error'}})
                return None
            if payload.get('stream') and (want_lp or echo or
                                          opts['zero_max']):
                self._json(400, {'error': {
                    'message': 'logprobs/echo/max_tokens=0 are not '
                               'supported with stream',
                    'type': 'invalid_request_error'}})
                return None
            if chat:
                messages = payload.get('messages')
                if (not isinstance(messages, list) or not messages or
                        not all(isinstance(m, dict) for m in messages)):
                    self._json(400, {'error': {
                        'message': '"messages" must be a non-empty list '
                                   'of {role, content} objects',
                        'type': 'invalid_request_error'}})
                    return None
                if server.tokenizer is None:
                    self._json(400, {'error': {
                        'message': 'chat API needs a tokenizer '
                                   '(--tokenizer / --hf-model)',
                        'type': 'invalid_request_error'}})
                    return None
                try:
                    tokens = server.tokenizer.apply_chat_template(
                        messages, tokenize=True,
                        add_generation_prompt=True)
                except Exception:  # noqa: BLE001 -- no template in ckpt
                    text = ''.join(
                        f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                        for m in messages) + 'assistant: '
                    tokens = server.tokenizer.encode(text)
            else:
                prompt = payload.get('prompt')
                if isinstance(prompt, list) and all(
                        isinstance(t, int) for t in prompt):
                    tokens = prompt        # OpenAI token-array form
                elif isinstance(prompt, str):
                    if server.tokenizer is None:
                        self._json(400, {'error': {
                            'message': 'string prompts need a tokenizer '
                                       '(--tokenizer / --hf-model); pass '
                                       'a token array instead',
                            'type': 'invalid_request_error'}})
                        return None
                    tokens = server.tokenizer.encode(prompt)
                else:
                    self._json(400, {'error': {
                        'message': '"prompt" (string or token array) '
                                   'required',
                        'type': 'invalid_request_error'}})
                    return None
                if not tokens:
                    self._json(400, {'error': {
                        'message': 'empty prompt',
                        'type': 'invalid_request_error'}})
                    return None
            # Adapter selection, LoRAX-style: the "model" field naming a
            # registered adapter selects it; the base model id or
            # absence = base; anything else is a 404.
            adapter = payload.get('adapter')
            model_field = payload.get('model')
            if adapter is None and model_field:
                if model_field in server.engine.adapters:
                    adapter = model_field
                elif model_field != server.engine.model_config.name:
                    self._json(404, {'error': {
                        'message': f'model {model_field!r} not found '
                                   '(served: '
                                   f'{server.engine.model_config.name}'
                                   ' + adapters '
                                   f'{sorted(server.engine.adapters)})',
                        'type': 'invalid_request_error',
                        'code': 'model_not_found'}})
                    return None
            req = Request(tokens=[int(t) for t in tokens],
                          max_new_tokens=max_new,
                          temperature=temperature,
                          request_id=uuid.uuid4().hex,
                          adapter=adapter,
                          want_prompt_logprobs=want_lp and echo,
                          deadline_s=deadline_s,
                          priority=priority,
                          tenant_id=tenant_id)
            return req, stop, opts

        @staticmethod
        def _openai_finish(reason: str) -> str:
            return {'eos': 'stop', 'length': 'length'}.get(reason, reason)

        def _openai_generate(self, payload, chat: bool) -> None:
            parsed = self._openai_request(payload, chat)
            if parsed is None:
                return
            req, stop, opts = parsed
            kind = 'chat.completion' if chat else 'text_completion'
            rid = ('chatcmpl-' if chat else 'cmpl-') + req.request_id[:24]
            model_name = req.adapter or server.engine.model_config.name
            if payload.get('stream'):
                try:
                    server._admit(req.request_id)
                except AdmissionError as e:
                    self._shed(e)
                    return
                try:
                    self._openai_stream(req, stop, chat, rid, model_name)
                finally:
                    server._drop_admitted(req.request_id)
                return
            # n > 1 (OpenAI `n`): independent engine requests batched by
            # continuous batching like any concurrent traffic.
            # dataclasses.replace copies every field, so a new sampling
            # knob cannot be dropped from the clones; the prompt is scored
            # once (the clones reuse choice 0's scores).
            reqs = [req] + [
                dataclasses.replace(req, tokens=list(req.tokens),
                                    request_id=uuid.uuid4().hex,
                                    arrival_time=None, stream_cb=None,
                                    want_prompt_logprobs=False)
                for _ in range(opts['n'] - 1)
            ]
            if len(reqs) > 1:
                # Admit the whole batch atomically up front: a partial
                # shed must 429 immediately and waste no device work.
                admitted = []
                try:
                    for r in reqs:
                        server._admit(r.request_id)
                        admitted.append(r.request_id)
                except AdmissionError as e:
                    for a in admitted:
                        server._drop_admitted(a)
                    self._shed(e)
                    return
            results: list = [None] * len(reqs)

            def one(i):
                try:
                    results[i] = server.submit(
                        reqs[i], pre_admitted=len(reqs) > 1,
                        count_prefix=i == 0)
                except AdmissionError as e:
                    # Only reachable for n == 1 (batch pre-admits).
                    results[i] = ('shed', e)

            if len(reqs) == 1:
                one(0)
                if isinstance(results[0], tuple):
                    self._shed(results[0][1])
                    return
            else:
                threads = [threading.Thread(target=one, args=(i,),
                                            daemon=True)
                           for i in range(len(reqs))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            if any(r is None for r in results):
                self._json(504, {'error': {'message': 'timed out',
                                           'type': 'timeout'}})
                return
            err = next((r for r in results
                        if r.finish_reason == 'error'), None)
            if err is not None:
                code = 500 if err.error_class == 'internal' else 400
                self._json(code, {'error': {
                    'message': err.error or 'bad request',
                    'type': 'invalid_request_error'
                    if code == 400 else 'internal_error'}})
                return
            res = results[0]
            for r in results[1:]:
                r.prompt_logprobs = res.prompt_logprobs
                r.prompt_top_logprobs = res.prompt_top_logprobs
            choices = []
            completion_tokens = 0
            for index, res_i in enumerate(results):
                choice, n_completion = self._openai_choice(
                    res_i, opts, stop, chat, index)
                choices.append(choice)
                completion_tokens += n_completion
            usage = {'prompt_tokens': len(res.prompt_tokens),
                     'completion_tokens': completion_tokens,
                     'total_tokens': len(res.prompt_tokens) +
                     completion_tokens}
            self._json(200, {'id': rid, 'object': kind,
                             'created': int(time.time()),
                             'model': model_name,
                             'choices': choices, 'usage': usage})

        def _openai_choice(self, res, opts, stop, chat, index):
            """One result -> one OpenAI choice object; returns
            (choice, completion_tokens_after_stop_truncation)."""
            finish = self._openai_finish(res.finish_reason)
            out_tokens = list(res.output_tokens)
            out_lps = list(res.logprobs or [])
            if opts['zero_max']:
                # max_tokens=0: the engine generated one token for the
                # prefill; the client asked for none.
                out_tokens, out_lps, finish = [], [], 'length'
            text = None
            n_completion = len(out_tokens)
            if server.tokenizer is not None:
                text = server.tokenizer.decode(out_tokens)
                at = self._find_stop(text, stop)
                if at >= 0:
                    text, finish = text[:at], 'stop'
                    # Usage counts only tokens up to the truncation:
                    # the smallest token prefix whose decode covers the
                    # kept text.
                    for i in range(len(out_tokens) + 1):
                        if len(server.tokenizer.decode(
                                out_tokens[:i])) >= at:
                            n_completion = i
                            break
            if chat:
                choice = {'index': index, 'finish_reason': finish,
                          'logprobs': None,
                          'message': {'role': 'assistant',
                                      'content': text or ''}}
                if opts['logprobs']:
                    # Chat logprobs shape (OpenAI): one content entry per
                    # generated token with its logprob and the requested
                    # top_logprobs alternatives.
                    tok = server.tokenizer
                    k = opts['logprob_k']

                    def entry(tid, lp_val):
                        s_ = tok.decode([tid])
                        return {'token': s_, 'logprob': lp_val,
                                'bytes': list(s_.encode('utf-8'))}

                    content = []
                    tops_all = list(res.top_logprobs or [])
                    for i in range(n_completion):
                        e = entry(out_tokens[i], out_lps[i])
                        e['top_logprobs'] = [
                            entry(tid, lp_val)
                            for tid, lp_val in tops_all[i][:k]
                        ] if i < len(tops_all) else []
                        content.append(e)
                    choice['logprobs'] = {'content': content}
            else:
                if opts['echo'] and text is not None:
                    text = server.tokenizer.decode(
                        res.prompt_tokens) + text
                choice = {'index': index, 'finish_reason': finish,
                          'text': text if text is not None
                          else '', 'logprobs': None}
                if text is None:    # token-only serving
                    choice['tokens'] = out_tokens
                if opts['logprobs']:
                    # With echo the prompt's positions come first (entry
                    # 0 null, as OpenAI's).
                    echo = opts['echo']
                    ids = ((list(res.prompt_tokens) if echo else []) +
                           out_tokens[:n_completion])
                    lps = ((list(res.prompt_logprobs or []) if echo
                            else []) + out_lps[:n_completion])
                    tops = ((list(res.prompt_top_logprobs or []) if echo
                             else []) +
                            list(res.top_logprobs or [])[:n_completion])
                    tok = server.tokenizer

                    def tstr(t):
                        return tok.decode([t]) if tok else str(t)

                    strs = [tstr(t) for t in ids]
                    offsets, pos = [], 0
                    for s_ in strs:
                        offsets.append(pos)
                        pos += len(s_)
                    # The requested k alternatives per position (the
                    # engine computes logprob_topk, best first).
                    k = opts['logprob_k']
                    choice['logprobs'] = {
                        'tokens': strs,
                        'token_logprobs': lps,
                        'top_logprobs': [
                            None if t is None else
                            {tstr(i): l for i, l in t[:k]}
                            for t in tops
                        ],
                        'text_offset': offsets,
                    }
            return choice, n_completion

        @staticmethod
        def _find_stop(text: str, stop) -> int:
            """Earliest stop-string position in text, or -1."""
            hit = -1
            for s in stop:
                at = text.find(s)
                if at >= 0 and (hit < 0 or at < hit):
                    hit = at
            return hit

        def _openai_stream(self, req, stop, chat, rid, model_name) -> None:
            """OpenAI-style SSE: one chunk object per decode window,
            a finish chunk, then `data: [DONE]`."""
            emit = self._sse_begin()
            kind = ('chat.completion.chunk' if chat
                    else 'text_completion')
            created = int(time.time())

            def emit_done() -> None:
                self.wfile.write(b'data: [DONE]\n\n')   # literal, no JSON
                self.wfile.flush()

            def chunk(delta_text, finish=None, first=False, tokens=None):
                if chat:
                    delta = {}
                    if first:
                        delta['role'] = 'assistant'
                    if delta_text:
                        delta['content'] = delta_text
                    choice = {'index': 0, 'delta': delta,
                              'finish_reason': finish}
                else:
                    choice = {'index': 0, 'text': delta_text,
                              'finish_reason': finish}
                    if tokens is not None:   # token-only serving
                        choice['tokens'] = tokens
                return {'id': rid, 'object': kind, 'created': created,
                        'model': model_name, 'choices': [choice]}

            streamed: list = []
            emitted = 0          # chars of decoded text already sent
            # A stop string can straddle decode windows: hold back the
            # longest possible stop-prefix so an already-emitted chunk
            # never contains part of a match (stream == non-stream).
            hold = max((len(s) for s in stop), default=1) - 1
            first = True
            try:
                for item_kind, value in server.submit_stream(
                        req, pre_admitted=True):
                    if item_kind == 'tokens':
                        streamed.extend(value)
                        if server.tokenizer is None:
                            # Token-only serving: the ids ARE the data.
                            emit(chunk('', tokens=value, first=first))
                            first = False
                            continue
                        # Full-prefix decode, emit the suffix delta.
                        text = server.tokenizer.decode(streamed)
                        hit = self._find_stop(text, stop)
                        if hit >= 0:
                            # Truncate at the stop string; returning
                            # closes the generator, which cancels the
                            # engine request (the slot frees now).
                            delta = text[:hit][emitted:]
                            if delta:
                                emit(chunk(delta, first=first))
                            emit(chunk('', finish='stop'))
                            emit_done()
                            return
                        safe = max(emitted, len(text) - hold)
                        delta = text[emitted:safe]
                        if delta:
                            emit(chunk(delta, first=first))
                            first = False
                            emitted = safe
                    elif item_kind == 'done':
                        finish = ('error' if value.finish_reason ==
                                  'error' else self._openai_finish(
                                      value.finish_reason))
                        if (server.tokenizer is not None and
                                value.finish_reason != 'error'):
                            # Flush the held-back tail (stop-checked).
                            text = server.tokenizer.decode(
                                value.output_tokens)
                            hit = self._find_stop(text, stop)
                            if hit >= 0:
                                text, finish = text[:hit], 'stop'
                            delta = text[emitted:]
                            if delta:
                                emit(chunk(delta, first=first))
                                first = False
                        emit(chunk('', finish=finish))
                        emit_done()
                    else:   # timeout
                        emit(chunk('', finish='error'))
                        emit_done()
            except (BrokenPipeError, ConnectionResetError):
                pass

        _GENERATE_PATHS = ('/generate', '/generate_text',
                           '/v1/completions', '/v1/chat/completions')

        def do_POST(self):
            try:
                n = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(n) or b'{}')
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {'error': str(e)})
                return
            if self.path == '/drain':
                # Graceful drain: stop admitting, finish in-flight up
                # to deadline_s, advertise via /healthz.  cancel=true
                # reverses an in-progress drain.
                if payload.get('cancel'):
                    server.undrain()
                    self._json(200, server.health())
                    return
                try:
                    deadline = payload.get('deadline_s')
                    deadline = (None if deadline is None
                                else float(deadline))
                except (TypeError, ValueError) as e:
                    self._json(400, {'error': f'bad field: {e}'})
                    return
                if deadline is not None and deadline <= 0:
                    self._json(400, {'error': 'deadline_s must be > 0'})
                    return
                server.drain(deadline)
                self._json(200, server.health())
                return
            if self.path in self._GENERATE_PATHS:
                # Drain gate: the 503 carries Retry-After and
                # X-SkyTpu-Draining so the LB retries elsewhere.
                if not server.begin_generate():
                    self._json(503, {'error': 'replica draining',
                                     'draining': True},
                               extra_headers={'Retry-After': '1',
                                              'X-SkyTpu-Draining': '1'})
                    return
                try:
                    if self.path == '/v1/completions':
                        self._openai_generate(payload, chat=False)
                    elif self.path == '/v1/chat/completions':
                        self._openai_generate(payload, chat=True)
                    else:
                        self._native_generate(payload)
                finally:
                    server.end_generate()
                return
            if self.path == '/load_adapter':
                self._load_adapter(payload)
                return
            if self.path == '/cache_prefix':
                # Register a prefix (system prompt): its KV rows stay
                # resident and prompts that start with it prefill only
                # their suffix.  Under --auto-prefix-cache this pins the
                # prefix's radix blocks (cached_prefix_len is then
                # block-aligned).
                tokens = payload.get('tokens')
                if tokens is None and server.tokenizer is not None:
                    prompt = payload.get('prompt')
                    if prompt:
                        tokens = server.tokenizer.encode(prompt)
                if not isinstance(tokens, list) or not tokens:
                    self._json(400, {'error': '"tokens" list (or '
                                     '"prompt" with a tokenizer) '
                                     'required'})
                    return
                try:
                    n = server.engine.register_prefix(
                        [int(t) for t in tokens],
                        adapter=payload.get('adapter'))
                except (TypeError, ValueError) as e:
                    self._json(400, {'error': str(e)})
                    return
                self._json(200, {'cached_prefix_len': n})
                return
            if self.path == '/adopt_blocks':
                # Warm-failover import into the radix cache.  A payload
                # that does not fit this replica is a clean 400 (the
                # survivor then serves cold).
                try:
                    self._json(200, server.engine.adopt_prefixes(payload))
                except (TypeError, ValueError, KeyError) as e:
                    self._json(400, {'error': str(e)})
                except Exception as e:  # noqa: BLE001 -- adoption is an
                    # optimization: a failure leaves the survivor
                    # serving (cold), never a dead handler thread.
                    self._json(500, {'error': str(e)})
                return
            self._json(404, {'error': 'not found'})

        def _load_adapter(self, payload: dict) -> None:
            """POST /load_adapter: a trained adapter file (.npz, either
            package's) from under --adapter-dir into a stack slot.  403
            without --adapter-dir; 400 for a missing name or path, a
            path that escapes the directory, or a bad artifact."""
            name = payload.get('name')
            path = payload.get('path')
            if not name or not path:
                self._json(400, {'error': '"name" and "path" required'})
                return
            if server.adapter_dir is None:
                self._json(403, {'error': 'runtime adapter loading '
                                 'disabled; start the server with '
                                 '--adapter-dir to enable'})
                return
            root = os.path.realpath(server.adapter_dir)
            resolved = os.path.realpath(os.path.join(root, str(path)))
            if not (resolved == root or
                    resolved.startswith(root + os.sep)):
                self._json(400, {'error': 'adapter path escapes '
                                 '--adapter-dir'})
                return
            try:
                idx = server.engine.register_adapter(
                    name, load_adapter_npz(resolved))
            except Exception as e:  # noqa: BLE001 -- client input (a
                # missing file, a directory, a corrupt npz, the wrong
                # family or rank): a JSON 400, never a dead handler.
                self._json(400, {'error': str(e)})
                return
            self._json(200, {'adapter': name, 'slot': idx})

        def _native_generate(self, payload: dict) -> None:
            if self.path == '/generate':
                tokens = payload.get('tokens')
                if not isinstance(tokens, list) or not tokens:
                    self._json(400, {'error': '"tokens" list required'})
                    return
            else:   # /generate_text
                if server.tokenizer is None:
                    self._json(400, {'error': 'no tokenizer configured'})
                    return
                tokens = server.tokenizer.encode(payload.get('prompt', ''))
                if not tokens:
                    self._json(400, {'error': 'empty prompt'})
                    return
            # Validate types here: a malformed field must become a 400,
            # never an exception inside the engine thread.
            try:
                tokens = [int(t) for t in tokens]
                max_new = payload.get('max_new_tokens')
                max_new = None if max_new is None else int(max_new)
                temperature = float(payload.get('temperature', 0.0))
                deadline = payload.get('deadline_s')
                deadline = None if deadline is None else float(deadline)
                priority = payload.get('priority')
                priority = None if priority is None else str(priority)
                tenant_id = payload.get('tenant_id')
                tenant_id = None if tenant_id is None else str(tenant_id)
            except (TypeError, ValueError) as e:
                self._json(400, {'error': f'bad field: {e}'})
                return
            if deadline is not None and deadline <= 0:
                self._json(400, {'error': 'deadline_s must be > 0'})
                return
            if priority is not None and priority not in PRIORITY_CLASSES:
                self._json(400, {'error': (
                    f'unknown priority {priority!r}; expected one of '
                    f'{list(PRIORITY_CLASSES)}')})
                return
            req = Request(tokens=tokens, max_new_tokens=max_new,
                          temperature=temperature,
                          request_id=uuid.uuid4().hex,
                          adapter=payload.get('adapter'),
                          want_prompt_logprobs=bool(
                              payload.get('prompt_logprobs')),
                          deadline_s=deadline,
                          priority=priority,
                          tenant_id=tenant_id)
            if payload.get('stream'):
                # Admit BEFORE the SSE 200 goes out: a shed must be a
                # clean 429 the client (and LB) can act on.
                try:
                    server._admit(req.request_id)
                except AdmissionError as e:
                    self._shed(e)
                    return
                try:
                    self._stream(req)
                finally:
                    server._drop_admitted(req.request_id)
                return
            try:
                res = server.submit(req)
            except AdmissionError as e:
                self._shed(e)
                return
            if res is None:
                self._json(504, {'error': 'timed out'})
                return
            if res.finish_reason == 'error':
                code = 500 if res.error_class == 'internal' else 400
                self._json(code, {'error': res.error or 'bad request'})
                return
            out = {
                'output_tokens': res.output_tokens,
                'ttft_s': res.ttft_s,
                'latency_s': res.latency_s,
                'finish_reason': res.finish_reason,
            }
            # Typed non-error terminals (deadline shed / cancel) carry
            # their reason through.
            if res.error:
                out['error'] = res.error
            if res.error_class:
                out['error_class'] = res.error_class
            if payload.get('logprobs'):
                out['logprobs'] = res.logprobs
            if payload.get('prompt_logprobs'):
                out['prompt_logprobs'] = res.prompt_logprobs
            if server.tokenizer is not None:
                out['text'] = server.tokenizer.decode(res.output_tokens)
            self._json(200, out)

    return Handler


class _BurstTolerantHTTPServer(ThreadingHTTPServer):
    # The default listen backlog (5) resets connections during an arrival
    # burst before admission control can answer 429.
    request_queue_size = 128


def serve(engine: InferenceEngine, host: str = '0.0.0.0', port: int = 8100,
          tokenizer: Optional[object] = None,
          max_projected_ttft_s: Optional[float] = None,
          max_queue: Optional[int] = None,
          adapter_dir: Optional[str] = None,
          auto_prefix: bool = False,
          warmup: bool = False) -> None:
    """Serve `engine` over HTTP until a drain completes (POST /drain or
    SIGTERM), then stop the engine's loop and return."""
    srv = InferenceServer(engine, tokenizer,
                          max_projected_ttft_s=max_projected_ttft_s,
                          max_queue=max_queue, adapter_dir=adapter_dir,
                          auto_prefix=auto_prefix, warmup=warmup)
    srv.start()
    httpd = _BurstTolerantHTTPServer((host, port), _make_handler(srv))
    # Graceful drain exit: once the in-flight work of a drain is done,
    # shut the listener down and return (the callback runs off-thread).
    srv._on_drained = httpd.shutdown

    def _sigterm(signum, frame):  # pylint: disable=unused-argument
        # Preemption notice: stop admitting, finish in-flight up to the
        # drain timeout the controller exports, then exit.
        srv.drain(float(os.environ.get('SKYTPU_SERVE_DRAIN_TIMEOUT',
                                       60.0)))

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass   # not the main thread (embedded/test use): no signal hook
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.stop()


def parse_tenant_weights(
        spec: Optional[str]) -> Optional[Dict[str, float]]:
    """'tenantA=3,tenantB=1.5' -> {'tenantA': 3.0, 'tenantB': 1.5}."""
    if not spec:
        return None
    out: Dict[str, float] = {}
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        if '=' not in part:
            raise ValueError(
                f'bad tenant weight {part!r} (want tenant=weight)')
        tenant, w = part.split('=', 1)
        out[tenant.strip()] = float(w)
    return out or None


def _int8_config(model_config):
    """The config with int8 weights; the llama family only, as the JAX
    server's check says."""
    if not isinstance(model_config, LlamaConfig):
        raise ValueError(
            '--weight-dtype int8 currently supports the llama '
            f'family; got {type(model_config).__name__}')
    return dataclasses.replace(model_config, weight_dtype='int8')


def run(model: str = 'llama-1b', host: str = '0.0.0.0', port: int = 8100,
        num_slots: int = 8, max_cache_len: int = 2048,
        tokenizer_name: Optional[str] = None,
        eos_id: Optional[int] = None,
        decode_steps: int = 8,
        hf_model: Optional[str] = None,
        cache_dtype: str = 'bfloat16',
        tensor_parallel: int = 0,
        weight_dtype: str = 'bf16',
        prefills_per_gap: int = 4,
        device=None,
        max_ttft: Optional[float] = None,
        max_queue: Optional[int] = None,
        draft_len: int = 0,
        ngram_max: int = 4,
        max_prefixes: int = 16,
        lora_rank: int = 0,
        lora_max_adapters: int = 8,
        adapter_dir: Optional[str] = None,
        adaptive_window: bool = False,
        decode_lookahead: bool = False,
        auto_prefix: bool = False,
        prefill_chunk: int = 0,
        kv_block_size: int = 0,
        kv_blocks: Optional[int] = None,
        auto_prefix_cache: bool = False,
        host_kv_bytes: int = 0,
        qos: bool = False,
        qos_tenant_weights: Optional[str] = None,
        warmup: bool = False) -> None:
    """Build the engine and an optional tokenizer, and serve.  The weights
    are a transformers checkpoint's (``hf_model``, a causal LM, loaded
    in bf16) or random ones from seed 0 for the registry's ``model``;
    ``weight_dtype='int8'`` quantizes the checkpoint's (on the engine's
    device) or draws random int8 ones.  The tokenizer defaults to the
    checkpoint's; when that implied one is missing the server runs
    token-only.  device: None means the card.

    tensor_parallel N > 1 serves over N ranks, one card each (or N gloo
    ranks with device='cpu'): joined from the env when one is up (torchrun,
    the podlet), else started here, ranks 1..N-1 in processes of their own
    that rendezvous through a file store in a temporary directory.  Rank 0
    alone reads the weights and the tokenizer; it sends the other ranks
    its configs and each rank its slice of the weights, serves HTTP, and
    releases them when it stops.  The other ranks run the engine's worker
    loop (``_tp_worker``)."""
    tp = tensor_parallel if tensor_parallel and tensor_parallel > 1 else 1
    if tp > 1:
        # Before the (tens-of-GB) weight load: a flag typo fails at once
        # (the JAX server's check and text).
        n_local = _visible_devices(device)
        if tp > n_local:
            raise ValueError(
                f'--tensor-parallel {tp} exceeds the {n_local} visible '
                'device(s); a mesh needs one chip per shard')
    if hf_model:
        import transformers

        from skypilot_tpu_torch.models import hf_import

        # The family from config.json alone, before the (tens-of-GB)
        # weight load: the JAX server's check and text.
        mt = getattr(transformers.AutoConfig.from_pretrained(hf_model),
                     'model_type', None)
        if mt not in hf_import.CAUSAL_LM:
            raise ValueError(
                f'--hf-model must be a supported causal-LM checkpoint '
                f"(model_type 'llama', 'qwen2', 'mistral', 'mixtral', "
                f"'gpt2' or 'gemma'); got model_type={mt!r}")
    else:
        model_config = get_model_config(model)
    mesh, ranks = None, []
    if tp > 1:
        ranks = _join_tp_group(tp, device)
        mesh = tp_mesh(tp, resolve_device(device).type)
        tp_lib.control_group()
        if dist.get_rank() != 0:
            _tp_worker(mesh, device)
            return
    engine, sent = None, False
    try:
        params = None
        tokenizer_implied = False   # tokenizer_name defaulted from hf_model
        if hf_model:
            dev = resolve_device(device)
            model_config, params = hf_import.load_hf_model(
                hf_model, param_dtype=torch.bfloat16)
            if weight_dtype == 'int8':
                model_config = _int8_config(model_config)
                # One weight at a time, on the engine's device (no host
                # f32 copy of the model); under tensor parallelism on the
                # host, whole (a row-parallel weight's scales span every
                # rank's columns), so no card holds more than its slice.
                qdev = dev if tp == 1 else torch.device('cpu')
                params = dict(quantize.iter_quantized(
                    (k, params.pop(k).to(qdev)) for k in list(params)))
            model = model_config.name
            if tokenizer_name is None:
                tokenizer_name = hf_model
                tokenizer_implied = True
        elif weight_dtype == 'int8':
            model_config = _int8_config(model_config)
        cfg = InferConfig(model=model, num_slots=num_slots,
                          max_cache_len=max_cache_len, eos_id=eos_id,
                          decode_steps=decode_steps,
                          prefills_per_gap=prefills_per_gap,
                          cache_dtype=resolve_cache_dtype(cache_dtype),
                          draft_len=draft_len, ngram_max=ngram_max,
                          max_prefixes=max_prefixes, lora_rank=lora_rank,
                          lora_max_adapters=lora_max_adapters,
                          adaptive_decode_window=adaptive_window,
                          decode_lookahead=decode_lookahead,
                          prefill_chunk=prefill_chunk,
                          kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                          auto_prefix_cache=auto_prefix_cache,
                          host_kv_bytes=host_kv_bytes,
                          qos=qos,
                          qos_tenant_weights=parse_tenant_weights(
                              qos_tenant_weights))
        tokenizer = None
        if tokenizer_name:
            from transformers import AutoTokenizer
            try:
                tokenizer = AutoTokenizer.from_pretrained(tokenizer_name)
            except Exception as e:  # noqa: BLE001 -- the tokenizer is optional
                if not tokenizer_implied:
                    raise            # explicitly requested: fail loudly
                # A checkpoint directory without tokenizer files:
                # token-only.
                print(f'warning: no tokenizer in {tokenizer_name} ({e}); '
                      '/generate_text disabled, /generate (token API) works')
                tokenizer = None
            if eos_id is None and tokenizer is not None:
                cfg.eos_id = getattr(tokenizer, 'eos_token_id', None)
        if mesh is not None:
            tp_lib.broadcast_object((model_config, cfg))
            sent = True
        engine = InferenceEngine(model_config, cfg, params=params,
                                 device=device, mesh=mesh)
        del params
        serve(engine, host=host, port=port, tokenizer=tokenizer,
              max_projected_ttft_s=max_ttft, max_queue=max_queue,
              adapter_dir=adapter_dir, auto_prefix=auto_prefix,
              warmup=warmup)
    finally:
        if engine is not None:
            engine.shutdown()
        elif mesh is not None and not sent:
            tp_lib.broadcast_object(None)   # no engine: release the ranks
        for proc in ranks:
            proc.join(timeout=60)
            if proc.is_alive():   # stuck where rank 0 failed: stopped here
                proc.kill()
                proc.join()
        if ranks:                  # the group this call started
            dist.destroy_process_group()


def _visible_devices(device) -> int:
    """The shards a tensor-parallel replica can place: the visible cards,
    or with device='cpu' the CPU cores this process may run on (one gloo
    rank each)."""
    if torch.device('cuda' if device is None else device).type == 'cuda':
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def _join_tp_group(tp: int, device) -> list:
    """The process group of a tensor-parallel replica: the env's (torchrun,
    the podlet), which must hold `tp` ranks, or, with none, one started
    here: ranks 1..tp-1 spawned to run ``_tp_rank``, all meeting at a file
    store in a fresh temporary directory (never a fixed port).  Returns
    the spawned processes (none when joined)."""
    if dist.is_initialized() or mesh_lib.initialize_distributed_from_env(
            device):
        if dist.get_world_size() != tp:
            raise ValueError(
                f'--tensor-parallel {tp} needs {tp} ranks; the process '
                f'group has {dist.get_world_size()}')
        return []
    init = 'file://' + os.path.join(tempfile.mkdtemp(prefix='skytpu-tp-'),
                                    'rendezvous')
    ctx = mp.get_context('spawn')
    ranks = [ctx.Process(target=_tp_rank, daemon=True,
                         args=(rank, tp, init, device))
             for rank in range(1, tp)]
    for proc in ranks:
        proc.start()
    _init_rank(0, tp, init, device)
    return ranks


def _init_rank(rank: int, world: int, init: str, device) -> None:
    cuda = resolve_device(device).type == 'cuda'
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group('nccl' if cuda else 'gloo', init_method=init,
                            rank=rank, world_size=world)


def _tp_rank(rank: int, world: int, init: str, device) -> None:
    """A rank that ``run`` spawned for its tensor-parallel replica."""
    if resolve_device(device).type == 'cpu':
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    _init_rank(rank, world, init, device)
    try:
        mesh = tp_mesh(world, resolve_device(device).type)
        tp_lib.control_group()
        _tp_worker(mesh, device)
    finally:
        dist.destroy_process_group()


def _tp_worker(mesh, device) -> None:
    """A rank > 0 of ``run``'s replica: the engine from rank 0's configs
    and its slice of rank 0's weights, then rank 0's dispatches until rank
    0 stops (or, when rank 0 failed before its engine, nothing)."""
    configs = tp_lib.broadcast_object()
    if configs is None:
        return
    model_config, cfg = configs
    InferenceEngine(model_config, cfg, device=device,
                    mesh=mesh).serve_worker()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama-1b')
    parser.add_argument('--port', type=int, default=8100)
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--num-slots', type=int, default=8)
    parser.add_argument('--max-cache-len', type=int, default=2048)
    parser.add_argument('--tokenizer', default=None,
                        help='HF tokenizer name (optional)')
    parser.add_argument('--eos-id', type=int, default=None)
    parser.add_argument('--decode-steps', type=int, default=8)
    parser.add_argument('--hf-model', default=None,
                        help='transformers checkpoint directory of the '
                             'causal LM (llama, qwen2, mistral, gemma, '
                             'gpt2, mixtral), served in bf16')
    parser.add_argument('--cache-dtype', default='bfloat16',
                        choices=['bfloat16', 'fp8', 'float8_e4m3fn'],
                        help='KV-cache storage dtype; fp8 (e4m3) halves '
                             'the cache bytes per slot')
    parser.add_argument('--tensor-parallel', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_SERVE_TP_SIZE', '0') or 0),
                        help='tensor-parallel serving over N cards, one '
                             'rank each (started here, or joined from '
                             'torchrun); default: $SKYTPU_SERVE_TP_SIZE '
                             'or 0')
    parser.add_argument('--draft-len', type=int, default=0,
                        help='speculative decoding: prompt-lookup draft '
                             'tokens per dispatch (0 disables)')
    parser.add_argument('--ngram-max', type=int, default=4,
                        help='longest n-gram tried when drafting')
    parser.add_argument('--max-prefixes', type=int, default=16,
                        help='resident prefix-KV entries for '
                             '/cache_prefix (LRU; 0 disables)')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='multi-LoRA serving: adapter rank '
                             '(0 disables; POST /load_adapter to load)')
    parser.add_argument('--lora-max-adapters', type=int, default=8,
                        help='resident adapter slots (--lora-rank)')
    parser.add_argument('--adapter-dir', default=None,
                        help='directory POST /load_adapter may read '
                             'from (unset: loading is disabled)')
    parser.add_argument('--adaptive-window', action='store_true',
                        help='queue-aware decode windows: short '
                             'dispatches only while arrivals wait')
    parser.add_argument('--decode-lookahead', action='store_true',
                        help='queue the next decode window before '
                             'reading the current one')
    parser.add_argument('--auto-prefix', action='store_true',
                        help='automatic prefix caching: a prompt head '
                             'seen twice registers itself (quantized to '
                             'a prefill bucket)')
    parser.add_argument('--prefill-chunk', type=int, default=0,
                        help='chunked prefill: split prompts into '
                             'N-token pieces interleaved between decode '
                             'windows, bounding the decode stall to one '
                             'chunk and lifting the largest-bucket '
                             'prompt cap (0 = monolithic prefill; must '
                             'divide --max-cache-len)')
    parser.add_argument('--kv-block-size', type=int, default=0,
                        help='block-paged KV cache: pool block size in '
                             'tokens (0 = dense slotted layout; must '
                             'divide --max-cache-len and every prefill '
                             'bucket). Decode reads ceil(len/block)*block '
                             'cached rows per step instead of '
                             'max_cache_len, and prefix hits share blocks '
                             'copy-free')
    parser.add_argument('--kv-blocks', type=int, default=None,
                        help='pool size in blocks (incl. the reserved '
                             'dump block). Default fully provisions '
                             'num_slots*max_cache_len/block + 1; smaller '
                             'pools oversubscribe device memory and '
                             'admission-defer requests whose worst-case '
                             'demand does not fit')
    parser.add_argument('--auto-prefix-cache', action='store_true',
                        help='engine-level automatic radix-tree prefix '
                             'caching over the paged KV pool (requires '
                             '--kv-block-size): completed prompts\' '
                             'full blocks become matchable, admitted '
                             'prompts reuse their longest block-aligned '
                             'cached prefix copy-free, unreferenced '
                             'leaves are LRU-evicted under pool '
                             'pressure')
    parser.add_argument('--host-kv-bytes', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_SERVE_HOST_KV_BYTES', '0') or 0),
                        help='host-RAM KV tier budget in bytes '
                             '(requires --auto-prefix-cache): radix '
                             'blocks evicted under device-memory pressure '
                             'spill to host RAM and restore on the next '
                             'prefix match (0 disables; default: '
                             '$SKYTPU_SERVE_HOST_KV_BYTES or 0)')
    parser.add_argument('--warmup', action='store_true',
                        default=os.environ.get(
                            'SKYTPU_SERVE_WARMUP', '') in
                        ('1', 'true', 'yes', 'on'),
                        help='warm every prefill bucket and the decode '
                             'windows before declaring ready (default: '
                             '$SKYTPU_SERVE_WARMUP or off)')
    parser.add_argument('--weight-dtype', default='bf16',
                        choices=['bf16', 'int8'],
                        help='int8 stores the decoder projections '
                             'quantized per output channel (about half '
                             "the weight bytes); the llama family's only")
    parser.add_argument('--qos', action='store_true',
                        help='QoS scheduling: interactive ahead of batch, '
                             'per-tenant weighted-fair queueing, deadline '
                             'shedding, chunk-boundary preemption')
    parser.add_argument('--qos-tenant-weights', default=None,
                        help='per-tenant WFQ weights, e.g. '
                             '"teamA=3,teamB=1"')
    args = parser.parse_args()
    run(model=args.model, host=args.host, port=args.port,
        num_slots=args.num_slots, max_cache_len=args.max_cache_len,
        tokenizer_name=args.tokenizer, eos_id=args.eos_id,
        decode_steps=args.decode_steps, hf_model=args.hf_model,
        cache_dtype=args.cache_dtype,
        tensor_parallel=args.tensor_parallel,
        weight_dtype=args.weight_dtype,
        draft_len=args.draft_len, ngram_max=args.ngram_max,
        max_prefixes=args.max_prefixes, lora_rank=args.lora_rank,
        lora_max_adapters=args.lora_max_adapters,
        adapter_dir=args.adapter_dir,
        adaptive_window=args.adaptive_window,
        decode_lookahead=args.decode_lookahead,
        auto_prefix=args.auto_prefix,
        prefill_chunk=args.prefill_chunk,
        kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
        auto_prefix_cache=args.auto_prefix_cache,
        host_kv_bytes=args.host_kv_bytes,
        qos=args.qos, qos_tenant_weights=args.qos_tenant_weights,
        warmup=args.warmup)


if __name__ == '__main__':
    main()
