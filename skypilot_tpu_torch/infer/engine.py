"""Continuous-batching inference engine, dense slotted KV cache, offline
``generate`` -- the PyTorch twin of the dense path of
``skypilot_tpu/infer/engine.py``.

- **KV cache**: one ``[num_slots, Hkv, max_cache_len, D]`` pair per layer,
  allocated once and updated in place.  A request occupies a slot from
  prefill until EOS / max-tokens, then the slot is recycled.
- **Bucketed, batched prefill** (``_prefill_insert``): prompts are
  right-padded to a bucket length and prefilled ``prefill_lanes`` at a
  time over a fresh ``[P, Hkv, bucket, D]`` cache; pad lanes duplicate
  the last real lane and target its slot (rewriting the same rows with
  the same values).  The first token is sampled at ``true_len - 1`` and
  each prompt's KV rows are copied into its slot.
- **Windowed decode** (``_decode``): ``decode_steps`` steps for every
  slot per window, with greedy or temperature sampling on the device,
  the chosen token's logprob and the top-``logprob_topk`` logprobs.  The
  window's tokens, logprobs and top-k ride ONE device->host transfer,
  packed into one f32 block (token ids bitcast).  A slot that stops
  mid-window wrote a few dead cache rows; the host discards those
  tokens and a later prefill overwrites the rows.

Prefill attends through ``write_kv_and_attend``/``decode_attention`` like
the JAX engine (not through the flash kernel).  Not ported yet:
``generate_stream`` and the HTTP server (ROADMAP.md A5), the paged cache,
radix prefix cache, host tier and the other serving features (A6).
"""
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.convert import init_params
from skypilot_tpu_torch.models.llama import Llama, LlamaConfig, init_cache
from skypilot_tpu_torch.models.registry import get_model_config

DEFAULT_PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048)
PRIORITY_CLASSES = ('interactive', 'batch')


@dataclasses.dataclass
class InferConfig:
    """Fields and defaults of the JAX engine's InferConfig.  The ones the
    port does not have yet must keep their defaults (see
    ``_UNPORTED``)."""
    model: str = 'llama-1b'
    num_slots: int = 8
    max_cache_len: int = 2048
    prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS
    max_new_tokens: int = 128
    eos_id: Optional[int] = None
    cache_dtype: torch.dtype = torch.bfloat16
    decode_steps: int = 8
    prefills_per_gap: int = 4
    adaptive_decode_window: bool = False
    decode_lookahead: bool = False
    prefill_lanes: int = 4
    prefill_chunk: int = 0
    draft_len: int = 0
    ngram_max: int = 4
    lora_rank: int = 0
    lora_max_adapters: int = 8
    lora_alpha: float = 16.0
    logprob_topk: int = 5
    kv_block_size: int = 0
    kv_blocks: Optional[int] = None
    auto_prefix_cache: bool = False
    host_kv_bytes: int = 0
    max_prefixes: int = 16
    run_stall_timeout_s: float = 120.0
    qos: bool = False
    qos_tenant_weights: Optional[Dict[str, float]] = None


# InferConfig features outside this slice: field -> ROADMAP.md item.
_UNPORTED = {
    'kv_block_size': 'A6 (paged KV + radix + host tier)',
    'auto_prefix_cache': 'A6 (paged KV + radix + host tier)',
    'host_kv_bytes': 'A6 (paged KV + radix + host tier)',
    'prefill_chunk': 'A6 (chunked prefill)',
    'draft_len': 'A6 (speculative decoding)',
    'lora_rank': 'A6 (multi-LoRA serving)',
    'qos': 'A6 (QoS scheduling)',
    'decode_lookahead': 'A5 (streaming serving)',
    'adaptive_decode_window': 'A5 (streaming serving)',
}


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0
    request_id: Optional[str] = None
    arrival_time: Optional[float] = None
    stream_cb: Optional[Callable[[List[int]], None]] = None
    adapter: Optional[str] = None
    want_prompt_logprobs: bool = False
    deadline_s: Optional[float] = None
    priority: Optional[str] = None
    tenant_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    request_id: Optional[str]
    prompt_tokens: List[int]
    output_tokens: List[int]
    ttft_s: float                 # submit -> first token
    latency_s: float              # submit -> last token
    finish_reason: str            # 'eos' | 'length' | 'error' | 'deadline'
    error: Optional[str] = None
    error_class: Optional[str] = None   # 'client' | 'internal' | 'shed'
    # log P(token | context) for each generated token.
    logprobs: Optional[List[float]] = None
    # Per generated position: top-k (token_id, logprob) pairs, best first.
    top_logprobs: Optional[List[List[Tuple[int, float]]]] = None
    prompt_logprobs: Optional[List[Optional[float]]] = None
    prompt_top_logprobs: Optional[List[Optional[List[Tuple[
        int, float]]]]] = None


def _pairs(ids_row, lps_row) -> List[Tuple[int, float]]:
    """[k] ids + [k] logprobs -> [(id, lp), ...] best-first."""
    return [(int(i), float(l)) for i, l in zip(ids_row, lps_row)]


def _unpack_head(buf: np.ndarray, topk: int):
    """Host inverse of ``_pack_head``: one transferred f32 block
    [..., 2+2k] -> (tokens i32, logprobs f32, top-k ids i32, top-k lps
    f32).  The id columns were bitcast on the device; a same-itemsize
    view restores them (the transfer is a byte copy)."""
    toks = np.ascontiguousarray(buf[..., 0]).view(np.int32)
    lps = buf[..., 1]
    tids = np.ascontiguousarray(buf[..., 2:2 + topk]).view(np.int32)
    tlps = buf[..., 2 + topk:]
    return toks, lps, tids, tlps


class _Slot:
    __slots__ = ('request', 'length', 'generated', 'submit_time',
                 'first_token_time', 'max_new', 'lps', 'tops')

    def __init__(self, request: Request, length: int, submit_time: float,
                 max_new: int):
        self.request = request
        self.length = length               # filled cache positions
        self.generated: List[int] = []
        self.submit_time = submit_time
        self.first_token_time: Optional[float] = None
        self.max_new = max_new
        self.lps: List[float] = []         # logprob per generated token
        self.tops: List[List[Tuple[int, float]]] = []


class InferenceEngine:
    """Single-device engine over the dense slotted cache.

    params: a ``Llama`` state_dict (``models.convert.state_dict_from_jax``
    or ``init_params``); None draws one with ``init_params`` from
    ``generator``.  generator: a ``torch.Generator`` on the engine's
    device, for the init (when params is None) and for sampling; None
    seeds one with 0.  device: None means the CUDA card.
    """

    def __init__(self, model_config: LlamaConfig,
                 cfg: Optional[InferConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        if not isinstance(model_config, LlamaConfig):
            raise TypeError('the port serves the llama family so far; got '
                            f'{type(model_config).__name__}')
        self.device = resolve_device(device)
        self.model_config = model_config
        self.cfg = cfg = cfg or InferConfig()
        defaults = InferConfig()
        for name, item in _UNPORTED.items():
            if getattr(cfg, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f'InferConfig.{name}={getattr(cfg, name)!r} is not '
                    f'ported yet (ROADMAP.md {item})')
        if cfg.cache_dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f'cache_dtype {cfg.cache_dtype} is not ported yet '
                '(ROADMAP.md A6: the fp8 KV cache)')
        if cfg.max_cache_len > model_config.max_seq_len:
            raise ValueError(
                f'max_cache_len {cfg.max_cache_len} exceeds model '
                f'max_seq_len {model_config.max_seq_len}')
        if cfg.decode_steps < 1:
            raise ValueError(
                f'decode_steps must be >= 1 (got {cfg.decode_steps})')
        if cfg.prefill_lanes < 1:
            raise ValueError(f'prefill_lanes must be >= 1 '
                             f'(got {cfg.prefill_lanes})')
        if not 1 <= cfg.logprob_topk <= model_config.vocab_size:
            raise ValueError(
                f'logprob_topk must be in [1, vocab_size='
                f'{model_config.vocab_size}] (got {cfg.logprob_topk})')
        buckets = tuple(b for b in cfg.prefill_buckets
                        if b <= cfg.max_cache_len)
        if not buckets or buckets[-1] < cfg.max_cache_len:
            # Any prompt the cache can hold has a bucket.
            buckets += (cfg.max_cache_len,)
        cfg.prefill_buckets = buckets
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        self.model = Llama(model_config, device=self.device).eval()
        self.model.load_state_dict(
            params if params is not None
            else init_params(model_config, generator))
        self.cache = init_cache(model_config, cfg.num_slots,
                                cfg.max_cache_len, cfg.cache_dtype,
                                self.device)
        b = cfg.num_slots
        self._slots: List[Optional[_Slot]] = [None] * b
        # Host mirrors of per-slot decode state, sent to the device per
        # window as small tensors.
        self._lengths = np.zeros((b,), np.int64)
        self._last_tokens = np.zeros((b,), np.int64)
        self._temps = np.zeros((b,), np.float32)
        self._lock = threading.Lock()

    # --------------------------------------------------------- device

    def _pack_head(self, logits: torch.Tensor, temps: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample one token per row of logits [N, V] (greedy where temp
        is 0, else Gumbel-max at that temperature).  Returns (the chosen
        tokens [N], one f32 block [N, 2 + 2k] packing token, logprob,
        top-k ids and top-k logprobs, ids bitcast to f32)."""
        logz = torch.logsumexp(logits, dim=-1)
        greedy = logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        sampled = (logits / temps.clamp_min(1e-4)[:, None] + gumbel).argmax(-1)
        chosen = torch.where(temps > 0, sampled, greedy)
        lp = logits.gather(-1, chosen[:, None])[:, 0] - logz
        top_vals, top_ids = torch.topk(logits, self.cfg.logprob_topk, dim=-1)
        return chosen, torch.cat([
            chosen.to(torch.int32).view(torch.float32)[:, None],
            lp[:, None],
            top_ids.to(torch.int32).view(torch.float32),
            top_vals - logz[:, None]], dim=-1)

    @torch.inference_mode()
    def _prefill_insert(self, tokens: torch.Tensor, true_lens: torch.Tensor,
                        slots: torch.Tensor,
                        temps: torch.Tensor) -> torch.Tensor:
        """P prompts forward over a fresh [P, Hkv, bucket, D] cache, first
        token sampled at true_lens-1, each prompt's KV rows copied into
        its slot.  tokens [P, bucket]; true_lens/slots/temps [P].
        Returns the packed head [P, 2+2k]."""
        p, bucket = tokens.shape
        pcache = init_cache(self.model_config, p, bucket,
                            self.cfg.cache_dtype, self.device)
        positions = torch.arange(bucket, device=self.device).expand(p, bucket)
        logits, pcache = self.model(tokens, positions, pcache)
        last = logits[torch.arange(p, device=self.device), true_lens - 1]
        _, head = self._pack_head(last, temps)
        for (k, v), (pk, pv) in zip(self.cache, pcache):
            k[slots, :, :bucket] = pk
            v[slots, :, :bucket] = pv
        return head

    @torch.inference_mode()
    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor,
                temps: torch.Tensor, steps: int) -> torch.Tensor:
        """`steps` decode steps for every slot; tokens/lengths/temps [B].
        Returns the packed window [steps, B, 2+2k]."""
        heads = []
        for _ in range(steps):
            logits, _ = self.model(tokens[:, None], lengths[:, None],
                                   self.cache)
            tokens, head = self._pack_head(logits[:, 0], temps)
            heads.append(head)
            lengths = lengths + 1
        return torch.stack(heads)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------- schedule

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f'prompt length {n} exceeds largest prefill bucket '
            f'{self.cfg.prefill_buckets[-1]}')

    def _free_slot(self, exclude=()) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None and i not in exclude:
                return i
        return None

    def _max_new(self, req: Request) -> int:
        return self.cfg.max_new_tokens if req.max_new_tokens is None \
            else req.max_new_tokens

    def _validate_request(self, req: Request) -> Tuple[int, int, int]:
        """Returns (prompt_len, bucket, max_new); raises ValueError on a
        bad request and NotImplementedError on a feature not ported."""
        if req.want_prompt_logprobs:
            raise NotImplementedError(
                'prompt logprobs are not ported yet (ROADMAP.md A6)')
        if req.stream_cb is not None:
            raise NotImplementedError(
                'streaming callbacks are not ported yet (ROADMAP.md A5, '
                'generate_stream)')
        n = len(req.tokens)
        max_new = self._max_new(req)
        if n < 1:
            raise ValueError('empty prompt')
        if req.adapter is not None:
            raise ValueError(
                f'request names adapter {req.adapter!r} but the engine '
                'was built without lora_rank')
        if max_new < 1:
            raise ValueError(
                f'max_new_tokens must be >= 1 (got {max_new}); generation '
                'always produces at least the prefill token')
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f'deadline_s must be > 0 (got {req.deadline_s})')
        if req.priority is not None and req.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f'unknown priority {req.priority!r}; expected one of '
                f'{list(PRIORITY_CLASSES)}')
        bucket = self._bucket(n)
        if n + max_new > self.cfg.max_cache_len:
            raise ValueError(
                f'prompt ({n}) + max_new_tokens ({max_new}) exceeds cache '
                f'({self.cfg.max_cache_len})')
        return n, bucket, max_new

    def _start_batch(self, items) -> None:
        """Prefill validated requests, grouped by bucket, prefill_lanes
        rows per dispatch.  items: (req, slot, submit_time, prompt_len,
        bucket, max_new) tuples.  Dispatch width is always
        prefill_lanes; pad lanes duplicate the last real lane, slot
        included, so their cache writes are identical rewrites."""
        lanes = self.cfg.prefill_lanes
        by_bucket: Dict[int, list] = {}
        for it in items:
            by_bucket.setdefault(it[4], []).append(it)
        for bucket, group in by_bucket.items():
            for ofs in range(0, len(group), lanes):
                chunk = group[ofs:ofs + lanes]
                p = len(chunk)
                tokens = np.zeros((lanes, bucket), np.int64)
                true_lens = np.ones((lanes,), np.int64)
                slots = np.zeros((lanes,), np.int64)
                temps = np.zeros((lanes,), np.float32)
                for i in range(lanes):
                    req, slot, _, n, _, _ = chunk[min(i, p - 1)]
                    tokens[i, :n] = req.tokens
                    true_lens[i] = n
                    slots[i] = slot
                    temps[i] = req.temperature
                if any(slots[i] != slots[p - 1] for i in range(p, lanes)):
                    raise RuntimeError(
                        f'pad lanes must duplicate the last real lane: '
                        f'{slots=} p={p}')
                head = self._prefill_insert(
                    self._to_device(tokens), self._to_device(true_lens),
                    self._to_device(slots), self._to_device(temps))
                first, first_lp, tids, tlps = _unpack_head(
                    head.cpu().numpy(), self.cfg.logprob_topk)  # ONE transfer
                now = time.time()
                for i, (req, slot, submit_time, n, _, max_new) in \
                        enumerate(chunk):
                    s = _Slot(req, length=n, submit_time=submit_time,
                              max_new=max_new)
                    s.first_token_time = now
                    s.generated.append(int(first[i]))
                    s.lps.append(float(first_lp[i]))
                    s.tops.append(_pairs(tids[i], tlps[i]))
                    self._slots[slot] = s
                    self._lengths[slot] = n
                    self._last_tokens[slot] = s.generated[0]
                    self._temps[slot] = req.temperature

    def _finish_slot(self, i: int, reason: str,
                     error: Optional[str] = None,
                     error_class: Optional[str] = None,
                     ) -> Tuple[Request, RequestResult]:
        s = self._slots[i]
        now = time.time()
        res = RequestResult(
            request_id=s.request.request_id,
            prompt_tokens=list(s.request.tokens),
            output_tokens=list(s.generated),
            ttft_s=(s.first_token_time or now) - s.submit_time,
            latency_s=now - s.submit_time,
            finish_reason=reason,
            error=error,
            error_class=error_class,
            logprobs=list(s.lps),
            top_logprobs=list(s.tops))
        self._slots[i] = None
        self._lengths[i] = 0
        self._temps[i] = 0.0
        return s.request, res

    def _decode_step(self) -> List[Tuple[Request, RequestResult]]:
        """One decode window for every slot: dispatch from the host
        mirrors, then consume it.  Returns lanes killed by the
        non-finite guard."""
        packed = self._decode(self._to_device(self._last_tokens),
                              self._to_device(self._lengths),
                              self._to_device(self._temps),
                              self.cfg.decode_steps)
        return self._consume_window(packed)

    def _consume_window(self, packed: torch.Tensor
                        ) -> List[Tuple[Request, RequestResult]]:
        """Append up to K tokens per slot, stopping at EOS, max_new or the
        cache end; tokens past a slot's stop are speculative overrun and
        are discarded."""
        toks, lps, gtoks, glps = _unpack_head(
            packed.cpu().numpy(), self.cfg.logprob_topk)  # ONE transfer
        bad: List[int] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            for k in range(toks.shape[0]):
                if len(s.generated) >= s.max_new:
                    break
                if (self.cfg.eos_id is not None and s.generated and
                        s.generated[-1] == self.cfg.eos_id):
                    break
                if s.length + 1 >= self.cfg.max_cache_len:
                    break
                if not np.isfinite(lps[k, i]):
                    # This lane's logits blew up: kill the lane, not the
                    # batch (other lanes' columns are independent).
                    bad.append(i)
                    break
                s.length += 1        # the token just fed is now cached
                s.generated.append(int(toks[k, i]))
                s.lps.append(float(lps[k, i]))
                s.tops.append(_pairs(gtoks[k, i], glps[k, i]))
            self._lengths[i] = s.length
            self._last_tokens[i] = s.generated[-1]
        return [self._finish_slot(
                    i, 'error',
                    error='non-finite logits in decode window (lane killed)',
                    error_class='internal') for i in bad]

    def _harvest(self) -> List[Tuple[Request, RequestResult]]:
        done = []
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            dl = s.request.deadline_s
            if dl is not None and now - s.submit_time >= dl:
                done.append(self._finish_slot(i, 'deadline'))
            elif self.cfg.eos_id is not None and \
                    s.generated[-1] == self.cfg.eos_id:
                done.append(self._finish_slot(i, 'eos'))
            elif len(s.generated) >= s.max_new:
                done.append(self._finish_slot(i, 'length'))
            elif s.length + 1 >= self.cfg.max_cache_len:
                done.append(self._finish_slot(i, 'length'))
        return done

    # ------------------------------------------------------------ API

    def generate(self, requests: List[Request]) -> List[RequestResult]:
        """Offline batch generation with continuous batching: every free
        slot is filled from the pending list before each decode window,
        and slots are refilled as requests finish.  Results come back in
        request order."""
        with self._lock:
            pending = list(requests)
            finished: List[Tuple[Request, RequestResult]] = []
            t0 = time.time()
            while pending or any(s is not None for s in self._slots):
                to_start = []
                while pending:
                    slot = self._free_slot(exclude=[it[1] for it in to_start])
                    if slot is None:
                        break
                    req = pending.pop(0)
                    try:
                        to_start.append((req, slot, t0,
                                         *self._validate_request(req)))
                    except ValueError as e:
                        # A bad request fails alone, not the whole batch.
                        finished.append((req, RequestResult(
                            request_id=req.request_id,
                            prompt_tokens=list(req.tokens),
                            output_tokens=[], ttft_s=0.0, latency_s=0.0,
                            finish_reason='error', error=str(e),
                            error_class='client')))
                if to_start:
                    self._start_batch(to_start)
                # The prefill already produced one token, which may meet
                # max_new_tokens=1 or be the EOS.
                finished.extend(self._harvest())
                if not any(s is not None for s in self._slots):
                    continue
                finished.extend(self._decode_step())
                finished.extend(self._harvest())
            order = {id(r): i for i, r in enumerate(requests)}
            finished.sort(key=lambda pair: order.get(id(pair[0]), 0))
            return [res for _, res in finished]


def engine_from_name(model: str, cfg: Optional[InferConfig] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> InferenceEngine:
    cfg = cfg or InferConfig(model=model)
    return InferenceEngine(get_model_config(model), cfg,
                           generator=generator, device=device)
