"""Continuous-batching inference engine over a dense slotted KV cache or a
block-paged KV pool -- the PyTorch twin of ``skypilot_tpu/infer/engine.py``.

- **Dense KV cache**: one ``[num_slots, Hkv, max_cache_len, D]`` pair per
  layer, allocated once and updated in place.  A request occupies a slot
  from prefill until EOS / max-tokens, then the slot is recycled.
- **Block-paged KV pool** (``kv_block_size > 0``): one
  ``[kv_blocks, Hkv, kv_block_size, D]`` pair per layer shared by every
  slot; a host-side allocator (``infer/block_pool.py``) maps each slot's
  logical blocks to pool blocks and admission reserves each request's
  worst-case block demand up front, deferring the head of the queue
  when the pool cannot hold it (``admission_deferred``).  With
  ``auto_prefix_cache`` a radix tree (``infer/radix.py``) indexes
  finished prompts' full blocks: a new prompt reuses its longest cached
  block-aligned prefix by reference and prefills only the suffix.  With
  ``host_kv_bytes`` radix eviction spills recently used blocks to a
  host-RAM tier and the next match restores them.  The hottest prefixes
  export (``export_hot_prefixes``) and adopt (``adopt_prefixes``) in the
  JAX replica's wire form: the drain-time handoff.
- **Bucketed, batched prefill** (``_prefill_insert``, ``_paged_prefill``):
  prompts are right-padded to a bucket length and prefilled
  ``prefill_lanes`` at a time; pad lanes duplicate the last real lane and
  target its slot (rewriting the same rows with the same values).  The
  first token is sampled at ``true_len - 1``.  A request with
  ``want_prompt_logprobs`` also gets every prompt position's log-prob
  and top-k from the same logits (``RequestResult.prompt_logprobs``,
  entry 0 ``None``); such requests bypass the radix tree.
- **Chunked prefill** (``prefill_chunk`` = C > 0, ``_chunk_round``): a
  prompt longer than the largest bucket, or (serving) one longer than C
  while other streams decode, is written C rows per serving gap in one
  full-slot-width dispatch over the live cache; its slot activates on
  the final chunk.  An active stream then stalls at most one chunk per
  window instead of a whole prefill.
- **Windowed decode** (``_decode``): ``decode_steps`` steps for every
  slot per window, with greedy or temperature sampling on the device,
  the chosen token's logprob and the top-``logprob_topk`` logprobs.  The
  window's tokens, logprobs and top-k ride ONE device->host transfer,
  packed into one f32 block (token ids bitcast).  A slot that stops
  mid-window wrote a few dead cache rows; the host discards those
  tokens and a later prefill overwrites the rows.
- **Serving** (``generate_stream``): a supervised loop that drains a
  request queue into the admission scheduler, prefills at most
  ``prefills_per_gap`` requests between decode windows while slots are
  busy, streams each window's tokens through ``Request.stream_cb``,
  honours cancels and deadlines, and contains every dispatch failure
  (``_contain_failure``): an attributed fault fails its slot, anything
  else fails the active batch and zeroes the cache (the paged pool's
  allocator and radix tree reset with it; the host tier stays).  The
  queue-aware window (``adaptive_decode_window``) and decode lookahead
  (``decode_lookahead``, the next window queued on the device from the
  current one's device-side tokens before the host waits for it) change
  the dispatch schedule, never the greedy tokens.

- **fp8 KV cache** (``cache_dtype=torch.float8_e4m3fn``): half the
  cache bytes per slot; rows enter the cache through
  ``models.llama.cast_rows`` (the JAX engine's bytes, NaN past e4m3's
  range) and move as their uint8 view (``as_bytes``) everywhere else.
- **Registered prefixes** (``register_prefix``, ``max_prefixes``): a
  system prompt's KV rows stay resident and a prompt that starts with it
  prefills only its suffix.  Dense: the rows are kept apart and
  preloaded into each lane's prefill cache (``_prefix_prefill``); paged:
  the entry holds pool blocks that matching slots share by reference, a
  partial tail block copied (``_paged_copy_blocks``); with the radix
  cache registration pins the prefix's nodes.
- **Multi-LoRA serving** (``lora_rank`` > 0): the model carries
  ``lora_max_adapters`` stacked zero adapters per target;
  ``register_adapter`` writes a trained adapter (``train.lora``'s
  ``.npz`` tree) into a slot in place, and every dispatch -- prefill of
  each kind, chunk rounds, decode windows and their lookahead, the
  speculative verify, prefix capture and prompt scoring -- takes one
  adapter id per row from the ``_slot_adapters`` host mirror (-1: the
  base model), so base and adapter requests share a batch.  Registered
  prefixes, radix nodes, host-tier entries and handed-off prefixes are
  keyed by adapter.  Re-registering a name drops every cached row
  computed under its old weights (ROADMAP.md C3).
- **Prompt-lookup speculative decoding** (``draft_len`` = D > 0,
  ``_spec_step``): each greedy slot drafts up to D tokens from an
  earlier occurrence of its trailing n-gram (``prompt_lookup_draft``),
  one ``[B, 1+D]`` cached forward verifies them, and the agreed prefix
  plus the model's own next token is accepted: greedy tokens are those
  of windowed decode.
- **QoS** (``qos``, ``qos_tenant_weights``; ``infer/qos.py``): priority
  classes and per-tenant weighted-fair queueing decide the admission
  order; at dequeue a request whose deadline the observed service rate
  cannot meet is shed (typed: finish_reason 'deadline', error_class
  'shed'), a more over-share tenant's doomed row first; with a paged pool,
  the radix tree and chunked prefill, an interactive arrival parks a
  part-prefilled batch prompt at its chunk boundary (``_park_chunk_job``)
  and the prompt resumes from its radix blocks.  QoS reorders and rejects
  work, never changes a stream's tokens.

Prefill attends through ``write_kv_and_attend``/``decode_attention`` (or
their paged twins) like the JAX engine, not through the flash kernel.

The engine serves the llama family (with gemma), GPT-2 and Mixtral, as
the JAX engine does: the module comes from ``registry.build_model`` and
the engine reads only ``head_dim_``, ``num_kv_heads``, ``num_layers``,
``max_seq_len`` and ``vocab_size`` of its config.  Mixtral's cached
forward routes every token exactly (all experts, gate-weighted).  The
block-paged pool and multi-LoRA serve the llama family only and refuse
the others with the JAX engine's TypeError.

- **Tensor-parallel serving** (``mesh`` with a 'tensor' axis, one process
  per rank; ``infer/tp.py``): every rank holds its slice of the weights
  (``parallel.mesh.shard_tensor``, sent by rank 0) in a rank-local model
  and the cache's ``Hkv / tp`` kv heads; rank 0 runs the engine and
  broadcasts each device dispatch, the other ranks run ``serve_worker``;
  a dispatch that fails on any rank stops the replica.  Host-tier
  rows and handoff payloads stay the topology-neutral ``[L, Hkv, bs, D]``:
  a spill or an export gathers every rank's heads, a restore or an
  adoption scatters them by heads.  ``stats()`` and ``kv_health()``
  report the degree and the per-chip bytes.  Multi-LoRA's adapter stacks
  are sliced with their projections, and GPT-2's fused ``c_attn`` by
  heads within each of q, k and v.  'data', 'fsdp', 'seq' and 'stage'
  ranks are replicas of their tensor group (no parameter sits on those
  axes).
"""
import base64
import collections
import contextlib
import dataclasses
import math
import queue
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from skypilot_tpu_torch.analysis import sanitizers
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer.block_pool import BlockPool, HostKVTier
from skypilot_tpu_torch.infer import qos as qos_mod
from skypilot_tpu_torch.infer.faults import InjectedFault
from skypilot_tpu_torch.infer.qos import DEFAULT_TENANT, PRIORITY_CLASSES
from skypilot_tpu_torch.infer.radix import RadixTree
from skypilot_tpu_torch.infer.scheduler import FifoScheduler
from skypilot_tpu_torch.infer.tp import (PerRank, TensorParallel,
                                         dispatch, validate_mesh)
from skypilot_tpu_torch.models.convert import init_params, iter_params
from skypilot_tpu_torch.models.llama import (FP8, LlamaConfig, as_bytes,
                                             init_cache, init_paged_cache)
from skypilot_tpu_torch.models.registry import (CausalLMConfig, build_model,
                                                get_model_config,
                                                is_causal_lm, rank_config)
from skypilot_tpu_torch.parallel.mesh import (Mesh, all_gather_cat,
                                              is_fused_qkv, shard_tensor)
from skypilot_tpu_torch.train.lora import (flax_path, is_lora_path, nest,
                                           port_name)

DEFAULT_PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048)

_CACHE_DTYPES = {
    'bfloat16': torch.bfloat16,
    'bf16': torch.bfloat16,
    'fp8': torch.float8_e4m3fn,
    'float8_e4m3fn': torch.float8_e4m3fn,
    'float32': torch.float32,
}


def resolve_cache_dtype(name: str) -> torch.dtype:
    """CLI string -> KV-cache dtype (the JAX engine's names).  fp8 (e4m3)
    halves the cache's bytes per slot; it keeps no scales, so rows past
    e4m3's range store NaN, as the JAX engine's do."""
    try:
        return _CACHE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f'unknown cache dtype {name!r}; one of '
            f'{sorted(_CACHE_DTYPES)}') from None


@dataclasses.dataclass
class InferConfig:
    """Fields and defaults of the JAX engine's InferConfig."""
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


def _dtype_name(dtype: torch.dtype) -> str:
    """The cache dtype's name on the wire: numpy's name for the JAX
    engine's dtype ('bfloat16', 'float8_e4m3fn', 'float32')."""
    return str(dtype).split('.')[-1]


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0
    request_id: Optional[str] = None
    # When the request entered the system (HTTP handler): TTFT and the
    # deadline count from here, so time spent queued for a slot counts.
    arrival_time: Optional[float] = None
    # Streaming: called on the engine thread, under the engine lock, with
    # each batch of newly generated token ids -- keep it cheap (a queue
    # put).  The RequestResult still arrives after the last chunk.
    stream_cb: Optional[Callable[[List[int]], None]] = None
    adapter: Optional[str] = None
    want_prompt_logprobs: bool = False
    # Seconds from arrival (else from dequeue); enforced by the engine:
    # an expired request is evicted with its partial output.
    deadline_s: Optional[float] = None
    priority: Optional[str] = None
    tenant_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    request_id: Optional[str]
    prompt_tokens: List[int]
    output_tokens: List[int]
    ttft_s: float                 # arrival/submit -> first token
    latency_s: float              # arrival/submit -> last token
    # 'eos' | 'length' | 'error' | 'deadline' | 'cancelled'
    finish_reason: str
    error: Optional[str] = None
    error_class: Optional[str] = None   # 'client' | 'internal' | 'shed'
    # log P(token | context) for each generated token.
    logprobs: Optional[List[float]] = None
    # Per generated position: top-k (token_id, logprob) pairs, best first.
    top_logprobs: Optional[List[List[Tuple[int, float]]]] = None
    prompt_logprobs: Optional[List[Optional[float]]] = None
    prompt_top_logprobs: Optional[List[Optional[List[Tuple[
        int, float]]]]] = None


def prompt_lookup_draft(hist: Sequence[int], k: int,
                        ngram_max: int) -> List[int]:
    """Prompt-lookup drafting: up to `k` tokens continuing the most recent
    earlier occurrence of the history's trailing n-gram, the longest n
    first.  Host-side numpy over the slot's own prompt + output tokens:
    no draft model, no device work."""
    length = len(hist)
    if length < 2 or k < 1:
        return []
    h = np.asarray(hist, np.int32)
    for n in range(min(ngram_max, length - 1), 0, -1):
        tail = h[length - n:]
        # Windows start at 0 .. length-1-n: the trailing n-gram itself
        # (start length-n) is left out, so a match is an earlier one.
        windows = np.lib.stride_tricks.sliding_window_view(
            h[:length - 1], n)
        cand = np.flatnonzero((windows == tail).all(axis=1))
        if cand.size:
            start = int(cand[-1]) + n
            proposal = h[start:start + k]
            if proposal.size:
                return proposal.tolist()
    return []


def _pairs(ids_row, lps_row) -> List[Tuple[int, float]]:
    """[k] ids + [k] logprobs -> [(id, lp), ...] best-first."""
    return [(int(i), float(l)) for i, l in zip(ids_row, lps_row)]


def _unpack_scores(buf: np.ndarray, topk: int):
    """Host inverse of ``_pack_scores``: one transferred f32 block
    [..., 1+2k] -> (logprobs f32, top-k ids i32, top-k lps f32).  The id
    columns were bitcast on the device; a same-itemsize view restores
    them (the transfer is a byte copy)."""
    tids = np.ascontiguousarray(buf[..., 1:1 + topk]).view(np.int32)
    return buf[..., 0], tids, buf[..., 1 + topk:]


def _unpack_head(buf: np.ndarray, topk: int):
    """Host inverse of ``_pack_head``: one transferred f32 block
    [..., 2+2k] -> (tokens i32, logprobs f32, top-k ids i32, top-k lps
    f32)."""
    toks = np.ascontiguousarray(buf[..., 0]).view(np.int32)
    return (toks, *_unpack_scores(buf[..., 1:], topk))


class _Slot:
    __slots__ = ('request', 'length', 'generated', 'submit_time',
                 'first_token_time', 'max_new', 'streamed', 'lps', 'tops',
                 'prompt_lps', 'prompt_tops', 'agen')

    def __init__(self, request: Request, length: int, submit_time: float,
                 max_new: int, agen: int = 0):
        self.request = request
        # The registration generation of the request's adapter when its
        # prompt rows were written: a re-registration since makes them
        # stale, and they must not join the radix tree (C3).
        self.agen = agen
        self.length = length               # filled cache positions
        self.generated: List[int] = []
        self.submit_time = submit_time
        self.first_token_time: Optional[float] = None
        self.max_new = max_new
        self.streamed = 0                  # tokens already stream_cb'd
        self.lps: List[float] = []         # logprob per generated token
        self.tops: List[List[Tuple[int, float]]] = []
        # want_prompt_logprobs: per prompt position, entry 0 None.
        self.prompt_lps: Optional[list] = None
        self.prompt_tops: Optional[list] = None


class _ChunkJob:
    """A prompt mid-chunked-prefill.  Owns its slot (excluded from
    _free_slot) but has no _Slot yet: rows [0, done) of the slot hold its
    prompt KV, and the host length mirror tracks `done`, so interleaved
    decode's dead-row writes for this lane land at the frontier, past the
    prompt rows already written.  The slot activates (becomes a _Slot,
    first token sampled) on the final chunk."""
    __slots__ = ('req', 'slot', 'submit_time', 'n', 'max_new', 'done', 'aid',
                 'agen')

    def __init__(self, req: Request, slot: int, submit_time: float,
                 n: int, max_new: int, aid: int = -1, agen: int = 0):
        self.req = req
        self.aid = aid                     # adapter stack slot, -1 base
        self.agen = agen                   # as _Slot.agen
        self.slot = slot
        self.submit_time = submit_time
        self.n = n                         # total prompt tokens
        self.max_new = max_new
        self.done = 0                      # prompt rows already written


class InferenceEngine:
    """Single-device engine over the dense slotted cache.

    params: a state_dict of the config's family
    (``models.convert.state_dict_from_jax`` or ``init_params``); None draws
    one with ``init_params`` from ``generator``.  generator: a
    ``torch.Generator`` on the engine's device, for the init (when params
    is None) and for sampling; None seeds one with 0.  device: None means
    the CUDA card.

    mesh: a ``parallel.mesh.Mesh`` with a 'tensor' axis enables
    tensor-parallel serving (see ``infer.tp``): every rank of the process
    group builds this engine with the same configs and takes rank 0's
    generator state; only rank 0's ``params`` are read (rank 0 sends each
    rank its slice), and with none every rank draws the same weights and
    keeps its slice.  All but rank 0 then call
    ``serve_worker``; rank 0 serves and calls ``shutdown`` at the end.
    num_kv_heads must be divisible by the tensor degree.  'data' and
    'fsdp' ranks hold replicas.
    """

    def __init__(self, model_config: CausalLMConfig,
                 cfg: Optional[InferConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, mesh: Optional[Mesh] = None):
        if not is_causal_lm(model_config):
            raise TypeError(
                'InferenceEngine supports the Llama, Mixtral and GPT-2 '
                'families (KV-cache decode path); got '
                f'{type(model_config).__name__}')
        self.device = resolve_device(device)
        # The serving thread selects this card itself: the current
        # device is per thread.
        self._cuda_index = (None if self.device.type != 'cuda' else
                            self.device.index if self.device.index is not None
                            else torch.cuda.current_device())
        self.model_config = model_config
        self.cfg = cfg = cfg or InferConfig()
        if cfg.cache_dtype not in (torch.bfloat16, FP8, torch.float32):
            raise ValueError(
                f'cache_dtype must be one of bfloat16, float8_e4m3fn, '
                f'float32 (got {cfg.cache_dtype})')
        if cfg.max_cache_len > model_config.max_seq_len:
            raise ValueError(
                f'max_cache_len {cfg.max_cache_len} exceeds model '
                f'max_seq_len {model_config.max_seq_len}')
        if cfg.decode_steps < 1:
            raise ValueError(
                f'decode_steps must be >= 1 (got {cfg.decode_steps})')
        if cfg.prefills_per_gap < 1:
            # 0 would block every new prefill while any slot is active.
            raise ValueError(f'prefills_per_gap must be >= 1 '
                             f'(got {cfg.prefills_per_gap})')
        if cfg.prefill_lanes < 1:
            raise ValueError(f'prefill_lanes must be >= 1 '
                             f'(got {cfg.prefill_lanes})')
        if cfg.prefill_chunk < 0:
            raise ValueError(f'prefill_chunk must be >= 0 '
                             f'(got {cfg.prefill_chunk})')
        if cfg.prefill_chunk and cfg.max_cache_len % cfg.prefill_chunk:
            # Chunk writes are C rows wide and start at multiples of C:
            # divisibility keeps start + C <= max_cache_len, so a write is
            # never clamped back onto the slot's own live prompt rows.
            raise ValueError(
                f'max_cache_len ({cfg.max_cache_len}) must be a multiple '
                f'of prefill_chunk ({cfg.prefill_chunk})')
        if not 1 <= cfg.logprob_topk <= model_config.vocab_size:
            raise ValueError(
                f'logprob_topk must be in [1, vocab_size='
                f'{model_config.vocab_size}] (got {cfg.logprob_topk})')
        if cfg.run_stall_timeout_s <= 0:
            raise ValueError(f'run_stall_timeout_s must be > 0 '
                             f'(got {cfg.run_stall_timeout_s})')
        if cfg.kv_block_size < 0:
            raise ValueError(f'kv_block_size must be >= 0 '
                             f'(got {cfg.kv_block_size})')
        if cfg.draft_len < 0:
            raise ValueError(f'draft_len must be >= 0 '
                             f'(got {cfg.draft_len})')
        if cfg.draft_len + 1 >= cfg.max_cache_len:
            raise ValueError(
                f'draft_len + 1 ({cfg.draft_len + 1}) must be < '
                f'max_cache_len ({cfg.max_cache_len})')
        if cfg.draft_len and cfg.ngram_max < 1:
            raise ValueError(f'ngram_max must be >= 1 '
                             f'(got {cfg.ngram_max})')
        # Tensor degree of this replica (1 unsharded): the model's and the
        # cache's heads per rank, and the per-chip KV bytes of stats().
        self._tp = validate_mesh(mesh, model_config)
        self._mesh = mesh
        self._paged = cfg.kv_block_size > 0
        if self._paged and not isinstance(model_config, LlamaConfig):
            raise TypeError(
                'the block-paged KV cache supports the llama '
                f'family; got {type(model_config).__name__}')
        if self._paged and cfg.max_cache_len % cfg.kv_block_size:
            raise ValueError(
                f'max_cache_len ({cfg.max_cache_len}) must be a multiple '
                f'of kv_block_size ({cfg.kv_block_size})')
        if self._paged and cfg.prefill_chunk % cfg.kv_block_size:
            raise ValueError(
                f'prefill_chunk ({cfg.prefill_chunk}) must be a multiple '
                f'of kv_block_size ({cfg.kv_block_size})')
        if cfg.auto_prefix_cache and not self._paged:
            raise ValueError(
                'auto_prefix_cache requires the block-paged KV cache '
                '(set kv_block_size > 0): the radix tree shares pool '
                'blocks by refcount')
        if cfg.host_kv_bytes < 0:
            raise ValueError(f'host_kv_bytes must be >= 0 '
                             f'(got {cfg.host_kv_bytes})')
        base_config = model_config
        if cfg.lora_rank:
            # Multi-LoRA: the model carries lora_max_adapters stacked
            # zero-delta adapters per target (the base model until one
            # is registered).
            if not isinstance(model_config, LlamaConfig):
                raise TypeError(
                    'multi-LoRA serving supports the llama family; got '
                    f'{type(model_config).__name__}')
            if cfg.lora_max_adapters < 1:
                raise ValueError('lora_max_adapters must be >= 1')
            model_config = dataclasses.replace(
                model_config, lora_rank=cfg.lora_rank,
                lora_alpha=cfg.lora_alpha,
                lora_num_adapters=cfg.lora_max_adapters)
            self.model_config = model_config
        buckets = tuple(b for b in cfg.prefill_buckets
                        if b <= cfg.max_cache_len)
        if not buckets or (buckets[-1] < cfg.max_cache_len
                           and not cfg.prefill_chunk):
            # Any prompt the cache can hold has a bucket; with chunked
            # prefill, prompts past the largest bucket chunk instead.
            buckets += (cfg.max_cache_len,)
        cfg.prefill_buckets = buckets
        if self._paged:
            bs_ = cfg.kv_block_size
            bad = [b for b in buckets if b % bs_]
            if bad:
                raise ValueError(
                    f'every prefill bucket must be a multiple of '
                    f'kv_block_size ({bs_}); got {bad}')
            max_blocks = cfg.max_cache_len // bs_
            n_blocks = cfg.kv_blocks
            if n_blocks is None:
                # Full provisioning (+1 dump block): admission never
                # defers, so dense and paged engines schedule alike.
                n_blocks = cfg.num_slots * max_blocks + 1
            if n_blocks < max_blocks + 1:
                raise ValueError(
                    f'kv_blocks ({n_blocks}) must be >= max_cache_len/'
                    f'kv_block_size + 1 ({max_blocks + 1}): one '
                    'full-length request must fit the pool')
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        # The config this rank's model and cache are built from: the
        # rank's share of the heads, MLP and experts under a mesh.
        self._local_config = (model_config if self._tp == 1 else
                              rank_config(model_config, self._tp))
        self.model = build_model(self._local_config,
                                 device=self.device).eval()
        self._tpc = TensorParallel(mesh) if mesh is not None else None
        self._full_shapes: Dict[str, Tuple[int, ...]] = {}
        # GPT-2's fused c_attn under a mesh: each weight's per-head sums
        # of q, k and v [3, H], taken where the full weight was seen
        # (rank 0 always): the shard check holds each rank's rows to them.
        self._qkv_head_sums: Dict[str, torch.Tensor] = {}
        if self._tpc is not None:
            # Every rank takes rank 0's generator state, then its slice of
            # each weight in the model's dtype, one tensor at a time:
            # rank 0's given weights are sent by rank 0 (only its host
            # holds the whole model), drawn ones are drawn by every rank
            # alike.  No card holds more than its slice.
            self._tpc.share_generator(generator)
            dtypes = {k: v.dtype for k, v in self.model.state_dict().items()}
            items = self._tpc.local_params(
                params, lambda: iter_params(base_config, generator), dtypes)
            params = {}
            for k, shape, v, full in items:
                self._full_shapes[k] = shape
                params[k] = v.to(self.device)
                if full is not None and is_fused_qkv(k):
                    self._qkv_head_sums[k] = sanitizers.qkv_head_sums(
                        full.to(v.dtype), model_config.num_heads)
        elif params is None:
            # The base weights a plain engine draws from this generator.
            params = init_params(base_config, generator)
        if cfg.lora_rank and not any(is_lora_path(k) for k in params):
            # A base state_dict: grafted under freshly drawn zero-delta
            # adapters (drawn one tensor at a time, the rest discarded;
            # under a mesh every rank draws them alike and keeps its
            # slices).
            for k, v in iter_params(model_config, generator):
                if not is_lora_path(k):
                    continue
                if self._tpc is not None:
                    self._full_shapes[k] = tuple(v.shape)
                    v = shard_tensor(k, v, self._tp, self._tpc.coord)
                params[k] = v
        self.model.load_state_dict(params)
        # Multi-LoRA: registered name -> stack slot, the name's
        # registration generation (C3), and the parameters as a nested
        # tree under their flax names, the shape register_adapter walks
        # (the JAX engine walks its param tree; only the stacked adapter
        # leaves are targets).  The Parameter objects are written in
        # place and never swapped: dispatches hold them.
        self._adapter_names: Dict[str, int] = {}  # guarded-by: _lock
        self._adapter_gen: Dict[str, int] = {}  # guarded-by: _lock
        self._param_tree = nest({flax_path(name): prm for name, prm
                                 in self.model.named_parameters()})
        b = cfg.num_slots
        self._pool: Optional[BlockPool] = None
        if self._paged:
            self._pool = BlockPool(n_blocks, bs_, max_blocks, b)
            self.paged_stats = {'deferred': 0, 'prefix_block_hits': 0}  # guarded-by: _lock
            self.cache = init_paged_cache(self._local_config, n_blocks, bs_,
                                          cfg.cache_dtype, self.device)
        else:
            self.cache = init_cache(self._local_config, b, cfg.max_cache_len,
                                    cfg.cache_dtype, self.device)
        # Automatic radix prefix caching over the pool (None when off);
        # radix_stats always exists so stats() has one shape.
        self._radix = (RadixTree(cfg.kv_block_size)
                       if self._paged and cfg.auto_prefix_cache else None)
        self.radix_stats = {'hits': 0, 'tokens_reused': 0, 'lookups': 0,  # guarded-by: _lock
                            'inserts': 0, 'evictions': 0}
        # Host-RAM KV tier, fed by radix eviction.  It survives
        # _reset_cache: its copies are keyed by token content, not pool
        # state.
        self._host_tier = (HostKVTier(
            cfg.host_kv_bytes, cfg.kv_block_size,
            recency_window=max(64, 4 * self._pool._num_blocks))
                           if self._radix is not None
                           and cfg.host_kv_bytes > 0 else None)
        # Pinned host rows of restores still being copied to the card,
        # each with the event after its copy: kept alive until it passed.
        self._h2d_inflight: List[Tuple[torch.Tensor, Any]] = []  # guarded-by: _lock
        # Drain-time hot-set handoff counters, under kv.host_tier.
        self.handoff_stats = {'exported': 0, 'adopted': 0}  # guarded-by: _lock
        # Requests dequeued but not admissible yet (paged admission):
        # admitted first once blocks free up.
        self._deferred: List[Request] = []  # guarded-by: _lock
        # Failure/recovery counters (stats()['faults'], /stats):
        #   internal_errors      requests failed with error_class='internal'
        #   deadline_evictions   requests evicted past Request.deadline_s
        #   loop_restarts        serving-loop supervisor restarts
        #   quarantined_batches  unattributed decode failures that failed
        #                        the whole active batch (+ cache zeroed)
        #   nonfinite_lanes      lanes killed by the non-finite logit guard
        self.fault_stats = {'internal_errors': 0, 'deadline_evictions': 0,  # guarded-by: _lock
                            'loop_restarts': 0, 'quarantined_batches': 0,
                            'nonfinite_lanes': 0}
        # An armed faults.FaultPlan (tests only); None = one attribute
        # check per site.
        self._faults = None
        # Requests failed inside the dispatch path (non-finite guard),
        # delivered by _harvest like every other finish.
        self._pending_failures: List[Tuple[Request, RequestResult]] = []  # guarded-by: _lock
        # Speculation: verify dispatches, drafts offered, drafts
        # accepted.  The acceptance EMA gates verify against windowed
        # decode (_spec_step): it starts optimistic, and while the
        # expected bonus is under half a token per active slot the
        # engine decodes windowed, re-probing every 50th step.
        self.spec_stats = {'dispatches': 0, 'drafted': 0, 'accepted': 0}  # guarded-by: _lock
        self._accept_ema = 0.5  # guarded-by: _lock
        self._spec_skips = 0  # guarded-by: _lock
        # Registered prefixes, LRU-ordered: (adapter, tokens) -> dense,
        # per-layer (k, v) rows [Hkv, n, D] in cache dtype (fp8 as its
        # uint8 view); paged,
        # {'blocks': pool block ids (one ref each), 'len': n}.  The
        # adapter is None for the base model.
        self._prefixes: collections.OrderedDict = collections.OrderedDict()  # guarded-by: _lock
        self.prefix_stats = {'hits': 0, 'tokens_reused': 0}  # guarded-by: _lock
        # Chunked prefill: slot -> _ChunkJob for prompts whose KV rows are
        # written one prefill_chunk per serving gap (_chunk_round).  A
        # chunking slot is reserved (not free) but has no _Slot yet.
        self._chunking: Dict[int, _ChunkJob] = {}  # guarded-by: _lock
        self.chunk_stats = {'rounds': 0, 'chunks': 0, 'requests': 0}  # guarded-by: _lock
        # Admission order: strict FIFO, or with cfg.qos priority classes
        # and per-tenant WFQ (infer/qos.py).  The scheduler has its own
        # lock (stats() reads it from other threads).
        self._sched = (
            qos_mod.WfqScheduler(
                weights=cfg.qos_tenant_weights,
                cost_fn=lambda r: len(r.tokens) + self._max_new(r))
            if cfg.qos else FifoScheduler())
        # preemptions: batch chunk jobs parked for interactive work;
        # sheds: typed deadline rejections at dequeue.
        self.qos_stats = {'preemptions': 0, 'sheds': 0}  # guarded-by: _lock
        self._tenant_qos: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        # Observed service rate (tokens/s a request, EWMA), fed by every
        # clean finish in _finish_slot; the projection shed reads it.
        self._svc_estimator = qos_mod.ServiceEstimator()
        self._slots: List[Optional[_Slot]] = [None] * b  # guarded-by: _lock
        # Request ids cancelled while still queued: dropped at dequeue.
        # id -> mark time; marks expire (_CANCEL_MARK_TTL_S) so a cancel
        # that raced a finish cannot poison a later request reusing the
        # id.
        self._cancelled: Dict[str, float] = {}  # guarded-by: _lock
        # Backlog snapshot for the window policy (_select_window): the
        # serving loop sets it before each step; 0 outside the loop, so
        # offline generate() runs full windows.
        self._arrivals_hint = 0  # guarded-by: _lock
        # Decode lookahead: a dispatched, unconsumed window (host-copy
        # handle, device-side (tokens, lengths) chain, slot snapshot,
        # prefill epoch).  The epoch bumps on every prefill so a chain
        # is never extended across a slot recycle.
        self._ahead = None  # guarded-by: _lock
        self._serving = False
        self._prefill_epoch = 0  # guarded-by: _lock
        # Consecutive dequeue passes that yielded only cancelled requests:
        # right-shifts the arrivals hint (a queue of tombstones must not
        # force short windows).
        self._cancel_only_streak = 0
        # Host mirrors of per-slot decode state, sent to the device per
        # window as small tensors.
        self._lengths = np.zeros((b,), np.int64)  # guarded-by: _lock
        self._last_tokens = np.zeros((b,), np.int64)  # guarded-by: _lock
        self._temps = np.zeros((b,), np.float32)  # guarded-by: _lock
        # Adapter stack slot of each slot's request (-1: the base model),
        # set at admission and reset at finish and cancel.
        self._slot_adapters = np.full((b,), -1, np.int64)  # guarded-by: _lock
        self._lock = sanitizers.instrument_lock(threading.Lock(),
                                                'infer.engine._lock')

    def _reset_cache(self) -> None:  # locked: _lock
        """Zero the KV cache in place -- the quarantine path after an
        unattributed dispatch failure.  In place because the tensors are
        the ones the next dispatch writes; rows a later prefill has not
        written are never read before they are written, so zero is as
        good as any value.  Paged: the allocator resets to empty, the
        registered prefixes (their blocks are pool blocks) are dropped
        and so is the radix tree (its generation bump invalidates any
        match taken before); the host tier stays, and so do dense
        prefixes (rows of their own).  Caller holds no live slots."""
        self._zero_cache()
        if self._paged:
            self._pool.reset()
            self._prefixes.clear()
            if self._radix is not None:
                self._radix.clear()

    @dispatch()
    @torch.inference_mode()
    def _zero_cache(self) -> None:
        for k, v in self.cache:
            as_bytes(k).zero_()
            as_bytes(v).zero_()

    # ------------------------------------------------- tensor parallelism

    def serve_worker(self) -> None:
        """A rank other than 0 of a tensor-parallel engine: run rank 0's
        dispatches on this rank's shard until rank 0 calls ``shutdown``."""
        if self._tpc is None or self._tpc.rank == 0:
            raise RuntimeError('serve_worker runs on a rank > 0 of a '
                               'tensor-parallel engine')
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        self._tpc.serve_worker(self)

    def shutdown(self) -> None:
        """Rank 0 of a tensor-parallel engine: release the other ranks from
        ``serve_worker`` (a no-op without a mesh or when done already)."""
        if self._tpc is not None and self._tpc.rank == 0:
            self._tpc.stop()

    @dispatch()
    @torch.inference_mode()
    def _block_rows(self, blk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool block `blk`'s rows of every layer, (k, v) [L, Hkv, bs, D]
        in the cache's bytes, every rank's kv heads gathered in head order:
        the topology-neutral host form of a spill and of an export."""
        out = []
        for part in (0, 1):
            rows = torch.stack([as_bytes(kv[part])[blk] for kv in self.cache])
            if self._tp > 1:
                rows = all_gather_cat(rows, self._tpc.group, 1)
            out.append(rows)
        return out[0], out[1]

    @dispatch()
    def _shard_report(self) -> List[Dict[str, Any]]:
        """Every rank's shard-layout report (``analysis.sanitizers``), in
        rank order."""
        from skypilot_tpu_torch.analysis.sanitizers import local_shard_report
        return self._tpc.gather_objects(local_shard_report(self))

    # ------------------------------------------------------ fault plans

    def arm_faults(self, plan) -> None:
        """Arm a faults.FaultPlan: the engine consults it at named sites
        (see faults.SITES).  Tests only."""
        self._faults = plan

    def disarm_faults(self) -> None:
        self._faults = None

    def _fault(self, site: str):
        """One consult of a named injection site; unarmed it is a single
        attribute check."""
        if self._faults is None:
            return None
        return self._faults.check(site)

    def _fault_raise(self, site: str) -> None:
        """Consult and raise InjectedFault if the plan fires.  Called on
        the host before a dispatch, so the cache stays intact."""
        sp = self._fault(site)
        if sp is not None:
            raise InjectedFault(
                f'{sp.message} [site={site}]', site,
                slots=None if sp.slot is None else [sp.slot])

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
        return chosen, torch.cat([
            chosen.to(torch.int32).view(torch.float32)[:, None],
            self._pack_scores(logits, logz, lp)], dim=-1)

    def _pack_scores(self, logits: torch.Tensor, logz: torch.Tensor,
                     lp: torch.Tensor) -> torch.Tensor:
        """The packed scores of logits [..., V] (logz their logsumexp,
        lp the chosen tokens' logprobs [...]): one f32 block
        [..., 1 + 2k] of the logprob, the top-k ids bitcast to f32 and
        their logprobs -- the tail of ``_pack_head``'s block and all of
        ``_pack_prompt``'s, as ``_unpack_head`` reads them."""
        top_vals, top_ids = torch.topk(logits, self.cfg.logprob_topk, dim=-1)
        return torch.cat([lp[..., None],
                          top_ids.to(torch.int32).view(torch.float32),
                          top_vals - logz[..., None]], dim=-1)

    def _pack_prompt(self, logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
        """Prompt scoring from a prefill's logits [P, S, V] over its
        tokens [P, S]: position t-1 predicts token t.  Returns one f32
        block [P, S-1, 1+2k] packing the token's logprob, the top-k ids
        (bitcast) and their logprobs.  A token id outside [-V, V) scores
        NaN, as the JAX engine's gather fills it (the model itself reads
        such an id clamped)."""
        head = logits[:, :-1]
        vocab = head.shape[-1]
        logz = torch.logsumexp(head, dim=-1)
        ids = tokens[:, 1:]
        ids = torch.where(ids < 0, ids + vocab, ids)
        valid = (ids >= 0) & (ids < vocab)
        sel = head.gather(-1, ids.clamp(0, vocab - 1)[..., None])[..., 0]
        lp = torch.where(valid, sel - logz, torch.full_like(sel, math.nan))
        return self._pack_scores(head, logz, lp)

    @dispatch()
    @torch.inference_mode()
    def _prefill_insert(self, tokens: torch.Tensor, true_lens: torch.Tensor,
                        slots: torch.Tensor, temps: torch.Tensor,
                        want_plp: bool = False,
                        adapter_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """P prompts forward over a fresh [P, Hkv, bucket, D] cache, first
        token sampled at true_lens-1, each prompt's KV rows copied into
        its slot.  tokens [P, bucket]; true_lens/slots/temps [P];
        adapter_ids [P] (multi-LoRA, else None).  Returns the packed head
        [P, 2+2k] and, with want_plp, the packed prompt scores
        [P, bucket-1, 1+2k] (else None)."""
        p, bucket = tokens.shape
        pcache = init_cache(self._local_config, p, bucket,
                            self.cfg.cache_dtype, self.device)
        positions = torch.arange(bucket, device=self.device).expand(p, bucket)
        logits, pcache = self.model(tokens, positions, pcache,
                                    adapter_ids=adapter_ids)
        last = logits[torch.arange(p, device=self.device), true_lens - 1]
        _, head = self._pack_head(last, temps)
        for (k, v), (pk, pv) in zip(self.cache, pcache):
            as_bytes(k)[slots, :, :bucket] = as_bytes(pk)
            as_bytes(v)[slots, :, :bucket] = as_bytes(pv)
        return head, (self._pack_prompt(logits, tokens) if want_plp
                      else None)

    def _akw(self, ids) -> Dict[str, torch.Tensor]:
        """A dispatch's adapter argument: the per-row adapter ids [P] on
        the device (-1: the base model), none when the engine serves no
        adapters."""
        if not self.cfg.lora_rank:
            return {}
        return {'adapter_ids': self._to_device(np.asarray(ids, np.int64))}

    def _adapter_id(self, adapter: Optional[str]) -> int:
        """The stack slot of a registered adapter; -1 for the base."""
        return -1 if adapter is None else self._adapter_names[adapter]

    def _agen(self, adapter: Optional[str]) -> int:
        """The registration generation of `adapter` (0 for the base)."""
        return self._adapter_gen.get(adapter, 0) if adapter else 0

    def _pkw(self, tables: Optional[torch.Tensor]) -> Dict[str, Any]:
        """The model's paged-attention arguments (none when dense)."""
        if tables is None:
            return {}
        return {'paged_tables': tables,
                'paged_block_size': self.cfg.kv_block_size}

    @dispatch()
    @torch.inference_mode()
    def _paged_prefill(self, tokens: torch.Tensor, starts: torch.Tensor,
                       true_pos: torch.Tensor,
                       tables: Optional[torch.Tensor],
                       temps: torch.Tensor, want_plp: bool = False,
                       adapter_ids: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A prefill dispatch straight over the live cache: tokens [P, W]
        forward at positions starts + arange(W), through the per-lane
        tables [P, NB] into the block pool (None: the dense cache, lane
        i being slot i), the first token sampled at true_pos (the last
        real token's index within the window).  Serves the paged
        monolithic bucket prefill (starts 0), the radix suffix prefill
        over shared prefix blocks (starts = matched length, per lane)
        and chunk rounds in both layouts (full slot width: a chunking
        lane starts at its frontier, an active lane at its length --
        dead rows past its live ones, as windowed decode writes -- an
        idle lane at 0).  Paged, writes past a lane's allocated blocks
        land in the dump block, past every query position; dense, the
        caller guarantees start + W <= max_cache_len for every lane
        (config divisibility and _chunk_round's guard), so no write is
        clamped onto live rows.  Returns the packed head [P, 2+2k] and,
        with want_plp (monolithic lanes only), the packed prompt scores
        (else None)."""
        p, w = tokens.shape
        positions = starts[:, None] + torch.arange(w, device=self.device)
        logits, _ = self.model(tokens, positions, self.cache,
                               adapter_ids=adapter_ids, **self._pkw(tables))
        last = logits[torch.arange(p, device=self.device), true_pos]
        _, head = self._pack_head(last, temps)
        return head, (self._pack_prompt(logits, tokens) if want_plp
                      else None)

    @dispatch()
    @torch.inference_mode()
    def _prefix_prefill(self, tokens: torch.Tensor, start: int,
                        true_lens: torch.Tensor, rows, slots: torch.Tensor,
                        temps: torch.Tensor,
                        adapter_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Lane-batched suffix prefill over a registered prefix (dense):
        tokens [P, SB] are the suffixes; each lane's fresh
        [Hkv, start + SB, D] cache holds the prefix rows [0, start) --
        rows (k, v) [Hkv, >= start, D] per layer, shared by the lanes --
        the suffix forwards at positions start.., the first token is
        sampled at true_lens - 1 of the suffix, and rows
        [0, start + SB) go into each lane's slot.  Returns the packed
        head [P, 2+2k]."""
        p, sb = tokens.shape
        width = start + sb
        pcache = init_cache(self._local_config, p, width,
                            self.cfg.cache_dtype, self.device)
        for (pk, pv), (rk, rv) in zip(pcache, rows):
            as_bytes(pk)[:, :, :start] = rk[:, :start]
            as_bytes(pv)[:, :, :start] = rv[:, :start]
        positions = start + torch.arange(sb, device=self.device).expand(p, sb)
        logits, pcache = self.model(tokens, positions, pcache,
                                    adapter_ids=adapter_ids)
        last = logits[torch.arange(p, device=self.device), true_lens - 1]
        _, head = self._pack_head(last, temps)
        for (k, v), (pk, pv) in zip(self.cache, pcache):
            as_bytes(k)[slots, :, :width] = as_bytes(pk)
            as_bytes(v)[slots, :, :width] = as_bytes(pv)
        return head

    @dispatch()
    @torch.inference_mode()
    def _paged_restore_blocks(self, dsts: torch.Tensor, krows: torch.Tensor,
                              vrows: torch.Tensor) -> None:
        """Scatter host-restored rows into pool blocks dsts [G]:
        krows/vrows [L, G, Hkv, bs, D], one tier entry per dst (the
        host-tier restore and hot-set adoption path; fp8 rows as their
        uint8 view).  Queued ahead of the suffix prefill that reads
        them.  Rows of every kv head (the host form) are cut to this
        rank's heads."""
        hkv = self.cache[0][0].shape[1]
        if krows.shape[2] != hkv:
            heads = slice(self._tpc.coord * hkv, (self._tpc.coord + 1) * hkv)
            krows, vrows = krows[:, :, heads], vrows[:, :, heads]
        for li, (kp, vp) in enumerate(self.cache):
            as_bytes(kp)[dsts] = krows[li]
            as_bytes(vp)[dsts] = vrows[li]

    @dispatch()
    @torch.inference_mode()
    def _paged_copy_blocks(self, src: int, dsts: torch.Tensor) -> None:
        """Copy pool block `src` into every block of dsts [G], per layer:
        the one device op a registered-prefix hit pays (each lane's
        partial tail block made private; the full blocks are shared by
        table reference)."""
        for kp, vp in self.cache:
            for pool in (as_bytes(kp), as_bytes(vp)):
                pool[dsts] = pool[src].clone().expand(
                    (dsts.shape[0],) + tuple(pool.shape[1:]))

    @dispatch(keep=True)
    @torch.inference_mode()
    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor,
                temps: torch.Tensor, steps: int,
                tables: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`steps` decode steps for every slot; tokens/lengths/temps [B];
        tables [B, NB] over the paged pool (None: the dense cache), built
        by the host to cover every write of the window.  Returns the
        packed window [steps, B, 2+2k] and the device-side (last tokens,
        lengths) a lookahead window continues from."""
        heads = []
        pkw = self._pkw(tables)
        for _ in range(steps):
            logits, _ = self.model(tokens[:, None], lengths[:, None],
                                   self.cache, adapter_ids=adapter_ids,
                                   **pkw)
            tokens, head = self._pack_head(logits[:, 0], temps)
            heads.append(head)
            lengths = lengths + 1
        return torch.stack(heads), tokens, lengths

    @dispatch()
    @torch.inference_mode()
    def _spec_verify(self, tokens: torch.Tensor, lengths: torch.Tensor,
                     temps: torch.Tensor,
                     tables: Optional[torch.Tensor] = None,
                     adapter_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """One speculative verify: tokens [B, 1+D] (column 0 each slot's
        last token, then its drafts) forward at lengths + arange(1+D)
        over the cache, every row written (rows past the accepted prefix
        are dead: the next dispatch writes from the accepted length
        before any query reaches them).  Returns the packed head
        [B, 1+D, 2+2k] of the model's next token after each position
        (greedy, or sampled where temps > 0)."""
        b, k = tokens.shape
        positions = lengths[:, None] + torch.arange(k, device=self.device)
        logits, _ = self.model(tokens, positions, self.cache,
                               adapter_ids=adapter_ids, **self._pkw(tables))
        _, head = self._pack_head(logits.reshape(b * k, -1),
                                  temps.repeat_interleave(k))
        return head.reshape(b, k, -1)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device.  To a card the
        copy is queued on the stream from pinned memory: a blocking copy
        would wait for every window already queued, which decode
        lookahead must not do."""
        t = torch.from_numpy(np.array(a))     # the mirror may change
        host = t
        if self.device.type == 'cuda':
            t = t.pin_memory().to(self.device, non_blocking=True)
        if self._tpc is not None:
            t._tp_host = host.numpy()     # what a dispatch broadcasts  # jit-ok: host is a CPU tensor (torch.from_numpy of the mirror)
        return t

    def _to_host(self, t: torch.Tensor):
        """Queue the device->host copy of t now; returns the handle
        ``_host_array`` waits on.  From a card the copy goes into pinned
        memory behind an event, so work queued after it (the lookahead
        window) does not delay the host's read."""
        if self.device.type != 'cuda':
            return t, None
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return buf, ev

    @staticmethod
    def _host_array(handle) -> np.ndarray:
        buf, ev = handle
        if ev is not None:
            ev.synchronize()  # jit-ok: the readback's one wait, on the event behind its pinned copy
        return buf.numpy()  # jit-ok: the pinned host buffer, waited on above

    def _rows_to_device(self, rows: torch.Tensor) -> torch.Tensor:
        """Host rows (pinned when the engine is on a card) to the device
        without blocking.  The pinned source stays referenced, with the
        event recorded after its copy, until that event has passed: the
        host allocator must not hand its memory out under the copy."""
        if self.device.type != 'cuda':
            return rows
        self._h2d_inflight = [(t, ev) for t, ev in self._h2d_inflight  # lock-ok: under _lock on rank 0 (_adopt_host_rows); a worker rank has one thread
                              if not ev.query()]
        out = rows.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._h2d_inflight.append((rows, ev))
        if self._tpc is not None:
            out._tp_host = rows           # what a dispatch broadcasts
        return out

    # ---------------------------------------------------- paged allocator
    #
    # The allocator lives in infer/block_pool.py (BlockPool); the engine
    # keeps thin delegates and read-only views of the pool's arrays under
    # the JAX engine's names (the conservation checks read them).  All
    # run under _lock.

    @property
    def _block_refs(self) -> np.ndarray:
        return self._pool._block_refs

    @property
    def _tables_np(self) -> np.ndarray:
        return self._pool._tables_np

    @property
    def _slot_nblocks(self) -> np.ndarray:
        return self._pool._slot_nblocks

    @property
    def _free_blocks(self) -> List[int]:
        return self._pool._free_blocks

    @property
    def _num_blocks(self) -> int:
        return self._pool._num_blocks if self._pool is not None else 0

    @property
    def _max_blocks(self) -> int:
        return self._pool._max_blocks if self._pool is not None else 1

    def _nb_bucket(self, needed: int) -> int:
        """Table width (in blocks) for a dispatch: the smallest power of
        two >= needed, capped at max_blocks (the JAX engine's width, so
        the rows gathered match its)."""
        nb = 1
        while nb < needed and nb < self._max_blocks:
            nb *= 2
        return min(nb, self._max_blocks)

    def _alloc_blocks(self, k: int) -> List[int]:  # locked: _lock
        return self._pool._alloc_blocks(k)

    def _deref_block(self, b: int) -> None:  # locked: _lock
        self._pool._deref_block(b)

    def _addref_block(self, b: int) -> None:  # locked: _lock
        self._pool._addref_block(b)

    def _ensure_blocks(self, slot: int, upto: int) -> None:  # locked: _lock
        self._pool._ensure_blocks(slot, upto)

    def _append_shared_blocks(self, slot: int, ids: Sequence[int]) -> None:  # locked: _lock
        self._pool._append_shared_blocks(slot, ids)

    def _free_slot_blocks(self, slot: int) -> None:  # locked: _lock
        self._pool._free_slot_blocks(slot)

    def _evict_radix(self, need: int) -> int:  # locked: _lock
        """Evict unpinned radix LEAVES whose only reference is the tree's
        own (so the deref frees a block), LRU-first, until `need` blocks
        are freed or nothing evictable remains.  With the host tier, each
        victim's rows are spilled first (_spill_blocks): the block id is
        still freed here, only the rows survive."""
        on_evict = (self._spill_blocks if self._host_tier is not None
                    else None)
        freed = self._radix.evict(need, self._block_refs,
                                  self._deref_block, on_evict=on_evict)
        self.radix_stats['evictions'] += freed
        return freed

    def _spill_blocks(self, adapter: Optional[str], node) -> None:  # locked: _lock
        """Radix-eviction spill hook: queue the copy of the victim
        block's rows into the host tier BEFORE the deref recycles the
        block id (the rows are views of the pool; the copy is queued on
        this stream ahead of any later write into the block).
        Dead-cold victims (outside the tier's recency window) skip the
        copy."""
        tier = self._host_tier
        if (self._radix.clock - node.last_used) > tier.recency_window:
            return
        blk = int(node.block)
        key = (adapter, RadixTree.path_tokens(node))
        if self._tpc is not None:
            k_rows, v_rows = self._block_rows(blk)
            tier.spill(key, list(k_rows), list(v_rows))
            return
        tier.spill(key, [as_bytes(kp)[blk] for kp, _ in self.cache],
                   [as_bytes(vp)[blk] for _, vp in self.cache])

    def _lane_tables(self, slot_rows: Sequence[int],
                     nb: int) -> torch.Tensor:
        """Device table array [len(slot_rows), nb] for a dispatch: the
        named slots' table rows truncated to `nb` entries (entries past a
        slot's allocation are 0, the dump block), sent without
        blocking."""
        rows = self._tables_np[np.asarray(slot_rows, np.int64), :nb]
        return self._to_device(rows.astype(np.int64))

    def _decode_tables(self, horizon: int) -> torch.Tensor:
        """Ensure every active slot's blocks for `horizon` more rows
        (capped at its worst-case demand -- writes past the cap go to the
        dump block) and build the dispatch table, wide enough to cover
        every lane's frontier + horizon: a position past the table's
        width would clamp into a live block."""
        for i, s in enumerate(self._slots):
            if s is not None:
                self._ensure_blocks(i, min(
                    int(self._lengths[i]) + horizon,
                    self._slot_cap_rows(len(s.request.tokens), s.max_new)))
        nb = self._nb_bucket(-(-(int(self._lengths.max()) + horizon)
                               // self.cfg.kv_block_size))
        return self._lane_tables(range(self.cfg.num_slots), nb)

    # ------------------------------------------------------ host KV tier

    def _restore_from_tier(self, req: Request, blocks: List[int],  # locked: _lock
                           n: int) -> List[int]:
        """Extend a radix match with blocks restored from the host tier:
        probe successive block-aligned prefixes past the device match,
        pop the hits, scatter their rows into freshly allocated pool
        blocks and index them in the tree -- the caller then treats the
        extended match like any other radix hit.

        Admission safety: the restored blocks join the requesting slot's
        table in place of private blocks its admitted worst-case demand
        already reserved; headroom backing other slots is untouched."""
        tier = self._host_tier
        bs_ = self.cfg.kv_block_size
        limit = (n - 1) // bs_       # >= 1 suffix token must forward
        keys: List[Any] = []
        while len(blocks) + len(keys) < limit:
            j = len(blocks) + len(keys)
            key = (req.adapter,
                   tuple(int(t) for t in req.tokens[:(j + 1) * bs_]))
            if not tier.contains(key):
                break
            keys.append(key)
        # Restore only when a suffix bucket still fits beside the
        # extended match: otherwise the request falls back to a full
        # prefill and the fresh blocks would be stranded in the tree.
        while keys:
            start = (len(blocks) + len(keys)) * bs_
            if (self._suffix_bucket(start, n - start) is not None
                    and len(keys) <= len(self._free_blocks)):
                break
            keys.pop()
        if not keys:
            return blocks
        rows = [tier.take(k) for k in keys]
        end = (len(blocks) + len(keys)) * bs_
        ids = self._adopt_host_rows(req.adapter, req.tokens[:end],
                                    blocks, rows)
        tier.stats['restores'] += len(ids)
        return list(blocks) + ids

    def _adopt_host_rows(self, adapter: Optional[str],  # locked: _lock
                         tokens: Sequence[int],
                         base_blocks: Sequence[int], rows) -> List[int]:
        """Allocate pool blocks for host rows (tier restore or hot-set
        adoption), scatter them in with one queued dispatch and index
        them in the radix tree as the continuation of ``base_blocks``.
        ``rows``: (k, v) host tensor pairs, each [L, Hkv, bs, D] in cache
        dtype (fp8 as its uint8 view)."""
        ids = self._alloc_blocks(len(rows))  # owns-blocks: radix
        try:
            pin = self.device.type == 'cuda'
            stacked = []
            for part in (0, 1):
                src = [r[part] for r in rows]
                buf = torch.empty((src[0].shape[0], len(src))
                                  + tuple(src[0].shape[1:]),
                                  dtype=src[0].dtype, pin_memory=pin)
                torch.stack(src, dim=1, out=buf)
                stacked.append(self._rows_to_device(buf))
            self._paged_restore_blocks(
                self._to_device(np.asarray(ids, np.int64)), *stacked)
        except BaseException:
            for b in ids:
                self._deref_block(b)
            raise
        self.radix_stats['inserts'] += self._radix.insert(
            adapter, tokens, list(base_blocks) + ids,
            addref=self._addref_block, deref=self._deref_block, own=True)
        return ids

    # -------------------------------------------------------- admission

    def _slot_cap_rows(self, n: int, max_new: int) -> int:
        """Worst-case filled rows of a request: prompt + generated (the
        prefill token is generated token #1, so the last decode write
        lands at row n + max_new - 2), capped at the cache."""
        return min(n + max_new - 1, self.cfg.max_cache_len)

    def _blocks_demand(self, n: int, max_new: int) -> int:
        return -(-self._slot_cap_rows(n, max_new) // self.cfg.kv_block_size)

    def _blocks_outstanding(self) -> int:
        """Blocks running slots may still allocate (worst case): their
        total demand minus what they already hold.  Shared prefix blocks
        count as held, so sharing raises admission headroom."""
        out = 0
        for i, s in enumerate(self._slots):
            if s is not None:
                out += max(0, self._blocks_demand(
                    len(s.request.tokens), s.max_new)
                    - int(self._slot_nblocks[i]))
        for slot, job in self._chunking.items():
            out += max(0, self._blocks_demand(job.n, job.max_new)
                       - int(self._slot_nblocks[slot]))
        return out

    def _can_admit_blocks(self, demand: int, extra: int = 0) -> bool:
        """Admission rule: start a request only when free blocks cover its
        worst-case demand beyond everything running slots (and `extra`,
        the demand of requests admitted in the same gap) may still
        claim, so _alloc_blocks never fails mid-flight.  Unreferenced
        radix leaves are reclaimable capacity, evicted before the
        request is deferred."""
        if not self._paged:
            return True
        if self._fault('block_alloc') is not None:
            # Injected pool pressure: the normal defer path.
            return False
        short = (demand + self._blocks_outstanding() + extra
                 - len(self._free_blocks))
        if short > 0 and self._radix is not None:
            self._evict_radix(short)
        return (len(self._free_blocks) - self._blocks_outstanding()
                - extra >= demand)

    # ------------------------------------------------------- surfaces

    @property
    def serving(self) -> bool:
        """True while the serving loop is alive (generate_stream's
        supervisor holds it); False before it starts, after a clean stop
        and after the supervisor gave up on a crash loop."""
        return self._serving

    @property
    def adapters(self) -> Dict[str, int]:
        """Registered LoRA adapters: name -> stack slot."""
        return dict(self._adapter_names)

    def register_adapter(self, name: str, adapter_tree) -> int:
        """Load a trained LoRA adapter -- the nested ``*_lora`` tree of
        ``train.lora`` (``load_adapter_npz``; the JAX package's artifact
        is the same) -- into a stack slot; later requests naming it
        decode with its delta.  Re-registering a name overwrites its
        slot.  Returns the slot index.

        Every leaf is checked before any is written, then the slot is
        written in place (``copy_`` into the stacked parameters the
        dispatches hold) under the engine lock, on the engine's card and
        its current stream: a window already queued reads the old
        values, a later one the new, none half of each.

        Every cached row computed under the name's old weights is
        dropped (ROADMAP.md C3): its registered prefixes, its radix nodes
        (the tree's references; blocks a live slot shares stay until it
        finishes) and its host-tier entries; slots admitted under the old
        weights do not insert their blocks into the tree when they
        finish.  The JAX engine drops only the registered prefixes.

        Over a mesh rank 0 checks the tree against the full (unsliced)
        stacked shapes, with the same errors, then one dispatch hands
        each rank its slices (``tp.PerRank``): a column-parallel
        projection's ``lora_b`` columns, a row-parallel one's ``lora_a``
        rows (``parallel.mesh.shard_tensor``)."""
        if not self.cfg.lora_rank:
            raise ValueError(
                'engine built without lora_rank; pass '
                'InferConfig(lora_rank=...) / --lora-rank to serve '
                'adapters')
        if isinstance(adapter_tree, Mapping) and \
                set(adapter_tree) == {'params'}:
            adapter_tree = adapter_tree['params']   # tolerate the wrapper
        # (parameter name, leaf), checked against the full (unsliced)
        # stacked shapes.
        writes: List[Tuple[str, np.ndarray]] = []

        def walk(tree, sub, path=''):
            for k, v in sub.items():
                target = tree.get(k) if isinstance(tree, Mapping) else None
                if target is None or (isinstance(v, Mapping) !=
                                      isinstance(target, Mapping)) or (
                        not isinstance(v, Mapping) and
                        not is_lora_path(path + k)):
                    raise KeyError(
                        f'adapter param {path}{k!r} has no target in the '
                        'model tree (wrong family/targets?)')
                if isinstance(v, Mapping):
                    walk(target, v, f'{path}{k}/')
                    continue
                arr = np.asarray(v, np.float32)
                pname = port_name(path + k)
                want = self._full_shapes.get(pname, tuple(target.shape))[1:]
                if arr.shape != want:
                    raise ValueError(
                        f'adapter leaf {path}{k} shape {arr.shape} '
                        f'does not match model {want} (rank mismatch?)')
                writes.append((pname, arr))

        walk(self._param_tree, adapter_tree)
        if self._tpc is None:
            with self._on_card():
                # Staged on the device before the lock: the host copies
                # wait for nothing the serving loop holds.
                leaves = [(name, torch.from_numpy(arr).to(self.device))
                          for name, arr in writes]
        else:
            # Each rank gets its slices (the stacked leaf's split, without
            # the stack dim), checked here first: a stale tree never
            # reaches a worker.
            leaves = PerRank(
                [(name, shard_tensor(name, torch.from_numpy(arr)[None],
                                     self._tp, coord)[0].numpy())
                 for name, arr in writes] for coord in self._tpc.coords)
        with self._lock:
            idx = self._adapter_names.get(name)
            if idx is None:
                if len(self._adapter_names) >= self.cfg.lora_max_adapters:
                    raise ValueError(
                        f'adapter slots full '
                        f'({self.cfg.lora_max_adapters}); re-register an '
                        'existing name to replace it')
                idx = len(self._adapter_names)
            self._write_adapter(idx, leaves)
            self._adapter_names[name] = idx
            self._adapter_gen[name] = self._adapter_gen.get(name, 0) + 1
            self._drop_adapter_rows(name)
        return idx

    def _on_card(self):
        """The engine's card as the current device (nothing on the CPU)."""
        return (torch.cuda.device(self._cuda_index)
                if self._cuda_index is not None
                else contextlib.nullcontext())

    @dispatch()
    def _write_adapter(self, idx: int, leaves) -> None:
        """Write an adapter's leaves [(parameter name, array)] (this rank's
        slices under a mesh) into stack slot `idx`, in place."""
        with self._on_card(), torch.no_grad():
            for name, arr in leaves:
                self.model.get_parameter(name)[idx].copy_(
                    torch.as_tensor(arr).to(self.device))

    def _drop_adapter_rows(self, name: str) -> None:
        """Forget every cached row computed under adapter `name` (caller
        holds the lock): registered prefixes, radix nodes, host-tier
        entries (C3)."""
        for key in [k for k in self._prefixes if k[0] == name]:
            entry = self._prefixes.pop(key)
            if self._paged:
                for b in entry['blocks']:
                    self._deref_block(b)
        if self._radix is not None:
            self._radix.drop_adapter(name, self._deref_block)
        if self._host_tier is not None:
            self._host_tier.drop_adapter(name)

    def _radix_section(self) -> Dict[str, Any]:
        rs = self.radix_stats
        lookups = rs['lookups']
        return {
            'enabled': self._radix is not None,
            'hits': rs['hits'],
            'lookups': lookups,
            'hit_rate': (rs['hits'] / lookups) if lookups else 0.0,
            'tokens_reused': rs['tokens_reused'],
            'inserts': rs['inserts'],
            'evictions': rs['evictions'],
            'nodes': self._radix.nodes if self._radix else 0,
            'blocks_held': self._radix.blocks_held if self._radix else 0,
            'pinned': self._radix.pinned if self._radix else 0,
        }

    def _host_tier_section(self) -> Dict[str, Any]:
        """kv.host_tier: one key set whether the tier exists or not.
        Lock-free counter reads, like the rest."""
        if self._host_tier is None:
            sec = {'enabled': False, 'budget_bytes': 0, 'bytes': 0,
                   'entries': 0, 'spills': 0, 'restores': 0,
                   'restore_hit_rate': 0.0, 'in_flight': 0,
                   'evictions': 0}
        else:
            sec = self._host_tier.stats_section()
        sec['exported'] = self.handoff_stats['exported']
        sec['adopted'] = self.handoff_stats['adopted']
        return sec

    def kv_health(self) -> Dict[str, Any]:
        """The /healthz KV summary, counters only: the JAX engine's key
        set (the LB's prober reads block_size, occupancy and
        radix.hit_rate)."""
        rs = self.radix_stats
        lookups = rs['lookups']
        radix = {'enabled': self._radix is not None, 'hits': rs['hits'],
                 'lookups': lookups,
                 'hit_rate': (rs['hits'] / lookups) if lookups else 0.0,
                 'nodes': self._radix.nodes if self._radix else 0,
                 'evictions': rs['evictions']}
        if not self._paged:
            return {'layout': 'dense', 'block_size': 0, 'blocks_total': 0,
                    'blocks_free': 0, 'occupancy': 0.0, 'tp': self._tp,
                    'radix': radix, 'host_tier': self._host_tier_section()}
        usable = self._num_blocks - 1
        free = len(self._free_blocks)
        return {
            'layout': 'paged',
            'block_size': self.cfg.kv_block_size,
            'blocks_total': usable,
            'blocks_free': free,
            'occupancy': ((usable - free) / usable) if usable else 0.0,
            'tp': self._tp,
            'radix': radix,
            'host_tier': self._host_tier_section(),
        }

    def stats(self) -> Dict[str, Any]:
        """KV-cache accounting (served by /stats): the JAX engine's
        structured 'kv' section and its deprecated flat aliases."""
        mc = self.model_config
        row_bytes = (2 * mc.num_kv_heads * mc.head_dim_ *
                     self.cfg.cache_dtype.itemsize * mc.num_layers)
        prefix = {**self.prefix_stats, 'resident': len(self._prefixes)}
        common = {
            'faults': dict(self.fault_stats),
            'qos': {
                'enabled': bool(self.cfg.qos),
                'scheduler': self._sched.stats(),
                'preemptions': self.qos_stats['preemptions'],
                'sheds': self.qos_stats['sheds'],
                'service_rate_tokens_per_s': self._svc_estimator.rate(),
                'tenants': {t: dict(c)
                            for t, c in list(self._tenant_qos.items())},
            },
        }
        tp = self._tp
        if not self._paged:
            total = self.cfg.num_slots * self.cfg.max_cache_len * row_bytes
            kv = {
                'layout': 'dense',
                'tp': tp,
                'bytes': {'total': total, 'resident': total,
                          'per_chip_total': total // tp,
                          'per_chip_resident': total // tp},
                'prefix': prefix,
                'radix': self._radix_section(),
                'host_tier': self._host_tier_section(),
            }
            return {
                'kv': kv,
                'serving': bool(self._serving),
                # deprecated aliases of kv.*, zeros where dense has no
                # pool
                'kv_layout': 'dense',
                'block_size': 0,
                'blocks_total': 0,
                'blocks_free': 0,
                'blocks_allocated': 0,
                'blocks_shared': 0,
                'blocks_prefix': 0,
                'shared_refs_saved': 0,
                'kv_bytes_per_block': 0,
                'kv_bytes_total': total,
                'kv_bytes_resident': total,
                'admission_deferred': 0,
                'prefix_block_hits': 0,
                **common,
            }
        bs_ = self.cfg.kv_block_size
        block_bytes = bs_ * row_bytes
        usable = self._num_blocks - 1
        free = len(self._free_blocks)
        refs = self._block_refs
        shared = int((refs[1:] > 1).sum())
        saved = int((refs[1:][refs[1:] > 1] - 1).sum())
        # A snapshot: stats() runs lock-free beside the serving thread.
        prefix_blocks = sum(len(e['blocks'])
                            for e in list(self._prefixes.values()))
        prefix['block_hits'] = self.paged_stats['prefix_block_hits']
        prefix['blocks'] = prefix_blocks
        total = self._num_blocks * block_bytes
        resident = (usable - free) * block_bytes
        kv = {
            'layout': 'paged',
            'tp': tp,
            'blocks': {'size': bs_, 'total': usable, 'free': free,
                       'allocated': usable - free, 'shared': shared,
                       'shared_refs_saved': saved},
            'bytes': {'per_block': block_bytes, 'total': total,
                      'resident': resident, 'per_chip_total': total // tp,
                      'per_chip_resident': resident // tp},
            'admission': {'deferred': self.paged_stats['deferred']},
            'prefix': prefix,
            'radix': self._radix_section(),
            'host_tier': self._host_tier_section(),
        }
        return {
            'kv': kv,
            'serving': bool(self._serving),
            # deprecated aliases of kv.*
            'kv_layout': 'paged',
            'block_size': bs_,
            'blocks_total': usable,
            'blocks_free': free,
            'blocks_allocated': usable - free,
            'blocks_shared': shared,
            'blocks_prefix': prefix_blocks,
            'shared_refs_saved': saved,
            'kv_bytes_per_block': block_bytes,
            'kv_bytes_total': total,
            'kv_bytes_resident': resident,
            'admission_deferred': self.paged_stats['deferred'],
            'prefix_block_hits': self.paged_stats['prefix_block_hits'],
            **common,
        }

    # Per-tenant counter rows are bounded: unbounded distinct tenant ids
    # must not grow engine memory without limit.
    _MAX_TENANT_ROWS = 256

    def _tenant_row(self, tenant: Optional[str]) -> Dict[str, int]:  # locked: _lock
        t = tenant or DEFAULT_TENANT
        row = self._tenant_qos.get(t)
        if row is None:
            if len(self._tenant_qos) >= self._MAX_TENANT_ROWS:
                t = '_overflow'
            row = self._tenant_qos.setdefault(t, {'admitted': 0, 'shed': 0})
        return row

    def _wire_rows(self, rows: torch.Tensor) -> str:
        """Base64 of one block's rows [L, Hkv, bs, D] as raw
        little-endian bytes in cache dtype (the JAX engine's wire form;
        bf16 and fp8 go through a byte view, which numpy cannot
        hold)."""
        raw = rows.cpu().contiguous().view(torch.uint8).numpy().tobytes()
        return base64.b64encode(raw).decode('ascii')

    def export_hot_prefixes(self, max_prefixes: int = 8,
                            max_blocks: int = 64) -> Dict[str, Any]:
        """Serialize the hottest radix prefixes -- device tree first (still
        resident = hottest), then host-tier entries, most recent first --
        into the wire form adopt_prefixes() takes (GET /hot_prefixes; the
        LB hands it to the affinity survivor during drain).  Blocking
        device->host reads: the drain path, not the serving one."""
        payload: Dict[str, Any] = {
            'version': 1,
            'model': self.cfg.model,
            'block_size': self.cfg.kv_block_size,
            'cache_dtype': _dtype_name(self.cfg.cache_dtype),
            'num_layers': len(self.cache),
            'prefixes': [],
        }
        if self._radix is None:
            return payload
        bs_ = self.cfg.kv_block_size
        with self._lock:
            leaves = [(ad, nd) for ad, nd in self._radix.walk_adapters()
                      if not nd.children]
            leaves.sort(key=lambda x: -x[1].last_used)
            cands = [(ad, RadixTree.path_tokens(nd)) for ad, nd in leaves]
            if self._host_tier is not None:
                cands.extend(self._host_tier.keys_recent_first())
            # Drop candidates subsumed by an earlier (hotter) one.
            chosen: List[Tuple[Optional[str], Tuple[int, ...]]] = []
            for ad, toks in cands:
                if len(chosen) >= max_prefixes:
                    break
                if any(a == ad and t[:len(toks)] == toks
                       for a, t in chosen):
                    continue
                chosen.append((ad, toks))
            budget = max_blocks
            for ad, toks in chosen:
                if budget <= 0:
                    break
                path = self._radix.peek(ad, toks, len(toks))
                recs = []
                for i in range(min(len(toks) // bs_, budget)):
                    if i < len(path):
                        k_rows, v_rows = self._block_rows(int(path[i]))
                    else:
                        entry = (self._host_tier.get(
                            (ad, toks[:(i + 1) * bs_]))
                            if self._host_tier is not None else None)
                        if entry is None:
                            break   # a hole: a prefix must be contiguous
                        k_rows, v_rows = entry
                    recs.append({'k': self._wire_rows(k_rows),
                                 'v': self._wire_rows(v_rows)})
                if not recs:
                    continue
                budget -= len(recs)
                payload['prefixes'].append({
                    'adapter': ad,
                    'tokens': [int(t) for t in toks[:len(recs) * bs_]],
                    'blocks': recs,
                })
            self.handoff_stats['exported'] += sum(
                len(p['blocks']) for p in payload['prefixes'])
        return payload

    def adopt_prefixes(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Adopt a drained peer's serialized hot prefixes into this
        engine's radix tree (the POST /adopt_blocks body), so a failover
        costs a suffix prefill instead of a full one.  The peer may be a
        JAX replica or a port replica: the form is the same.  A
        payload-level mismatch raises ValueError (a client error); a
        malformed prefix is skipped."""
        if self._radix is None:
            raise ValueError('replica has no radix cache '
                             '(kv_block_size/auto_prefix_cache off)')
        if int(payload.get('version', 0)) != 1:
            raise ValueError(
                f"unsupported hot-prefix payload version "
                f"{payload.get('version')!r}")
        bs_ = self.cfg.kv_block_size
        if int(payload.get('block_size', 0)) != bs_:
            raise ValueError(
                f"block_size mismatch: payload "
                f"{payload.get('block_size')!r}, engine {bs_}")
        name = _dtype_name(self.cfg.cache_dtype)
        if payload.get('cache_dtype') != name:
            raise ValueError(
                f"cache_dtype mismatch: payload "
                f"{payload.get('cache_dtype')!r}, engine {name}")
        if payload.get('model') != self.cfg.model:
            raise ValueError(
                f"model mismatch: payload {payload.get('model')!r}, "
                f"engine {self.cfg.model!r}")
        nl = len(self.cache)
        if int(payload.get('num_layers', 0)) != nl:
            raise ValueError(
                f"num_layers mismatch: payload "
                f"{payload.get('num_layers')!r}, engine {nl}")
        mc = self.model_config
        row_shape = (nl, mc.num_kv_heads, bs_, mc.head_dim_)

        # Rows move as the cache's bytes (fp8 as its uint8 view).
        row_dtype = as_bytes(self.cache[0][0]).dtype

        def decode(text) -> torch.Tensor:
            raw = bytearray(base64.b64decode(text))
            return torch.frombuffer(raw, dtype=row_dtype).reshape(row_shape)

        adopted_p = adopted_b = skipped = 0
        with self._lock, torch.inference_mode():
            for pref in payload.get('prefixes', []):
                tokens = [int(t) for t in pref.get('tokens', [])]
                adapter = pref.get('adapter')
                if (adapter is not None
                        and adapter not in self._adapter_names):
                    skipped += 1
                    continue
                try:
                    rows = [(decode(rec['k']), decode(rec['v']))
                            for rec in pref.get('blocks', [])]
                except (KeyError, TypeError, ValueError, RuntimeError):
                    skipped += 1
                    continue
                nruns = min(len(rows), len(tokens) // bs_)
                if nruns < 1:
                    skipped += 1
                    continue
                existing = self._radix.match(adapter, tokens, nruns * bs_)
                rows = rows[len(existing):nruns]
                if not rows:
                    continue            # already resident
                # Adopted blocks are cache, not load: never eat into the
                # headroom running slots' admission already reserved.
                headroom = (len(self._free_blocks)
                            - self._blocks_outstanding())
                rows = rows[:max(0, headroom)]
                if not rows:
                    skipped += 1
                    continue
                end = (len(existing) + len(rows)) * bs_
                ids = self._adopt_host_rows(adapter, tokens[:end],
                                            existing, rows)
                adopted_p += 1
                adopted_b += len(ids)
            self.handoff_stats['adopted'] += adopted_b
        return {'adopted_prefixes': adopted_p,
                'adopted_blocks': adopted_b, 'skipped': skipped}

    # ---------------------------------------------------- prefix cache

    def register_prefix(self, tokens: Sequence[int],
                        adapter: Optional[str] = None) -> int:
        """Compute a prefix's KV rows and keep them resident; later
        prompts that start with these tokens prefill only their suffix.
        Returns the prefix length (under the radix cache, the pinned
        block-aligned length).  LRU-evicts past cfg.max_prefixes.

        Dense: the capture forward reads only the weights, so it runs
        outside the engine lock and in-flight decode keeps going; only
        the registry insert takes the lock, and it captures again when
        the adapter was re-registered meanwhile.  Paged and radix: the
        capture writes the shared pool, under the lock.

        adapter: compute (and match) the rows under that LoRA adapter;
        prefix KV is adapter-dependent, so an entry only ever matches
        requests naming the same adapter (None: the base model)."""
        if not self.cfg.max_prefixes:
            raise ValueError('prefix caching disabled (max_prefixes=0)')
        n = len(tokens)
        if n < 1:
            raise ValueError('empty prefix')
        if adapter is not None and adapter not in self._adapter_names:
            raise ValueError(f'unknown adapter {adapter!r}')
        aid = self._adapter_id(adapter)
        bucket = self._bucket(n)     # raises when no bucket holds it
        arr = np.zeros((1, bucket), np.int64)
        arr[0, :n] = tokens
        if self._paged:
            if self._radix is not None:
                return self._register_prefix_radix(arr, n, bucket,
                                                   adapter, aid, tokens)
            return self._register_prefix_paged(arr, n, bucket, adapter,
                                               aid, tokens)
        key = (adapter, tuple(int(t) for t in tokens))
        while True:
            # A re-registration of the adapter during the capture (C3)
            # leaves rows of its old weights: capture again.
            gen = self._agen(adapter)
            rows = self._prefill_capture(self._to_device(arr), n,
                                         **self._akw([aid]))
            with self._lock:
                if self._agen(adapter) != gen:
                    continue
                self._prefixes[key] = rows
                self._prefixes.move_to_end(key)
                while len(self._prefixes) > self.cfg.max_prefixes:
                    self._prefixes.popitem(last=False)
            return n

    @dispatch(keep=True)
    @torch.inference_mode()
    def _prefill_capture(self, tokens: torch.Tensor, n: int,
                         adapter_ids: Optional[torch.Tensor] = None
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Forward a prefix [1, bucket] over a fresh cache and return its
        first n rows per layer, (k, v) [Hkv, n, D] (fp8 as its uint8
        view); the logits are discarded."""
        bucket = tokens.shape[1]
        pcache = init_cache(self._local_config, 1, bucket,
                            self.cfg.cache_dtype, self.device)
        positions = torch.arange(bucket, device=self.device)[None]
        self.model(tokens, positions, pcache, adapter_ids=adapter_ids)
        return [(as_bytes(k)[0, :, :n].clone(), as_bytes(v)[0, :, :n].clone())
                for k, v in pcache]

    def _register_prefix_paged(self, arr: np.ndarray, n: int, bucket: int,
                               adapter: Optional[str], aid: int,
                               tokens: Sequence[int]) -> int:
        """Paged capture: forward the prefix over the live pool into
        freshly allocated blocks; the entry holds one reference on each,
        and later hits share the full blocks by reference."""
        bs_ = self.cfg.kv_block_size
        need = -(-n // bs_)
        key = (adapter, tuple(int(t) for t in tokens))
        with self._lock:
            def headroom():
                return len(self._free_blocks) - self._blocks_outstanding()

            # LRU entries go first (their blocks free at once unless a
            # running slot still shares them).
            while headroom() < need and self._prefixes:
                _, old = self._prefixes.popitem(last=False)
                for b in old['blocks']:
                    self._deref_block(b)
            if headroom() < need:
                raise ValueError(
                    f'KV block pool too small to register a {n}-token '
                    f'prefix ({need} blocks; {len(self._free_blocks)} '
                    'free after honoring running slots) -- raise '
                    'kv_blocks')
            blocks = self._capture_into_blocks(arr, n, bucket, need, aid)  # owns-blocks: entry
            self._prefixes[key] = {'blocks': blocks, 'len': n}
            self._prefixes.move_to_end(key)
            while len(self._prefixes) > self.cfg.max_prefixes:
                _, old = self._prefixes.popitem(last=False)
                for b in old['blocks']:
                    self._deref_block(b)
        return n

    def _register_prefix_radix(self, arr: np.ndarray, n: int, bucket: int,
                               adapter: Optional[str], aid: int,
                               tokens: Sequence[int]) -> int:
        """register_prefix under auto_prefix_cache is pinning: the
        prefix's full blocks are prefilled into the pool (or found
        cached), inserted into the radix tree and marked pinned, so
        eviction passes them by.  Returns the pinned, block-aligned
        length (a sub-block tail is not cacheable)."""
        bs_ = self.cfg.kv_block_size
        m = (n // bs_) * bs_
        if m < bs_:
            raise ValueError(
                f'prefix shorter than one KV block ({bs_} tokens) '
                'cannot be pinned under auto_prefix_cache')
        need = m // bs_
        with self._lock:
            # Admission sheds unpinned radix leaves first, so pinning
            # displaces cache before it can fail.
            if not self._can_admit_blocks(need):
                raise ValueError(
                    f'KV block pool too small to pin a {n}-token '
                    f'prefix ({need} blocks; {len(self._free_blocks)} '
                    'free after honoring running slots) -- raise '
                    'kv_blocks')
            # Rows [m, n) scatter past the table's allocated entries,
            # into the dump block.
            blocks = self._capture_into_blocks(arr, n, bucket, need, aid)  # owns-blocks: radix
            # own=True: the tree takes over the allocation refs; runs
            # already cached are dereffed (freed).
            self.radix_stats['inserts'] += self._radix.insert(
                adapter, tokens, blocks, addref=self._addref_block,
                deref=self._deref_block, own=True, pinned=True)
        return m

    def _capture_into_blocks(self, arr: np.ndarray, n: int, bucket: int,
                             need: int, aid: int) -> List[int]:
        """Allocate `need` pool blocks and prefill the prefix arr
        [1, bucket] into them in one paged dispatch (under the lock), under
        adapter slot `aid` (-1: the base model).
        Returns the blocks, each holding the caller's reference; on a
        failure they are returned to the pool."""
        bs_ = self.cfg.kv_block_size
        blocks = self._alloc_blocks(need)  # owns-blocks: return
        table = np.zeros((1, bucket // bs_), np.int64)
        table[0, :need] = blocks
        try:
            self._paged_prefill(
                self._to_device(arr), self._to_device(np.zeros(1, np.int64)),
                self._to_device(np.full(1, n - 1, np.int64)),
                self._to_device(table),
                self._to_device(np.zeros(1, np.float32)),
                **self._akw([aid]))
        except BaseException:
            for b in blocks:
                self._deref_block(b)
            raise
        return blocks

    def _match_prefix(self, tokens: Sequence[int],
                      adapter: Optional[str] = None):
        """The longest registered prefix under the same adapter that the
        prompt starts with.  Returns (start, key), start being the rows
        reused -- len(prefix), or len(prefix) - 1 when the prompt IS the
        prefix (one token must forward for the first token's logits) --
        or None.  A prompt strictly inside a prefix takes a full
        prefill.  A hit is an LRU touch."""
        n = len(tokens)
        best = None
        for key in self._prefixes:
            p_adapter, p_tokens = key
            if p_adapter != adapter:
                continue
            lp = len(p_tokens)
            if n > lp:
                if tuple(tokens[:lp]) != p_tokens:
                    continue
                start = lp
            elif n == lp:
                start = lp - 1
                if start < 1 or tuple(tokens[:start]) != p_tokens[:start]:
                    continue
            else:
                continue
            if best is None or start > best[0]:
                best = (start, key)
        if best is None:
            return None
        start, key = best
        self._prefixes.move_to_end(key)
        return start, key

    def _force_admit_blocks(self, demand: int) -> bool:
        """Last resort when a request cannot be admitted and nothing is
        running (an offline batch with prefix entries holding the pool):
        LRU-evict prefix entries until it fits.  With no running slot
        every shared reference is an entry's, so eviction frees blocks.
        Returns admissibility."""
        while (not self._can_admit_blocks(demand) and self._prefixes and
               not any(s is not None for s in self._slots) and
               not self._chunking):
            _, entry = self._prefixes.popitem(last=False)
            for b in entry['blocks']:
                self._deref_block(b)
        return self._can_admit_blocks(demand)

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
            if s is None and i not in exclude and i not in self._chunking:
                return i
        return None

    def has_free_slot(self) -> bool:
        """Lock-free saturation peek for the server's admission control
        (a stale answer shifts one admission decision by one loop gap).
        A slot mid-chunked-prefill is taken, not free."""
        return any(s is None and i not in self._chunking
                   for i, s in enumerate(self._slots))

    def _max_new(self, req: Request) -> int:
        return self.cfg.max_new_tokens if req.max_new_tokens is None \
            else req.max_new_tokens

    def _validate_request(self,
                          req: Request) -> Tuple[int, Optional[int], int]:
        """Returns (prompt_len, bucket, max_new); raises ValueError on a
        bad request.  bucket is None when no bucket holds the prompt but
        chunked prefill can: such prompts are accepted up to
        max_cache_len - max_new and always chunk."""
        n = len(req.tokens)
        max_new = self._max_new(req)
        if n < 1:
            raise ValueError('empty prompt')
        if req.adapter is not None:
            if not self.cfg.lora_rank:
                raise ValueError(
                    f'request names adapter {req.adapter!r} but the '
                    'engine was built without lora_rank')
            if req.adapter not in self._adapter_names:
                raise ValueError(
                    f'unknown adapter {req.adapter!r}; registered: '
                    f'{sorted(self._adapter_names)}')
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
        try:
            bucket: Optional[int] = self._bucket(n)
        except ValueError:
            if not self.cfg.prefill_chunk:
                raise
            if req.want_prompt_logprobs:
                # Scoring needs every prompt position's logits in one
                # forward; chunks discard all but the final one's.
                raise ValueError(
                    f'prompt_logprobs requires the prompt ({n}) to fit '
                    f'the largest prefill bucket '
                    f'({self.cfg.prefill_buckets[-1]})') from None
            bucket = None
        if n + max_new > self.cfg.max_cache_len:
            raise ValueError(
                f'prompt ({n}) + max_new_tokens ({max_new}) exceeds cache '
                f'({self.cfg.max_cache_len})')
        if self._paged:
            demand = self._blocks_demand(n, max_new)
            usable = self._num_blocks - 1
            if demand > usable:
                raise ValueError(
                    f'request needs {demand} KV blocks but the pool '
                    f'only has {usable} (kv_blocks too small for this '
                    'prompt + max_new_tokens)')
        return n, bucket, max_new

    def _should_chunk(self, req: Request, n: int,
                      bucket: Optional[int]) -> bool:
        """Chunked-prefill policy.  A prompt no bucket holds must chunk.
        An in-bucket prompt chunks only in the serving loop, only when
        longer than one chunk, and only when someone would stall behind
        its monolithic prefill (an active slot or another chunk job):
        offline throughput and a prompt arriving to an idle engine want
        the one-dispatch prefill.  Scored prompts never chunk."""
        c = self.cfg.prefill_chunk
        if not c or req.want_prompt_logprobs:
            return False
        if bucket is None:
            return True
        return (self._serving and n > c and
                (any(s is not None for s in self._slots) or
                 bool(self._chunking)))

    def _suffix_bucket(self, start: int, suffix_len: int) -> Optional[int]:
        for b in self.cfg.prefill_buckets:
            if b >= suffix_len and start + b <= self.cfg.max_cache_len:
                return b
        return None

    def _activate(self, chunk, head: torch.Tensor,  # locked: _lock
                  prompt: Optional[torch.Tensor] = None,
                  agens: Optional[Sequence[int]] = None) -> None:
        """Fill the slots of one prefill dispatch's real lanes from its
        packed head (ONE transfer): chunk holds the lanes' (req, slot,
        submit_time, n, bucket, max_new) tuples.  prompt: the packed
        prompt scores of a want_plp dispatch, given to the lanes that
        asked for them.  agens: the lanes' adapter generations when their
        rows were written before this call (chunked prefill), else the
        current ones."""
        topk = self.cfg.logprob_topk
        first, first_lp, tids, tlps = _unpack_head(
            self._host_array(self._to_host(head)), topk)
        if prompt is not None:
            plp, ptids, ptlps = _unpack_scores(
                self._host_array(self._to_host(prompt)), topk)
        now = time.time()
        for i, (req, slot, submit_time, n, _, max_new) in enumerate(chunk):
            s = _Slot(req, length=n, submit_time=submit_time,
                      max_new=max_new,
                      agen=(agens[i] if agens is not None
                            else self._agen(req.adapter)))
            s.first_token_time = now
            s.generated.append(int(first[i]))
            s.lps.append(float(first_lp[i]))
            s.tops.append(_pairs(tids[i], tlps[i]))
            if req.want_prompt_logprobs:
                s.prompt_lps = [None] + [float(x) for x in plp[i, :n - 1]]
                s.prompt_tops = [None] + [_pairs(ptids[i, t], ptlps[i, t])
                                          for t in range(n - 1)]
            self._slots[slot] = s
            self._lengths[slot] = n
            self._last_tokens[slot] = s.generated[0]
            self._temps[slot] = req.temperature
            self._slot_adapters[slot] = self._adapter_id(req.adapter)

    def _start_radix_group_paged(self, group, sb: int, gen: int) -> None:  # locked: _lock
        """Start radix-matched requests sharing a suffix bucket: each
        slot's table gets its matched blocks by REFERENCE (matches are
        block-aligned, so no block is ever copied), then the suffixes
        forward in lane-batched paged prefills with per-lane starts.

        group: ((req, slot, submit_time, n, bucket, max_new), start,
        blocks) triples.  `gen` is the tree generation the matches were
        taken under; match to refcount bump runs under one lock hold, so
        a mismatch means a reset slid in between -- fail loudly rather
        than share dead blocks."""
        if gen != self._radix.generation:
            raise RuntimeError(
                'radix tree reset between match and start '
                f'({gen} != {self._radix.generation})')
        bs_ = self.cfg.kv_block_size
        lanes = self.cfg.prefill_lanes
        for ofs in range(0, len(group), lanes):
            chunk = group[ofs:ofs + lanes]
            p = len(chunk)
            tokens = np.zeros((lanes, sb), np.int64)
            starts = np.zeros((lanes,), np.int64)
            true_pos = np.zeros((lanes,), np.int64)
            slots = np.zeros((lanes,), np.int64)
            temps = np.zeros((lanes,), np.float32)
            aids = np.full((lanes,), -1, np.int64)
            for it, start, blocks in chunk:       # real lanes only
                req, slot, _, n, _, _ = it
                self._append_shared_blocks(slot, blocks)
                self._ensure_blocks(slot, n)
                self.paged_stats['prefix_block_hits'] += len(blocks)
                self.radix_stats['hits'] += 1
                self.radix_stats['tokens_reused'] += start
            for i in range(lanes):
                it, start, _ = chunk[min(i, p - 1)]
                req, slot, _, n, _, _ = it
                tokens[i, :n - start] = req.tokens[start:]
                starts[i] = start
                true_pos[i] = n - start - 1
                slots[i] = slot
                temps[i] = req.temperature
                aids[i] = self._adapter_id(req.adapter)
            # The table covers every lane's start + suffix bucket (pad
            # lanes duplicate a real lane, so the max is a real one).
            nb = self._nb_bucket(-(-(int(starts.max()) + sb) // bs_))
            head, _ = self._paged_prefill(
                self._to_device(tokens), self._to_device(starts),
                self._to_device(true_pos), self._lane_tables(slots, nb),
                self._to_device(temps), **self._akw(aids))
            self._activate([it for it, _, _ in chunk], head)

    def _start_radix(self, items) -> list:  # locked: _lock
        """The radix branch of _start_batch: match each prompt against
        the tree (capped at n-1 tokens: one token must forward),
        extend the match from the host tier, and start the matched
        requests by suffix bucket.  Returns the items left for a full
        prefill."""
        rgroups: Dict[int, list] = {}
        rest = []
        gen = self._radix.generation
        bs_ = self.cfg.kv_block_size
        for it in items:
            req, _, _, n, _, _ = it
            if req.want_prompt_logprobs:
                # Scoring needs every prompt position's logits, which
                # reused rows do not have: a full prefill, no lookup.
                rest.append(it)
                continue
            self.radix_stats['lookups'] += 1
            blocks = self._radix.match(req.adapter, req.tokens, n - 1)
            if self._host_tier is not None:
                blocks = self._restore_from_tier(req, blocks, n)
            if not blocks:
                rest.append(it)
                continue
            start = len(blocks) * bs_
            sb = self._suffix_bucket(start, n - start)
            if sb is None:       # no bucket fits beside the match
                rest.append(it)
                continue
            rgroups.setdefault(sb, []).append((it, start, blocks))
        for sb, rgroup in rgroups.items():
            self._start_radix_group_paged(rgroup, sb, gen)
        return rest

    def _start_prefixed_group(self, group, start: int, sb: int,  # locked: _lock
                              key) -> None:
        """Start requests that matched one registered prefix with the
        same start and suffix bucket, prefill_lanes to a dispatch, pad
        lanes duplicating the last real lane (slot included)."""
        if self._paged:
            self._start_prefixed_group_paged(group, start, sb, key)
            return
        rows = self._prefixes[key]
        aid = self._adapter_id(key[0])
        lanes = self.cfg.prefill_lanes
        for ofs in range(0, len(group), lanes):
            chunk = group[ofs:ofs + lanes]
            p = len(chunk)
            tokens = np.zeros((lanes, sb), np.int64)
            true_lens = np.ones((lanes,), np.int64)
            slots = np.zeros((lanes,), np.int64)
            temps = np.zeros((lanes,), np.float32)
            for i in range(lanes):
                req, slot, _, n, _, _ = chunk[min(i, p - 1)]
                tokens[i, :n - start] = req.tokens[start:]
                true_lens[i] = n - start
                slots[i] = slot
                temps[i] = req.temperature
            if any(slots[i] != slots[p - 1] for i in range(p, lanes)):
                raise RuntimeError(
                    f'pad lanes must duplicate the last real lane: '
                    f'{slots=} p={p}')
            head = self._prefix_prefill(
                self._to_device(tokens), start, self._to_device(true_lens),
                rows, self._to_device(slots), self._to_device(temps),
                **self._akw([aid] * lanes))
            self._activate(chunk, head)
            self.prefix_stats['hits'] += p
            self.prefix_stats['tokens_reused'] += start * p

    def _start_prefixed_group_paged(self, group, start: int, sb: int,  # locked: _lock
                                    key) -> None:
        """Paged prefix reuse: each matched slot's table takes the
        prefix's full blocks by reference, a partial tail block is made
        private with one block copy per dispatch, and the suffixes
        forward over the pool at start."""
        entry = self._prefixes[key]
        aid = self._adapter_id(key[0])
        bs_ = self.cfg.kv_block_size
        shared_n = start // bs_
        tail = start % bs_
        lanes = self.cfg.prefill_lanes
        for ofs in range(0, len(group), lanes):
            chunk = group[ofs:ofs + lanes]
            p = len(chunk)
            tokens = np.zeros((lanes, sb), np.int64)
            true_pos = np.zeros((lanes,), np.int64)
            slots = np.zeros((lanes,), np.int64)
            temps = np.zeros((lanes,), np.float32)
            dsts = []
            for req, slot, _, n, _, _ in chunk:   # real lanes only
                self._append_shared_blocks(
                    slot, [int(b) for b in entry['blocks'][:shared_n]])
                if tail:
                    # A private block for the tail: the allocation's
                    # reference is the table entry's.
                    [dst] = self._alloc_blocks(1)  # owns-blocks: table
                    cur = int(self._slot_nblocks[slot])
                    self._tables_np[slot, cur] = dst
                    self._slot_nblocks[slot] = cur + 1
                    dsts.append(dst)
                self._ensure_blocks(slot, n)
                self.paged_stats['prefix_block_hits'] += shared_n
            for i in range(lanes):
                req, slot, _, n, _, _ = chunk[min(i, p - 1)]
                tokens[i, :n - start] = req.tokens[start:]
                true_pos[i] = n - start - 1
                slots[i] = slot
                temps[i] = req.temperature
            if any(slots[i] != slots[p - 1] for i in range(p, lanes)):
                raise RuntimeError(
                    f'pad lanes must duplicate the last real lane: '
                    f'{slots=} p={p}')
            if dsts:
                self._paged_copy_blocks(
                    int(entry['blocks'][shared_n]),
                    self._to_device(np.asarray(dsts, np.int64)))
            nb = self._nb_bucket(-(-(start + sb) // bs_))
            head, _ = self._paged_prefill(
                self._to_device(tokens),
                self._to_device(np.full((lanes,), start, np.int64)),
                self._to_device(true_pos), self._lane_tables(slots, nb),
                self._to_device(temps), **self._akw([aid] * lanes))
            self._activate(chunk, head)
            self.prefix_stats['hits'] += p
            self.prefix_stats['tokens_reused'] += start * p

    def _start_prefixed(self, items) -> list:
        """The registered-prefix branch of _start_batch: group the
        prompts that match a prefix and have a suffix bucket beside it
        by (prefix, start, suffix bucket) and start them.  Returns the
        items left (no match, scoring, or no suffix bucket -- such a
        prompt takes a full prefill, or chunks)."""
        groups: Dict[Any, list] = {}
        rest = []
        for it in items:
            # Scoring needs every prompt position's logits, which reused
            # rows do not have: a full prefill.
            m = (None if it[0].want_prompt_logprobs else
                 self._match_prefix(it[0].tokens, it[0].adapter))
            if m is None:
                rest.append(it)
                continue
            start, key = m
            sb = self._suffix_bucket(start, len(it[0].tokens) - start)
            if sb is None:
                rest.append(it)
                continue
            groups.setdefault((key, start, sb), []).append(it)
        for (key, start, sb), group in groups.items():
            self._start_prefixed_group(group, start, sb, key)
        return rest

    def _start_batch(self, items) -> None:  # locked: _lock
        """Prefill validated requests, grouped by bucket, prefill_lanes
        rows per dispatch.  items: (req, slot, submit_time, prompt_len,
        bucket, max_new) tuples.  Dispatch width is always
        prefill_lanes; pad lanes duplicate the last real lane, slot
        included, so their cache writes are identical rewrites.  With
        the radix cache, matched prompts first prefill only their
        suffix (_start_radix).

        With registered prefixes, prompts that start with one prefill
        only their suffix (_start_prefixed).

        With chunked prefill, the prompts _should_chunk picks reserve
        their slot as a _ChunkJob instead; _chunk_round writes them.

        Bumps the prefill epoch first: an in-flight lookahead window's
        chain is never extended across a slot recycle, and its snapshot
        keeps a recycled slot from consuming the old occupant's column.
        The prefill need not wait for that window: it is queued behind
        it on the device, so its KV rows land after the window's dead
        rows."""
        self._fault_raise('prefill')
        self._prefill_epoch += 1
        if self._radix is not None and items:
            items = self._start_radix(items)
        if self._prefixes:
            items = self._start_prefixed(items)
        if self.cfg.prefill_chunk:
            rest = []
            for it in items:
                req, slot, submit_time, n, bucket, max_new = it
                if not self._should_chunk(req, n, bucket):
                    rest.append(it)
                    continue
                # Reserve the slot without activating it: decode windows
                # in between write dead rows at the frontier (the length
                # mirror), which later chunks overwrite before any query
                # position reaches them.
                self._chunking[slot] = _ChunkJob(
                    req, slot, submit_time, n, max_new,
                    self._adapter_id(req.adapter), self._agen(req.adapter))
                self._lengths[slot] = 0
                self._temps[slot] = 0.0
                self._slot_adapters[slot] = -1
                self.chunk_stats['requests'] += 1
            items = rest
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
                aids = np.full((lanes,), -1, np.int64)
                for i in range(lanes):
                    req, slot, _, n, _, _ = chunk[min(i, p - 1)]
                    tokens[i, :n] = req.tokens
                    true_lens[i] = n
                    slots[i] = slot
                    temps[i] = req.temperature
                    aids[i] = self._adapter_id(req.adapter)
                if any(slots[i] != slots[p - 1] for i in range(p, lanes)):
                    raise RuntimeError(
                        f'pad lanes must duplicate the last real lane: '
                        f'{slots=} p={p}')
                # Prompt scoring is a full [P, S, V] pass: only when a
                # request of the dispatch asked for it.
                want_plp = any(it[0].want_prompt_logprobs for it in chunk)
                if self._paged:
                    for req, slot, _, n, _, _ in chunk:   # real lanes
                        self._ensure_blocks(slot, n)
                    head, prompt = self._paged_prefill(
                        self._to_device(tokens),
                        self._to_device(np.zeros((lanes,), np.int64)),
                        self._to_device(true_lens - 1),
                        self._lane_tables(slots, self._nb_bucket(
                            bucket // self.cfg.kv_block_size)),
                        self._to_device(temps), want_plp,
                        **self._akw(aids))
                else:
                    head, prompt = self._prefill_insert(
                        self._to_device(tokens), self._to_device(true_lens),
                        self._to_device(slots), self._to_device(temps),
                        want_plp, **self._akw(aids))
                self._activate(chunk, head, prompt)

    def _chunk_round(self) -> bool:  # locked: _lock
        """Advance every in-progress chunked prefill by one chunk in a
        single full-width dispatch; activate the slots whose final chunk
        landed.  Returns True when a dispatch happened (the serving
        loop's `moved`).  Called between decode windows, so an active
        slot's worst inter-token stall is one chunk forward instead of a
        whole prefill.

        Two skip guards keep the cache writes sound:

        - an active slot within C of the cache end would have the
          dispatch's C-row frontier write clamped back onto its live
          rows (dense) or past its table; such a slot finishes within C
          tokens (harvested at length + 1 >= M), so skipping this gap
          cannot deadlock: decode keeps running in between.
        - an in-flight lookahead window's dead-row writes would land
          after a chunk dispatched now and garble the chunk's rows at
          the frontier: wait for the next decode step to consume it
          (lookahead is off while chunking, so at most one window of
          delay).  With no active slot left to consume it, drop it,
          as _decode_step would."""
        if not self._chunking:
            return False
        self._fault_raise('chunk_round')
        c = self.cfg.prefill_chunk
        m = self.cfg.max_cache_len
        if self._ahead is not None:
            if any(s is not None for s in self._slots):
                return False
            self._ahead = None
        if any(s is not None and s.length + c > m for s in self._slots):
            return False
        # An in-flight chain is never extended across these writes (and a
        # final chunk is a slot recycle, like any prefill).
        self._prefill_epoch += 1
        b = self.cfg.num_slots
        tokens = np.zeros((b, c), np.int64)
        starts = self._lengths.copy()
        true_pos = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        aids = self._slot_adapters.copy()
        finals = []
        for slot, job in self._chunking.items():
            real = min(c, job.n - job.done)
            tokens[slot, :real] = job.req.tokens[job.done:job.done + real]
            starts[slot] = job.done
            true_pos[slot] = real - 1
            aids[slot] = job.aid
            if self._paged:
                self._ensure_blocks(slot, job.done + real)
            if job.done + real >= job.n:
                temps[slot] = job.req.temperature
                finals.append((slot, job))
            job.done += real
            # The mirror tracks the frontier: interleaved decode's dead
            # rows for this lane land past the prompt rows written.
            self._lengths[slot] = job.done
            self.chunk_stats['chunks'] += 1
        self.chunk_stats['rounds'] += 1
        tables = None
        if self._paged:
            # The table covers every lane's frontier + C (active lanes
            # write dead rows there): a position past its width would
            # clamp into a live block.
            tables = self._lane_tables(range(b), self._nb_bucket(
                -(-(int(starts.max()) + c) // self.cfg.kv_block_size)))
        head, _ = self._paged_prefill(
            self._to_device(tokens), self._to_device(starts),
            self._to_device(true_pos), tables, self._to_device(temps),
            **self._akw(aids))
        if self._radix is not None:
            # Block-boundary inserts, after the dispatch (a raised chunk
            # fault never indexes unwritten rows): every full block of
            # prompt rows the pool now holds is matchable at once.
            # Finals are still in _chunking; their insert at finish is
            # an idempotent touch on top.  A job whose adapter was
            # re-registered since its first chunk holds stale rows.
            for slot, job in self._chunking.items():
                if job.agen == self._agen(job.req.adapter):
                    self._radix_adopt(slot, job.req.tokens, job.done,
                                      job.req.adapter)
        if finals:
            for slot, _ in finals:
                del self._chunking[slot]
            lanes = self._to_device(np.asarray([slot for slot, _ in finals]))
            self._activate([(job.req, slot, job.submit_time, job.n, None,
                             job.max_new) for slot, job in finals],
                           head[lanes], agens=[job.agen for _, job in finals])
        return True

    def _radix_adopt(self, slot: int, tokens: Sequence[int], rows: int,  # locked: _lock
                     adapter: Optional[str]) -> None:
        """Insert the slot's full PROMPT blocks (rows [0, rows) of
        `tokens`, whole blocks only) into the radix tree by reference.
        Only prefill-written rows are indexed: decode-written rows at the
        same positions could differ numerically from a prefill's.
        Idempotent: already-cached runs get an LRU touch."""
        full = min(rows // self.cfg.kv_block_size,
                   int(self._slot_nblocks[slot]))
        if full < 1:
            return
        blocks = [int(b) for b in self._tables_np[slot, :full]]
        self.radix_stats['inserts'] += self._radix.insert(
            adapter, tokens, blocks, addref=self._addref_block)

    def _flush_streams(self) -> None:
        """Deliver the newly generated tokens of every streaming slot.
        A callback's error is swallowed: a broken consumer must not kill
        the loop (its request still finishes normally)."""
        for s in self._slots:
            if s is None or s.request.stream_cb is None:
                continue
            if len(s.generated) > s.streamed:
                chunk = s.generated[s.streamed:]
                s.streamed = len(s.generated)
                try:
                    s.request.stream_cb(list(chunk))
                except Exception:  # noqa: BLE001
                    pass

    def _finish_slot(self, i: int, reason: str,  # locked: _lock
                     error: Optional[str] = None,
                     error_class: Optional[str] = None,
                     ) -> Tuple[Request, RequestResult]:
        s = self._slots[i]
        if s.request.stream_cb is not None and len(s.generated) > s.streamed:
            try:
                s.request.stream_cb(list(s.generated[s.streamed:]))
            except Exception:  # noqa: BLE001
                pass
        now = time.time()
        if reason in ('eos', 'length'):
            # Clean finishes feed the shed bound's service-rate EWMA
            # (error and deadline durations would skew it short).
            self._svc_estimator.observe(
                len(s.request.tokens) + len(s.generated),
                now - s.submit_time)
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
            top_logprobs=list(s.tops),
            prompt_logprobs=(list(s.prompt_lps)
                             if s.prompt_lps is not None else None),
            prompt_top_logprobs=(list(s.prompt_tops)
                                 if s.prompt_tops is not None else None))
        req = s.request
        self._slots[i] = None
        self._lengths[i] = 0
        self._temps[i] = 0.0
        self._slot_adapters[i] = -1
        if self._paged:
            if (self._radix is not None and reason != 'error' and
                    not req.want_prompt_logprobs and
                    s.agen == self._agen(req.adapter)):
                # The slot's full prompt blocks join the tree before the
                # table is torn down ('error' finishes may have left rows
                # unwritten; a scored request bypasses the tree; rows
                # written under an adapter's replaced weights are stale).
                self._radix_adopt(i, req.tokens, len(req.tokens),
                                  req.adapter)
            self._free_slot_blocks(i)
        if req.request_id is not None:
            self._cancelled.pop(req.request_id, None)   # stale mark
        return req, res

    # ----------------------------------------------------- containment

    def _fail_slot(self, i: int,  # locked: _lock
                   error: str) -> Tuple[Request, RequestResult]:
        """Fail one active slot's request with error_class='internal':
        the slot is freed, the partial output returned."""
        self.fault_stats['internal_errors'] += 1
        return self._finish_slot(i, 'error', error=error,
                                 error_class='internal')

    def _fail_chunk_job(self, slot: int, reason: str,  # locked: _lock
                        error: Optional[str] = None
                        ) -> Tuple[Request, RequestResult]:
        """End a part-prefilled chunk job (reason 'error' or 'deadline'):
        release the reserved slot and every block its chunks wrote."""
        job = self._chunking.pop(slot)
        self._lengths[slot] = 0
        self._temps[slot] = 0.0
        self._slot_adapters[slot] = -1
        if self._paged:
            self._free_slot_blocks(slot)
        if error is not None:
            self.fault_stats['internal_errors'] += 1
        if job.req.request_id is not None:
            self._cancelled.pop(job.req.request_id, None)
        now = time.time()
        return job.req, RequestResult(
            request_id=job.req.request_id,
            prompt_tokens=list(job.req.tokens),
            output_tokens=[],
            ttft_s=now - job.submit_time,
            latency_s=now - job.submit_time,
            finish_reason=reason,
            error=error,
            error_class='internal' if error is not None else None)

    def _shed_request(self, req: Request, elapsed: float, reason: str,
                      result_cb) -> None:
        """Typed shed at dequeue, one shape for both triggers (the
        deadline expired in the queue; the projected completion cannot
        meet it): finish_reason 'deadline', error_class 'shed', the
        deadline_evictions counter and the qos and tenant counters."""
        with self._lock:
            self.fault_stats['deadline_evictions'] += 1
            self.qos_stats['sheds'] += 1
            self._tenant_row(req.tenant_id)['shed'] += 1
            result_cb(RequestResult(
                request_id=req.request_id,
                prompt_tokens=list(req.tokens),
                output_tokens=[], ttft_s=0.0,
                latency_s=elapsed,
                finish_reason='deadline',
                error=reason, error_class='shed'))

    # ------------------------------------------------------------- qos

    def _park_chunk_job(self, slot: int) -> Request:  # locked: _lock
        """Preempt a part-prefilled prompt at its chunk boundary (caller
        holds the lock): the reserved slot frees now for higher-priority
        work, and the rows already written stay as refcounted radix
        blocks, so resuming is a suffix-only prefill.  Nothing has
        streamed (a chunk job has no _Slot yet).  A job whose adapter was
        re-registered since its first chunk holds stale rows: they are
        not adopted, and the job resumes from scratch.  Returns the
        request for the caller to requeue."""
        job = self._chunking.pop(slot)
        if (self._radix is not None and job.done > 0 and
                job.agen == self._agen(job.req.adapter)):
            self._radix_adopt(slot, job.req.tokens, job.done,
                              job.req.adapter)
        self._lengths[slot] = 0
        self._temps[slot] = 0.0
        self._slot_adapters[slot] = -1
        self._free_slot_blocks(slot)
        self.qos_stats['preemptions'] += 1
        return job.req

    def _maybe_preempt_for(self, exclude) -> Optional[int]:
        """Every slot is taken, but an interactive request waits and a
        batch prompt is only part-prefilled: park the batch job with the
        most prefill still ahead of it and hand its slot over.  Gated on
        qos, a paged pool with the radix tree and chunked prefill (what
        makes park and resume nearly free), and on no lookahead window in
        flight (its dead-row writes for the parked lane would land in
        blocks the pool has already recycled)."""
        if not (self.cfg.qos and self._paged and
                self._radix is not None and self.cfg.prefill_chunk):
            return None
        if self._deferred or not self._sched.waiting('interactive'):
            # Deferred head-of-line work is admitted first whatever its
            # class: preempting for it would be a no-op.
            return None
        victim = None
        with self._lock:
            if self._ahead is not None:
                return None
            remaining = -1
            for slot, job in self._chunking.items():
                if slot in exclude or qos_mod.classify(job.req) != 'batch':
                    continue
                if job.n - job.done > remaining:
                    victim, remaining = slot, job.n - job.done
            if victim is None:
                return None
            req = self._park_chunk_job(victim)
        self._sched.requeue(req)
        return victim

    def _doomed(self, req: Request, now: float) -> bool:
        """True when `req` carries a deadline that its elapsed queue time
        plus the projected service time cannot meet."""
        if req.deadline_s is None:
            return False
        elapsed = (now - req.arrival_time
                   if req.arrival_time is not None else 0.0)
        proj = self._svc_estimator.projected_s(
            len(req.tokens) + self._max_new(req))
        return proj is not None and elapsed + proj > req.deadline_s

    def _contain_failure(self, exc: BaseException, phase: str  # locked: _lock
                         ) -> List[Tuple[Request, RequestResult]]:
        """Step-level containment of a decode-phase failure (under the
        engine lock).  An InjectedFault names the slot(s) it injured and
        only those fail.  Anything else cannot be bisected after the
        fact -- the window is one batched dispatch that writes the cache
        in place -- so the whole active batch fails with
        error_class='internal' and the cache is zeroed (_reset_cache),
        leaving the engine clean for the queue still waiting."""
        msg = f'{phase} failed: {exc!r}'
        slots_hint = getattr(exc, 'slots', None)
        failed: List[Tuple[Request, RequestResult]] = []
        # An in-flight lookahead window was dispatched against
        # pre-failure state: drop it rather than consume it.
        self._ahead = None
        if slots_hint:
            for i in slots_hint:
                if 0 <= i < self.cfg.num_slots and self._slots[i] is not None:
                    failed.append(self._fail_slot(i, msg))
                elif i in self._chunking:
                    failed.append(
                        self._fail_chunk_job(i, 'error', error=msg))
            return failed
        self.fault_stats['quarantined_batches'] += 1
        failed.extend(self._fail_all_inflight(msg))
        if self._tp_lost() is None:
            # A tensor-parallel replica that lost a rank runs no dispatch
            # (this one would raise with the failures undelivered): its
            # loop stops at the next pass.
            self._reset_cache()
        return failed

    def _tp_lost(self) -> Optional[str]:
        """Why this tensor-parallel engine lost a rank, else None."""
        return None if self._tpc is None else self._tpc.lost

    # ---------------------------------------------------------- decode

    def _select_window(self) -> int:
        """Decode-window policy (adaptive_decode_window), queue-aware:
        a short window only while an arrival waits for the next prefill
        gap with a slot free to take it, or while a prompt is
        mid-chunked-prefill (its next chunk rides the gap after this
        window).  A request streaming alone gets full windows (a short
        one costs it a dispatch per two tokens)."""
        steps = self.cfg.decode_steps
        if self.cfg.adaptive_decode_window and (
                self._chunking or
                (self._arrivals_hint > 0
                 and any(s is None and i not in self._chunking
                         for i, s in enumerate(self._slots)))):
            return min(2, steps)
        return steps

    def _decode_step(self, steps: Optional[int] = None) -> None:  # locked: _lock
        """One decode window for every active slot: consume a pending
        lookahead window if one exists, else dispatch from the host
        mirrors; maybe queue the NEXT window from the device-side chain
        before waiting for this one's transfer (_maybe_dispatch_ahead);
        then append up to K tokens per slot (_consume_window)."""
        if self._ahead is not None:
            handle, chain, snap, epoch = self._ahead
            self._ahead = None
            if epoch != self._prefill_epoch:
                # A prefill happened while this window was in flight: its
                # chain lacks the new slot(s), so nothing more hangs off
                # it.  If no snapshot slot is alive any more, serve the
                # current slots a fresh window instead.
                chain = None
                if not any(s is not None and s is snap[i]
                           for i, s in enumerate(self._slots)):
                    handle = None
            if handle is not None:
                if chain is not None:
                    # Ahead windows are always full: the pending one is
                    # cfg.decode_steps in flight.
                    self._maybe_dispatch_ahead(chain, snap,
                                               self.cfg.decode_steps)
                self._consume_window(handle, snap)
                return
        if steps is None:
            steps = self._select_window()
        handle, chain = self._dispatch_decode(steps)
        self._maybe_dispatch_ahead(chain, list(self._slots), steps)
        self._consume_window(handle)

    def _dispatch_decode(self, steps: int):
        """One window dispatched from the host slot mirrors.  Returns the
        host-copy handle of its packed result and the device-side
        (tokens, lengths) chain."""
        paged = {'tables': self._decode_tables(steps)} if self._paged else {}
        packed, last, lens = self._decode(
            self._to_device(self._last_tokens),
            self._to_device(self._lengths), self._to_device(self._temps),
            steps, **paged, **self._akw(self._slot_adapters))
        return self._to_host(packed), (last, lens)

    def _maybe_dispatch_ahead(self, chain, snap,  # locked: _lock
                              in_flight_steps: int = 0) -> None:
        """Decode lookahead: queue the next full window now, fed by the
        previous window's device-side last tokens and lengths, so it
        never waits for that window's trip to the host.  Safe because
        decode is independent per slot:

        - a slot that finishes while the window is in flight has its
          column discarded (the consume is restricted to `snap`, the
          slot objects active at dispatch), and its cache writes are the
          dead rows windowed decode already tolerates;
        - a prefill recycling a freed slot does not wait: it is queued
          behind the window, the snapshot keeps the new request from a
          stale column, and the epoch bump keeps lookahead off the stale
          chain;
        - while arrivals wait (hint > 0) or a prompt is mid-chunked-
          prefill nothing is queued ahead: the window would push their
          prefill or chunk back (TTFT), and a chunk must never be
          dispatched under a window's frontier writes (_chunk_round
          waits for _ahead to drain);
        - a window no survivor could take a token from (each finishes
          inside the `in_flight_steps` already queued) is not queued;
        - under speculative decoding nothing is queued ahead: a verify
          needs the host's drafts, which need the last window's
          tokens."""
        if (not self.cfg.decode_lookahead or self.cfg.draft_len > 0 or
                not self._serving or self._arrivals_hint > 0 or
                self._chunking):
            return
        live = [s for i, s in enumerate(snap)
                if s is not None and self._slots[i] is s]
        if not live:
            return          # nobody left to deliver the window to
        if all(min(s.max_new - len(s.generated),
                   self.cfg.max_cache_len - 1 - s.length)
               <= in_flight_steps for s in live):
            return          # every survivor finishes in flight
        # Paged: the window in flight advances the device lengths past
        # the host mirror, so the tables budget both windows' rows (built
        # on the host from the mirrors, sent without blocking).
        paged = ({'tables': self._decode_tables(in_flight_steps +
                                                self.cfg.decode_steps)}
                 if self._paged else {})
        packed, last, lens = self._decode(
            chain[0], chain[1], self._to_device(self._temps),
            self.cfg.decode_steps,
            **paged, **self._akw(self._slot_adapters))
        self._ahead = (self._to_host(packed), (last, lens), snap,
                       self._prefill_epoch)

    def _consume_window(self, handle, snap=None) -> None:  # locked: _lock
        """Append up to K tokens per slot, stopping at EOS, max_new or the
        cache end; tokens past a slot's stop are speculative overrun and
        are discarded.  With `snap` (a lookahead window), only the slots
        that were active at its dispatch take its columns."""
        toks, lps, gtoks, glps = _unpack_head(
            self._host_array(handle), self.cfg.logprob_topk)  # ONE transfer
        sp = self._fault('nonfinite_logits')
        if sp is not None:
            # Poison one lane's logprobs after the transfer, the way a
            # real blow-up of that lane's logits would reach the host.
            lane = sp.slot
            if lane is None:
                lane = next((i for i, s in enumerate(self._slots)
                             if s is not None), 0)
            lps = np.array(lps)
            lps[:, lane] = np.nan
        bad: List[int] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if snap is not None and snap[i] is not s:
                # Dispatched before this slot's occupant existed: the
                # column is the previous request's.
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
        for i in bad:
            self.fault_stats['nonfinite_lanes'] += 1
            self._pending_failures.append(self._fail_slot(
                i, 'non-finite logits in decode window (lane killed)'))

    def _spec_step(self) -> None:  # locked: _lock
        """One speculative dispatch: draft by prompt lookup, verify
        [B, 1+D] in one forward, accept the agreed prefix plus the
        model's own next token (so a dispatch yields at least one token,
        and greedy tokens equal windowed decode's)."""
        k = self.cfg.draft_len + 1
        cache_len = self.cfg.max_cache_len
        # A slot within k of the cache end would have its k-row write
        # clamped back onto live rows; such slots finish within a few
        # tokens, so windowed decode runs until they do.  A chunking
        # slot's frontier is the same hazard.
        if (any(s is not None and s.length > cache_len - k
                for s in self._slots) or
                any(job.done > cache_len - k
                    for job in self._chunking.values())):
            self._decode_step()
            return
        b = self.cfg.num_slots
        tokens = np.zeros((b, k), np.int64)
        tokens[:, 0] = self._last_tokens
        drafted = np.zeros((b,), np.int64)
        for i, s in enumerate(self._slots):
            if s is None or s.request.temperature > 0:
                # A sampled slot cannot accept greedy-verified drafts:
                # it rides the dispatch at one token.
                continue
            # A dispatch appends at most `budget` tokens, the first of
            # which needs no draft: drafting past it is wasted and would
            # understate the acceptance rate.
            budget = min(s.max_new - len(s.generated),
                         cache_len - 1 - s.length)
            want = min(self.cfg.draft_len, budget - 1)
            if want < 1:
                continue
            hist = s.request.tokens + s.generated
            drafts = prompt_lookup_draft(hist, want, self.cfg.ngram_max)
            tokens[i, 1:1 + len(drafts)] = drafts
            drafted[i] = len(drafts)
        if not drafted.any():
            # Nothing to verify: windowed decode's decode_steps tokens
            # a dispatch beat a one-token verify.
            self._decode_step()
            return
        active = sum(s is not None for s in self._slots)
        if self._accept_ema * float(drafted.sum()) < 0.5 * active:
            # Expected bonus under half a token per active slot: decode
            # windowed, with a verify probe every 50th step to keep the
            # EMA live as traffic shifts.
            self._spec_skips += 1
            if self._spec_skips < 50:
                self._decode_step()
                return
        self._spec_skips = 0
        tables = self._decode_tables(k) if self._paged else None
        packed = self._spec_verify(
            self._to_device(tokens), self._to_device(self._lengths),
            self._to_device(self._temps), tables,
            **self._akw(self._slot_adapters))
        preds, preds_lp, g_toks, g_lps = _unpack_head(
            self._host_array(self._to_host(packed)),
            self.cfg.logprob_topk)                     # ONE transfer
        self.spec_stats['dispatches'] += 1
        accepted_before = self.spec_stats['accepted']
        bad: List[int] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self.spec_stats['drafted'] += int(drafted[i])
            for t in range(k):
                if len(s.generated) >= s.max_new:
                    break
                if (self.cfg.eos_id is not None and s.generated and
                        s.generated[-1] == self.cfg.eos_id):
                    break
                if s.length + 1 >= cache_len:
                    break
                if not np.isfinite(preds_lp[i, t]):
                    # This lane's logits blew up: the lane dies alone.
                    bad.append(i)
                    break
                if t > 0:
                    # Position t fed draft tokens[i, t]: it counts only if
                    # the prediction at t - 1 agrees (greedy slots only).
                    if (s.request.temperature > 0 or t > drafted[i] or
                            int(tokens[i, t]) != int(preds[i, t - 1])):
                        break
                    self.spec_stats['accepted'] += 1
                s.length += 1
                s.generated.append(int(preds[i, t]))
                s.lps.append(float(preds_lp[i, t]))
                s.tops.append(_pairs(g_toks[i, t], g_lps[i, t]))
            self._lengths[i] = s.length
            self._last_tokens[i] = s.generated[-1]
        for i in bad:
            self.fault_stats['nonfinite_lanes'] += 1
            self._pending_failures.append(self._fail_slot(
                i, 'non-finite logits in spec verify (lane killed)'))
        dispatch_drafted = int(drafted.sum())
        dispatch_accepted = self.spec_stats['accepted'] - accepted_before
        if dispatch_drafted:
            rate = dispatch_accepted / dispatch_drafted
            self._accept_ema = 0.9 * self._accept_ema + 0.1 * rate

    _CANCEL_MARK_TTL_S = 600.0

    def cancel(self, request_id: str) -> bool:
        """Stop generating for a request and free its slot now (client
        gone, stop string hit).  Returns True when it was in a slot (its
        result is not delivered: the caller owns the consequence); False
        marks it to be dropped at dequeue."""
        with self._lock:
            self._prune_cancel_marks()
            for i, s in enumerate(self._slots):
                if s is not None and s.request.request_id == request_id:
                    self._finish_slot(i, 'cancelled')
                    return True
            for slot, job in list(self._chunking.items()):
                if job.req.request_id == request_id:
                    # Mid-chunked-prefill: free the reserved slot; its
                    # partly written prompt rows are dead (the next
                    # occupant writes every row before reading it).
                    del self._chunking[slot]
                    self._lengths[slot] = 0
                    self._slot_adapters[slot] = -1
                    if self._paged:
                        self._free_slot_blocks(slot)
                    return True
            self._cancelled[request_id] = time.time()
            return False

    def uncancel(self, request_id: str) -> None:
        """Drop a pending-cancel mark, for the caller who learns after
        cancel() returned False that the request had already finished."""
        with self._lock:
            self._cancelled.pop(request_id, None)

    def _prune_cancel_marks(self) -> None:  # locked: _lock
        now = time.time()
        stale = [rid for rid, ts in self._cancelled.items()
                 if now - ts > self._CANCEL_MARK_TTL_S]
        for rid in stale:
            del self._cancelled[rid]

    def _step(self) -> None:
        """One decode dispatch (the decode_step fault site first): a
        speculative verify when drafting is on, else a window."""
        self._fault_raise('decode_step')
        if self.cfg.draft_len > 0:
            self._spec_step()
        else:
            self._decode_step()

    def _harvest(self) -> List[Tuple[Request, RequestResult]]:  # locked: _lock
        done = []
        if self._pending_failures:
            done.extend(self._pending_failures)
            self._pending_failures = []
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            dl = s.request.deadline_s
            if dl is not None and now - s.submit_time >= dl:
                # Deadline eviction: the partial output ships and the
                # slot frees now.  Checked before eos/length so an
                # expired request never counts as a clean finish.
                self.fault_stats['deadline_evictions'] += 1
                done.append(self._finish_slot(i, 'deadline'))
            elif self.cfg.eos_id is not None and \
                    s.generated[-1] == self.cfg.eos_id:
                done.append(self._finish_slot(i, 'eos'))
            elif len(s.generated) >= s.max_new:
                done.append(self._finish_slot(i, 'length'))
            elif s.length + 1 >= self.cfg.max_cache_len:
                done.append(self._finish_slot(i, 'length'))
        for slot, job in list(self._chunking.items()):
            dl = job.req.deadline_s
            if dl is not None and now - job.submit_time >= dl:
                # A part-prefilled prompt past its deadline: no more
                # chunk dispatches for a result nobody will read.
                self.fault_stats['deadline_evictions'] += 1
                done.append(self._fail_chunk_job(slot, 'deadline'))
        return done

    # ------------------------------------------------------------ API

    def generate(self, requests: List[Request]) -> List[RequestResult]:
        """Offline batch generation with continuous batching: every free
        slot is filled from the pending list before each decode window,
        and slots are refilled as requests finish.  Results come back in
        request order.  A decode failure is contained as in the serving
        loop (_contain_failure)."""
        with self._lock:
            pending = list(requests)
            finished: List[Tuple[Request, RequestResult]] = []
            t0 = time.time()
            while (pending or self._chunking or
                   any(s is not None for s in self._slots)):
                to_start = []
                admit_extra = 0
                while pending:
                    slot = self._free_slot(exclude=[it[1] for it in to_start])
                    if slot is None:
                        break
                    if self._paged:
                        req = pending[0]
                        demand = self._blocks_demand(
                            len(req.tokens), self._max_new(req))
                        # An oversized demand falls through to
                        # _validate_request, which fails it alone.  With
                        # nothing running every radix block is
                        # evictable, so the head always fits then.
                        if demand <= self._num_blocks - 1 and \
                                not self._can_admit_blocks(demand,
                                                           admit_extra):
                            # Nothing running and nothing about to:
                            # evict prefix entries rather than deadlock.
                            if (to_start or self._chunking or
                                    any(s is not None
                                        for s in self._slots) or
                                    not self._force_admit_blocks(demand)):
                                self.paged_stats['deferred'] += 1
                                break
                    req = pending.pop(0)
                    try:
                        to_start.append((req, slot, t0,
                                         *self._validate_request(req)))
                        if self._paged:
                            admit_extra += demand
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
                if self._chunking:
                    # Offline only prompts no bucket holds chunk: one
                    # chunk per pass, between the decode windows.
                    try:
                        self._chunk_round()
                    except Exception as e:  # pylint: disable=broad-except
                        finished.extend(
                            self._contain_failure(e, 'chunk round'))
                # The prefill already produced one token, which may meet
                # max_new_tokens=1 or be the EOS.
                finished.extend(self._harvest())
                if not any(s is not None for s in self._slots):
                    continue
                try:
                    self._step()
                except Exception as e:  # pylint: disable=broad-except
                    finished.extend(self._contain_failure(e, 'decode step'))
                finished.extend(self._harvest())
            order = {id(r): i for i, r in enumerate(requests)}
            finished.sort(key=lambda pair: order.get(id(pair[0]), 0))
            return [res for _, res in finished]

    # Consecutive fast deaths (loop up < 1 s) before the supervisor
    # gives up: a crash loop that makes no progress surfaces to the
    # caller instead of spinning and eating the queue.
    _MAX_LOOP_RESTARTS = 3

    def generate_stream(self, request_queue: 'queue.Queue[Request]',
                        result_cb, stop_event: threading.Event,
                        idle_sleep: float = 0.005) -> None:
        """Serving loop: pull requests from a queue, run continuous
        batching until stop_event is set, deliver RequestResults through
        result_cb (and tokens through each request's stream_cb).

        Supervised: an exception that escapes _serve_loop's contained
        regions (1) fails every in-flight request now with
        error_class='internal', (2) restarts the loop with the queue
        intact, (3) after _MAX_LOOP_RESTARTS consecutive sub-second
        deaths fails the queued requests too and re-raises.

        Runs on the caller's thread, which it puts in inference mode and
        on the engine's card: both are per thread, and a serving thread
        outside inference mode would record autograd state every window.
        """
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        consecutive = 0
        try:
            self._serving = True
            while True:
                t_up = time.time()
                try:
                    with torch.inference_mode():
                        self._serve_loop(request_queue, result_cb,
                                         stop_event, idle_sleep)
                    return
                except Exception as e:  # pylint: disable=broad-except
                    with self._lock:
                        self.fault_stats['loop_restarts'] += 1
                        self._ahead = None
                        for _, res in self._fail_all_inflight(
                                f'serving loop died: {e!r}'):
                            try:
                                result_cb(res)
                            except Exception:  # noqa: BLE001
                                pass
                    if stop_event.is_set():
                        return
                    consecutive = (consecutive + 1
                                   if time.time() - t_up < 1.0 else 1)
                    # A tensor-parallel engine that lost a rank never
                    # serves again: give up at once (/healthz 'dead').
                    if (consecutive > self._MAX_LOOP_RESTARTS or
                            self._tp_lost() is not None):
                        self._drain_queue_failing(request_queue,
                                                  result_cb, e)
                        raise
        finally:
            # Outside the loop the hint is 0 (offline generate runs full
            # windows) and no lookahead window is pending.
            self._serving = False
            with self._lock:
                self._ahead = None
                self._arrivals_hint = 0

    def _fail_all_inflight(self, msg: str
                           ) -> List[Tuple[Request, RequestResult]]:
        """Fail every active slot and chunk job (caller holds the lock):
        the loop that would advance them is dead."""
        failed = [self._fail_slot(i, msg)
                  for i, s in enumerate(self._slots) if s is not None]
        for slot in list(self._chunking):
            failed.append(self._fail_chunk_job(slot, 'error', error=msg))
        return failed

    def _drain_queue_failing(self, request_queue, result_cb,
                             exc: BaseException) -> None:
        """Terminal supervisor path: the queued requests will never
        serve, so fail them now rather than leave their clients waiting
        for timeouts."""
        with self._lock:
            pending = list(self._deferred)
            self._deferred = []
            while True:
                r = self._sched.pop()
                if r is None:
                    break
                pending.append(r)
            while True:
                try:
                    pending.append(request_queue.get_nowait())
                except queue.Empty:
                    break
            for req in pending:
                self.fault_stats['internal_errors'] += 1
                try:
                    result_cb(RequestResult(
                        request_id=req.request_id,
                        prompt_tokens=list(req.tokens),
                        output_tokens=[], ttft_s=0.0, latency_s=0.0,
                        finish_reason='error',
                        error=f'serving loop dead: {exc!r}',
                        error_class='internal'))
                except Exception:  # noqa: BLE001
                    pass

    def _serve_loop(self, request_queue, result_cb, stop_event,
                    idle_sleep) -> None:
        while not stop_event.is_set():
            lost = self._tp_lost()
            if lost is not None:
                raise RuntimeError(
                    f'tensor-parallel engine is shut down: {lost}')
            if self._faults is not None:
                sp = self._fault('stall')
                if sp is not None:
                    time.sleep(sp.stall_s)   # a wedged host thread
                if self._chunking or any(s is not None
                                         for s in self._slots):
                    # Loop death outside every contained region, the
                    # supervisor's case; consulted only with work in
                    # flight so "hit 1" does not race the idle spin.
                    self._fault_raise('serve_loop')
            moved = False
            to_start = []
            admit_extra = 0
            dequeued = cancelled_deq = 0
            while True:
                try:
                    self._sched.push(request_queue.get_nowait())
                except queue.Empty:
                    break
            while True:
                if len(to_start) >= self.cfg.prefills_per_gap and any(
                        s is not None for s in self._slots):
                    break  # let active slots decode; prefill more next gap
                excl = [it[1] for it in to_start]
                slot = self._free_slot(exclude=excl)
                if slot is None:
                    # QoS preemption: an interactive arrival may take a
                    # part-prefilled batch prompt's slot at its chunk
                    # boundary (a no-op unless cfg.qos).
                    slot = self._maybe_preempt_for(excl)
                    if slot is None:
                        break
                # Admission-deferred requests go first (head of line: a
                # big request must not starve behind small ones that keep
                # fitting around it).
                if self._deferred:
                    req = self._deferred.pop(0)
                else:
                    req = self._sched.pop()
                    if req is None:
                        break
                if self._paged:
                    demand = self._blocks_demand(len(req.tokens),
                                                 self._max_new(req))
                    # Under the lock: admission may evict radix leaves,
                    # and the lock orders it against a quarantine reset.
                    with self._lock:
                        admissible = (demand > self._num_blocks - 1 or
                                      self._can_admit_blocks(demand,
                                                             admit_extra))
                        if (not admissible and not to_start and
                                not self._chunking and
                                not any(s is not None
                                        for s in self._slots)):
                            # Registered prefixes hold the pool and
                            # nothing runs: evict them, LRU first.
                            admissible = self._force_admit_blocks(demand)
                        if not admissible:
                            # Back to the head; admitted first once blocks
                            # free up.
                            self._deferred.insert(0, req)
                            self.paged_stats['deferred'] += 1
                    if not admissible:
                        break
                if (req.request_id is not None and
                        req.request_id in self._cancelled):
                    # Cancelled while queued: never prefill it.  Results
                    # are delivered under the lock, as at every
                    # result_cb site: a caller who sees cancel() return
                    # False can rely on a prior finish being delivered.
                    with self._lock:
                        self._cancelled.pop(req.request_id, None)
                        result_cb(RequestResult(
                            request_id=req.request_id,
                            prompt_tokens=list(req.tokens),
                            output_tokens=[], ttft_s=0.0, latency_s=0.0,
                            finish_reason='cancelled'))
                    moved = True
                    dequeued += 1
                    cancelled_deq += 1
                    continue
                dequeued += 1
                now = time.time()
                elapsed = (now - req.arrival_time
                           if req.arrival_time is not None else 0.0)
                shed_reason = None
                if (req.deadline_s is not None and
                        req.arrival_time is not None and
                        elapsed >= req.deadline_s):
                    # Expired while queued: never spend a prefill on it.
                    shed_reason = (
                        f'deadline_s={req.deadline_s} expired in queue '
                        f'({elapsed:.3f}s elapsed)')
                elif self.cfg.qos and self._doomed(req, now):
                    # Projection bound: at the observed service rate the
                    # prefill and decode cannot land inside the deadline;
                    # a typed shed now beats an eviction mid-flight.
                    proj = self._svc_estimator.projected_s(
                        len(req.tokens) + self._max_new(req))
                    shed_reason = (
                        f'projected completion {elapsed + proj:.3f}s '
                        f'cannot meet deadline_s={req.deadline_s}')
                    # WFQ order pops the under-share tenant first: shed
                    # a doomed queued row of a tenant strictly more over
                    # its fair share instead, when there is one.
                    victim = self._sched.shed_victim(
                        prefer_over=req.tenant_id or DEFAULT_TENANT,
                        doomed=lambda r, _now=now: self._doomed(r, _now))
                    if victim is not None:
                        self._sched.requeue(req)
                        self._shed_request(
                            victim, (now - victim.arrival_time
                                     if victim.arrival_time is not None
                                     else 0.0),
                            'over-fair-share victim: projected completion '
                            f'cannot meet deadline_s={victim.deadline_s}',
                            result_cb)
                        moved = True
                        continue
                if shed_reason is not None:
                    self._shed_request(req, elapsed, shed_reason, result_cb)
                    moved = True
                    continue
                try:
                    to_start.append((req, slot,
                                     req.arrival_time or time.time(),
                                     *self._validate_request(req)))
                    if self._paged:
                        admit_extra += demand
                except ValueError as e:
                    with self._lock:
                        result_cb(RequestResult(
                            request_id=req.request_id,
                            prompt_tokens=list(req.tokens),
                            output_tokens=[], ttft_s=0.0, latency_s=0.0,
                            finish_reason='error', error=str(e),
                            error_class='client'))
                moved = True
            if dequeued:
                # A pass that dequeued only cancelled requests halves the
                # hint's view of the backlog; a real dequeue resets it.
                if dequeued == cancelled_deq:
                    self._cancel_only_streak = min(
                        self._cancel_only_streak + 1, 16)
                else:
                    self._cancel_only_streak = 0
            if to_start:
                try:
                    with self._lock:
                        # Re-check cancel marks under the lock: a cancel()
                        # racing the unlocked dequeue above left only a
                        # mark.
                        dropped = [
                            it for it in to_start
                            if it[0].request_id is not None and
                            it[0].request_id in self._cancelled]
                        to_start = [it for it in to_start
                                    if it not in dropped]
                        for it in dropped:
                            self._cancelled.pop(it[0].request_id, None)
                        if to_start:
                            self._start_batch(to_start)
                            for it in to_start:
                                self._tenant_row(
                                    it[0].tenant_id)['admitted'] += 1
                        for it in dropped:
                            result_cb(RequestResult(
                                request_id=it[0].request_id,
                                prompt_tokens=list(it[0].tokens),
                                output_tokens=[], ttft_s=0.0,
                                latency_s=0.0, finish_reason='cancelled'))
                except Exception as e:  # pylint: disable=broad-except
                    # A prefill failure must not kill the loop: every
                    # request of the batch fails as internal, and a slot
                    # a partly applied batch already filled is freed (it
                    # would also be harvested otherwise).
                    with self._lock:
                        for req, slot, *_ in to_start:
                            s = self._slots[slot]
                            if s is not None and s.request is req:
                                self._slots[slot] = None
                                self._lengths[slot] = 0
                                self._temps[slot] = 0.0
                                self._slot_adapters[slot] = -1
                            if (self._paged and self._slots[slot] is None
                                    and slot not in self._chunking):
                                # Blocks a half-applied batch allocated
                                # for this slot would leak.
                                self._free_slot_blocks(slot)
                        for req, slot, *_ in to_start:
                            self.fault_stats['internal_errors'] += 1
                            result_cb(RequestResult(
                                request_id=req.request_id,
                                prompt_tokens=list(req.tokens),
                                output_tokens=[], ttft_s=0.0,
                                latency_s=0.0,
                                finish_reason='error', error=str(e),
                                error_class='internal'))
            with self._lock:
                if self._chunking:
                    # At most one chunk between decode windows: an active
                    # stream's stall from a long arrival is one chunk plus
                    # one window, not the whole prefill.  Contained like
                    # a prefill.
                    try:
                        moved = self._chunk_round() or moved
                    except Exception as e:  # pylint: disable=broad-except
                        for _, res in self._contain_failure(
                                e, 'chunk round'):
                            result_cb(res)
                        moved = True
                self._flush_streams()            # prefill first tokens
                for _, res in self._harvest():   # prefill-only finishes
                    result_cb(res)
                if any(s is not None for s in self._slots):
                    # The backlog the window policy sees: requests still
                    # queued at step time (decayed by a cancel-only
                    # streak).
                    self._arrivals_hint = (
                        (request_queue.qsize() + self._sched.backlog())
                        >> self._cancel_only_streak)
                    try:
                        self._step()
                    except Exception as e:  # pylint: disable=broad-except
                        for _, res in self._contain_failure(
                                e, 'decode step'):
                            result_cb(res)
                    self._flush_streams()
                    for _, res in self._harvest():
                        result_cb(res)
                    moved = True
            if not moved:
                if self._host_tier is not None:
                    # Land in-flight spill copies while idle, so the next
                    # restore probe does not wait for them.
                    with self._lock:
                        self._host_tier.finalize()
                # Quiesce point: nothing moved this pass, so the block
                # pool's refcounts must balance exactly and every rank's
                # cache and weights must hold their declared layout (each
                # a no-op unless its sanitizer gate or SKYTPU_SANITIZERS
                # is on).
                sanitizers.audit_quiesce(self)
                time.sleep(idle_sleep)

    def generate_served(self, requests: List[Request],
                        gaps: Optional[Sequence[float]] = None
                        ) -> List[RequestResult]:
        """Run requests (distinct request_ids) through the serving loop
        on a thread of its own and return their results in request
        order.  gaps: seconds to wait before each request arrives (its
        arrival_time is stamped as it is queued); None queues them all
        before the loop starts.  Stall detection is progress-aware: the
        run fails after one window of cfg.run_stall_timeout_s in which
        no request finished, with stats() in the error; a long healthy
        run resets the window with every finish."""
        ids = [r.request_id for r in requests]
        if None in ids or len(set(ids)) != len(ids):
            raise ValueError('generate_served needs distinct request_ids')
        results: Dict[str, RequestResult] = {}
        done = threading.Event()

        def deliver(res: RequestResult) -> None:
            results[res.request_id] = res
            if len(results) == len(requests):
                done.set()

        q: 'queue.Queue[Request]' = queue.Queue()
        if gaps is None:
            for r in requests:
                q.put(r)
        stop = threading.Event()
        loop = threading.Thread(target=self.generate_stream,
                                args=(q, deliver, stop), daemon=True)
        loop.start()
        stall_s = self.cfg.run_stall_timeout_s
        last_done = 0
        try:
            for r, gap in zip(requests, gaps if gaps is not None else ()):
                time.sleep(float(gap))
                r.arrival_time = time.time()
                q.put(r)
            while not done.wait(timeout=stall_s):
                if len(results) == last_done:
                    raise RuntimeError(
                        f'serving stalled: {len(results)}/{len(requests)} '
                        f'requests finished, none in the last '
                        f'{stall_s:.1f}s (InferConfig.run_stall_timeout_s);'
                        f' engine stats: {self.stats()}')
                last_done = len(results)
        finally:
            stop.set()
            loop.join(timeout=30)
        return [results[i] for i in ids]

    def warmup(self) -> None:
        """Warm-up before serving: one prefill per configured bucket and
        the decode windows (warmup_decode), so the first real request
        finds cuBLAS handles, workspaces and the caching allocator's
        blocks in place.  Runs through offline generate(): call it
        before generate_stream starts."""
        for bi, bkt in enumerate(self.cfg.prefill_buckets):
            # Two tokens of room: the prompt lands in this bucket and
            # prompt + max_new_tokens fits the cache.
            n = min(bkt, self.cfg.max_cache_len - 2)
            self.generate([Request(tokens=[bi + 2] * n, max_new_tokens=2)])
        self.warmup_decode([1, 2, 3])
        self._warm_spec(min(max(self.cfg.prefill_buckets[0], 8), 64))

    def warmup_decode(self, tokens: Sequence[int]) -> None:
        """One short request (a prefill and a full decode window); with
        the adaptive window, one through the short window too; with
        chunked prefill, one prompt past the largest bucket (every chunk
        round has one [num_slots, C] shape)."""
        self.generate([Request(tokens=list(tokens), max_new_tokens=2)])
        if (self.cfg.adaptive_decode_window and self.cfg.decode_steps > 2
                and self.cfg.num_slots >= 2):
            self._arrivals_hint = 1  # lock-ok: warmup, pre-serving
            try:
                self.generate([Request(tokens=list(tokens),
                                       max_new_tokens=2)])
            finally:
                self._arrivals_hint = 0  # lock-ok: warmup, pre-serving
        if self.cfg.prefill_chunk:
            n = min(max(self.cfg.prefill_buckets) + 1,
                    self.cfg.max_cache_len - 1)
            base = list(tokens) or [1]
            rep = (base * (n // len(base) + 1))[:n]
            self.generate([Request(tokens=rep, max_new_tokens=1)])

    def _warm_spec(self, prompt_len: int) -> None:
        """Run the speculative verify once outside a measurement: a
        repetitive prompt makes sure it drafts, so _spec_step really
        dispatches.  The acceptance EMA and spec_stats are restored, so
        warm-up neither biases the policy nor shows in the counters."""
        if not self.cfg.draft_len:
            return
        ema = self._accept_ema
        stats = dict(self.spec_stats)
        rep = ([7, 8] * (prompt_len // 2 + 1))[:max(prompt_len, 4)]
        self.generate([Request(tokens=rep, max_new_tokens=4)])
        self._accept_ema = ema  # lock-ok: warmup must not bias policy
        self.spec_stats.update(stats)

    def benchmark_serving(self, num_requests: int = 64,
                          prompt_len: int = 219, new_tokens: int = 188,
                          qps: Optional[float] = None,
                          seed: int = 0) -> Dict[str, Any]:
        """Serving benchmark: random prompts arrive over time (Poisson at
        `qps` from a numpy seed; None = all at once) into the serving
        loop (generate_served, with its stall detection), so TTFT is a
        time to first token under load.  Reports req/s, tok/s, TTFT and
        TPOT p50/p99 (the JAX engine's keys)."""
        rng = np.random.default_rng(seed)
        reqs = [Request(tokens=rng.integers(
            0, self.model_config.vocab_size, size=prompt_len).tolist(),
                        max_new_tokens=new_tokens, request_id=str(i))
                for i in range(num_requests)]
        # Both phases (and both window variants) warm before the clock.
        self.warmup_decode(reqs[0].tokens)
        self._warm_spec(prompt_len)
        gaps = (rng.exponential(1.0 / qps, size=num_requests)
                if qps else np.zeros(num_requests))
        t0 = time.time()
        results = self.generate_served(reqs, gaps)
        elapsed = time.time() - t0
        out_tokens = sum(len(r.output_tokens) for r in results)
        in_tokens = sum(len(r.prompt_tokens) for r in results)
        ttfts = sorted(r.ttft_s for r in results)
        tpots = sorted(
            (r.latency_s - r.ttft_s) / max(len(r.output_tokens) - 1, 1)
            for r in results)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(len(xs) * p))]

        return {
            'requests_per_second': len(results) / elapsed,
            'output_tokens_per_second': out_tokens / elapsed,
            'input_tokens_per_second': in_tokens / elapsed,
            'ttft_median_s': pct(ttfts, 0.5),
            'ttft_p99_s': pct(ttfts, 0.99),
            'tpot_median_s': pct(tpots, 0.5),
            'tpot_p99_s': pct(tpots, 0.99),
            # None (JSON null) without an arrival rate: float('inf')
            # would serialize as the non-standard 'Infinity'.
            'offered_qps': qps if qps else None,
            'completed': len(results),
            'elapsed_s': elapsed,
        }

    def benchmark(self, num_requests: int = 32, prompt_len: int = 128,
                  new_tokens: int = 64, seed: int = 0) -> Dict[str, float]:
        """Offline benchmark: req/s, output tok/s and TTFT of random
        prompts (from a numpy seed) through generate()."""
        rng = np.random.default_rng(seed)
        reqs = [Request(tokens=rng.integers(
            0, self.model_config.vocab_size, size=prompt_len).tolist(),
                        max_new_tokens=new_tokens)
                for _ in range(num_requests)]
        # A full-length request first, so the timed run meets warm
        # buffers in the same prefill bucket.
        self.warmup_decode(reqs[0].tokens)
        self._warm_spec(prompt_len)
        t0 = time.time()
        results = self.generate(reqs)
        elapsed = time.time() - t0
        out_tokens = sum(len(r.output_tokens) for r in results)
        in_tokens = sum(len(r.prompt_tokens) for r in results)
        ttfts = sorted(r.ttft_s for r in results)
        return {
            'requests_per_second': num_requests / elapsed,
            'output_tokens_per_second': out_tokens / elapsed,
            'input_tokens_per_second': in_tokens / elapsed,
            'ttft_median_s': ttfts[len(ttfts) // 2],
            'ttft_p99_s': ttfts[min(len(ttfts) - 1,
                                    int(len(ttfts) * 0.99))],
            'elapsed_s': elapsed,
        }


def engine_from_name(model: str, cfg: Optional[InferConfig] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> InferenceEngine:
    cfg = cfg or InferConfig(model=model)
    return InferenceEngine(get_model_config(model), cfg,
                           generator=generator, device=device)
