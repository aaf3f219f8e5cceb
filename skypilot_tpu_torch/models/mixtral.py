"""Mixtral-family MoE decoder: Llama attention + top-k sparse SwiGLU
experts -- the PyTorch twin of ``skypilot_tpu/models/mixtral.py``.

Attention, RMSNorm, RoPE and the KV-cache contract are the llama module's
(``llama.Attention`` on ``config.as_llama()``), so ``llama.init_cache``
sizes Mixtral's cache and the engine serves it unchanged.  The FFN is a
``MoEBlock``:

- the no-cache forward (training, scoring) routes with GShard capacity:
  each expert takes at most ``capacity = max(1, int(cf * G * k / E))`` of
  the G tokens, ranked choice-major -- every token's first choice before
  any token's second, then by token index -- and a (token, choice) past
  its expert's capacity loses that expert's output (the residual
  carries the token).  The JAX module builds one-hot ``[G, E, C]``
  dispatch and combine tensors; here the same slots are computed as
  indices (``top_k_routing``) and the tokens move by gather and
  index_put, which costs O(k*G*E) memory instead of O(G^2).  The router's
  load-balance loss comes back beside the output;
- the cached forward (the engine's, any cache dtype) routes exactly: every
  expert runs on every token and the outputs are gate-weighted, so a
  served stream never loses an expert to another slot's traffic.

The router is an f32 dense layer on the f32 input, stored in f32;
``top_k`` runs on its softmax probabilities (a stable sort, so ties take
the lower expert as ``lax.top_k`` does) and the k gates are renormalized.
Expert weights are stacked ``[E, H, F]`` / ``[E, F, H]`` tensors in
``param_dtype``, the flax layout, multiplied with ``torch.bmm`` in the
compute dtype.
"""
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from skypilot_tpu_torch.models.llama import (Attention, KVCache, LlamaConfig,
                                             RankConfig, RMSNorm,
                                             _embed_and_head, _remat, embed,
                                             head_logits, tensor_degree)
from skypilot_tpu_torch.parallel.mesh import (Mesh, active_mesh,
                                              all_reduce_sum, copy_to_group,
                                              gathered, reduce_from_group,
                                              split, tensor_group)


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    name: str
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    router_aux_loss_weight: float = 0.02
    tie_embeddings: bool = False
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ('q_proj', 'k_proj', 'v_proj',
                                     'o_proj')
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        """The attention and norm hyperparameters of the shared llama
        blocks."""
        return LlamaConfig(
            name=self.name, vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
            lora_targets=self.lora_targets, dtype=self.dtype)

    def _params(self, experts: int) -> int:
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        d = self.head_dim_
        attn = h * d * (self.num_heads * 2 + self.num_kv_heads * 2)
        moe = experts * 3 * h * self.intermediate_size + \
            h * self.num_experts
        return l * (attn + moe + 2 * h) + v * h * 2 + h

    @property
    def num_params(self) -> int:
        return self._params(self.num_experts)

    @property
    def active_params(self) -> int:
        """Parameters one token touches (the compute-cost count)."""
        return self._params(self.experts_per_token)

    def flops_per_token(self, seq_len: int) -> float:
        attn_flops = 12 * self.num_layers * self.num_heads * \
            self.head_dim_ * seq_len
        return 6 * self.active_params + attn_flops


@dataclasses.dataclass(frozen=True)
class MixtralRankConfig(MixtralConfig):
    """A Mixtral config as one rank of a tensor-parallel split (as
    ``llama.RankConfig``): the rank holds num_experts / N whole experts,
    and its attention is a llama ``RankConfig``'s."""
    tensor_parallel: int = 1

    def as_llama(self) -> LlamaConfig:
        base = super().as_llama()
        return RankConfig(**{f.name: getattr(base, f.name)
                             for f in dataclasses.fields(base)},
                          tensor_parallel=self.tensor_parallel)


def capacity(config: MixtralConfig, num_tokens: int) -> int:
    """Slots per expert for a group of `num_tokens` tokens."""
    return max(1, int(config.capacity_factor * num_tokens *
                      config.experts_per_token / config.num_experts))


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(router_logits: torch.Tensor, k: int):
    """(softmax probs [G, E], renormalized top-k gates [G, k], their
    experts [G, k]), in f32."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


class Routing(NamedTuple):
    """Capacity routing of G tokens, per (choice, token) pair [k, G]:
    ``expert`` its expert, ``slot`` its rank within that expert (choice-
    major), ``kept`` whether the rank is under ``capacity``, ``gate`` its
    renormalized router probability (f32); ``aux`` the load-balance loss.
    The JAX module's one-hot dispatch [G, E, C] is 1 at (token, expert,
    slot) of every kept pair, and its combine holds the pair's gate
    there."""
    expert: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    capacity: int


def top_k_routing(router_logits: torch.Tensor, num_experts: int, k: int,
                  capacity: int, mesh: Optional[Mesh] = None,
                  rows: int = 1) -> Routing:
    """GShard routing from router logits [G, E], as the JAX module's
    ``top_k_routing``: the slot of each (choice, token) is its rank among
    the pairs routed to its expert in (choice, token) order; the aux loss
    is E * sum_e(top-1 share_e * mean prob_e) over every token (no mask).

    Under a mesh (training) the G tokens are this rank's part of the
    GLOBAL token group, which the JAX module routes whole: its `rows` rows
    of the batch (its 'data'/'fsdp' block) and, under 'seq', one sequence
    block of each; `capacity` is the global group's.  One all-gather of
    the per-row counts gives each pair its global slot, and ``kept`` is
    global slot < capacity, while ``slot`` stays the rank-local one that
    places the kept pairs (they come first within each expert, so their
    local slots stay below ``capacity``).  The aux loss's sums are
    all-reduced over the group, the router's part differentiably."""
    probs, gate_vals, gate_idx = _gates(router_logits, k)
    expert = gate_idx.T.contiguous()                            # [k, G]
    flat = expert.reshape(-1)
    # Rank within the expert: a running count over the flattened
    # choice-major [k*G, E] one-hot, read at the pair's own expert.
    ranks = torch.cumsum(F.one_hot(flat, num_experts), dim=0) - 1
    slot = ranks.gather(1, flat[:, None]).view_as(expert)
    top1 = torch.bincount(expert[0], minlength=num_experts).float()
    prob_sum = probs.sum(0)
    tokens = float(expert.shape[1])
    global_slot = slot
    if mesh is not None:
        group = mesh.group('data', 'fsdp', 'seq')
        global_slot = _global_slots(expert, num_experts, rows, mesh, group)
        dist.all_reduce(top1, group=group)
        prob_sum = all_reduce_sum(prob_sum, group)
        tokens *= mesh.size('data', 'fsdp', 'seq')
    aux = torch.sum((top1 / tokens) * (prob_sum / tokens)) * num_experts
    return Routing(expert, slot, global_slot < capacity, gate_vals.T, aux,
                   capacity)


def _global_slots(expert: torch.Tensor, num_experts: int, rows: int,
                  mesh: Mesh, group) -> torch.Tensor:
    """Each (choice, token) pair's slot [k, G] in the global token group
    (see ``top_k_routing``): the pairs of its expert before it in
    (choice, global token) order, from every rank's per-row counts."""
    k, g = expert.shape
    s = g // rows
    ndp, nseq = mesh.size('data', 'fsdp'), mesh.size('seq')
    onehot = F.one_hot(expert, num_experts).view(k, rows, s, num_experts)
    in_row = (torch.cumsum(onehot, 2) - onehot).gather(
        3, expert.view(k, rows, s, 1)).view(k, g)
    counts = onehot.sum(2)                                      # [k, b, E]
    every = [torch.empty_like(counts) for _ in range(ndp * nseq)]
    dist.all_gather(every, counts.contiguous(), group=group)
    # Segments (one sequence block of one row) in global token order.
    every = torch.stack(every).view(ndp, nseq, k, rows, num_experts)
    every = every.permute(2, 0, 3, 1, 4).reshape(k, -1, num_experts)
    seg_prefix = torch.cumsum(every, 1) - every
    total = every.sum(1)                                        # [k, E]
    base = torch.cumsum(total, 0) - total
    seg = ((mesh.coord('data', 'fsdp') * rows +
            torch.arange(rows, device=expert.device)) * nseq +
           mesh.coord('seq'))
    before = seg_prefix[:, seg].gather(
        2, expert.view(k, rows, s)).view(k, g)
    return base.gather(1, expert) + before + in_row


class MoEBlock(nn.Module):
    """Top-k sparse SwiGLU experts (see the module docstring).  forward
    returns (out, aux): aux is the router's load-balance loss times
    ``router_aux_loss_weight`` on the capacity path, None on the exact
    one."""

    def __init__(self, config: MixtralConfig, device=None, param_dtype=None):
        super().__init__()
        cfg = self.config = config
        pd = param_dtype or cfg.dtype
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = nn.Linear(h, e, bias=False, dtype=torch.float32,
                                device=device)
        # A rank of a tensor-parallel split holds its whole experts.
        e = split(e, tensor_degree(cfg))

        def stacked(*shape):
            return nn.Parameter(torch.empty(shape, dtype=pd, device=device))

        self.w_gate = stacked(e, h, f)
        self.w_up = stacked(e, h, f)
        self.w_down = stacked(e, f, h)

    def _experts(self, x: torch.Tensor, weights=None) -> torch.Tensor:
        """SwiGLU of every expert on its rows: x [E, N, H] -> [E, N, H]
        (`weights`: this rank's (w_gate, w_up, w_down) experts)."""
        dt = self.config.dtype
        w_gate, w_up, w_down = weights or (self.w_gate, self.w_up,
                                           self.w_down)
        hmid = F.silu(torch.bmm(x, w_gate.to(dt))) * \
            torch.bmm(x, w_up.to(dt))
        return torch.bmm(hmid, w_down.to(dt))

    def forward(self, x: torch.Tensor, exact: bool = False):
        """Under a mesh (training), the routing is the global token
        group's (``top_k_routing`` over the mesh), and with expert weights
        sharded over 'tensor' (expert parallelism, the rule ('expert',
        'tensor')) each rank runs its own experts on the replicated
        tokens and the partial outputs are summed over the tensor group;
        the router and its aux loss stay replicated.

        A rank of a tensor-parallel split (``MixtralRankConfig``, serving)
        holds its experts as plain tensors and does the same: its experts
        on the replicated tokens, their gates, the sum over the group."""
        cfg = self.config
        b, s, h = x.shape
        g, e, dt = b * s, cfg.num_experts, cfg.dtype
        xf = x.reshape(g, h)
        logits = self.router(xf.float())
        xc = xf.to(dt)
        local = self.w_gate.shape[0]      # a DTensor's is the global one
        if exact:
            _, gate_vals, gate_idx = _gates(logits, cfg.experts_per_token)
            gates = torch.zeros_like(logits).scatter(1, gate_idx, gate_vals)
            if local < e:
                group, rank = tensor_group()
                gates = gates[:, rank * local:(rank + 1) * local]
            out = self._experts(xc.expand(local, g, h))
            out = torch.einsum('egh,ge->gh', out, gates.to(dt))
            if local < e:
                out = reduce_from_group(out, group)
            return out.reshape(b, s, h), None
        mesh = active_mesh()
        group_tokens = g if mesh is None else \
            g * mesh.size('data', 'fsdp', 'seq')
        r = top_k_routing(logits, e, cfg.experts_per_token,
                          capacity(cfg, group_tokens), mesh, rows=b)
        weights = (self.w_gate, self.w_up, self.w_down)
        first, gate = 0, r.gate
        if isinstance(self.w_gate, DTensor):      # experts over 'tensor'
            group = mesh.group('tensor')
            weights = tuple(w.to_local() for w in weights)
            local = weights[0].shape[0]
            first = mesh.coord('tensor') * local
            xc, gate = copy_to_group(xc, group), copy_to_group(gate, group)
        elif local < e:                          # a rank's serving experts
            first = tensor_group()[1] * local
        mine = r.kept & (r.expert >= first) & (r.expert < first + local)
        rows = min(r.capacity, g)
        tok = torch.arange(g, device=x.device).expand_as(r.expert)
        expert_in = xc.new_zeros(local, rows, h)
        expert_in[r.expert[mine] - first, r.slot[mine]] = xc[tok[mine]]
        expert_out = self._experts(expert_in, weights)
        picked = expert_out[(r.expert - first).clamp(0, local - 1),
                            r.slot.clamp_max(rows - 1)]
        weight = torch.where(mine, gate, 0.0).to(dt)           # [k, G]
        out = (weight[..., None].float() * picked.float()).sum(0).to(dt)
        if first or local < e:
            out = reduce_from_group(out, mesh.group('tensor'))
        return out.reshape(b, s, h), r.aux * cfg.router_aux_loss_weight


class MixtralLayer(nn.Module):

    def __init__(self, config: MixtralConfig, device=None, param_dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.norm_eps
        self.input_norm = RMSNorm(h, eps, device)
        self.attn = Attention(config.as_llama(), device, param_dtype)
        self.post_attn_norm = RMSNorm(h, eps, device)
        self.moe = MoEBlock(config, device, param_dtype)

    def forward(self, x, positions, kv_cache=None):
        """(out, new_cache) with a cache (exact routing), else (out, aux)
        (capacity routing): aux comes back as an output, so a
        checkpointed call's recomputation leaves it as it was."""
        attn_in = self.input_norm(x)
        if kv_cache is not None:
            attn_out, extra = self.attn(attn_in, positions, kv_cache)
        else:
            attn_out = self.attn(attn_in, positions)
        h = x + attn_out
        moe_out, aux = self.moe(self.post_attn_norm(h),
                                exact=kv_cache is not None)
        return h + moe_out, (extra if kv_cache is not None else aux)


class Mixtral(nn.Module):
    """MoE decoder LM.  forward(tokens [B, S]) -> logits [B, S, V] f32.

    Parameter names mirror the flax tree (``layers.{i}`` for
    ``layer_{i}``, ``moe.router.weight`` for the router kernel
    transposed, ``moe.w_gate``/``w_up``/``w_down`` as stored there);
    ``models.convert`` maps one onto the other."""

    def __init__(self, config: MixtralConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        _embed_and_head(self, config, device)
        self.layers = nn.ModuleList(
            MixtralLayer(config, device, param_dtype)
            for _ in range(config.num_layers))
        self.final_norm = RMSNorm(h, config.norm_eps, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, hidden_only: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                return_aux: bool = False,
                head: Optional[Callable] = None):
        """Scoring and training: forward(tokens) -> logits (capacity
        routing); with return_aux, (logits, aux) where aux is the sum over
        layers of each router's weighted load-balance loss (the JAX
        module's sown ``router_aux_loss`` values, summed as its trainer
        sums them).  hidden_only=True returns the final-norm hidden states
        [B, S, H] instead of logits.

        Incremental inference: forward(tokens, positions, cache) ->
        (logits, cache), the llama module's cache contract, with exact
        routing.  Token ids map as the llama module's do.  adapter_ids
        must be None: multi-LoRA serves the llama family only.  ``head``
        is the llama module's (the trainer's chunked loss under a
        mesh)."""
        if adapter_ids is not None:
            raise TypeError('multi-LoRA serving supports the llama family; '
                            'got MixtralConfig')
        cfg = self.config
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        vocab = cfg.vocab_size
        tokens = torch.where(tokens < 0, tokens + vocab,
                             tokens).clamp(0, vocab - 1)
        x = embed(self, tokens).to(cfg.dtype)
        new_cache, aux = [], torch.zeros((), device=tokens.device)
        # Every layer checkpointed under grad, as the JAX module's nn.remat.
        remat = None if cache is not None else _remat('full')
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x, layer_cache = layer(x, positions, cache[i])
                new_cache.append(layer_cache)
                continue
            x, layer_aux = (remat(layer, x, positions) if remat is not None
                            else layer(x, positions))
            aux = aux + layer_aux
        x = self.final_norm(x)
        if head is not None:
            out = head(x, self.output_projection())
        elif hidden_only:
            out = x
        else:
            out = head_logits(self, x)
        if cache is not None:
            return out, new_cache
        return (out, aux) if return_aux else out

    def output_projection(self) -> torch.Tensor:
        """The [H, V] head matrix (``Llama.output_projection``)."""
        if self.lm_head is not None:
            return gathered(self.lm_head.weight).T
        return gathered(self.embedding).T
