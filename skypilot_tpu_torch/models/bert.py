"""BERT-family encoder: a bidirectional transformer with MLM and
sequence-classification heads -- the PyTorch twin of
``skypilot_tpu/models/bert.py``.

Numerics follow the JAX module:

- the embedding sum runs in f32 (word, then position, then token type;
  type ids default to zeros), then the f32 ``embeddings_norm``, then the
  cast to ``config.dtype``.  Token ids map as the JAX gather does: a
  negative id wraps once, then clamps into the table.  A sequence past
  ``max_seq_len`` raises the JAX ``ValueError``;
- the layers are post-LN: ``x + sublayer(x)`` summed in the compute
  dtype, then a LayerNorm computed in f32 (flax's one-pass variance,
  ``gpt2.layer_norm``), cast back.  GELU is exact (erf);
- self-attention without a mask runs ``ops.flash_attention(causal=
  False)`` (the Hopper kernels on a CUDA tensor).  With a padding mask it
  is the JAX module's plain masked path: the scores in the compute dtype,
  *then* scaled by d^-0.5, a -1e30 bias on masked keys, softmax in f32,
  the probabilities cast back to v's dtype.  It launches no kernel;
- the MLM head: ``transform`` and GELU in the compute dtype, the f32
  ``transform_norm`` output kept in f32, and an f32 ``decoder``;
- the classifier: tanh over the ``pooler`` of ``x[:, 0]`` in the compute
  dtype, then an f32 ``classifier``.

Every layer is checkpointed under grad, as the JAX module's ``nn.remat``:
a training step runs each layer's attention forward twice.

Parameter names mirror the flax tree (``layers.{i}`` for ``layer_{i}``;
``query``/``key``/``value`` and ``output`` as ``[heads*D, H]`` and
``[H, heads*D]`` linears); ``models.convert`` maps one onto the other.
Projection weights are stored in ``param_dtype`` (default
``config.dtype``); the embeddings, LayerNorms, ``decoder`` and
``classifier`` are f32.
"""
import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from skypilot_tpu_torch.models.gpt2 import LayerNorm, _gather_index
from skypilot_tpu_torch.models.llama import Linear, _remat
from skypilot_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_classes: int = 2          # classification head width
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_heads


class BertSelfAttention(nn.Module):

    def __init__(self, config: BertConfig, device=None, param_dtype=None):
        super().__init__()
        cfg = self.config = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        hd = cfg.num_heads * cfg.head_dim_
        self.query = Linear(h, hd, True, cfg.dtype, pd, device)
        self.key = Linear(h, hd, True, cfg.dtype, pd, device)
        self.value = Linear(h, hd, True, cfg.dtype, pd, device)
        self.output = Linear(hd, h, True, cfg.dtype, pd, device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        d = cfg.head_dim_
        q, k, v = (proj(x).view(b, s, cfg.num_heads, d).transpose(1, 2)
                   for proj in (self.query, self.key, self.value))
        if attention_mask is not None:
            scores = torch.einsum('bhqd,bhkd->bhqk', q, k) * d ** -0.5
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               -1e30)
            probs = torch.softmax(scores.float() + bias, dim=-1)
            out = torch.einsum('bhqk,bhkd->bhqd', probs.to(v.dtype), v)
        else:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)
        return self.output(out.transpose(1, 2).reshape(b, s, -1))


class BertLayer(nn.Module):

    def __init__(self, config: BertConfig, device=None, param_dtype=None):
        super().__init__()
        cfg = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        self.attention = BertSelfAttention(cfg, device, param_dtype)
        self.attention_norm = LayerNorm(h, cfg.norm_eps, device)
        self.intermediate = Linear(h, cfg.intermediate_size, True,
                                   cfg.dtype, pd, device)
        self.output = Linear(cfg.intermediate_size, h, True, cfg.dtype, pd,
                             device)
        self.output_norm = LayerNorm(h, cfg.norm_eps, device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        dt = x.dtype
        x = self.attention_norm(x + self.attention(x, attention_mask)).to(dt)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_norm(x + h).to(dt)


class Bert(nn.Module):
    """Encoder.  forward(tokens [B, S], type_ids?, attention_mask?) ->
    hidden states [B, S, H] in ``config.dtype``."""

    def __init__(self, config: BertConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size

        def table(n):
            return nn.Parameter(torch.empty(n, h, dtype=torch.float32,
                                            device=device))

        self.word_embeddings = table(cfg.vocab_size)
        self.position_embeddings = table(cfg.max_seq_len)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        self.embeddings_norm = LayerNorm(h, cfg.norm_eps, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device, param_dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        s = tokens.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f'sequence length {s} exceeds max_seq_len {cfg.max_seq_len}')
        if type_ids is None:
            type_ids = torch.zeros_like(tokens)
        positions = torch.arange(s, device=tokens.device)
        x = (self.word_embeddings[_gather_index(tokens, cfg.vocab_size)]
             + self.position_embeddings[positions][None]
             + self.token_type_embeddings[
                 _gather_index(type_ids, cfg.type_vocab_size)])
        x = self.embeddings_norm(x).to(cfg.dtype)
        remat = _remat('full')
        for layer in self.layers:
            x = (remat(layer, x, attention_mask) if remat is not None
                 else layer(x, attention_mask))
        return x


class BertForMaskedLM(nn.Module):
    """forward(tokens, type_ids?, attention_mask?) -> f32 logits
    [B, S, V]."""

    def __init__(self, config: BertConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        self.bert = Bert(cfg, device, param_dtype)
        self.transform = Linear(h, h, True, cfg.dtype, pd, device)
        self.transform_norm = LayerNorm(h, cfg.norm_eps, device)
        self.decoder = Linear(h, cfg.vocab_size, True, torch.float32,
                              torch.float32, device)

    def forward(self, tokens, type_ids=None, attention_mask=None):
        x = self.bert(tokens, type_ids, attention_mask)
        x = self.transform_norm(F.gelu(self.transform(x)))
        return self.decoder(x)


class BertForSequenceClassification(nn.Module):
    """IMDB-style classifier: [CLS] pooling and a linear head.
    forward(tokens, type_ids?, attention_mask?) -> f32 logits
    [B, num_classes]."""

    def __init__(self, config: BertConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        h, pd = cfg.hidden_size, param_dtype or cfg.dtype
        self.bert = Bert(cfg, device, param_dtype)
        self.pooler = Linear(h, h, True, cfg.dtype, pd, device)
        self.classifier = Linear(h, cfg.num_classes, True, torch.float32,
                                 torch.float32, device)

    def forward(self, tokens, type_ids=None, attention_mask=None):
        x = self.bert(tokens, type_ids, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled.float())


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM loss: cross-entropy on the masked positions only."""
    from skypilot_tpu_torch.train.trainer import cross_entropy_loss
    return cross_entropy_loss(logits, targets, mask)
