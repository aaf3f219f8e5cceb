"""HuggingFace checkpoint import -- the port's counterpart of
``skypilot_tpu/models/hf_import.py`` (llama, qwen2, mistral, gemma, gpt2,
mixtral and bert checkpoints).

Two layers, as in the JAX package:

- ``convert_state_dict(cfg, state_dict)``: HF parameter names -> the
  port's ``Llama`` state_dict, in torch.  HF's ``[out, in]`` linears are
  already ``nn.Linear``'s layout, so weights keep their shape and stored
  dtype (or take ``param_dtype``); RMSNorm weights become the port's
  ``w - 1`` form in f32 (Gemma checkpoints already store it:
  ``hf_norm_zero_centered``).  GPT-2's Conv1D weights are stored
  ``[in, out]`` and are transposed; its LayerNorms keep weight and bias.
  Mixtral's experts (``w1``/``w3``/``w2`` = gate/up/down) are transposed
  and stacked into the port's ``[E, H, F]``/``[E, F, H]`` tensors.
  BERT's encoder lands under ``bert.`` with its LayerNorms' weight and
  bias as scale and bias, and the MLM head (``transform``,
  ``transform_norm``, ``decoder``) when the checkpoint has one.  No
  transformers import.
- ``load_hf_model(name_or_path)``: loads a transformers checkpoint (a
  local directory, or a model id already in the local cache: nothing is
  downloaded; bert through ``AutoModelForMaskedLM``, the rest through
  ``AutoModelForCausalLM``), derives the config with ``config_from_hf``
  and converts.
  ``transformers`` is imported inside it only.

RoPE is the rotate-half convention on both sides: no head-dim permutation.
HF's Mixtral routes without a capacity, so ``config_from_hf`` sets the
drop-free ``capacity_factor = E / k``, as the JAX importer does.
"""
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.models.bert import BertConfig
from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.models.mixtral import MixtralConfig
from skypilot_tpu_torch.models.registry import ModelConfig

StateDict = Dict[str, torch.Tensor]

# HF model types the JAX server takes for --hf-model: the causal LMs.
CAUSAL_LM = ('llama', 'qwen2', 'mistral', 'mixtral', 'gpt2', 'gemma')

# Non-weight buffers that legitimately remain unconverted (matched as
# suffixes against checkpoint keys).
_IGNORABLE_SUFFIXES = (
    'rotary_emb.inv_freq',          # old llama/mixtral checkpoints
    '.attn.bias',                   # gpt2 causal-mask buffer
    '.attn.masked_bias',            # gpt2 mask fill buffer
    'embeddings.position_ids',      # bert position buffer
    'cls.predictions.decoder.bias',  # same tensor as cls.predictions.bias
)


class _SD:
    """state_dict view that strips an optional prefix and tracks usage."""

    def __init__(self, sd: Dict[str, Any]):
        self._sd = dict(sd)
        self.used = set()

    def __call__(self, key: str):
        for k in (key, f'model.{key}', f'transformer.{key}'):
            if k in self._sd:
                self.used.add(k)
                return self._sd[k]
        raise KeyError(
            f'{key!r} not in checkpoint (tried bare/model./transformer. '
            f'prefixes); sample keys: {sorted(self._sd)[:5]}')

    def has(self, key: str) -> bool:
        return any(k in self._sd for k in (key, f'model.{key}',
                                           f'transformer.{key}'))

    def unused(self):
        return sorted(set(self._sd) - self.used)


def _reader(sd: _SD, param_dtype: Optional[torch.dtype]):
    """sd(key) as a tensor in param_dtype (None keeps its stored dtype)."""
    def w(key):
        t = torch.as_tensor(sd(key)).detach()
        return t if param_dtype is None else t.to(param_dtype)
    return w


def _convert_llama(cfg, sd: _SD,
                   param_dtype: Optional[torch.dtype]) -> StateDict:
    """Llama and Mixtral: the shared attention and norms, then each
    layer's MLP or sparse MoE block."""
    w = _reader(sd, param_dtype)
    zero_centered = getattr(cfg, 'hf_norm_zero_centered', False)

    def norm(key):
        # As the JAX importer: the weight in the target dtype, then the
        # '+1' reparam in f32 (the subtraction must not round in bf16).
        t = w(key).float()
        return t if zero_centered else t - 1.0

    out: StateDict = {'embedding': w('embed_tokens.weight'),
                      'final_norm.scale': norm('norm.weight')}
    if not cfg.tie_embeddings:
        out['lm_head.weight'] = w('lm_head.weight')
    for i in range(cfg.num_layers):
        p = f'layers.{i}.'           # the same layer prefix on both sides
        out[p + 'input_norm.scale'] = norm(p + 'input_layernorm.weight')
        out[p + 'post_attn_norm.scale'] = norm(
            p + 'post_attention_layernorm.weight')
        for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            out[f'{p}attn.{name}.weight'] = w(f'{p}self_attn.{name}.weight')
        if getattr(cfg, 'attention_bias', False):   # Qwen2-style biases
            for name in ('q_proj', 'k_proj', 'v_proj'):
                out[f'{p}attn.{name}.bias'] = w(f'{p}self_attn.{name}.bias')
        if isinstance(cfg, MixtralConfig):
            moe = p + 'block_sparse_moe.'
            out[p + 'moe.router.weight'] = w(moe + 'gate.weight')
            # HF expert naming: w1 = gate, w3 = up, w2 = down.
            for name, hf in (('w_gate', 'w1'), ('w_up', 'w3'),
                             ('w_down', 'w2')):
                out[f'{p}moe.{name}'] = torch.stack([
                    w(f'{moe}experts.{e}.{hf}.weight').T
                    for e in range(cfg.num_experts)])
            continue
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            out[f'{p}mlp.{name}.weight'] = w(f'{p}mlp.{name}.weight')
    return out


def _convert_gpt2(cfg: GPT2Config, sd: _SD,
                  param_dtype: Optional[torch.dtype]) -> StateDict:
    w = _reader(sd, param_dtype)
    out: StateDict = {'wte': w('wte.weight'), 'wpe': w('wpe.weight')}

    def norm(name):
        out[name + '.scale'] = w(name + '.weight')
        out[name + '.bias'] = w(name + '.bias')

    norm('ln_f')
    for i in range(cfg.num_layers):
        p = f'h.{i}.'                # the same block prefix on both sides
        norm(p + 'ln_1')
        norm(p + 'ln_2')
        for n in ('attn.c_attn', 'attn.c_proj', 'mlp.c_fc', 'mlp.c_proj'):
            # HF GPT-2's Conv1D stores [in, out]: transposed to [out, in].
            out[f'{p}{n}.weight'] = w(f'{p}{n}.weight').T
            out[f'{p}{n}.bias'] = w(f'{p}{n}.bias')
    return out


def _convert_bert(cfg: BertConfig, sd: _SD,
                  param_dtype: Optional[torch.dtype]) -> StateDict:
    """The encoder under ``bert.``, and the MLM head when the checkpoint
    has one: HF's linears are already ``[out, in]``."""
    w = _reader(sd, param_dtype)
    out: StateDict = {}

    def linear(dst, src):
        out[dst + '.weight'] = w(src + '.weight')
        out[dst + '.bias'] = w(src + '.bias')

    def norm(dst, src):
        out[dst + '.scale'] = w(src + '.weight')
        out[dst + '.bias'] = w(src + '.bias')

    for name in ('word_embeddings', 'position_embeddings',
                 'token_type_embeddings'):
        out['bert.' + name] = w(f'bert.embeddings.{name}.weight')
    norm('bert.embeddings_norm', 'bert.embeddings.LayerNorm')
    for i in range(cfg.num_layers):
        p, q = f'bert.encoder.layer.{i}.', f'bert.layers.{i}.'
        for name in ('query', 'key', 'value'):
            linear(f'{q}attention.{name}', f'{p}attention.self.{name}')
        linear(q + 'attention.output', p + 'attention.output.dense')
        norm(q + 'attention_norm', p + 'attention.output.LayerNorm')
        linear(q + 'intermediate', p + 'intermediate.dense')
        linear(q + 'output', p + 'output.dense')
        norm(q + 'output_norm', p + 'output.LayerNorm')
    if sd.has('cls.predictions.transform.dense.weight'):   # MLM head
        linear('transform', 'cls.predictions.transform.dense')
        norm('transform_norm', 'cls.predictions.transform.LayerNorm')
        out['decoder.weight'] = w('cls.predictions.decoder.weight')
        out['decoder.bias'] = w('cls.predictions.bias')
    return out


def convert_state_dict(cfg: ModelConfig, state_dict: Dict[str, Any],
                       strict: bool = True,
                       param_dtype: Optional[torch.dtype] = None
                       ) -> StateDict:
    """An HF torch state_dict -> the port's state_dict of the config's
    family.

    strict: raise if the checkpoint holds weights with no target (q/k/v
    biases the config does not declare, extra heads): dropping them
    silently would serve a wrong model.  Pass False to convert anyway.

    param_dtype: the dtype of the converted weights (None keeps each
    tensor's stored dtype); norm scales are f32 regardless."""
    conv = {LlamaConfig: _convert_llama, GPT2Config: _convert_gpt2,
            MixtralConfig: _convert_llama,
            BertConfig: _convert_bert}.get(type(cfg))
    if conv is None:
        raise ValueError(
            f'no HF converter for {type(cfg).__name__}; supported: '
            "['LlamaConfig', 'GPT2Config', 'MixtralConfig', 'BertConfig']")
    sd = _SD(state_dict)
    out = {k: v.contiguous() for k, v in conv(cfg, sd, param_dtype).items()}
    # GPT-2 is always weight-tied (no config field).
    tied = isinstance(cfg, GPT2Config) or getattr(cfg, 'tie_embeddings',
                                                  False)
    leftover = [
        k for k in sd.unused()
        if not k.endswith(_IGNORABLE_SUFFIXES)
        and not (tied and k.endswith('lm_head.weight'))
    ]
    if leftover and strict:
        raise ValueError(
            f'checkpoint weights with no converter target (would be '
            f'silently dropped): {leftover[:8]}'
            f'{" ..." if len(leftover) > 8 else ""}; pass strict=False '
            f'to convert anyway')
    return out


def config_from_hf(hf_config, name: Optional[str] = None) -> ModelConfig:
    """Map a transformers config object to the port's config of its
    family, with the JAX importer's refusals word for word."""
    mt = getattr(hf_config, 'model_type', None)
    name = name or f'hf-{mt}'
    if mt in ('llama', 'qwen2', 'mistral'):
        # Qwen2 is llama + unconditional q/k/v biases; Mistral is llama +
        # sliding-window attention.
        if mt == 'qwen2' and getattr(hf_config, 'use_sliding_window',
                                     False):
            # Qwen2's flag windows only SOME layers (per
            # max_window_layers): a uniform band would be wrong.
            raise ValueError(
                'qwen2 use_sliding_window=true is layer-selective and '
                'not implemented; refusing to load with wrong masking')
        sliding = (getattr(hf_config, 'sliding_window', None)
                   if mt == 'mistral' else None)
        scaling_kw = {}
        rs = getattr(hf_config, 'rope_scaling', None)
        rope_type = rs.get('rope_type', rs.get('type')) if rs else None
        if rope_type == 'default':   # HF 'default' == unscaled RoPE
            rs = None
        if rs:
            if rope_type != 'llama3':
                raise ValueError(
                    f'unsupported rope_scaling type {rope_type!r} (only '
                    f"'llama3' frequency scaling is implemented); refusing "
                    'to load with wrong RoPE frequencies')
            scaling_kw = dict(
                rope_scaling_factor=float(rs['factor']),
                rope_scaling_low_freq=float(rs['low_freq_factor']),
                rope_scaling_high_freq=float(rs['high_freq_factor']),
                rope_scaling_original_max_len=int(
                    rs['original_max_position_embeddings']))
        return LlamaConfig(
            name=name, vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=getattr(hf_config, 'head_dim', None),
            max_seq_len=hf_config.max_position_embeddings,
            rope_theta=getattr(hf_config, 'rope_theta', 10000.0),
            norm_eps=hf_config.rms_norm_eps,
            attention_bias=(mt == 'qwen2' or
                            getattr(hf_config, 'attention_bias', False)),
            tie_embeddings=getattr(hf_config, 'tie_word_embeddings', False),
            sliding_window=sliding,
            **scaling_kw)
    if mt == 'gemma':
        # Gemma: llama topology + GeGLU, sqrt(H)-scaled embeddings, an
        # explicit head_dim, tied embeddings and zero-centered norm
        # weights.  The activation comes from the checkpoint: early
        # configs run exact GELU.
        hf_act = (getattr(hf_config, 'hidden_activation', None) or
                  getattr(hf_config, 'hidden_act', 'gelu_pytorch_tanh'))
        act = {'gelu_pytorch_tanh': 'gelu_tanh', 'gelu_tanh': 'gelu_tanh',
               'gelu': 'gelu', 'gelu_new': 'gelu_tanh',
               'silu': 'silu'}.get(hf_act)
        if act is None:
            raise ValueError(
                f'unsupported gemma hidden activation {hf_act!r}; '
                'refusing to load with a wrong MLP')
        return LlamaConfig(
            name=name, vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=getattr(hf_config, 'head_dim', 256),
            max_seq_len=hf_config.max_position_embeddings,
            rope_theta=getattr(hf_config, 'rope_theta', 10000.0),
            norm_eps=hf_config.rms_norm_eps,
            tie_embeddings=True,
            hidden_act=act,
            scale_embeddings=True,
            hf_norm_zero_centered=True)
    if mt == 'gpt2':
        return GPT2Config(
            name=name, vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.n_embd, num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head, max_seq_len=hf_config.n_positions,
            norm_eps=hf_config.layer_norm_epsilon)
    if mt == 'mixtral':
        return MixtralConfig(
            name=name, vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            num_experts=hf_config.num_local_experts,
            experts_per_token=hf_config.num_experts_per_tok,
            # No dropped tokens: HF routes without a capacity.
            capacity_factor=float(hf_config.num_local_experts) /
            hf_config.num_experts_per_tok,
            max_seq_len=hf_config.max_position_embeddings,
            rope_theta=getattr(hf_config, 'rope_theta', 1e6),
            norm_eps=hf_config.rms_norm_eps,
            router_aux_loss_weight=getattr(hf_config,
                                           'router_aux_loss_coef', 0.02),
            tie_embeddings=getattr(hf_config, 'tie_word_embeddings', False))
    if mt == 'bert':
        return BertConfig(
            name=name, vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_seq_len=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            norm_eps=hf_config.layer_norm_eps)
    raise ValueError(f'unsupported HF model_type: {mt!r}')


def load_hf_model(name_or_path: str, dtype: Optional[torch.dtype] = None,
                  param_dtype: Optional[torch.dtype] = None
                  ) -> Tuple[ModelConfig, StateDict]:
    """Load a transformers checkpoint (a local directory or a warm cache)
    and return ``(config, state_dict)``.  The config comes first, from
    ``config.json`` alone, so a checkpoint of a family the port does not
    have fails before any weight is read.

    dtype: the config's compute dtype; param_dtype: the dtype the
    converted weights are stored in (see convert_state_dict)."""
    import transformers
    hf_cfg = transformers.AutoConfig.from_pretrained(name_or_path)
    cfg = config_from_hf(hf_cfg, name=name_or_path)
    auto = (transformers.AutoModelForMaskedLM
            if isinstance(cfg, BertConfig)
            else transformers.AutoModelForCausalLM)
    # dtype='auto' keeps the checkpoint's stored precision.  The keyword
    # was renamed torch_dtype -> dtype in transformers 4.56, and
    # from_pretrained swallows unknown keywords, so pick it by version.
    ver = tuple(int(x) for x in transformers.__version__.split('.')[:2])
    dtype_kw = 'dtype' if ver >= (4, 56) else 'torch_dtype'
    model = auto.from_pretrained(name_or_path, low_cpu_mem_usage=True,
                                 **{dtype_kw: 'auto'})
    # If the keyword was ignored anyway, the model comes back fp32 though
    # the checkpoint stores a narrower dtype.
    stored = getattr(hf_cfg, 'dtype', None) or getattr(
        hf_cfg, 'torch_dtype', None)
    first_param = next(iter(model.parameters()), None)
    loaded = None if first_param is None else first_param.dtype
    if (stored is not None and loaded is not None
            and str(stored).replace('torch.', '') != 'float32'
            and loaded == torch.float32):
        import warnings
        warnings.warn(
            f'{name_or_path}: checkpoint stores {stored} but transformers '
            f'{transformers.__version__} loaded fp32 (dtype kwarg ignored) '
            '— converting; expect a transient 2x host-RAM peak')
        model = model.to(stored if not isinstance(stored, str)
                         else getattr(torch, stored))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = convert_state_dict(cfg, model.state_dict(),
                                param_dtype=param_dtype)
    del model
    return cfg, params
