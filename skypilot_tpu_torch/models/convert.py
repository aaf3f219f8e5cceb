"""Weights for the port's models (``Llama``, ``GPT2``, ``Mixtral``,
``Bert``, ``ResNet``): carried across from the JAX package's flax tree, or
drawn at random with the JAX package's distributions.

``state_dict_from_jax`` is the inverse of the layout mapping in
``skypilot_tpu/models/hf_import.py`` (``_linear``, ``_qkv_kernel``,
``_oproj_kernel``): flax ``[in, out]`` kernels become ``nn.Linear``
``[out, in]`` weights, the per-head q/k/v kernels ``[H, heads, D]``
become ``[heads*D, H]`` and o_proj ``[heads, D, H]`` becomes
``[H, heads*D]``.  RMSNorm scales keep their stored ``w - 1`` form.
An int8 tree's ``kernel_q``/``scale`` leaves (``QuantDenseGeneral``) map
the same way to ``weight_q`` (int8) and ``scale`` (f32, flattened over the
output dims), with or without LoRA adapters beside them.
LoRA adapter leaves (``*_lora/lora_a``, ``lora_b``, single or stacked)
keep their shapes, which are already flattened over the feature dims;
``train.lora.extract_adapter_tree`` is the way back for them (the
``.npz`` writer's input).

GPT-2's flax leaves (``h_{i}/attn/c_attn`` ``[H, 3, heads, D]`` with a
``[3, heads, D]`` bias, ``c_proj`` ``[heads, D, H]``, the MLP's ``c_fc``
and ``c_proj``) flatten the same way into ``h.{i}.*`` linears; its
LayerNorms keep ``scale`` and ``bias``.  Mixtral's ``layer_{i}`` holds the
llama attention and norms beside ``moe/router`` (a ``[H, E]`` kernel,
transposed like any linear) and the stacked experts ``moe/w_gate``,
``w_up`` ``[E, H, F]`` and ``w_down`` ``[E, F, H]``, which keep the flax
layout, and LoRA adapters on its attention as llama's.

BERT's tree (the encoder alone, or ``bert`` under a head's ``transform``,
``transform_norm`` and ``decoder``, or ``pooler`` and ``classifier``)
holds ``DenseGeneral`` kernels: ``query``/``key``/``value`` ``[H, nh, d]``
with a ``[nh, d]`` bias, ``output`` ``[nh, d, H]``, the rest ``[in, out]``;
each becomes an ``[out, in]`` linear with a flat bias.  ResNet's flax
convolutions are HWIO and become OIHW; its ``batch_stats`` (``mean``,
``var``) become each BatchNorm's ``running_mean`` and ``running_var``.
"""
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.bert import BertConfig
from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.mixtral import MixtralConfig
from skypilot_tpu_torch.models.resnet import ResNetConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _i8(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int8))


def _linear(sd: StateDict, dst: str, leaf: Mapping[str, Any],
            n_in: int) -> None:
    """A flax dense leaf (its kernel flattened to ``[n_in, out]``) as the
    ``[out, in]`` weight and flat bias of the linear `dst`."""
    sd[dst + '.weight'] = _t(leaf['kernel']).reshape(n_in, -1).T
    sd[dst + '.bias'] = _t(leaf['bias']).reshape(-1)


def _norm(sd: StateDict, dst: str, leaf: Mapping[str, Any]) -> None:
    sd[dst + '.scale'] = _t(leaf['scale'])
    sd[dst + '.bias'] = _t(leaf['bias'])


def state_dict_from_jax(params: Mapping[str, Any], config: Any,
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> StateDict:
    """flax ``params['params']`` (nested dicts of numpy arrays) -> the
    port's state_dict of the config's family (f32 CPU tensors, int8 for
    quantized weights; ``load_state_dict`` casts each to its parameter's
    dtype).  ResNet also needs the flax ``batch_stats``."""
    if isinstance(config, GPT2Config):
        sd = _gpt2_from_jax(params, config)
    elif isinstance(config, BertConfig):
        sd = _bert_from_jax(params, config)
    elif isinstance(config, ResNetConfig):
        if batch_stats is None:
            raise ValueError('a ResNet state_dict needs the flax '
                             'batch_stats beside its params')
        sd = _resnet_from_jax(params, batch_stats)
    else:
        sd = _llama_from_jax(params, config)
    return {k: v.contiguous() for k, v in sd.items()}


def _gpt2_from_jax(params: Mapping[str, Any],
                   config: GPT2Config) -> StateDict:
    h = config.hidden_size
    sd: StateDict = {'wte': _t(params['wte']), 'wpe': _t(params['wpe'])}
    _norm(sd, 'ln_f', params['ln_f'])
    for i in range(config.num_layers):
        src, dst = params[f'h_{i}'], f'h.{i}.'
        _norm(sd, dst + 'ln_1', src['ln_1'])
        _norm(sd, dst + 'ln_2', src['ln_2'])
        _linear(sd, dst + 'attn.c_attn', src['attn']['c_attn'], h)
        _linear(sd, dst + 'attn.c_proj', src['attn']['c_proj'], h)
        _linear(sd, dst + 'mlp.c_fc', src['mlp']['c_fc'], h)
        _linear(sd, dst + 'mlp.c_proj', src['mlp']['c_proj'],
                config.intermediate_size)
    return sd


def _llama_from_jax(params: Mapping[str, Any], config: Any) -> StateDict:
    """Llama and Mixtral: the shared attention and norms, then each
    layer's MLP or MoE block."""
    # Imported here: the train package imports this module.
    from skypilot_tpu_torch.train import lora
    h = config.hidden_size
    moe = isinstance(config, MixtralConfig)
    bias = getattr(config, 'attention_bias', False)
    sd: StateDict = {'embedding': _t(params['embedding']),
                     'final_norm.scale': _t(params['final_norm']['scale'])}
    if not config.tie_embeddings:
        sd['lm_head.weight'] = _t(params['lm_head']['kernel']).T
    for i in range(config.num_layers):
        src, dst = params[f'layer_{i}'], f'layers.{i}.'
        for norm in ('input_norm', 'post_attn_norm'):
            sd[f'{dst}{norm}.scale'] = _t(src[norm]['scale'])
        attn = src['attn']

        def weight(leaf, key, layout):
            """The projection's weight under `key` (``weight``, or
            ``weight_q`` and ``scale`` for an int8 leaf), `layout` turning
            the flax kernel into ``[out, in]``."""
            if 'kernel_q' in leaf:
                sd[key + 'weight_q'] = layout(_i8(leaf['kernel_q']))
                sd[key + 'scale'] = _t(leaf['scale']).reshape(-1)
            else:
                sd[key + 'weight'] = layout(_t(leaf['kernel']))

        for name in ('q_proj', 'k_proj', 'v_proj'):
            weight(attn[name], f'{dst}attn.{name}.',
                   lambda k: k.reshape(h, -1).T)
            if bias:
                sd[f'{dst}attn.{name}.bias'] = \
                    _t(attn[name]['bias']).reshape(-1)
        weight(attn['o_proj'], f'{dst}attn.o_proj.',
               lambda k: k.reshape(-1, h).T)
        if moe:
            experts = src['moe']
            sd[dst + 'moe.router.weight'] = _t(experts['router']['kernel']).T
            for name in ('w_gate', 'w_up', 'w_down'):
                sd[f'{dst}moe.{name}'] = _t(experts[name])
        else:
            for name in ('gate_proj', 'up_proj', 'down_proj'):
                weight(src['mlp'][name], f'{dst}mlp.{name}.', lambda k: k.T)
        for path, leaf in _flat_tree(src, f'layer_{i}/'):
            if lora.is_lora_path(path):
                sd[lora.port_name(path)] = _t(leaf)
    return sd


def _bert_from_jax(params: Mapping[str, Any],
                   config: BertConfig) -> StateDict:
    """The encoder (under ``bert.`` when a head holds it) and whichever
    head the tree has."""
    h = config.hidden_size
    sd: StateDict = {}
    enc, pre = (params['bert'], 'bert.') if 'bert' in params else (params,
                                                                   '')
    for name in ('word_embeddings', 'position_embeddings',
                 'token_type_embeddings'):
        sd[pre + name] = _t(enc[name])
    _norm(sd, pre + 'embeddings_norm', enc['embeddings_norm'])
    for i in range(config.num_layers):
        src, dst = enc[f'layer_{i}'], f'{pre}layers.{i}.'
        attn = src['attention']
        for name in ('query', 'key', 'value'):
            _linear(sd, f'{dst}attention.{name}', attn[name], h)
        _linear(sd, dst + 'attention.output', attn['output'],
                config.num_heads * config.head_dim_)
        _norm(sd, dst + 'attention_norm', src['attention_norm'])
        _linear(sd, dst + 'intermediate', src['intermediate'], h)
        _linear(sd, dst + 'output', src['output'], config.intermediate_size)
        _norm(sd, dst + 'output_norm', src['output_norm'])
    for name in ('transform', 'decoder', 'pooler', 'classifier'):
        if name in params:
            _linear(sd, name, params[name], h)
    if 'transform_norm' in params:
        _norm(sd, 'transform_norm', params['transform_norm'])
    return sd


def _resnet_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> StateDict:
    sd: StateDict = {}
    for path, leaf in _flat_tree(params, ''):
        mod, name = path.rsplit('/', 1)
        dst = mod.replace('/', '.')
        if name == 'kernel' and leaf.ndim == 4:    # HWIO -> OIHW
            sd[dst + '.weight'] = _t(leaf).permute(3, 2, 0, 1)
        elif name == 'kernel':                     # the head, [in, out]
            sd[dst + '.weight'] = _t(leaf).T
        else:                                      # bias, BatchNorm scale
            sd[f'{dst}.{name}'] = _t(leaf)
    for path, leaf in _flat_tree(batch_stats, ''):
        mod, name = path.rsplit('/', 1)
        sd[f'{mod.replace("/", ".")}.running_{name}'] = _t(leaf)
    return sd


def _flat_tree(tree: Mapping[str, Any], prefix: str
               ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flat_tree(val, f'{prefix}{key}/')
        else:
            yield prefix + key, val


def init_params(config: Any, generator: torch.Generator,
                head: str = 'lm') -> StateDict:
    """A random state_dict with the JAX module's init distributions.
    Llama: normal(0.02) for the embedding, every projection and lm_head;
    normal(0.02/sqrt(2L)) for o_proj (depth-scaled residual branch);
    zeros for norm scales and biases; with ``weight_dtype='int8'`` each
    projection as ``QuantDenseGeneral`` draws it (the normal draw at the
    projection's std, quantized at the fixed scale ``4*std/127``, which
    every channel's ``scale`` holds); with ``lora_rank`` > 0, each
    target's adapter as ``train.lora.adapter_init`` draws it (A normal(0.02),
    B zeros; stacked ``lora_num_adapters`` deep when that is > 0).
    Mixtral: llama's attention, norms, embedding and lm_head, and
    normal(0.02) for the router and every expert.  GPT-2: normal(0.02) for
    ``wte``, ``c_attn`` and ``c_fc``, normal(0.01) for ``wpe``,
    normal(0.02/sqrt(2L)) for both ``c_proj``; biases 0, LayerNorm scales
    1.  BERT: normal(0.02) for every kernel and embedding table, zero
    biases, LayerNorm scales 1 and biases 0.  ResNet: flax's default
    ``lecun_normal`` for every convolution and the head (a normal
    truncated at +-2 sigma, std sqrt(1/fan_in)/0.87962566, fan_in = kh*kw*in
    or in), zero head bias, BatchNorm scale 1 (``bn3``: 0) and bias 0,
    running mean 0 and variance 1.  Tensors are f32 on the generator's
    device.  `head` picks BERT's task head, as ``registry.build_model``
    does.  Does not reproduce JAX's random bits."""
    return dict(iter_params(config, generator, head))


def iter_params(config: Any, generator: torch.Generator, head: str = 'lm'
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """init_params one tensor at a time, (name, f32 tensor) in the same
    order and from the same draws: a caller that copies each into a
    model in a narrower dtype never holds the whole f32 state_dict."""
    dev = generator.device

    def normal(std, *shape):
        return torch.randn(shape, generator=generator, device=dev) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    if isinstance(config, GPT2Config):
        yield from _iter_gpt2(config, normal, zeros)
        return
    if isinstance(config, BertConfig):
        yield from _iter_bert(config, head, normal, zeros)
        return
    if isinstance(config, ResNetConfig):
        yield from _iter_resnet(config, generator, zeros)
        return
    h, d, n_layers = config.hidden_size, config.head_dim_, config.num_layers
    moe = isinstance(config, MixtralConfig)
    int8 = getattr(config, 'weight_dtype', 'bf16') == 'int8'
    bias = getattr(config, 'attention_bias', False)

    def proj(key, std, n_out, n_in):
        w = normal(std, n_out, n_in)
        if not int8:
            yield key + 'weight', w
            return
        scale0 = 4.0 * std / 127.0
        yield key + 'weight_q', torch.clamp(
            torch.round(w / scale0), -127, 127).to(torch.int8)
        yield key + 'scale', torch.full((n_out,), scale0, device=dev)

    yield 'embedding', normal(0.02, config.vocab_size, h)
    yield 'final_norm.scale', zeros(h)
    if not config.tie_embeddings:
        yield 'lm_head.weight', normal(0.02, config.vocab_size, h)
    heads = {'q_proj': config.num_heads, 'k_proj': config.num_kv_heads,
             'v_proj': config.num_kv_heads}
    o_std = 0.02 / (2 * n_layers) ** 0.5
    n_ad = getattr(config, 'lora_num_adapters', 0)
    # Imported here: the train package imports this module.
    from skypilot_tpu_torch.train import lora

    def adapter(prefix, name, n_in, n_out):
        if not (config.lora_rank and name in config.lora_targets):
            return
        r, stack = config.lora_rank, (n_ad,) if n_ad else ()
        a, b = lora.adapter_init(stack + (n_in, r), stack + (r, n_out),
                                 generator)
        yield f'{prefix}{name}_lora.lora_a', a
        yield f'{prefix}{name}_lora.lora_b', b

    for i in range(n_layers):
        p = f'layers.{i}.'
        yield p + 'input_norm.scale', zeros(h)
        yield p + 'post_attn_norm.scale', zeros(h)
        for name, n in heads.items():
            yield from proj(f'{p}attn.{name}.', 0.02, n * d, h)
            if bias:
                yield f'{p}attn.{name}.bias', zeros(n * d)
            yield from adapter(p + 'attn.', name, h, n * d)
        hd = config.num_heads * d
        yield from proj(p + 'attn.o_proj.', o_std, h, hd)
        yield from adapter(p + 'attn.', 'o_proj', hd, h)
        inter = config.intermediate_size
        if moe:
            e = config.num_experts
            yield p + 'moe.router.weight', normal(0.02, e, h)
            yield p + 'moe.w_gate', normal(0.02, e, h, inter)
            yield p + 'moe.w_up', normal(0.02, e, h, inter)
            yield p + 'moe.w_down', normal(0.02, e, inter, h)
            continue
        for name, n_in, n_out in (('gate_proj', h, inter),
                                  ('up_proj', h, inter),
                                  ('down_proj', inter, h)):
            yield from proj(f'{p}mlp.{name}.', 0.02, n_out, n_in)
            yield from adapter(p + 'mlp.', name, n_in, n_out)


def _iter_gpt2(config: GPT2Config, normal, zeros
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    h, inter = config.hidden_size, config.intermediate_size
    resid_std = 0.02 / (2 * config.num_layers) ** 0.5

    def norm(prefix):
        yield prefix + '.scale', zeros(h) + 1.0
        yield prefix + '.bias', zeros(h)

    def linear(prefix, std, n_out, n_in):
        yield prefix + '.weight', normal(std, n_out, n_in)
        yield prefix + '.bias', zeros(n_out)

    yield 'wte', normal(0.02, config.vocab_size, h)
    yield 'wpe', normal(0.01, config.max_seq_len, h)
    yield from norm('ln_f')
    for i in range(config.num_layers):
        p = f'h.{i}.'
        yield from norm(p + 'ln_1')
        yield from linear(p + 'attn.c_attn', 0.02, 3 * h, h)
        yield from linear(p + 'attn.c_proj', resid_std, h, h)
        yield from norm(p + 'ln_2')
        yield from linear(p + 'mlp.c_fc', 0.02, inter, h)
        yield from linear(p + 'mlp.c_proj', resid_std, h, inter)


def _iter_bert(config: BertConfig, head: str, normal, zeros
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The encoder's parameters (under ``bert.`` when `head` is 'mlm' or
    'classify'), then that head's."""
    h, inter = config.hidden_size, config.intermediate_size
    hd = config.num_heads * config.head_dim_

    def norm(prefix):
        yield prefix + '.scale', zeros(h) + 1.0
        yield prefix + '.bias', zeros(h)

    def linear(prefix, n_out, n_in):
        yield prefix + '.weight', normal(0.02, n_out, n_in)
        yield prefix + '.bias', zeros(n_out)

    pre = 'bert.' if head in ('mlm', 'classify') else ''
    yield pre + 'word_embeddings', normal(0.02, config.vocab_size, h)
    yield pre + 'position_embeddings', normal(0.02, config.max_seq_len, h)
    yield pre + 'token_type_embeddings', normal(
        0.02, config.type_vocab_size, h)
    yield from norm(pre + 'embeddings_norm')
    for i in range(config.num_layers):
        p = f'{pre}layers.{i}.'
        for name in ('query', 'key', 'value'):
            yield from linear(f'{p}attention.{name}', hd, h)
        yield from linear(p + 'attention.output', h, hd)
        yield from norm(p + 'attention_norm')
        yield from linear(p + 'intermediate', inter, h)
        yield from linear(p + 'output', h, inter)
        yield from norm(p + 'output_norm')
    if head == 'mlm':
        yield from linear('transform', h, h)
        yield from norm('transform_norm')
        yield from linear('decoder', config.vocab_size, h)
    elif head == 'classify':
        yield from linear('pooler', h, h)
        yield from linear('classifier', config.num_classes, h)


def _iter_resnet(config: ResNetConfig, generator: torch.Generator, zeros
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    dev = generator.device

    def lecun(*shape):
        """flax's lecun_normal: variance 1/fan_in over the truncated
        normal's own variance (0.87962566^2 at +-2 sigma); the OIHW and
        [out, in] layouts put fan_in in the trailing dims."""
        fan_in = math.prod(shape[1:])
        t = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)

    def bn(prefix, n, scale=1.0):
        yield prefix + '.scale', zeros(n) + scale
        yield prefix + '.bias', zeros(n)
        yield prefix + '.running_mean', zeros(n)
        yield prefix + '.running_var', zeros(n) + 1.0

    w = config.width
    yield 'conv_init.weight', lecun(w, 3, 7, 7)
    yield from bn('bn_init', w)
    n_in = w
    for i, count in enumerate(config.stage_sizes):
        f = w * 2 ** i
        for j in range(count):
            p = f'stage{i}_block{j}.'
            yield p + 'conv1.weight', lecun(f, n_in, 1, 1)
            yield from bn(p + 'bn1', f)
            yield p + 'conv2.weight', lecun(f, f, 3, 3)
            yield from bn(p + 'bn2', f)
            yield p + 'conv3.weight', lecun(4 * f, f, 1, 1)
            yield from bn(p + 'bn3', 4 * f, scale=0.0)
            if n_in != 4 * f or (i > 0 and j == 0):
                yield p + 'proj.weight', lecun(4 * f, n_in, 1, 1)
                yield from bn(p + 'bn_proj', 4 * f)
            n_in = 4 * f
    yield 'head.weight', lecun(config.num_classes, n_in)
    yield 'head.bias', zeros(config.num_classes)
