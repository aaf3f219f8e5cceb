"""Weights for the port's models (``Llama``, ``GPT2``, ``Mixtral``): carried
across from the JAX package's flax tree, or drawn at random with the JAX
package's distributions.

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
layout.
"""
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.mixtral import MixtralConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _i8(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int8))


def state_dict_from_jax(params: Mapping[str, Any],
                        config: Any) -> StateDict:
    """flax ``params['params']`` (nested dicts of numpy arrays) -> the
    port's state_dict of the config's family (f32 CPU tensors, int8 for
    quantized weights; ``load_state_dict`` casts each to its parameter's
    dtype)."""
    if isinstance(config, GPT2Config):
        sd = _gpt2_from_jax(params, config)
    else:
        sd = _llama_from_jax(params, config)
    return {k: v.contiguous() for k, v in sd.items()}


def _gpt2_from_jax(params: Mapping[str, Any],
                   config: GPT2Config) -> StateDict:
    h = config.hidden_size
    sd: StateDict = {'wte': _t(params['wte']), 'wpe': _t(params['wpe'])}

    def norm(dst, leaf):
        sd[dst + '.scale'] = _t(leaf['scale'])
        sd[dst + '.bias'] = _t(leaf['bias'])

    def linear(dst, leaf, n_in):
        sd[dst + '.weight'] = _t(leaf['kernel']).reshape(n_in, -1).T
        sd[dst + '.bias'] = _t(leaf['bias']).reshape(-1)

    norm('ln_f', params['ln_f'])
    for i in range(config.num_layers):
        src, dst = params[f'h_{i}'], f'h.{i}.'
        norm(dst + 'ln_1', src['ln_1'])
        norm(dst + 'ln_2', src['ln_2'])
        linear(dst + 'attn.c_attn', src['attn']['c_attn'], h)
        linear(dst + 'attn.c_proj', src['attn']['c_proj'], h)
        linear(dst + 'mlp.c_fc', src['mlp']['c_fc'], h)
        linear(dst + 'mlp.c_proj', src['mlp']['c_proj'],
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
            continue
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            weight(src['mlp'][name], f'{dst}mlp.{name}.', lambda k: k.T)
        for path, leaf in _flat_tree(src, f'layer_{i}/'):
            if lora.is_lora_path(path):
                sd[lora.port_name(path)] = _t(leaf)
    return sd


def _flat_tree(tree: Mapping[str, Any], prefix: str
               ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flat_tree(val, f'{prefix}{key}/')
        else:
            yield prefix + key, val


def init_params(config: Any, generator: torch.Generator) -> StateDict:
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
    1.  Tensors are f32 on the generator's device.  Does not reproduce
    JAX's random bits."""
    return dict(iter_params(config, generator))


def iter_params(config: Any, generator: torch.Generator
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
