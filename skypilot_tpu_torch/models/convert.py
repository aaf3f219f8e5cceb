"""Weights for the port's ``Llama``: carried across from the JAX package's
flax tree, or drawn at random with the JAX package's distributions.

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
"""
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import LlamaConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _i8(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int8))


def state_dict_from_jax(params: Mapping[str, Any],
                        config: LlamaConfig) -> StateDict:
    """flax ``params['params']`` (nested dicts of numpy arrays) -> the
    port's ``Llama`` state_dict (f32 CPU tensors, int8 for quantized
    weights; ``load_state_dict`` casts each to its parameter's dtype)."""
    # Imported here: the train package imports this module.
    from skypilot_tpu_torch.train import lora
    h = config.hidden_size
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
            if config.attention_bias:
                sd[f'{dst}attn.{name}.bias'] = \
                    _t(attn[name]['bias']).reshape(-1)
        weight(attn['o_proj'], f'{dst}attn.o_proj.',
               lambda k: k.reshape(-1, h).T)
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            weight(src['mlp'][name], f'{dst}mlp.{name}.', lambda k: k.T)
        for path, leaf in _flat_tree(src, f'layer_{i}/'):
            if lora.is_lora_path(path):
                sd[lora.port_name(path)] = _t(leaf)
    return {k: v.contiguous() for k, v in sd.items()}


def _flat_tree(tree: Mapping[str, Any], prefix: str
               ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flat_tree(val, f'{prefix}{key}/')
        else:
            yield prefix + key, val


def init_params(config: LlamaConfig,
                generator: torch.Generator) -> StateDict:
    """A random state_dict with the JAX module's init distributions:
    normal(0.02) for the embedding, every projection and lm_head;
    normal(0.02/sqrt(2L)) for o_proj (depth-scaled residual branch);
    zeros for norm scales and biases; with ``weight_dtype='int8'`` each
    projection as ``QuantDenseGeneral`` draws it (the normal draw at the
    projection's std, quantized at the fixed scale ``4*std/127``, which
    every channel's ``scale`` holds); with ``lora_rank`` > 0, each
    target's adapter as ``train.lora.adapter_init`` draws it (A normal(0.02),
    B zeros; stacked ``lora_num_adapters`` deep when that is > 0).
    Tensors are f32 on the generator's device.  Does not reproduce JAX's
    random bits."""
    return dict(iter_params(config, generator))


def iter_params(config: LlamaConfig, generator: torch.Generator
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """init_params one tensor at a time, (name, f32 tensor) in the same
    order and from the same draws: a caller that copies each into a
    model in a narrower dtype never holds the whole f32 state_dict."""
    dev = generator.device
    h, d, n_layers = config.hidden_size, config.head_dim_, config.num_layers

    def normal(std, *shape):
        return torch.randn(shape, generator=generator, device=dev) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def proj(key, std, n_out, n_in):
        w = normal(std, n_out, n_in)
        if config.weight_dtype != 'int8':
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
    n_ad = config.lora_num_adapters
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
            if config.attention_bias:
                yield f'{p}attn.{name}.bias', zeros(n * d)
            yield from adapter(p + 'attn.', name, h, n * d)
        hd = config.num_heads * d
        yield from proj(p + 'attn.o_proj.', o_std, h, hd)
        yield from adapter(p + 'attn.', 'o_proj', hd, h)
        inter = config.intermediate_size
        for name, n_in, n_out in (('gate_proj', h, inter),
                                  ('up_proj', h, inter),
                                  ('down_proj', inter, h)):
            yield from proj(f'{p}mlp.{name}.', 0.02, n_out, n_in)
            yield from adapter(p + 'mlp.', name, n_in, n_out)
