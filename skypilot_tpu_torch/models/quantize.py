"""Int8 weight quantization for serving -- the port's counterpart of
``skypilot_tpu/models/quantize.py``, on the port's own state_dict.

Each decoder projection's ``weight`` [out, in] becomes ``weight_q`` (int8,
per output channel, symmetric) and ``scale`` (f32 [out]), the layout
``models.llama.QuantLinear`` holds.  The embedding, ``lm_head``, norms,
biases and LoRA adapters pass through: they are a small share of the bytes
and dominate logit fidelity.

The arithmetic is the JAX package's: ``scale = max(amax, 1e-8) / 127`` in
f32 over the contraction dims, then ``round(w / scale)`` (half to even)
clipped to +-127, so the bytes equal ``quantize_params`` followed by
``convert.state_dict_from_jax`` for the same weights.  The flax o_proj
kernel ``[heads, d, H]`` contracts two dims; in the port's ``[H, heads*d]``
layout that is the same amax over each row.  Tensors stay on their device
(a 7B quantizes on the card, one f32 copy of one weight at a time), and
every division is a true quotient, so the card gives the CPU's bytes.
"""
from typing import Iterable, Iterator, Mapping, Tuple

import torch

# Projection module names whose weight quantizes (the decoder matmuls,
# where the weight bytes live).
_PROJ_NAMES = ('q_proj', 'k_proj', 'v_proj', 'o_proj',
              'gate_proj', 'up_proj', 'down_proj')


def _is_proj_weight(name: str) -> bool:
    """True for a port state_dict key ``...<proj>.weight`` of a decoder
    projection (not its bias, not a LoRA adapter's leaves)."""
    parts = name.split('.')
    return len(parts) >= 2 and parts[-1] == 'weight' and \
        parts[-2] in _PROJ_NAMES


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float ``[out, in]`` -> (int8 ``[out, in]``, f32 scale ``[out]``)."""
    w = w.float()
    amax = torch.clamp(w.abs().amax(dim=1), min=1e-8)
    # A tensor divisor, not the Python scalar 127: CUDA divides a tensor
    # by a scalar as a product with its reciprocal, which can land one
    # ulp from the CPU's (and numpy's) true quotient.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def iter_quantized(items: Iterable[Tuple[str, torch.Tensor]]
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) pairs of a float state_dict -> those of the int8
    one, one tensor at a time: a caller that drops each input after use
    never holds both copies of the model."""
    for name, t in items:
        if _is_proj_weight(name):
            q, scale = quantize_weight(t)
            stem = name[:-len('weight')]
            yield stem + 'weight_q', q
            yield stem + 'scale', scale
        else:
            yield name, t


def quantize_state_dict(sd: Mapping[str, torch.Tensor]
                        ) -> 'dict[str, torch.Tensor]':
    """A bf16 or f32 port state_dict -> the int8-serving state_dict (non-
    projection entries pass through).  Load it into a ``Llama`` built with
    ``weight_dtype='int8'``."""
    return dict(iter_quantized(sd.items()))
