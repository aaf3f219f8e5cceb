"""LoRA: low-rank adapters for parameter-efficient finetuning -- the port
of ``skypilot_tpu/train/lora.py``.

An adapter is a sibling module of its base projection (``q_proj`` +
``q_proj_lora``) computing ``y = base(x) + (alpha/rank) * (x·A)·B`` with
A ~ N(0, 0.02) and B = 0, so the delta starts at exactly zero and a LoRA
model with grafted base weights gives the base model's logits bit for
bit.  The base parameters keep their names and shapes; training freezes
them (``requires_grad_(False)``) and builds the optimizer over the
``*_lora`` parameters only, so the base carries no Adam moments.

Multi-LoRA serving stacks N adapters per target (``[N, in, r]`` /
``[N, r, out]``) and ``adapter_ids [B]`` selects one per sequence: the
per-row gathered product (a "BGMV") in plain PyTorch, as the JAX module
computes it with ``jnp.einsum``.  A row with id < 0 gets the base model
exactly: it is masked, where the JAX module multiplies it by a scale of 0
(``inf * 0`` there turns a non-finite adapter in slot 0 into NaN on every
base row; ROADMAP.md C4).

The interchange format is the JAX package's ``.npz``: the ``*_lora``
leaves under their flax paths joined with ``/``
(``layer_{i}/attn/q_proj_lora/lora_a``), feature dims flattened
(``lora_a [in, r]``, ``lora_b [r, out]``), f32.  A file either package
writes loads in the other.
"""
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Tree = Dict[str, Any]

_PORT_LAYER = re.compile(r'^layers\.(\d+)\.')
_FLAX_LAYER = re.compile(r'^layer_(\d+)/')


def flax_path(name: str) -> str:
    """A port parameter name as its flax path joined with '/':
    ``layers.3.attn.q_proj_lora.lora_a`` ->
    ``layer_3/attn/q_proj_lora/lora_a``."""
    return _PORT_LAYER.sub(r'layer_\1/', name).replace('.', '/')


def port_name(path: str) -> str:
    """Inverse of ``flax_path``."""
    return _FLAX_LAYER.sub(r'layers.\1.', path).replace('/', '.')


def is_lora_path(path: Union[str, Tuple[Any, ...]]) -> bool:
    """True if a parameter belongs to an adapter (a module name ends with
    '_lora').  Takes a port name (``layers.0.attn.q_proj_lora.lora_a``),
    a flax path joined with '/', or a tuple of keys."""
    parts = (re.split(r'[./]', path) if isinstance(path, str)
             else [str(k) for k in path])
    return any(p.endswith('_lora') for p in parts)


def adapter_init(a_shape: Tuple[int, ...], b_shape: Tuple[int, ...],
                 generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's adapter init, f32 on the generator's device:
    A ~ N(0, 0.02), B = 0."""
    dev = generator.device
    a = torch.randn(a_shape, generator=generator, device=dev) * 0.02
    return a, torch.zeros(b_shape, device=dev)


class LoRAAdapter(nn.Module):
    """Low-rank delta of one projection, over its flattened input and
    output features.

    num_adapters 0 (training): one adapter, ``lora_a [in, r]`` and
    ``lora_b [r, out]``.  num_adapters N (multi-LoRA serving): stacked
    ``[N, in, r]`` / ``[N, r, out]``, and ``adapter_ids [B]`` picks one
    per row; id < 0 is the base model (a zero delta, masked).

    Parameters are f32 (drawn by ``adapter_init``, through
    ``models.convert.init_params``), cast to ``dtype`` at use.  The
    arithmetic order
    is the JAX module's, which bf16 parity depends on: the two products
    in ``dtype``, then the scale alpha/rank (in ``dtype``)."""

    def __init__(self, in_dim: int, out_dim: int, rank: int, alpha: float,
                 dtype: torch.dtype = torch.bfloat16, num_adapters: int = 0,
                 device=None):
        super().__init__()
        n = num_adapters
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.num_adapters = n
        # alpha/rank rounded to `dtype` once, as the JAX module casts it:
        # a Python float multiplies on every device without a copy.
        self.scale = float(torch.tensor(alpha / rank, dtype=dtype))
        a_shape = (in_dim, rank) if not n else (n, in_dim, rank)
        b_shape = (rank, out_dim) if not n else (n, rank, out_dim)
        self.lora_a = nn.Parameter(torch.zeros(a_shape, device=device))
        self.lora_b = nn.Parameter(torch.zeros(b_shape, device=device))

    def forward(self, x: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if not self.num_adapters:
            y = (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            return y * self.scale
        if adapter_ids is None:
            raise ValueError('multi-adapter LoRA needs adapter_ids [batch]')
        idx = adapter_ids.clamp(0, self.num_adapters - 1)
        a_g = self.lora_a[idx].to(dt)                   # [B, in, r]
        b_g = self.lora_b[idx].to(dt)                   # [B, r, out]
        h = torch.einsum('b...i,bir->b...r', x, a_g)
        y = torch.einsum('b...r,bro->b...o', h, b_g) * self.scale
        base = (adapter_ids < 0).view((-1,) + (1,) * (y.ndim - 1))
        return y.masked_fill(base, 0.0)


def _flat(params) -> Dict[str, Any]:
    """A module, a port state_dict or a nested flax-form tree, as
    {flax path: leaf}."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    out: Dict[str, Any] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f'{prefix}{key}/')
            else:
                out[prefix + (flax_path(key) if not prefix else key)] = val

    walk(params, '')
    return out


def nest(flat: Mapping[str, Any]) -> Tree:
    """{'a/b/c': leaf} -> {'a': {'b': {'c': leaf}}}: flax paths joined
    with '/' as the nested tree."""
    tree: Tree = {}
    for path, val in flat.items():
        *heads, leaf = path.split('/')
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = val
    return tree


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def merge_base_params(state_dict: Union[Mapping[str, torch.Tensor],
                                        nn.Module],
                      base: Mapping[str, torch.Tensor]):
    """Graft a base (non-LoRA) state_dict into a LoRA-enabled one: every
    base entry replaces its same-named counterpart (in that entry's dtype
    and device); adapter entries keep their init.  Returns the merged
    state_dict.

    Given the model itself (a trainer's ``state.model``), the base is
    written into it in place and the model returned; a model placed on a
    mesh (DTensor parameters) takes a full base state_dict that rank 0
    alone needs to hold (``set_model_state_dict`` broadcasts it from
    rank 0; every rank keeps its shards), so the other ranks may pass
    {}."""
    model = state_dict if isinstance(state_dict, nn.Module) else None
    if model is not None:
        state_dict = model.state_dict()
    out = dict(state_dict)
    for key, val in base.items():
        if key not in state_dict:
            raise KeyError(f'base param {key!r} missing from the LoRA '
                           'model tree')
        leaf = state_dict[key]
        out[key] = val.to(dtype=leaf.dtype, device='cpu' if model is not
                          None else leaf.device)
    if model is None:
        return out
    from torch.distributed.tensor import DTensor
    if any(isinstance(p, DTensor) for p in model.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict)
        set_model_state_dict(
            model, {k: out[k] for k in base},
            options=StateDictOptions(full_state_dict=True, strict=False,
                                     broadcast_from_rank0=True))
    else:
        model.load_state_dict({k: out[k] for k in base}, strict=False)
    return model


def extract_adapter_tree(params) -> Tree:
    """The ``*_lora`` leaves only, as the nested flax-form tree of f32
    numpy arrays (the portable adapter artifact that ``register_adapter``
    takes).  ``params``: a module, a port state_dict or a nested tree."""
    return nest({p: _numpy(v) for p, v in _flat(params).items()
                 if is_lora_path(p)})


def num_adapter_params(params) -> int:
    """Total adapter (trainable) parameter count."""
    return sum(int(np.prod(np.shape(v))) for p, v in _flat(params).items()
               if is_lora_path(p))


def save_adapter_npz(params, path: str) -> int:
    """Write the adapter (``*_lora``) leaves as a flat .npz under their
    flax paths -- the format ``POST /load_adapter`` reads, in either
    package.  Returns the number of leaves written."""
    flat = {p: _numpy(v) for p, v in _flat(params).items()
            if is_lora_path(p)}
    if not flat:
        raise ValueError('no *_lora leaves in the given tree')
    np.savez(path, **flat)
    return len(flat)


def load_adapter_npz(path: str) -> Tree:
    """Inverse of save_adapter_npz: the nested adapter tree from a .npz."""
    with np.load(path) as z:
        return nest({key: z[key] for key in z.files})
