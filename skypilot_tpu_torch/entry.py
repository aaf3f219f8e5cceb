"""Entry points of the port, the twins of ``__graft_entry__``'s: ``entry``,
the no-cache forward of ``llama-1b`` over tokens ``[1, 1024]``, whose
attention runs through the Hopper flash-attention kernel; and
``dryrun_multichip``, one train step of each parallel leg over the
process group's ranks."""
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.convert import init_params
from skypilot_tpu_torch.models.llama import Llama
from skypilot_tpu_torch.models.registry import get_model_config


def entry(device=None) -> Tuple[Callable, Tuple]:
    """Returns (forward, (model, tokens)): ``forward(model, tokens)`` gives
    logits [1, 1024, 32000] f32.  Random weights drawn from a
    ``torch.Generator`` seeded with 0.  device None means the card."""
    device = resolve_device(device)
    config = get_model_config('llama-1b')
    model = Llama(config, device=device).eval()
    model.load_state_dict(init_params(
        config, torch.Generator(device=device).manual_seed(0)))
    tokens = torch.zeros((1, 1024), dtype=torch.long, device=device)

    def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(tokens)

    return forward, (model, tokens)


def dryrun_config(device: torch.device):
    """The dryrun's tiny llama: the JAX dryrun's config, on the card at 4x
    the width (hidden 512, MLP 1024: head_dim 64, where the Hopper
    kernels start; the JAX config's 16 is below every kernel's)."""
    from skypilot_tpu_torch.models.llama import LlamaConfig
    wide = device.type == 'cuda'
    return LlamaConfig(name='dryrun', vocab_size=512,
                       hidden_size=512 if wide else 128,
                       intermediate_size=1024 if wide else 256,
                       num_layers=2, num_heads=8, num_kv_heads=4,
                       max_seq_len=128, tie_embeddings=True)


def dryrun_multichip(n_devices: int, device=None,
                     params: Optional[Dict[str, Dict]] = None,
                     log: Callable[[str], None] = print) -> Dict[str, float]:
    """The twin of the training legs of ``__graft_entry__.dryrun_multichip``:
    on a process group of `n_devices` ranks (started from the env, or a
    one-rank group), one train step of each leg on the reference's tiny
    config, each asserting a finite loss and printing the JAX line:

    - dp/fsdp/tp: ``MeshSpec(data, fsdp, tensor)`` as the reference picks
      it from the device count, with grad accumulation 2;
    - sp: ring attention over ``seq=2``; pp: GPipe over ``stage=2``
      (both skipped, with the reason printed, when the rank count is odd,
      as the reference skips them);
    - ep: Mixtral with its experts sharded over 'tensor'.

    `params` maps a leg ('dp', 'sp', 'pp', 'ep') to its starting
    state_dict (e.g. the JAX legs' weights through
    ``convert.state_dict_from_jax``); by default each is drawn from the
    seed of the reference's PRNG key.  Returns each run leg's loss."""
    from torch import distributed as dist

    from skypilot_tpu_torch.models.mixtral import MixtralConfig
    from skypilot_tpu_torch.parallel.mesh import (MeshSpec,
                                                  ensure_process_group)
    from skypilot_tpu_torch.train.trainer import Trainer, TrainConfig
    device = ensure_process_group(device)
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f'need {n_devices} ranks, have {world}')
    params = params or {}
    config = dryrun_config(device)
    tensor = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // tensor
    fsdp = math.gcd(rest, config.hidden_size)
    data = rest // fsdp
    if data == 1 and fsdp % 2 == 0:   # prefer exercising a data axis
        data, fsdp = 2, fsdp // 2
    spec = MeshSpec(data=data, fsdp=fsdp, tensor=tensor)
    dp_total = data * fsdp
    batch = max(8, 2 * dp_total)
    batch += (-batch) % (2 * dp_total)
    tokens = torch.zeros((batch, 65), dtype=torch.long, device=device)
    losses: Dict[str, float] = {}

    def leg(name, model_config, mesh, seed, **train):
        tr = Trainer(TrainConfig(model=model_config.name, batch_size=batch,
                                 seq_len=64, warmup_steps=1, total_steps=2,
                                 mesh=mesh, **train), model_config,
                     device=device)
        tr.setup(seed=seed, params=params.get(name))
        loss = float(tr._step_fn(tr.state, {'tokens': tokens})['loss'])
        assert math.isfinite(loss), f'non-finite loss in dryrun {name}'
        losses[name] = loss
        return loss

    loss = leg('dp', config, spec, 0, grad_accum_steps=2)
    log(f'dryrun_multichip ok: mesh={spec.shape} loss={loss:.3f}')
    if n_devices % 2 == 0:
        sp_spec = MeshSpec(data=data, fsdp=fsdp * tensor // 2, seq=2)
        loss = leg('sp', config, sp_spec, 0)
        log(f'dryrun sp ok: mesh={sp_spec.shape} loss={loss:.3f}')
        loss = leg('pp', config, MeshSpec(stage=2, data=n_devices // 2), 1,
                   pipeline_microbatches=2)
        log(f'dryrun pp ok: stages=2 loss={loss:.3f}')
    else:
        log(f'dryrun sp skipped: {n_devices} rank(s); seq=2 needs an even '
            'count')
        log(f'dryrun pp skipped: {n_devices} rank(s); stage=2 needs an '
            'even count')
    ep_config = MixtralConfig(
        name='dryrun-moe', vocab_size=512, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size, num_layers=2,
        num_heads=8, num_kv_heads=4, num_experts=max(2, tensor),
        experts_per_token=2, max_seq_len=128, tie_embeddings=True)
    loss = leg('ep', ep_config, spec, 2)
    log(f'dryrun ep ok: experts={ep_config.num_experts} loss={loss:.3f}')
    return losses
