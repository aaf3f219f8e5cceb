"""Main-path entry point of the port, the twin of ``__graft_entry__.entry``:
the no-cache forward of ``llama-1b`` over tokens ``[1, 1024]``, whose
attention runs through the Hopper flash-attention kernel."""
from typing import Callable, Tuple

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
