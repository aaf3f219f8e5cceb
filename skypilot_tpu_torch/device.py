"""Device resolution shared by every entry point of the port."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card.  Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is visible:
    the port never carries on quietly on the CPU.  Pass ``'cpu'`` to run
    the plain PyTorch paths."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is visible; pass device="cpu" to run the '
            'plain PyTorch versions on the CPU')
    return dev
