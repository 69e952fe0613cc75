"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is wanted and CUDA is not available; the
    port never moves to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dro_sfm_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return device
