"""Progressive scaling: anneal the number of supervised scales with
training progress.

PyTorch counterpart of `dro_sfm_tpu/losses/progressive.py`: after every
``threshold`` fraction of training the coarsest remaining prediction drops
out of the loss. Predictions are stacked coarsest first, so the active set
is the last ``n`` entries of a 0/1 weight mask.
"""
from __future__ import annotations

import torch


def progressive_scale_mask(num_preds: int, threshold: float, progress,
                           dtype=torch.float32, device=None) -> torch.Tensor:
    """[P] weight mask with the finest ``n(progress)`` predictions active.

    ``threshold`` <= 0 disables it (all ones). Boundaries at
    ``threshold * (i + 1)`` for i < P - 1, then 1.0;
    ``n = P - searchsorted(boundaries, progress)`` (left side).
    """
    if threshold <= 0.0:
        return torch.ones(num_preds, dtype=dtype, device=device)
    bounds = torch.tensor([threshold * (i + 1) for i in range(num_preds - 1)]
                          + [1.0], dtype=dtype, device=device)
    progress = torch.as_tensor(progress, dtype=dtype, device=device).reshape(1)
    n = num_preds - torch.searchsorted(bounds, progress)[0]
    return (torch.arange(num_preds, device=device) >= num_preds - n).to(dtype)
