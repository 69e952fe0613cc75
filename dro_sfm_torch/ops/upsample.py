"""RAFT-style convex upsampling of coarse depth maps (channel-last).

PyTorch counterpart of `dro_sfm_tpu/ops/upsample.py`: each fine pixel is a
softmax-convex combination of its 3x3 coarse neighbourhood. Under a height
split (`parallel/spatial.py`) the neighbourhoods of a band read one row of
each neighbour (zeros outside the image), and the upsampled band is rows
``[r * r0, r * r1)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dro_sfm_torch.parallel import spatial


def neighborhood_3x3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 neighbourhoods of [..., H, W, 1] -> [..., H, W, 9],
    row-major over (dy, dx) in {-1, 0, 1}^2 (the order of torch's
    ``F.unfold(x, 3, padding=1)``)."""
    h, w = x.shape[-3], x.shape[-2]
    if spatial.current() is None:
        xp = F.pad(x[..., 0], (1, 1, 1, 1))
    else:
        xp = F.pad(spatial.halo(x, -3, 1, 1)[..., 0], (1, 1))
    taps = [xp[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=-1)


def convex_upsample(depth: torch.Tensor, mask: torch.Tensor,
                    ratio: int = 8) -> torch.Tensor:
    """Upsample depth [..., h, w, 1] by ``ratio`` with mask [..., h, w, 9*r*r].

    The mask channels factor as (9, ratio, ratio), neighbour index slowest.
    The softmax over the 9 taps runs in the mask's dtype; the blend runs in
    the depth dtype (fp32), since a bf16 mask times fp32 taps promotes.
    """
    batch = depth.shape[:-3]
    h, w = depth.shape[-3], depth.shape[-2]
    taps = neighborhood_3x3(depth)                            # [..., h, w, 9]
    m = torch.softmax(mask.reshape(*batch, h, w, 9, ratio, ratio), dim=-3)
    fine = (m * taps[..., None, None]).sum(dim=-3)             # [..., h, w, r, r]
    fine = fine.transpose(-3, -2)                              # [..., h, r, w, r]
    return fine.reshape(*batch, h * ratio, w * ratio, 1)
