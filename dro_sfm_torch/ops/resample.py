"""Bilinear image resampling on channel-last tensors (plain PyTorch).

PyTorch counterpart of `dro_sfm_tpu/ops/resample.py`: the semantics of
``grid_sample(mode='bilinear', padding_mode='zeros', align_corners=True)``
written as four gathers. Pixel coordinates sample at integer centres
0..W-1 and out-of-bounds taps contribute zero. It is the plain version
behind `resize_bilinear` and the warp-cost kernel (`ops/tent_warp.py`).
"""
from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` [..., H, W, C] at ``coords`` [..., Ho, Wo, 2].

    coords holds (x, y) positions in source pixel space; the leading dims of
    both must match. Returns
    [..., Ho, Wo, C] in the image dtype; the tap weights are computed in the
    coords dtype and cast to the image dtype, as the JAX version does.
    The taps are summed in the order (0,0), (0,1), (1,0), (1,1) over (dy, dx),
    which the warp-cost kernel repeats.
    """
    h, w, c = image.shape[-3], image.shape[-2], image.shape[-1]
    batch = image.shape[:-3]
    ho, wo = coords.shape[-3], coords.shape[-2]
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()

    flat = image.reshape(-1, c)
    n_img = flat.shape[0] // (h * w)
    base = (torch.arange(n_img, device=image.device) * (h * w)).reshape(
        *batch, 1, 1)
    out = None
    for dy, dx, weight in (
        (0, 0, (1 - wx) * (1 - wy)),
        (0, 1, wx * (1 - wy)),
        (1, 0, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        tap = flat.index_select(0, idx.reshape(-1)).reshape(*batch, ho, wo, c)
        tap = tap * (weight * valid.to(weight.dtype)).to(image.dtype)[..., None]
        out = tap if out is None else out + tap
    return out
