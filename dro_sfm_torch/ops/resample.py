"""Bilinear image resampling on channel-last tensors (plain PyTorch).

PyTorch counterpart of `dro_sfm_tpu/ops/resample.py`: the semantics of
``grid_sample(mode='bilinear', padding_mode='zeros', align_corners=True)``
written as four gathers. Pixel coordinates sample at integer centres
0..W-1 and out-of-bounds taps contribute zero. It is the plain version
behind `resize_bilinear` and the warp-cost kernels (`ops/tent_warp.py`);
`bilinear_taps` decides the taps for all of them.
"""
from __future__ import annotations

import torch


def bilinear_taps(coords: torch.Tensor, h: int, w: int):
    """The four bilinear taps of each coordinate into an [h, w] map, as the
    warp-cost kernels compute them (`csrc/tent_warp_common.cuh:make_taps`).

    coords [n, ..., 2] holds (x, y) positions into map ``i`` of ``n`` in
    ``coords[i]`` -> (index [4, n, ...] into the flattened [n*h*w] maps,
    valid [4, n, ...], weight [4, n, ...] in the coords dtype, wx [n, ...],
    wy [n, ...]), taps in the order (dy, dx) = (0,0), (0,1), (1,0), (1,1).
    Coordinates are clamped to [-2, w+1] and [-2, h+1] first: every tap of
    a clamped coordinate lies outside the map, so the clamp changes no
    result and keeps the floor in integer range.
    """
    x = coords[..., 0].clamp(-2.0, w + 1.0)
    y = coords[..., 1].clamp(-2.0, h + 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    base = torch.arange(coords.shape[0], device=coords.device) * (h * w)
    base = base.reshape(-1, *[1] * (coords.ndim - 2))
    index, valid, weight = [], [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        valid.append((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
        index.append(base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        weight.append((wx if dx else 1 - wx) * (wy if dy else 1 - wy))
    return torch.stack(index), torch.stack(valid), torch.stack(weight), wx, wy


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
    index, valid, weight, _, _ = bilinear_taps(coords.reshape(-1, ho, wo, 2), h, w)
    flat = image.reshape(-1, c)
    out = None
    for t in range(4):
        tap = flat.index_select(0, index[t].reshape(-1)).reshape(*batch, ho, wo, c)
        scale = (weight[t] * valid[t].to(weight.dtype)).to(image.dtype)
        tap = tap * scale.reshape(*batch, ho, wo)[..., None]
        out = tap if out is None else out + tap
    return out
