"""Pinhole camera helpers (channel-last).

PyTorch counterpart of the functional part of `dro_sfm_tpu/geometry/camera.py`:
an unnormalized pixel grid at integer centres, intrinsics rescaling with the
+0.5 pixel-centre shift, and the analytic inverse of pinhole intrinsics.
"""
from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Homogeneous pixel coordinate grid [H, W, 3] of (x, y, 1)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def scale_intrinsics(K: torch.Tensor, scale: float) -> torch.Tensor:
    """Rescale [..., 3, 3] intrinsics for an image resized by ``scale``, with
    the pixel-centre rule c' = (c + 0.5) * s - 0.5."""
    K = K.clone()
    K[..., 0, 0] = K[..., 0, 0] * scale
    K[..., 1, 1] = K[..., 1, 1] * scale
    K[..., :2, 2] = (K[..., :2, 2] + 0.5) * scale - 0.5
    return K


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [..., 3, 3] pinhole intrinsics."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    Kinv = K.clone()
    Kinv[..., 0, 0] = 1.0 / fx
    Kinv[..., 1, 1] = 1.0 / fy
    Kinv[..., 0, 2] = -cx / fx
    Kinv[..., 1, 2] = -cy / fy
    return Kinv
