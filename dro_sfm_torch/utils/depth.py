"""Flip-fusion post-processing of inverse depth maps, and depth files.

PyTorch counterpart of `fuse_inv_depth`, `post_process_inv_depth`,
`viz_inv_depth`, `load_depth` and `write_depth` in
`dro_sfm_tpu/utils/depth.py`: depth files are ``.npz`` (``depth``,
``intrinsics``) or uint16 ``.png`` holding ``depth * 256``
(`dro_sfm_torch.utils.image_io`); the colormap is matplotlib's, bit for bit,
from the port's own table (`dro_sfm_torch.utils.colormap`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dro_sfm_torch.ops.image import flip_lr
from dro_sfm_torch.utils.colormap import apply_colormap
from dro_sfm_torch.utils.image_io import read_png, write_png


def fuse_inv_depth(inv_depth: torch.Tensor, inv_depth_hat: torch.Tensor,
                   method: str = "mean") -> torch.Tensor:
    """Fuse an inverse depth map with its unflipped counterpart."""
    if method == "mean":
        return 0.5 * (inv_depth + inv_depth_hat)
    if method == "max":
        return torch.maximum(inv_depth, inv_depth_hat)
    if method == "min":
        return torch.minimum(inv_depth, inv_depth_hat)
    raise ValueError(f"Unknown post-process method {method}")


def post_process_inv_depth(inv_depth: torch.Tensor,
                           inv_depth_flipped: torch.Tensor,
                           method: str = "mean") -> torch.Tensor:
    """Flip test-time augmentation: ``inv_depth_flipped`` [..., H, W, 1]
    (the prediction on the flipped images) is flipped back and fused with
    ``inv_depth``; the left and right 5% of the width take the single-view
    estimates, which stereo occlusion spoils in the other view."""
    w = inv_depth.shape[-2]
    inv_depth_hat = flip_lr(inv_depth_flipped)
    fused = fuse_inv_depth(inv_depth, inv_depth_hat, method=method)
    xs = torch.linspace(0.0, 1.0, w, dtype=inv_depth.dtype,
                        device=inv_depth.device)[None, :, None]
    mask = 1.0 - torch.clamp(20.0 * (xs - 0.05), 0.0, 1.0)
    mask_hat = torch.flip(mask, dims=(1,))
    return (mask_hat * inv_depth + mask * inv_depth_hat
            + (1.0 - mask - mask_hat) * fused)


def viz_inv_depth(inv_depth: np.ndarray, normalizer: Optional[float] = None,
                  percentile: float = 95, colormap: str = "plasma",
                  filter_zeros: bool = False) -> np.ndarray:
    """Colormap an inverse depth map [H,W] or [H,W,1] (numpy, on the host)
    -> RGB float64 [H,W,3]: the map divided by ``normalizer`` (by default
    its ``percentile``-th percentile, over the non-zero values with
    ``filter_zeros``) and clipped to [0, 1]."""
    inv = np.asarray(inv_depth).squeeze()
    if normalizer is None:
        vals = inv[inv > 0] if filter_zeros and (inv > 0).any() else inv
        normalizer = np.percentile(vals, percentile)
    inv = inv / (normalizer + 1e-6)
    return apply_colormap(np.clip(inv, 0.0, 1.0), colormap)[..., :3]


def load_depth(path: str) -> np.ndarray:
    """A depth map from ``.npz`` or a uint16 ``.png`` (``depth * 256``)."""
    if path.endswith("npz"):
        return np.load(path)["depth"]
    if path.endswith("png"):
        depth_png = read_png(path)
        if depth_png.shape[-1] != 1:
            raise ValueError(f"{path}: a depth png has one channel, not {depth_png.shape[-1]}")
        depth_png = depth_png[..., 0].astype(np.float64)
        if not depth_png.max() > 255:
            raise ValueError(f"Wrong .png depth file {path}: no value above 255")
        return (depth_png / 256.0).astype(np.float32)
    raise NotImplementedError(f"Depth extension not supported: {path}")


def write_depth(path: str, depth: np.ndarray,
                intrinsics: Optional[np.ndarray] = None) -> None:
    """Save a depth map to ``.npz`` or uint16 ``.png`` (``depth * 256``)."""
    depth = np.asarray(depth).squeeze()
    if path.endswith(".npz"):
        np.savez_compressed(path, depth=depth, intrinsics=intrinsics)
    elif path.endswith(".png"):
        write_png(path, (depth * 256.0).astype(np.uint16))
    else:
        raise NotImplementedError(f"Depth filename not valid: {path}")
