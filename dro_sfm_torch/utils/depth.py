"""Flip-fusion post-processing of inverse depth maps.

PyTorch counterpart of `fuse_inv_depth` and `post_process_inv_depth` in
`dro_sfm_tpu/utils/depth.py`.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.ops.image import flip_lr


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
