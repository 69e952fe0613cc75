"""Depth <-> inverse-depth conversions (leaf module, no intra-repo deps).

PyTorch counterpart of `dro_sfm_tpu/ops/depth_ops.py`.
"""
from __future__ import annotations

import torch


def inv2depth(inv_depth: torch.Tensor) -> torch.Tensor:
    """Inverse depth -> depth; non-positive inputs map to 0."""
    depth = 1.0 / inv_depth.clamp_min(1e-6)
    return torch.where(inv_depth <= 0.0, torch.zeros_like(depth), depth)


def depth2inv(depth: torch.Tensor) -> torch.Tensor:
    """Depth -> inverse depth; non-positive inputs map to 0."""
    inv = 1.0 / depth.clamp_min(1e-6)
    return torch.where(depth <= 0.0, torch.zeros_like(inv), inv)


def _clip01_straight_through(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) forward, identity gradient backward: a hard clip's zero
    gradient would freeze saturated disparity pixels for good."""
    return x + (x.clamp(0.0, 1.0) - x).detach()


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Map a sigmoid output to (scaled_disp, depth) within depth bounds.

    ``disp`` is clamped to [0, 1] first (straight-through gradient), so the
    result is a valid inverse depth in [1/max_depth, 1/min_depth] even for
    the raw accumulated refinement deltas.
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * _clip01_straight_through(disp)
    return scaled_disp, 1.0 / scaled_disp
