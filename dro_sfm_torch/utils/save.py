"""Test-time depth files and images.

PyTorch-side counterpart of `dro_sfm_tpu/utils/save.py`: for each valid
sample of an evaluation batch, as the flags of ``config.save.depth`` ask, a
compressed ``.npz`` with the depth map and the intrinsics, a uint16
``.png`` of ``depth * 256``, the input image (``_rgb.png``) and the
colormapped inverse depth (``_viz.png``, `viz_inv_depth`), the images
written by the port's PNG writer with the JAX package's uint8 rounding.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from dro_sfm_torch.utils.depth import viz_inv_depth, write_depth
from dro_sfm_torch.utils.image_io import write_png


def to_host(x) -> np.ndarray:
    """A tensor (on the card or the host) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def save_depth(batch: Dict, output: Dict, save_cfg, prefix: str = "") -> None:
    """Write ``<folder>/<filename>_depth.npz``, ``_depth.png``, ``_rgb.png``
    and ``_viz.png`` (as ``save.depth`` asks) for each valid sample of an
    evaluation batch: ``batch`` is the collated numpy batch (``filename``,
    ``rgb``, ``intrinsics``, ``valid``), ``output`` the evaluation step's
    (``inv_depth_pp`` [B,H,W,1])."""
    flags = save_cfg.depth
    if not (flags.rgb or flags.viz or flags.npz or flags.png):
        return
    folder = save_cfg.folder
    os.makedirs(folder, exist_ok=True)
    inv_depths = to_host(output["inv_depth_pp"])
    depths = np.where(inv_depths > 0, 1.0 / np.maximum(inv_depths, 1e-6), 0.0)
    rgbs = to_host(batch["rgb"]) if flags.rgb else None
    valid = batch.get("valid")
    for i, filename in enumerate(batch["filename"]):
        if valid is not None and not valid[i]:
            continue
        name = filename.replace("/", "_")
        if prefix:
            name = f"{prefix}_{name}"
        base = os.path.join(folder, name)
        if flags.npz:
            write_depth(base + "_depth.npz", depths[i],
                        intrinsics=np.asarray(batch["intrinsics"][i]))
        if flags.png:
            write_depth(base + "_depth.png", depths[i])
        if flags.rgb:
            write_png(base + "_rgb.png", (rgbs[i] * 255).astype(np.uint8))
        if flags.viz:
            write_png(base + "_viz.png", (viz_inv_depth(inv_depths[i]) * 255).astype(np.uint8))
