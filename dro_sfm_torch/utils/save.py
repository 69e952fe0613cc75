"""Test-time depth files.

PyTorch-side counterpart of `dro_sfm_tpu/utils/save.py` for the ``npz`` and
``png`` flags of ``config.save.depth``: per sample, a compressed ``.npz``
with the depth map and the intrinsics and a uint16 ``.png`` of ``depth *
256``. The ``rgb`` and ``viz`` images (an RGB writer and a colormap of the
depth) are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from dro_sfm_torch.utils.depth import write_depth

_NOT_PORTED = ("save.depth.{} is not ported yet: the rgb and viz panels need a "
               "colour image writer and a colormap (ROADMAP A9). Set save.depth.rgb "
               "and .viz to False (npz and png depth files are written).")


def check_save_flags(save_cfg) -> None:
    """Raise when ``save.depth`` asks for a file the port cannot write."""
    for flag in ("rgb", "viz"):
        if save_cfg.depth[flag]:
            raise NotImplementedError(_NOT_PORTED.format(flag))


def save_depth(batch: Dict, output: Dict, save_cfg, prefix: str = "") -> None:
    """Write ``<folder>/<filename>_depth.npz`` and ``.png`` (as
    ``save.depth`` asks) for each valid sample of an evaluation batch:
    ``batch`` is the collated numpy batch (``filename``, ``intrinsics``,
    ``valid``), ``output`` the evaluation step's (``inv_depth_pp``
    [B,H,W,1])."""
    check_save_flags(save_cfg)
    if not (save_cfg.depth.npz or save_cfg.depth.png):
        return
    folder = save_cfg.folder
    os.makedirs(folder, exist_ok=True)
    inv_depths = output["inv_depth_pp"].float().cpu().numpy()
    depths = np.where(inv_depths > 0, 1.0 / np.maximum(inv_depths, 1e-6), 0.0)
    valid = batch.get("valid")
    for i, filename in enumerate(batch["filename"]):
        if valid is not None and not valid[i]:
            continue
        name = filename.replace("/", "_")
        if prefix:
            name = f"{prefix}_{name}"
        base = os.path.join(folder, name)
        if save_cfg.depth.npz:
            write_depth(base + "_depth.npz", depths[i],
                        intrinsics=np.asarray(batch["intrinsics"][i]))
        if save_cfg.depth.png:
            write_depth(base + "_depth.png", depths[i])
