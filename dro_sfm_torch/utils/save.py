"""Test-time depth files.

PyTorch-side counterpart of `dro_sfm_tpu/utils/save.py` for the ``npz``
flag of ``config.save.depth``: one compressed ``.npz`` per sample with the
depth map and the intrinsics. The ``png``, ``rgb`` and ``viz`` files need
OpenCV and matplotlib and are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

_NOT_PORTED = ("save.depth.{} needs OpenCV and matplotlib, which the port "
               "does not use; png, rgb and viz files are ROADMAP A9. Set "
               "save.depth.png, .rgb and .viz to False (npz files need neither).")


def check_save_flags(save_cfg) -> None:
    """Raise when ``save.depth`` asks for a file the port cannot write."""
    for flag in ("png", "rgb", "viz"):
        if save_cfg.depth[flag]:
            raise NotImplementedError(_NOT_PORTED.format(flag))


def save_depth(batch: Dict, output: Dict, save_cfg, prefix: str = "") -> None:
    """Write ``<folder>/<filename>_depth.npz`` for each valid sample of an
    evaluation batch: ``batch`` is the collated numpy batch (``filename``,
    ``intrinsics``, ``valid``), ``output`` the evaluation step's
    (``inv_depth_pp`` [B,H,W,1])."""
    check_save_flags(save_cfg)
    if not save_cfg.depth.npz:
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
        np.savez_compressed(os.path.join(folder, name + "_depth.npz"),
                            depth=np.asarray(depths[i]).squeeze(),
                            intrinsics=np.asarray(batch["intrinsics"][i]))
