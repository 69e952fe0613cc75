"""Depth metrics of a folder of predicted depth maps against a folder of
ground truth, no model needed: the port's counterpart of
`scripts/evaluate_depth_maps.py`.

    python -m dro_sfm_torch.scripts.evaluate_depth_maps --pred out/ --gt gt/ \\
        [--crop garg|eigen_nyu] [--min-depth 0.2] [--max-depth 80] [--use-gt-scale]

Files are ``.npz`` (``depth``) or uint16 ``.png`` (``depth * 256``), paired
in sorted order. The mean of the 9 depth metrics over the pairs is printed,
one ``name: value`` line each. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

EXTENSIONS = (".npz", ".png")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="folder-vs-folder depth metrics")
    p.add_argument("--pred", required=True, help="predicted depth folder")
    p.add_argument("--gt", required=True, help="ground-truth depth folder")
    p.add_argument("--crop", default="", choices=["", "garg", "eigen_nyu"])
    p.add_argument("--min-depth", type=float, default=0.2)
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--use-gt-scale", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def depth_files(folder: str):
    return sorted(f for f in os.listdir(folder) if f.endswith(EXTENSIONS))


def main(argv=None) -> np.ndarray:
    """Print and return the 9 mean metrics (`DEPTH_METRIC_NAMES`)."""
    args = parse_args(argv)
    from dro_sfm_torch.training.metrics import (
        DEPTH_METRIC_NAMES,
        MetricsConfig,
        compute_depth_metrics,
    )
    from dro_sfm_torch.utils.depth import load_depth
    from dro_sfm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pred_files, gt_files = depth_files(args.pred), depth_files(args.gt)
    if len(pred_files) != len(gt_files):
        raise SystemExit(f"{len(pred_files)} pred vs {len(gt_files)} gt files")
    cfg = MetricsConfig(crop=args.crop, min_depth=args.min_depth, max_depth=args.max_depth)

    def as_batch(path):
        depth = torch.as_tensor(load_depth(path), dtype=torch.float32)
        return depth.to(device)[None, ..., None]                   # [1,H,W,1]

    total = np.zeros(len(DEPTH_METRIC_NAMES))
    for pf, gf in zip(pred_files, gt_files):
        m = compute_depth_metrics(as_batch(os.path.join(args.gt, gf)),
                                  as_batch(os.path.join(args.pred, pf)), cfg,
                                  use_gt_scale=args.use_gt_scale)
        total += m.cpu().numpy()
    total /= len(pred_files)
    for name, value in zip(DEPTH_METRIC_NAMES, total):
        print(f"{name:>10}: {value:.4f}")
    return total


if __name__ == "__main__":
    main()
