"""Render a dataset's samples to a preview video or PNG frames.

    python -m dro_sfm_torch.scripts.preview_dataset --config configs/train_synthetic.yaml \
        --split train --output preview.avi [--max-samples 50]

The port's copy of `tools/preview_dataset.py`: each sample's target, its
context frames and, where it has one, its ground-truth inverse depth, side
by side in a labelled grid. ``--output`` ending in ``.avi`` writes an MJPEG
AVI at 5 frames/s (the JAX tool writes mp4, which the port has no encoder
for, ROADMAP C); any other path is a folder of PNG frames.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dataset preview")
    p.add_argument("--config", required=True)
    p.add_argument("--split", default="train", choices=["train", "validation", "test"])
    p.add_argument("--output", required=True, help=".avi or folder of pngs")
    p.add_argument("--max-samples", type=int, default=50)
    args = p.parse_args(argv)
    if args.output.endswith(".mp4"):
        raise NotImplementedError(f"{args.output}: the port writes an MJPEG .avi or PNG "
                                  "frames (no mp4 encoder, ROADMAP C)")

    import numpy as np

    from dro_sfm_torch.data import setup_dataset
    from dro_sfm_torch.utils.config import load_config
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.image_io import write_png
    from dro_sfm_torch.visualization.image_grid import ImageGrid, write_video

    cfg = load_config(args.config)
    ds = setup_dataset(cfg.datasets[args.split], cfg.datasets.augmentation, args.split)
    if isinstance(ds, list):
        ds = ds[0]
    n = min(len(ds), args.max_samples)
    frames = []
    for i in range(n):
        s = ds[i]
        n_ctx = s["rgb_context"].shape[0]
        cols = 1 + n_ctx + (1 if "depth" in s else 0)
        h, w = s["rgb"].shape[:2]
        grid = ImageGrid(1, cols, h, w)
        grid.set_cell(0, 0, s["rgb"], label=f"rgb {s['filename'][:18]}")
        for c in range(n_ctx):
            grid.set_cell(0, 1 + c, s["rgb_context"][c], label=f"ctx{c}")
        if "depth" in s:
            d = np.asarray(s["depth"])[..., 0]
            inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0)
            grid.set_cell(0, cols - 1, viz_inv_depth(inv), label="gt inv depth")
        frames.append(grid.canvas)
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{n}]")
    if args.output.endswith(".avi"):
        write_video(args.output, frames, fps=5)
        print(f"wrote {args.output} ({len(frames)} samples)")
    else:
        os.makedirs(args.output, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(args.output, f"{i:05d}.png"), f)
        print(f"wrote {len(frames)} pngs to {args.output}")
    return len(frames)


if __name__ == "__main__":
    main()
