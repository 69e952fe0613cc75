"""Depth inference CLI of the port for a frame or a folder of them (PNG, JPEG, BMP).

    python -m dro_sfm_torch.scripts.infer --checkpoint x.ckpt --input frames/ --output out/
    python -m dro_sfm_torch.scripts.infer ... --save png --ply --device cpu

The port's counterpart of `scripts/infer.py`. The checkpoint is the port's
or the JAX package's (`inference.load_model_and_config`). Each frame is the
target of a window with its neighbours in the folder as context (itself at
the ends); its depth is written as ``<name>.npz`` (depth, intrinsics) or a
uint16 ``<name>.png`` (``depth * 256``) or, with ``--save viz``,
``<name>_viz.png``: the frame stacked over its colormapped inverse depth
(`viz_inv_depth`); with ``--ply`` its point cloud. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch depth inference")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input", required=True, help="frame (PNG, JPEG, BMP) or folder")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--save", default="npz", choices=["npz", "png", "viz"])
    p.add_argument("--ply", action="store_true",
                   help="also export a point cloud per frame")
    p.add_argument("--image-shape", type=int, nargs=2, default=None)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Run the CLI; returns the files written (depth files or panels)."""
    args = parse_args(argv)
    import numpy as np

    from dro_sfm_torch.scripts.frames import FrameLoader, list_frames, open_model
    from dro_sfm_torch.utils.depth import viz_inv_depth, write_depth
    from dro_sfm_torch.utils.image_io import write_png
    from dro_sfm_torch.visualization.pointcloud import export_pointcloud

    files = (list_frames(args.input) if os.path.isdir(args.input) else [args.input])
    if not files:
        raise ValueError(f"no images found in {args.input}")
    infer, shape, K = open_model(args.checkpoint, args.device, args.image_shape)
    load = FrameLoader(shape)
    os.makedirs(args.output, exist_ok=True)
    written = []
    for i, f in enumerate(files):
        target = load(f)
        prev_f = files[i - 1] if i > 0 else f
        next_f = files[i + 1] if i + 1 < len(files) else f
        depth, _ = infer(target, np.stack([load(prev_f), load(next_f)]))
        base = os.path.join(args.output, os.path.splitext(os.path.basename(f))[0])
        if args.save == "viz":
            inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
            viz = (viz_inv_depth(inv) * 255).astype(np.uint8)
            write_png(f"{base}_viz.png",
                      np.concatenate([(target * 255).astype(np.uint8), viz], axis=0))
            written.append(f"{base}_viz.png")
        else:
            write_depth(f"{base}.{args.save}", depth, intrinsics=K)
            written.append(f"{base}.{args.save}")
        if args.ply:
            export_pointcloud(f"{base}.ply", depth, K, rgb=target)
        print(f"[{i + 1}/{len(files)}] {f} -> {written[-1]}")
    return written


if __name__ == "__main__":
    main()
