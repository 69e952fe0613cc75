"""Depth inference CLI of the port for a frame or a folder of them (PNG, JPEG, BMP).

    python -m dro_sfm_torch.scripts.infer --checkpoint x.ckpt --input frames/ --output out/
    python -m dro_sfm_torch.scripts.infer ... --save png --ply --device cpu

The port's counterpart of `scripts/infer.py`. The checkpoint is the port's
or the JAX package's (`inference.load_model_and_config`). Each frame is the
target of a window with its neighbours in the folder as context (itself at
the ends); its depth is written as ``<name>.npz`` (depth, intrinsics) or a
uint16 ``<name>.png`` (``depth * 256``), and with ``--ply`` its point
cloud. Runs on the card unless ``--device cpu``. ``--save viz`` (a
colormapped panel) is ROADMAP A9 and raises.
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
    """Run the CLI; returns the depth files written."""
    args = parse_args(argv)
    if args.save == "viz":
        raise NotImplementedError("--save viz needs a colormap and a colour image "
                                  "writer (ROADMAP A9); use --save npz or png")
    import numpy as np

    from dro_sfm_torch.scripts.frames import FrameLoader, list_frames, open_model
    from dro_sfm_torch.utils.depth import write_depth
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
        write_depth(f"{base}.{args.save}", depth, intrinsics=K)
        written.append(f"{base}.{args.save}")
        if args.ply:
            export_pointcloud(f"{base}.ply", depth, K, rgb=target)
        print(f"[{i + 1}/{len(files)}] {f} -> {base}.{args.save}")
    return written


if __name__ == "__main__":
    main()
