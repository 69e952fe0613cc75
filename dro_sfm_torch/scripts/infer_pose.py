"""Sliding-window pose inference CLI of the port.

    python -m dro_sfm_torch.scripts.infer_pose --checkpoint x.ckpt --input frames/ \
        --output trajectory.json [--device cpu]

The port's counterpart of `scripts/infer_pose.py`: 3-frame windows over a
folder of frames (PNG, JPEG, BMP), the relative poses chained into a global trajectory
with monocular scale propagation (`inference.TrajectoryAccumulator`),
written as json, and with ``--plot`` as a top-down figure
(`plot_trajectory`). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch pose inference")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input", required=True, help="frame folder")
    p.add_argument("--output", required=True, help="output json path")
    p.add_argument("--plot", default=None, help="optional trajectory png")
    p.add_argument("--image-shape", type=int, nargs=2, default=None)
    p.add_argument("--sample-rate", type=int, default=1)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Run the CLI; returns the trajectory (camera-to-world [4,4] poses)."""
    args = parse_args(argv)
    import numpy as np

    from dro_sfm_torch.inference import TrajectoryAccumulator
    from dro_sfm_torch.scripts.frames import FrameLoader, list_frames, open_model

    files = list_frames(args.input, args.sample_rate)
    if len(files) <= 2:
        raise ValueError(f"need at least 3 frames in {args.input}, found {len(files)}")
    infer, shape, _ = open_model(args.checkpoint, args.device, args.image_shape)
    load = FrameLoader(shape)
    accum = TrajectoryAccumulator()
    for i in range(1, len(files) - 1):
        _, poses = infer(load(files[i]), np.stack([load(files[i - 1]), load(files[i + 1])]))
        accum.add(poses[0], poses[1])            # pose21 (prev), pose23 (next)
        print(f"[{i}/{len(files) - 2}] {os.path.basename(files[i])}")
    accum.save_json(args.output)
    print(f"trajectory ({len(accum.trajectory)} poses) -> {args.output}")
    if args.plot:
        from dro_sfm_torch.visualization.trajectory import plot_trajectory
        plot_trajectory(args.plot, accum.trajectory)
        print(f"plot -> {args.plot}")
    return accum.trajectory


if __name__ == "__main__":
    main()
