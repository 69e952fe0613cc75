"""Capture ingestion: quaternion pose CSV -> per-frame 4x4 pose txts.

    python -m dro_sfm_torch.scripts.ingest_capture --capture /data/cap01 \
        --trajectory /data/cap01/traj.csv --scene cap01 --split-out /data/split.txt \
        [--check] [--filter] [--preview-video /data/cap01/preview.mp4] [--preset gazebo]

The port's counterpart of `tools/ingest_capture.py`, on the port's own image
files (no OpenCV): a capture directory holds ``cam_left/*.jpg``,
``depth/*.png`` (uint16 millimetres) and a trajectory CSV of rows
``timestamp, px, py, pz, qx, qy, qz, qw``; each frame (its timestamp in its
name, in s, ms, us or ns) takes the nearest pose within ``--max-dt``, written
as ``pose/<frame>.txt`` (camera-to-world), and the split file lists the
matched frames as ``MatterportDataset`` reads them. ``--check`` prints the
data-consistency census (missing depths, unmatched frames, invalid poses),
``--filter`` runs the drop/split quality pass
(`dro_sfm_torch.data.depth_filter`), ``--preset gazebo`` writes the
RoboMaker sim intrinsics and applies the camera-to-tracker chain, and
``--preview-video`` writes the rgb|depth-colormap inspection video as the JAX
tool's OpenCV writer does (mp4v; `VideoWriter`: ``.mp4``, ``.m4v``, ``.mov``
or ``.avi``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    two_s = 2.0 / (q @ q)
    r, i, j, k = q
    return np.array([
        [1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
         two_s * (i * k + j * r)],
        [two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
         two_s * (j * k - i * r)],
        [two_s * (i * k - j * r), two_s * (j * k + i * r),
         1 - two_s * (i * i + j * j)],
    ])


def load_trajectory(path: str) -> np.ndarray:
    """CSV rows (ts, px, py, pz, qx, qy, qz, qw) -> [N, 8] floats."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) >= 8:
                rows.append([float(x) for x in parts[:8]])
    return np.asarray(rows)


# Gazebo RoboMaker sim-capture constants, as in the JAX tool: camera
# intrinsics and the body-frame chain camera -> IMU -> GT tracker.
GAZEBO_INTRINSICS = np.array([
    [530.4669406576809, 0.0, 320.5],
    [0.0, 530.4669406576809, 240.5],
    [0.0, 0.0, 1.0]])


def _translation_T(x, y, z):
    T = np.eye(4)
    T[:3, 3] = [x, y, z]
    return T


GAZEBO_CAM2GT = _translation_T(0, 0, -0.068) @ _translation_T(-0.076, 0, -0.025)
# Axis remap between the camera optical frame (z forward) and the gazebo
# body/world frame, behind --apply-cam2world for captures whose tracker
# rotations are body-frame.
GAZEBO_CAM2WORLD = np.array([
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0]])

PRESETS = {
    # preset -> (intrinsics or None, pose transform applied as T @ cam2gt)
    "none": (None, None),
    "gazebo": (GAZEBO_INTRINSICS, GAZEBO_CAM2GT),
}


def census(capture: str, frames, kept, poses) -> dict:
    """Data-consistency counts: frames, matched, unmatched, missing depth,
    invalid poses."""
    from dro_sfm_torch.data.depth_filter import is_invalid_pose
    depth_dir = os.path.join(capture, "depth")
    missing_depth = [
        f for f in kept
        if not os.path.exists(
            os.path.join(depth_dir, os.path.splitext(f)[0] + ".png"))]
    bad_poses = [f for f, T in zip(kept, poses) if is_invalid_pose(T)]
    report = {
        "frames": len(frames),
        "pose_matched": len(kept),
        "unmatched": len(frames) - len(kept),
        "missing_depth": len(missing_depth),
        "invalid_pose": len(bad_poses),
    }
    for k, v in report.items():
        print(f"  check {k}: {v}")
    for f in missing_depth[:10]:
        print(f"    no depth: {f}")
    return report


def read_depth_mm(path: str) -> np.ndarray:
    """The samples of a one-channel depth PNG, [H,W]."""
    from dro_sfm_torch.utils.image_io import read_png
    depth = read_png(path)
    if depth.shape[-1] != 1:
        raise NotImplementedError(f"{path}: a depth PNG has one channel, not {depth.shape[-1]}")
    return depth[..., 0]


def quality_filter(capture: str, kept, poses):
    """Drop/split pass -> (keep mask, segment ids)."""
    from dro_sfm_torch.data.depth_filter import filter_sequence, invalid_depth_fraction
    depth_dir = os.path.join(capture, "depth")
    fracs = []
    for fname in kept:
        dp = os.path.join(depth_dir, os.path.splitext(fname)[0] + ".png")
        if os.path.exists(dp):
            fracs.append(invalid_depth_fraction(read_depth_mm(dp)))
        else:
            fracs.append(0.0)  # no depth channel: pose-only filtering
    return filter_sequence(poses, fracs)


def preview_canvas(rgb: np.ndarray, depth_mm, fname: str) -> np.ndarray:
    """The frame beside its colormapped inverse depth (black without one),
    the frame's name in its corner: uint8 RGB [H, 2W, 3]."""
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.image_io import resize_bilinear_u8
    from dro_sfm_torch.visualization.draw import put_text
    if depth_mm is not None:
        depth_m = depth_mm.astype(np.float32) / 1000.0
        inv = np.where(depth_m > 0, 1.0 / np.maximum(depth_m, 1e-6), 0.0)
        viz = resize_bilinear_u8((viz_inv_depth(inv) * 255).astype(np.uint8), rgb.shape[:2])
    else:
        viz = np.zeros_like(rgb)
    canvas = np.concatenate([rgb, viz], axis=1)
    put_text(canvas, fname, (8, 24), 0.7, (255, 255, 255), 2, 8)
    return canvas


def preview_video(capture: str, kept, out_path: str, fps: int = 10) -> int:
    """rgb|depth-colormap inspection video (mp4v); returns its frames."""
    from dro_sfm_torch.utils.image_io import read_image_rgb
    from dro_sfm_torch.utils.video_io import VideoWriter
    depth_dir = os.path.join(capture, "depth")
    n = 0
    with VideoWriter(out_path, fps) as writer:
        for fname in kept:
            path = os.path.join(capture, "cam_left", fname)
            if not os.path.exists(path):
                continue
            dp = os.path.join(depth_dir, os.path.splitext(fname)[0] + ".png")
            depth_mm = read_depth_mm(dp) if os.path.exists(dp) else None
            writer.write(preview_canvas(read_image_rgb(path), depth_mm, fname))
            n += 1
        if n == 0:
            raise ValueError(f"{out_path}: no frame to preview")
    return n


def main(argv=None) -> dict:
    """Run the CLI; returns the matched frames, the split lines and, with
    ``--check``, the census."""
    p = argparse.ArgumentParser(description="capture -> matterport layout")
    p.add_argument("--capture", required=True,
                   help="capture dir with cam_left/ and depth/")
    p.add_argument("--trajectory", required=True, help="pose CSV")
    p.add_argument("--scene", required=True, help="scene name for the split")
    p.add_argument("--split-out", required=True)
    p.add_argument("--max-dt", type=float, default=0.05,
                   help="max frame/pose timestamp gap (s)")
    p.add_argument("--check", action="store_true",
                   help="print the data-consistency census")
    p.add_argument("--filter", action="store_true",
                   help="apply the depth/pose quality drop+split pass to "
                        "the emitted split")
    p.add_argument("--min-segment", type=int, default=3,
                   help="with --filter: drop kept segments shorter than this")
    p.add_argument("--preview-video", default="",
                   help="write an rgb|depth inspection video (.mp4) here")
    p.add_argument("--preset", choices=sorted(PRESETS), default="none",
                   help="capture rig preset: 'gazebo' writes the RoboMaker "
                        "sim intrinsics and applies the camera->GT-tracker "
                        "translation chain to trajectory poses")
    p.add_argument("--apply-cam2world", action="store_true",
                   help="also apply the optical-frame axis remap "
                        "(GAZEBO_CAM2WORLD) for captures whose tracker "
                        "rotations are gazebo body-frame; off by default")
    args = p.parse_args(argv)

    preset_K, preset_T = PRESETS[args.preset]
    if args.apply_cam2world:
        preset_T = (GAZEBO_CAM2WORLD if preset_T is None
                    else preset_T @ GAZEBO_CAM2WORLD)

    traj = load_trajectory(args.trajectory)
    ts = traj[:, 0]
    cam_dir = os.path.join(args.capture, "cam_left")
    pose_dir = os.path.join(args.capture, "pose")
    os.makedirs(pose_dir, exist_ok=True)

    frames = sorted(f for f in os.listdir(cam_dir) if f.endswith(".jpg"))
    kept, kept_poses = [], []
    for fname in frames:
        # Frame timestamps are encoded in the filename (ms or ns ticks).
        stamp = float(os.path.splitext(fname)[0])
        for scale in (1.0, 1e-3, 1e-6, 1e-9):
            i = int(np.argmin(np.abs(ts - stamp * scale)))
            if abs(ts[i] - stamp * scale) <= args.max_dt:
                break
        else:
            continue
        _, px, py, pz, qx, qy, qz, qw = traj[i]
        T = np.eye(4)
        T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
        T[:3, 3] = [px, py, pz]
        if preset_T is not None:
            T = T @ preset_T  # tracker pose -> camera pose
        np.savetxt(os.path.join(pose_dir, fname.replace(".jpg", ".txt")), T)
        kept.append(fname)
        kept_poses.append(T)

    if preset_K is not None:
        np.savetxt(os.path.join(args.capture, "intrinsics.txt"), preset_K)

    report = census(args.capture, frames, kept, kept_poses) if args.check else None

    if args.filter:
        from dro_sfm_torch.data.depth_filter import split_lines_from_segments
        keep, seg = quality_filter(args.capture, kept, kept_poses)
        lines = split_lines_from_segments(
            kept, keep, seg, f"{args.scene}/cam_left",
            min_segment=args.min_segment)
        print(f"filter kept {int(keep.sum())}/{len(kept)} frames in "
              f"{int(seg.max()) + 1 if keep.any() else 0} segments; "
              f"{len(lines)} split lines after min-segment")
    else:
        lines = [f"{args.scene}/cam_left {fname}" for fname in kept]

    with open(args.split_out, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))

    if args.preview_video:
        n = preview_video(args.capture, kept, args.preview_video)
        print(f"preview video: {n} frames -> {args.preview_video}")

    print(f"matched {len(kept)}/{len(frames)} frames; "
          f"poses in {pose_dir}, split in {args.split_out}")
    return {"kept": kept, "lines": lines, "census": report}


if __name__ == "__main__":
    main()
