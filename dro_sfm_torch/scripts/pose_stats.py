"""Per-sequence camera-pose statistics and validity census.

    python -m dro_sfm_torch.scripts.pose_stats /data/scans/scene0000_00 [...more dirs]
        [--pose-subdir pose] [--timestamp-unit ms]

The port's copy of `tools/pose_stats.py`: for each sequence directory of
per-frame pose ``.txt`` files, frame-to-frame motion (min, max, mean,
total), rotation validity (orthonormality and determinant), NaN poses and,
when frame names encode timestamps, the capture intervals. One JSON line a
sequence on standard output, a summary line on standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def rotation_defect(R: np.ndarray) -> float:
    """Deviation of R from SO(3): ||R R^T - I||_F + |det(R) - 1|."""
    return float(np.linalg.norm(R @ R.T - np.eye(3)) + abs(np.linalg.det(R) - 1.0))


def sequence_stats(seq_dir: str, pose_subdir: str = "pose",
                   timestamp_unit: str = "") -> dict:
    pose_dir = os.path.join(seq_dir, pose_subdir)
    if not os.path.isdir(pose_dir):
        pose_dir = seq_dir
    # Numeric frame order ("10" after "2").
    files = sorted((f for f in os.listdir(pose_dir) if f.endswith(".txt")),
                   key=lambda f: (int("".join(c for c in f if c.isdigit()) or 0), f))
    positions, stamps = [], []
    n_nan = n_bad_rot = 0
    worst_defect = 0.0
    for fname in files:
        pose = np.genfromtxt(os.path.join(pose_dir, fname))
        if pose.size < 12:
            continue
        pose = pose.reshape(-1, 4)[:4]
        if not np.all(np.isfinite(pose)):
            n_nan += 1
            continue
        defect = rotation_defect(pose[:3, :3])
        worst_defect = max(worst_defect, defect)
        if defect > 1e-2:
            n_bad_rot += 1
        positions.append(pose[:3, 3])
        if timestamp_unit:
            digits = "".join(c for c in os.path.splitext(fname)[0] if c.isdigit())
            if digits:
                stamps.append(int(digits))
    out = {"sequence": os.path.basename(seq_dir.rstrip("/")),
           "n_pose_files": len(files),
           "n_valid": len(positions),
           "n_nan": n_nan,
           "n_bad_rotation": n_bad_rot,
           "worst_rotation_defect": round(worst_defect, 6)}
    if len(positions) >= 2:
        step = np.linalg.norm(np.diff(np.stack(positions), axis=0), axis=1)
        out["move_m"] = {"min": round(float(step.min()), 6),
                         "max": round(float(step.max()), 6),
                         "mean": round(float(step.mean()), 6),
                         "total": round(float(step.sum()), 3)}
    if len(stamps) >= 2:
        scale = {"ms": 1.0, "us": 1e-3, "ns": 1e-6}.get(timestamp_unit, 1.0)
        dt = np.diff(np.asarray(stamps, np.float64)) * scale
        out["dt_ms"] = {"min": round(float(dt.min()), 3),
                        "max": round(float(dt.max()), 3),
                        "mean": round(float(dt.mean()), 3)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="camera pose statistics")
    ap.add_argument("dirs", nargs="+", help="sequence directories")
    ap.add_argument("--pose-subdir", default="pose")
    ap.add_argument("--timestamp-unit", default="",
                    help="ms|us|ns: frame names encode timestamps")
    args = ap.parse_args(argv)
    for d in args.dirs:
        stats = sequence_stats(d, args.pose_subdir, args.timestamp_unit)
        print(json.dumps(stats))
        move = stats.get("move_m", {})
        print(f"  {stats['sequence']}: {stats['n_valid']} valid poses "
              f"({stats['n_nan']} NaN, {stats['n_bad_rotation']} bad R), "
              f"move mean {move.get('mean', 0)} m", file=sys.stderr)


if __name__ == "__main__":
    main()
