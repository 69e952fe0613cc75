"""Trajectory files of the video demo (numpy).

The port's copy of the numerical helpers of
`dro_sfm_tpu/visualization/demo_video.py`: the trajectory as an OBJ, the
ground-truth poses of a frame folder, and the alignment to them. The
annotated multi-panel video (`DemoVideoComposer` and its panels) needs
OpenCV's drawing and video writer and is ROADMAP A9.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from dro_sfm_torch.visualization.trajectory import (
    absolute_trajectory_error,
    positions_from_poses,
    umeyama_alignment,
)

VIDEO_NOT_PORTED = ("the annotated demo video (depth_vis.mp4), its per-frame panels and "
                    "trajectory.png need OpenCV and matplotlib; they are ROADMAP A9")


def poses_to_obj(path: str, poses: Sequence[np.ndarray]) -> None:
    """Camera centres as OBJ vertices, with a triangle fan so that mesh
    viewers draw the path."""
    with open(path, "w") as f:
        for p in poses:
            f.write(f"v {p[0, 3]} {p[1, 3]} {p[2, 3]}\n")
        for i in range(1, len(poses) - 1, 2):
            f.write(f"f {i} {i + 1} {i + 2}\n")


def load_gt_poses(pose_dir: str, frame_files: Sequence[str],
                  ) -> Optional[List[np.ndarray]]:
    """The ground-truth pose ([4,4] text, one file per frame, matched by
    base name) of each frame, or None unless every frame has a finite one."""
    poses = []
    for f in frame_files:
        base = os.path.splitext(os.path.basename(f))[0]
        p = os.path.join(pose_dir, base + ".txt")
        if not os.path.exists(p):
            return None
        pose = np.genfromtxt(p).reshape(4, 4)
        if not np.all(np.isfinite(pose)):
            return None
        poses.append(pose.astype(np.float64))
    return poses


def align_to_gt(pred_poses: Sequence[np.ndarray],
                gt_poses: Sequence[np.ndarray]):
    """Umeyama-align the predicted camera centres to the ground truth:
    (aligned positions [T,3], ATE-RMSE)."""
    p = positions_from_poses(pred_poses)
    g = positions_from_poses(gt_poses)
    s, R, t = umeyama_alignment(p, g, with_scale=True)
    aligned = (s * (R @ p.T)).T + t
    ate = absolute_trajectory_error(pred_poses, gt_poses, align_scale=True)
    return aligned, ate
