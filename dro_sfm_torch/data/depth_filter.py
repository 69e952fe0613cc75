"""Capture-quality filters: depth range clipping, pose validity, motion
thresholds, and the sequence drop/split pass (numpy, on the host).

The port's copy of `dro_sfm_tpu/data/depth_filter.py`, which it may not
import: a frame is dropped when its pose is not finite or more than 40% of
its depth lies outside 0.4-10 m, and a kept frame starts a new segment when
its motion from the previous kept frame passes a threshold preset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# Depth range clip in millimetres (`depth_filter.py:26-27`).
CLIP_DEPTH_MIN_MM = 400     # 0.4 m
CLIP_DEPTH_MAX_MM = 10000   # 10.0 m


def clip_depth(depth_mm: np.ndarray,
               min_mm: float = CLIP_DEPTH_MIN_MM,
               max_mm: float = CLIP_DEPTH_MAX_MM) -> np.ndarray:
    """Zero out depth readings outside the trusted sensor range.

    Millimetre depth images (`depth_filter.py:14-34`); returns a copy.
    """
    out = np.array(depth_mm)
    out[(out < min_mm) | (out > max_mm)] = 0
    return out


def is_invalid_pose(pose: np.ndarray) -> bool:
    """True if the pose matrix contains NaN/Inf (`depth_filter.py:37-55`,
    vectorized instead of the reference's per-element loop)."""
    return bool(~np.all(np.isfinite(pose)))


def matrix_to_6d_pose(pose_curr: np.ndarray,
                      pose_prev: np.ndarray) -> np.ndarray:
    """Relative pose prev->curr as [tx, ty, tz (mm), rx, ry, rz (deg)].

    `depth_filter.py:78-91`; euler extraction mirrors
    `geometry/rotations.matrix_to_euler` (host numpy copy — the magnitudes
    drive thresholding, branch convention matches `pose_utils.py:7-35`).
    """
    rel = np.linalg.inv(pose_prev) @ pose_curr
    r = rel[:3, :3]
    cy = float(np.sqrt(r[2, 2] ** 2 + r[1, 2] ** 2))
    if cy > 1e-6:
        ex = np.arctan2(-r[1, 2], r[2, 2])
        ez = np.arctan2(-r[0, 1], r[0, 0])
    else:
        ex = 0.0
        ez = np.arctan2(r[1, 0], r[1, 1])
    ey = np.arctan2(r[0, 2], cy)
    deg = np.degrees([ex, ey, ez])
    t_mm = rel[:3, 3] * 1000.0
    return np.array([t_mm[0], t_mm[1], t_mm[2], deg[0], deg[1], deg[2]])


@dataclass(frozen=True)
class MotionThreshold:
    """Per-axis + norm limits on inter-frame motion (`depth_filter.py:93-116`)."""
    d_t: float      # per-axis translation limit, mm
    d_ts: float     # translation norm limit, mm
    d_r: float      # per-axis rotation limit, deg
    d_rs: float     # rotation norm limit, deg

    def contains(self, pose_6d: Sequence[float]) -> bool:
        p = np.asarray(pose_6d, dtype=np.float64)
        t, r = p[:3], p[3:]
        if np.linalg.norm(t) > self.d_ts or np.linalg.norm(r) > self.d_rs:
            return False
        return bool(np.all(np.abs(t) <= self.d_t)
                    and np.all(np.abs(r) <= self.d_r))


# Statistical presets from the reference capture study
# (`depth_filter.py:117-139`, "viz_scene0600_00.avi").
THRESHOLD_1 = MotionThreshold(d_t=90.0, d_ts=120.0, d_r=5.0, d_rs=7.5)
THRESHOLD_5 = MotionThreshold(d_t=145.0, d_ts=205.0, d_r=14.5, d_rs=21.5)


def pose_in_threshold_1(pose_6d: Sequence[float]) -> bool:
    return THRESHOLD_1.contains(pose_6d)


def pose_in_threshold_5(pose_6d: Sequence[float]) -> bool:
    return THRESHOLD_5.contains(pose_6d)


def find_idx_of_prev_n(dropped: Sequence[bool], curr_idx: int,
                       prev_n: int) -> int:
    """Index of the ``prev_n``-th kept frame before ``curr_idx``
    (`depth_filter.py:58-76`); -1 when fewer exist."""
    n = prev_n
    for idx in range(curr_idx - 1, -1, -1):
        if dropped[idx]:
            continue
        n -= 1
        if n == 0:
            return idx
    return -1


def invalid_depth_fraction(depth_mm: np.ndarray) -> float:
    """Fraction of pixels outside the trusted range after clipping
    (`matterport_filter.py:70-77`)."""
    clipped = clip_depth(depth_mm)
    return float(np.count_nonzero(clipped <= 0)) / clipped.size


def filter_sequence(poses: Sequence[np.ndarray],
                    invalid_fracs: Sequence[float],
                    max_invalid_frac: float = 0.4,
                    threshold: MotionThreshold = THRESHOLD_1,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop/split pass over one capture sequence.

    The reference's sequence filter (`matterport_filter.py:92-150`): a frame
    is *dropped* when its pose is invalid or more than ``max_invalid_frac``
    of its depth is untrusted; a kept frame *starts a new segment* when its
    motion relative to the previous kept frame exceeds ``threshold`` (the
    camera jumped — warping across the gap is hopeless).

    Returns (keep [N] bool, segment_id [N] int32; -1 for dropped frames).
    """
    n = len(poses)
    keep = np.zeros(n, dtype=bool)
    seg = np.full(n, -1, dtype=np.int32)
    dropped = [False] * n
    seg_id = -1
    prev_kept = -1
    for i in range(n):
        if invalid_fracs[i] > max_invalid_frac or is_invalid_pose(poses[i]):
            dropped[i] = True
            continue
        if prev_kept < 0:
            seg_id += 1
        else:
            pose_6d = matrix_to_6d_pose(poses[i], poses[prev_kept])
            if not threshold.contains(pose_6d):
                seg_id += 1
        keep[i] = True
        seg[i] = seg_id
        prev_kept = i
    return keep, seg


def split_lines_from_segments(names: Sequence[str], keep: np.ndarray,
                              seg: np.ndarray, scene: str,
                              min_segment: int = 3) -> List[str]:
    """Split-file lines ``scene frame`` for kept frames, skipping segments
    shorter than ``min_segment`` (too short for context windows;
    `matterport_filter.py:152-170` writes filtered split lists)."""
    lines: List[str] = []
    for s in range(int(seg.max()) + 1 if keep.any() else 0):
        idxs = np.nonzero(seg == s)[0]
        if len(idxs) < min_segment:
            continue
        lines.extend(f"{scene} {names[i]}" for i in idxs)
    return lines
