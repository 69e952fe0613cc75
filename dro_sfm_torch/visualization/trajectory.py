"""Trajectory alignment and error (numpy).

The port's copy of the numerical part of
`dro_sfm_tpu/visualization/trajectory.py`: camera positions, the Umeyama
similarity alignment and the absolute trajectory error. The plots need
matplotlib, which the card's machine lacks: `plot_trajectory` raises
(ROADMAP A9).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

PLOT_NOT_PORTED = ("trajectory plots need matplotlib, which the port does not use; "
                   "they are ROADMAP A9 (trajectory.json and trajectory_pose.obj "
                   "hold the trajectory)")


def positions_from_poses(poses: Sequence[np.ndarray]) -> np.ndarray:
    """[T,4,4] camera-to-world poses -> positions [T,3]."""
    return np.asarray([p[:3, 3] for p in poses])


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """The similarity (scale, R [3,3], t [3]) that minimises
    ||y - (s R x + t)||^2 over the points x, y [N,3]."""
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / x.shape[0]
    scale = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = mu_y - scale * R @ mu_x
    return scale, R, t


def absolute_trajectory_error(pred: Sequence[np.ndarray],
                              gt: Sequence[np.ndarray],
                              align_scale: bool = True) -> float:
    """ATE-RMSE between predicted and ground-truth camera-to-world
    trajectories after Umeyama alignment (sim3, or se3 without scale)."""
    p = positions_from_poses(pred)
    g = positions_from_poses(gt)
    if p.shape != g.shape:
        raise ValueError(f"trajectories of shapes {p.shape} and {g.shape}")
    s, R, t = umeyama_alignment(p, g, with_scale=align_scale)
    aligned = (s * (R @ p.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - g) ** 2, axis=1))))


def plot_trajectory(path: str, *args, **kwargs) -> None:
    """Not ported: raises (ROADMAP A9)."""
    raise NotImplementedError(f"{path}: {PLOT_NOT_PORTED}")
