"""Trajectory alignment, error and the top-down plot (numpy, on the host).

The port's counterpart of `dro_sfm_tpu/visualization/trajectory.py`: camera
positions, the Umeyama similarity alignment, the absolute trajectory error
and `plot_trajectory`. The JAX package plots with matplotlib, which the
card's machine lacks; the port draws its own figure with
`dro_sfm_torch.visualization.draw` (the same content, not matplotlib's
look: ROADMAP C).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

PLOT_SIZE = 640                      # the figure's side, pixels
PLOT_MARGIN = 48
BLUE, GREEN, RED = (31, 119, 180), (44, 160, 44), (214, 39, 40)
DASH, GAP = 10.0, 9.0                # the ground truth's dashes, pixels (the caps take 2 of a gap)


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


def dashes(points: np.ndarray, on: float = DASH, off: float = GAP):
    """The pieces of the polyline ``points`` [N,2] that a dashed line draws:
    ``on`` pixels drawn, ``off`` left out, along its length."""
    pts = np.asarray(points, np.float64)
    seg = np.diff(pts, axis=0)
    lengths = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(lengths)])
    period, pieces = on + off, []
    start = 0.0
    while start < cum[-1]:
        stop = min(start + on, cum[-1])
        s = np.concatenate([[start], cum[(cum > start) & (cum < stop)], [stop]])
        pieces.append(np.stack([np.interp(s, cum, pts[:, 0]), np.interp(s, cum, pts[:, 1])], 1))
        start += period
    return pieces


def plot_trajectory(path: str, poses: Sequence[np.ndarray],
                    gt_poses: Optional[Sequence[np.ndarray]] = None,
                    axes=(0, 2), title: str = "trajectory") -> dict:
    """Top-down trajectory figure saved as a PNG: the prediction as a solid
    blue line with a green marker at its start, the ground truth (if given)
    as a dashed red line, one scale on both axes, a legend and a title.
    ``axes`` selects the ground plane (x, z by default for forward-moving
    cameras). Returns the figure (uint8 RGB) and its map from the plane to
    pixels: ``x = x0 + scale * (p[axes[0]] - lo[0])``, ``y = y0 - scale *
    (p[axes[1]] - lo[1])``."""
    from dro_sfm_torch.utils.image_io import write_png
    from dro_sfm_torch.visualization.draw import (
        circle_filled, get_text_size, polylines, put_text)
    p = positions_from_poses(poses)[:, list(axes)]
    g = None if gt_poses is None else positions_from_poses(gt_poses)[:, list(axes)]
    ref = p if g is None else np.concatenate([p, g])
    lo, hi = ref.min(axis=0), ref.max(axis=0)
    box = PLOT_SIZE - 2 * PLOT_MARGIN
    scale = box / max(float((hi - lo).max()), 1e-9)
    x0 = PLOT_MARGIN + (box - scale * (hi[0] - lo[0])) / 2
    y0 = PLOT_SIZE - PLOT_MARGIN - (box - scale * (hi[1] - lo[1])) / 2

    def to_px(q):
        return np.stack([x0 + scale * (q[:, 0] - lo[0]), y0 - scale * (q[:, 1] - lo[1])], 1)

    img = np.full((PLOT_SIZE, PLOT_SIZE, 3), 255, np.uint8)
    frame = np.array([[PLOT_MARGIN - 8] * 2, [PLOT_SIZE - PLOT_MARGIN + 8, PLOT_MARGIN - 8],
                      [PLOT_SIZE - PLOT_MARGIN + 8] * 2,
                      [PLOT_MARGIN - 8, PLOT_SIZE - PLOT_MARGIN + 8]])
    polylines(img, frame, (0, 0, 0), 1, closed=True)
    if g is not None:
        for piece in dashes(to_px(g)):
            polylines(img, np.rint(piece).astype(np.int64), RED, 2)
    pix = np.rint(to_px(p)).astype(np.int64)
    polylines(img, pix, BLUE, 2)
    circle_filled(img, pix[0], 5, GREEN)
    (tw, _), _ = get_text_size(title, 0.5)
    put_text(img, title, ((PLOT_SIZE - tw) // 2, PLOT_MARGIN - 18), 0.5, (0, 0, 0))
    entries = [("pred", BLUE, "line"), ("start", GREEN, "dot")]
    if g is not None:
        entries.append(("gt", RED, "dash"))
    lx, ly = PLOT_SIZE - PLOT_MARGIN - 90, PLOT_MARGIN + 4
    polylines(img, np.array([[lx - 6, ly - 6], [lx + 84, ly - 6],
                             [lx + 84, ly + 20 * len(entries) - 4],
                             [lx - 6, ly + 20 * len(entries) - 4]]), (128, 128, 128), 1,
              closed=True)
    for k, (name, color, kind) in enumerate(entries):
        y = ly + 20 * k + 6
        if kind == "dot":
            circle_filled(img, (lx + 14, y), 5, color)
        else:
            sample = np.array([[lx, y], [lx + 28, y]])
            pieces = dashes(sample, 8, 12) if kind == "dash" else [sample]
            for piece in pieces:
                polylines(img, np.rint(piece).astype(np.int64), color, 2)
        put_text(img, name, (lx + 36, y + 5), 0.45, (0, 0, 0))
    write_png(path, img)
    return {"image": img, "scale": scale, "x0": x0, "y0": y0, "lo": lo}
