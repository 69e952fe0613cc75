"""The annotated multi-panel demo video and its trajectory files (host, numpy).

The port's counterpart of `dro_sfm_tpu/visualization/demo_video.py`: the
trajectory as an OBJ, the ground-truth poses of a frame folder and the
alignment to them; the top-down trajectory panel and the cloud panel; and
`DemoVideoComposer`, the 4x2-panel canvas with its header and footer bands.
Text, lines and the marker are drawn by `dro_sfm_torch.visualization.draw`
(its text bit for bit as OpenCV's, its antialiased lines within the bars of
ROADMAP C), panels are resized as ``cv2.resize`` resizes them
(`resize_bilinear_u8`), and the colours are the JAX package's, as its
canvas shows them: the annotation bands draw the reversed colour triples
that the JAX package hands to OpenCV on an RGB canvas.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np

from dro_sfm_torch.utils.image_io import resize_bilinear_u8
from dro_sfm_torch.visualization.draw import circle_filled, polylines, put_text
from dro_sfm_torch.visualization.trajectory import (
    absolute_trajectory_error,
    positions_from_poses,
    umeyama_alignment,
)

_BLUE = (90, 160, 255)
_RED = (255, 90, 90)
_GREEN = (80, 220, 120)
_YELLOW = (255, 220, 80)
_WHITE = (255, 255, 255)


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


def draw_trajectory_panel(poses: Sequence[np.ndarray], upto: int,
                          size=(240, 320), axes=(0, 2),
                          color=_BLUE, overlay: Optional[np.ndarray] = None,
                          overlay_color=_RED,
                          label: str = "") -> np.ndarray:
    """Top-down trajectory panel, uint8 RGB [h,w,3] (``size`` = (h, w)).
    ``poses`` [T,4,4] camera-to-world; positions[:upto+1] are drawn (width
    2) over the bounds of the whole trajectory, so that the view is stable
    across video frames, with a marker at the last; ``overlay`` [T,3] draws
    a second (ground-truth) path in full (width 1)."""
    h, w = size
    img = np.full((h, w, 3), 24, np.uint8)
    pts = positions_from_poses(poses)[:, list(axes)]
    ref = pts if overlay is None else np.concatenate(
        [pts, overlay[:, list(axes)]], axis=0)
    lo, hi = ref.min(axis=0), ref.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    margin = 20

    def to_px(p):
        q = (p - lo) / span
        x = (margin + q[..., 0] * (w - 2 * margin)).astype(np.int32)
        y = (h - margin - q[..., 1] * (h - 2 * margin)).astype(np.int32)
        return np.stack([x, y], axis=-1)

    if overlay is not None and len(overlay):
        polylines(img, to_px(overlay[:, list(axes)]), overlay_color, 1)
    seg = to_px(pts[:upto + 1])
    if len(seg) > 1:
        polylines(img, seg, color, 2)
    circle_filled(img, seg[-1], 4, _GREEN)
    if label:
        put_text(img, label, (8, 20), 0.45, _WHITE)
    return img


class DemoVideoComposer:
    """Annotated 4x2-panel frame composer.

    Panels: (a) RGB + frame text, (b) depth-validity mask overlay,
    (c) trajectory, (d) trajectory against the ground truth + ATE,
    (e) predicted depth, (f) ground-truth depth (dimmed when absent),
    (g) ground-truth trajectory, (h) accumulated cloud (top-down scatter).
    """

    HEADER = 64
    FOOTER = 40
    GAP = 8

    def __init__(self, shape, model_path: str = "", data_path: str = "",
                 sample_rate: int = 1, max_frames: int = 0, fps: float = 10.0,
                 git_sha: str = ""):
        self.h, self.w = shape
        self.info = {
            "datetime": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "host": socket.gethostname(),
            "git": git_sha or "n/a",
            "model": model_path,
            "data": data_path,
            "sample_rate": sample_rate,
            "max_frames": max_frames,
            "fps": fps,
        }

    @property
    def frame_size(self):
        """(height, width) of the composed canvas."""
        ph = self.h // 2
        pw = self.w // 2
        return (self.HEADER + 2 * ph + 3 * self.GAP + self.FOOTER,
                4 * pw + 5 * self.GAP)

    def _annotation_bands(self, canvas):
        i = self.info
        put_text(canvas, f"{i['datetime']} @ {i['host']} @ {i['git']}", (10, 22), 0.5,
                 _RED[::-1])
        put_text(canvas, f"model: {i['model']}", (10, 42), 0.5, _YELLOW[::-1])
        put_text(canvas, f"data: {i['data']}", (10, 60), 0.5, _YELLOW[::-1])
        put_text(canvas, f"sample_rate: {i['sample_rate']}   max_frames: "
                 f"{i['max_frames']}   fps: {i['fps']:.1f}",
                 (10, self.frame_size[0] - 14), 0.5, _GREEN[::-1])

    def compose(self, panels: Dict[str, np.ndarray], frame_idx: int,
                frame_name: str = "", ate: Optional[float] = None,
                ) -> np.ndarray:
        """Compose one canvas (RGB uint8). ``panels`` maps panel keys
        ('rgb', 'mask', 'depth', 'depth_gt', 'traj', 'traj_vs_gt',
        'traj_gt', 'cloud') to images; missing keys render dimmed."""
        ph, pw = self.h // 2, self.w // 2
        H, W = self.frame_size
        canvas = np.full((H, W, 3), 48, np.uint8)
        canvas[:self.HEADER] = 28
        canvas[H - self.FOOTER:] = 28
        self._annotation_bands(canvas)

        layout = [
            ("rgb", 0, 0, f"(a) rgb [{frame_idx:4d}] {frame_name}"),
            ("mask", 0, 1, "(b) depth-validity mask"),
            ("traj", 0, 2, "(c) traj pred"),
            ("traj_vs_gt", 0, 3,
             "(d) traj pred vs GT" if ate is None
             else f"(d) pred vs GT  ATE {ate:.3f}m"),
            ("depth", 1, 0, "(e) predicted depth"),
            ("depth_gt", 1, 1, "(f) groundtruth depth"),
            ("traj_gt", 1, 2, "(g) traj GT"),
            ("cloud", 1, 3, "(h) fused cloud (top-down)"),
        ]
        for key, r, c, label in layout:
            img = panels.get(key)
            if img is None:
                img = np.full((ph, pw, 3), 36, np.uint8)
            else:
                if img.dtype != np.uint8:
                    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                if img.ndim == 2:
                    img = np.repeat(img[..., None], 3, axis=-1)
                img = np.array(resize_bilinear_u8(img, (ph, pw)))    # a copy, drawn on
            put_text(img, label, (6, 18), 0.45, _WHITE)
            y = self.HEADER + self.GAP + r * (ph + self.GAP)
            x = self.GAP + c * (pw + self.GAP)
            canvas[y:y + ph, x:x + pw] = img
        return canvas


def cloud_topdown_panel(points: np.ndarray, colors: np.ndarray,
                        size=(240, 320), axes=(0, 2),
                        max_points: int = 60000) -> np.ndarray:
    """Top-down scatter of the accumulated coloured cloud, uint8 RGB
    [h,w,3]: at most ``max_points`` points (drawn with ``default_rng(0)``),
    the 2nd-98th percentile box of the ground plane stretched to the panel."""
    h, w = size
    img = np.full((h, w, 3), 24, np.uint8)
    if len(points) == 0:
        return img
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(len(points), max_points,
                                              replace=False)
        points, colors = points[sel], colors[sel]
    p = points[:, list(axes)]
    lo, hi = np.percentile(p, 2, axis=0), np.percentile(p, 98, axis=0)
    span = np.maximum(hi - lo, 1e-6)
    q = np.clip((p - lo) / span, 0, 1)
    x = (q[:, 0] * (w - 1)).astype(np.int32)
    y = ((1 - q[:, 1]) * (h - 1)).astype(np.int32)
    c = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    img[y, x] = c
    return img
