"""Pinhole camera helpers (channel-last).

PyTorch counterpart of `dro_sfm_tpu/geometry/camera.py`: an unnormalized
pixel grid at integer centres, intrinsics rescaling with the +0.5
pixel-centre shift, the analytic inverse of pinhole intrinsics, and the
`Camera` that lifts depth to points and projects them (z clamped at 1e-5,
normalised coordinates ``2x / (W - 1) - 1``). Under a height split
(`parallel/spatial.py`) a band's grid holds global y (`pixel_grid`'s
``row0``), and `Camera` normalises y by the image's rows.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.parallel import spatial


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None,
               row0: int = 0) -> torch.Tensor:
    """Homogeneous pixel coordinate grid [H, W, 3] of (x, y, 1), y starting
    at ``row0`` (a band's first global row)."""
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def scale_intrinsics(K: torch.Tensor, x_scale, y_scale=None) -> torch.Tensor:
    """Rescale [..., 3, 3] intrinsics for an image resized by ``x_scale``
    across and ``y_scale`` (default ``x_scale``) down, with the pixel-centre
    rule c' = (c + 0.5) * s - 0.5."""
    if y_scale is None:
        y_scale = x_scale
    K = K.clone()
    K[..., 0, 0] = K[..., 0, 0] * x_scale
    K[..., 1, 1] = K[..., 1, 1] * y_scale
    K[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    K[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return K


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [..., 3, 3] pinhole intrinsics."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    Kinv = K.clone()
    Kinv[..., 0, 0] = 1.0 / fx
    Kinv[..., 1, 1] = 1.0 / fy
    Kinv[..., 0, 2] = -cx / fx
    Kinv[..., 1, 2] = -cy / fy
    return Kinv


class Camera:
    """Pinhole camera with intrinsics K [..., 3, 3] and world->camera pose
    ``Tcw`` (identity for the target camera)."""

    def __init__(self, K: torch.Tensor, Tcw: Pose | None = None):
        self.K = K
        self.Tcw = (Pose.identity(K.shape[:-2], dtype=K.dtype, device=K.device)
                    if Tcw is None else Tcw)

    def scaled(self, x_scale, y_scale=None) -> "Camera":
        """The camera of the image resized by ``x_scale`` across and
        ``y_scale`` (default ``x_scale``) down; itself at scale 1."""
        if y_scale is None:
            y_scale = x_scale
        if x_scale == 1.0 and y_scale == 1.0:
            return self
        return Camera(scale_intrinsics(self.K, x_scale, y_scale), self.Tcw)

    def reconstruct(self, depth: torch.Tensor, frame: str = "w") -> torch.Tensor:
        """Lift a depth map [..., H, W, 1] to 3D points [..., H, W, 3]: rays
        Kinv @ (x, y, 1) scaled by depth, moved to the world frame by
        ``Tcw``'s inverse when ``frame="w"``."""
        h, w = depth.shape[-3], depth.shape[-2]
        grid = pixel_grid(h, w, dtype=depth.dtype, device=depth.device,
                          row0=spatial.row_offset(h))
        rays = torch.einsum("...ij,hwj->...hwi", invert_intrinsics(self.K), grid)
        points = rays * depth
        if frame == "c":
            return points
        if frame == "w":
            return self.Tcw.inverse().transform_points(points)
        raise ValueError(f"Unknown reference frame {frame}")

    def project(self, points: torch.Tensor, frame: str = "w",
                normalize: bool = True) -> torch.Tensor:
        """Project 3D points [..., H, W, 3] to coordinates [..., H, W, 2]:
        pixels, or [-1, 1] with ``2u / (W - 1) - 1`` when ``normalize``. z is
        clamped at 1e-5, so points behind the camera land far outside."""
        h, w = spatial.image_rows(points.shape[-3]), points.shape[-2]
        if frame == "w":
            points = self.Tcw.transform_points(points)
        elif frame != "c":
            raise ValueError(f"Unknown reference frame {frame}")
        proj = torch.einsum("...ij,...hwj->...hwi", self.K, points)
        z = proj[..., 2].clamp_min(1e-5)
        u, v = proj[..., 0] / z, proj[..., 1] / z
        if normalize:
            u = 2.0 * u / (w - 1) - 1.0
            v = 2.0 * v / (h - 1) - 1.0
        return torch.stack([u, v], dim=-1)


def view_synthesis_coords(depth: torch.Tensor, cam: Camera, ref_cam: Camera,
                          normalize: bool = False) -> torch.Tensor:
    """Coordinates in the reference view of each target pixel lifted with
    ``depth``: ``ref_cam.project(cam.reconstruct(depth))``."""
    return ref_cam.project(cam.reconstruct(depth, frame="w"), frame="w",
                           normalize=normalize)
