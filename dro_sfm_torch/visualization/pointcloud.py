"""Point clouds from depth: unprojection, .ply / .obj files, voxel grids.

The port's copy of `dro_sfm_tpu/visualization/pointcloud.py` (numpy, no
viewer), with `fuse_scene_pointcloud` reading a scene's files through the
port's PNG and JPEG readers.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def depth_to_points(depth: np.ndarray, K: np.ndarray,
                    pose_c2w: Optional[np.ndarray] = None,
                    rgb: Optional[np.ndarray] = None):
    """Unproject a depth map [H,W] to world points: (points [M,3], colors
    [M,3] uint8 or None) for the pixels with depth > 0. ``pose_c2w`` maps
    camera to world (identity when None); ``rgb`` is [H,W,3] float in [0,1]
    or uint8."""
    h, w = depth.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    d = depth.reshape(-1)
    valid = d > 0
    pts = (pix[valid] @ np.linalg.inv(K).T) * d[valid, None]
    if pose_c2w is not None:
        pts = pts @ pose_c2w[:3, :3].T + pose_c2w[:3, 3]
    colors = None
    if rgb is not None:
        c = rgb.reshape(-1, 3)[valid]
        colors = (c * 255).astype(np.uint8) if c.dtype != np.uint8 else c
    return pts, colors


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY of the points (and their colours)."""
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            for p, c in zip(points, colors):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def write_obj(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """OBJ vertex cloud (colours as per-vertex extensions)."""
    with open(path, "w") as f:
        if colors is not None:
            for p, c in zip(points, colors):
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0] / 255:.4f} {c[1] / 255:.4f} {c[2] / 255:.4f}\n")
        else:
            for p in points:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def export_pointcloud(path: str, depth: np.ndarray, K: np.ndarray,
                      pose_c2w: Optional[np.ndarray] = None,
                      rgb: Optional[np.ndarray] = None) -> int:
    """Unproject and write by extension (.ply / .obj); the point count."""
    pts, colors = depth_to_points(depth, K, pose_c2w, rgb)
    if path.endswith(".ply"):
        write_ply(path, pts, colors)
    elif path.endswith(".obj"):
        write_obj(path, pts, colors)
    else:
        raise ValueError(f"Unknown point cloud format: {path}")
    return pts.shape[0]


def voxel_downsample(points: np.ndarray,
                     colors: Optional[np.ndarray] = None,
                     voxel: float = 0.05):
    """One (mean) point, and colour, per occupied voxel: the points sorted
    by voxel, then each segment's mean."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel).astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    new_seg = np.ones(len(k), bool)
    new_seg[1:] = np.any(k[1:] != k[:-1], axis=1)
    seg_id = np.cumsum(new_seg) - 1
    n_seg = int(seg_id[-1]) + 1
    counts = np.bincount(seg_id, minlength=n_seg).astype(np.float64)
    out_pts = np.stack([
        np.bincount(seg_id, weights=points[order, i], minlength=n_seg)
        for i in range(3)], axis=1) / counts[:, None]
    out_cols = None
    if colors is not None:
        out_cols = np.stack([
            np.bincount(seg_id, weights=colors[order, i].astype(np.float64),
                        minlength=n_seg)
            for i in range(3)], axis=1) / counts[:, None]
        out_cols = out_cols.astype(colors.dtype)
    return out_pts.astype(points.dtype), out_cols


def fuse_scene_pointcloud(scene_dir: str, out_path: str,
                          image_dir: str = "color", depth_dir: str = "depth",
                          pose_dir: str = "pose",
                          intrinsics_file: str = "intrinsic/intrinsic_color.txt",
                          stride: int = 10, pixel_stride: int = 4,
                          voxel: float = 0.0, depth_max: float = 10.0) -> int:
    """Fuse a scene's ground-truth depth maps (uint16 PNG, millimetres) into
    one coloured world point cloud: every ``stride``-th frame of
    ``image_dir`` unprojected with its pose, subsampled by ``pixel_stride``,
    depths past ``depth_max`` dropped, optionally voxel-downsampled, written
    as ``.ply`` or ``.obj``. Returns the point count."""
    from dro_sfm_torch.data.scannet import read_png_depth_mm
    from dro_sfm_torch.utils.image_io import read_image_rgb, resize_bilinear_u8
    img_root = os.path.join(scene_dir, image_dir)
    frames = sorted(f for f in os.listdir(img_root)
                    if f.lower().endswith((".jpg", ".png")))[::stride]
    K_path = os.path.join(scene_dir, intrinsics_file)
    K = (np.genfromtxt(K_path)[:3, :3] if os.path.exists(K_path)
         else None)
    all_pts, all_cols = [], []
    for fname in frames:
        base = os.path.splitext(fname)[0]
        dp = os.path.join(scene_dir, depth_dir, base + ".png")
        pp = os.path.join(scene_dir, pose_dir, base + ".txt")
        if not (os.path.exists(dp) and os.path.exists(pp)):
            continue
        depth = read_png_depth_mm(dp)[..., 0]          # metres, -1 where 0
        depth[(depth < 0) | (depth > depth_max)] = 0.0
        pose = np.genfromtxt(pp).reshape(4, 4)
        if not np.all(np.isfinite(pose)):
            continue
        rgb = resize_bilinear_u8(read_image_rgb(os.path.join(img_root, fname)),
                                 depth.shape[:2])
        s = pixel_stride
        Ks = (K if K is not None else np.array(
            [[depth.shape[1], 0, depth.shape[1] / 2],
             [0, depth.shape[1], depth.shape[0] / 2], [0, 0, 1.0]])).copy()
        Ks[0] /= s
        Ks[1] /= s
        pts, cols = depth_to_points(depth[::s, ::s], Ks, pose, rgb[::s, ::s])
        all_pts.append(pts)
        all_cols.append(cols)
    if not all_pts:
        return 0
    pts = np.concatenate(all_pts)
    cols = np.concatenate(all_cols)
    if voxel > 0:
        pts, cols = voxel_downsample(pts, cols, voxel)
    if out_path.endswith(".obj"):
        write_obj(out_path, pts, cols)
    else:
        write_ply(out_path, pts, cols)
    return pts.shape[0]

