"""Render a point cloud and/or a trajectory to a PNG or a turntable video.

    python -m dro_sfm_torch.scripts.vis --ply out/pointcloud.ply --output render.mp4
    python -m dro_sfm_torch.scripts.vis --trajectory out/trajectory.json --output traj.png

The port's counterpart of `scripts/vis.py`. The points of an ASCII ``.ply``
(at most ``--max-points``, drawn with ``default_rng(0)`` as the JAX script
draws them) are splatted on the device (`visualization.splat`: one pixel a
point, z-buffered); the trajectory of a ``trajectory.json`` is drawn over
them in red, its start as a green dot (`visualization.draw`). A ``.png``
shows matplotlib's default view (elevation 30, azimuth -60); any other path
is a turntable of ``--frames`` views at elevation 20 and 15 frames a second,
written as OpenCV's mp4v writer writes it (`VideoWriter`: ``.mp4``, ``.m4v``,
``.mov`` or ``.avi``). Runs on the card unless ``--device cpu``. The JAX
script draws with matplotlib; the port's own drawing is a recorded
difference (ROADMAP C).
"""
from __future__ import annotations

import argparse
import json
import time


SIZE = 800                       # the image's side, pixels (matplotlib's 8 in at 100 dpi)


def read_ply(path: str):
    """Points [N,3] (float64) and colours [N,3] (uint8, or None) of an
    ASCII PLY as `write_ply` writes it."""
    import numpy as np
    with open(path) as f:
        n, has_color, header = 0, False, 0
        for line in f:
            header += 1
            line = line.strip()
            if line.startswith("format") and "ascii" not in line:
                raise NotImplementedError(f"{path}: a binary PLY; the port reads ASCII PLY")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar red"):
                has_color = True
            if line == "end_header":
                break
    if n == 0:
        return np.zeros((0, 3)), None
    rows = np.loadtxt(path, skiprows=header, max_rows=n, ndmin=2)
    cols = rows[:, 3:6].astype(np.uint8) if has_color else None
    return rows[:, :3].astype(np.float64), cols


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch offline 3D rendering")
    p.add_argument("--ply", default=None)
    p.add_argument("--trajectory", default=None, help="trajectory json")
    p.add_argument("--output", required=True, help=".png, or .mp4/.mov/.avi for a turntable")
    p.add_argument("--frames", type=int, default=60, help="turntable frames for video output")
    p.add_argument("--max-points", type=int, default=100000)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns the rendered frames (uint8 RGB) and each
    frame's device milliseconds (host clock around the render and its copy
    to the host)."""
    args = parse_args(argv)
    if not (args.ply or args.trajectory):
        raise ValueError("nothing to render: pass --ply and/or --trajectory")
    from dro_sfm_torch.utils.video_io import VideoWriter
    if not args.output.endswith(".png"):
        VideoWriter.container(args.output)           # refuse a bad path before any render
    import numpy as np
    import torch

    from dro_sfm_torch.utils.device import resolve_device
    from dro_sfm_torch.utils.image_io import write_png
    from dro_sfm_torch.visualization.draw import circle_filled, polylines
    from dro_sfm_torch.visualization.splat import BACKGROUND, View, render_points

    device = resolve_device(args.device)
    pts, cols = np.zeros((0, 3)), None
    if args.ply:
        pts, cols = read_ply(args.ply)
        if pts.shape[0] > args.max_points:
            sel = np.random.default_rng(0).choice(pts.shape[0], args.max_points, replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None
        if cols is None:
            cols = np.zeros_like(pts, dtype=np.uint8)
    xyz = None
    if args.trajectory:
        with open(args.trajectory) as f:
            xyz = np.asarray([np.asarray(m)[:3, 3] for m in json.load(f)], np.float64)
    ref = np.concatenate([a for a in (pts, xyz) if a is not None and len(a)])
    lo, hi = ref.min(axis=0), ref.max(axis=0)
    size = (SIZE, SIZE)
    d_pts = torch.as_tensor(pts, dtype=torch.float64, device=device)
    d_cols = torch.as_tensor(cols if cols is not None else np.zeros((0, 3), np.uint8),
                             device=device)
    views = ([(30.0, -60.0)] if args.output.endswith(".png")
             else [(20.0, i * 360.0 / args.frames) for i in range(args.frames)])
    frames, render_ms = [], []
    for elev, azim in views:
        view = View(lo, hi, size, elev, azim)
        t0 = time.perf_counter()
        if len(pts):
            img = render_points(d_pts, d_cols, view).cpu().numpy()
        else:
            img = np.full((*size, 3), BACKGROUND, np.uint8)
        render_ms.append(1e3 * (time.perf_counter() - t0))
        if xyz is not None:
            u, v, _ = view.project(xyz)
            px = np.stack([np.floor(u), np.floor(v)], 1).astype(np.int64)
            polylines(img, px, (255, 0, 0), 2)
            circle_filled(img, px[0], 5, (0, 160, 0))
        frames.append(img)
    if args.output.endswith(".png"):
        write_png(args.output, frames[0])
    else:
        with VideoWriter(args.output, 15) as writer:
            for img in frames:
                writer.write(img)
    print(f"wrote {args.output} ({len(frames)} frame(s) of {size[1]}x{size[0]}, "
          f"{len(pts)} points; median {np.median(render_ms):.2f} ms a render on {device})")
    return {"frames": frames, "render_ms": render_ms, "points": int(len(pts))}


if __name__ == "__main__":
    main()
