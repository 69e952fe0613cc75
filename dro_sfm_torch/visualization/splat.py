"""Point clouds rendered on the device: one pixel a point, z-buffered.

The port's replacement of the matplotlib 3D scatter of `scripts/vis.py`. The
camera looks at the cloud's bounding-box centre from the direction that
matplotlib's ``view_init(elev, azim)`` gives (z up, ``azim`` about z,
``elev`` above the x-y plane), orthographically, with one scale on every
axis (matplotlib stretches each axis to its box: ROADMAP C). Each point is
projected to a pixel and keyed by ``(depth << 32) | index``, depth quantized
to 30 bits; ``scatter_reduce_(..., "amin")`` keeps the nearest point of
each pixel (the lower index on a tie) and the pixels take its colour. The
projection is elementwise float64 arithmetic with host scalars (no matrix
product, no sum), so that the card and the CPU round alike and, the keys
being integers, give the same image bit for bit.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DEPTH_BITS = 30
EMPTY = torch.iinfo(torch.int64).max
BACKGROUND = 255


class View:
    """The orthographic camera of one (elev, azim) on a cloud's bounds:
    `project` maps points [...,3] to pixel columns, rows and depths in
    [0, 1] (0 nearest), on the device of the points or in numpy."""

    def __init__(self, lo, hi, size: Tuple[int, int], elev: float, azim: float,
                 fill: float = 0.9):
        lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        self.center = [float(c) for c in (lo + hi) / 2]
        self.radius = max(float(np.sqrt(((hi - lo) ** 2).sum())) / 2, 1e-9)
        e, a = math.radians(elev), math.radians(azim)
        self.right = (-math.sin(a), math.cos(a), 0.0)
        self.up = (-math.sin(e) * math.cos(a), -math.sin(e) * math.sin(a), math.cos(e))
        self.eye = (math.cos(e) * math.cos(a), math.cos(e) * math.sin(a), math.sin(e))
        self.h, self.w = size
        self.scale = fill * min(self.h, self.w) / (2 * self.radius)

    def _dot(self, q, axis):
        return q[0] * axis[0] + q[1] * axis[1] + q[2] * axis[2]

    def project(self, points):
        q = [points[..., k] - self.center[k] for k in range(3)]
        u = self._dot(q, self.right) * self.scale + self.w / 2
        v = self.h / 2 - self._dot(q, self.up) * self.scale
        depth = (self.radius - self._dot(q, self.eye)) / (2 * self.radius)
        return u, v, depth


def render_points(points: torch.Tensor, colors: torch.Tensor, view: View) -> torch.Tensor:
    """uint8 RGB [H,W,3] on the device of ``points`` [N,3] (float64) and
    ``colors`` [N,3] (uint8): each point's colour at its pixel, the nearest
    point winning, the rest white."""
    h, w = view.h, view.w
    u, v, depth = view.project(points)
    col, row = torch.floor(u).long(), torch.floor(v).long()
    inside = (col >= 0) & (col < w) & (row >= 0) & (row < h)
    idx = torch.nonzero(inside).squeeze(1)
    dq = torch.clamp(torch.floor(depth[idx] * (1 << DEPTH_BITS)), 0, (1 << DEPTH_BITS) - 1).long()
    keys = (dq << 32) | idx
    zbuf = torch.full((h * w,), EMPTY, dtype=torch.int64, device=points.device)
    zbuf.scatter_reduce_(0, row[idx] * w + col[idx], keys, reduce="amin", include_self=True)
    hit = zbuf != EMPTY
    image = torch.full((h * w, 3), BACKGROUND, dtype=torch.uint8, device=points.device)
    image[hit] = colors[zbuf[hit] & 0xFFFFFFFF]
    return image.reshape(h, w, 3)
