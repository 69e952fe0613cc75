"""Rotation conversions (batched torch).

PyTorch counterpart of `dro_sfm_tpu/geometry/rotations.py`. Only the euler
convention of the pose head is ported so far; the rest of the library comes
with bundle adjustment.
"""
from __future__ import annotations

import torch


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] (x, y, z) -> rotation matrices [..., 3, 3],
    composed as R = Rx @ Ry @ Rz (the reference pose head's order)."""
    x, y, z = angles.unbind(-1)
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    rx = _stack33(one, zero, zero,
                  zero, cx, -sx,
                  zero, sx, cx)
    ry = _stack33(cy, zero, sy,
                  zero, one, zero,
                  -sy, zero, cy)
    rz = _stack33(cz, -sz, zero,
                  sz, cz, zero,
                  zero, zero, one)
    return rx @ ry @ rz


def _stack33(*entries: torch.Tensor) -> torch.Tensor:
    """Nine [...] tensors in row-major order -> [..., 3, 3]."""
    return torch.stack(entries, dim=-1).reshape(*entries[0].shape, 3, 3)
