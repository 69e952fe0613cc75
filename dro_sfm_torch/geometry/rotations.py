"""Rotation representation conversions (batched torch).

PyTorch counterpart of `dro_sfm_tpu/geometry/rotations.py`, with its names
and argument order: the euler convention of the pose head (R = Rx @ Ry @
Rz) and its inverse, axis-angle, quaternions (w, x, y, z: scalar first),
the twelve euler conventions, the continuous 6D representation and random
rotations. Every function is shape-polymorphic over leading batch dims and
branch-free on values, so it runs under `torch.func.vmap` and forward AD.

The random draws take a `torch.Generator` where the JAX functions take a
PRNG key, so their values differ from `jax.random`'s; their distribution is
the same.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Euler (the pose head's convention: R = Rx @ Ry @ Rz)
# ---------------------------------------------------------------------------

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


def matrix_to_euler(mat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> euler angles [..., 3] (x, y, z), the
    inverse of `euler_to_matrix`; at gimbal lock (cos y <= ``eps``) x is 0
    and z takes the whole in-plane angle."""
    r11, r12, r13 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    r21, r22, r23 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    r33 = mat[..., 2, 2]
    cy = torch.sqrt(r33 * r33 + r23 * r23)
    safe = cy > eps
    ex = torch.where(safe, torch.atan2(-r23, r33), torch.zeros_like(cy))
    ey = torch.atan2(r13, cy)
    ez = torch.where(safe, torch.atan2(-r12, r11), torch.atan2(r21, r22))
    return torch.stack([ex, ey, ez], dim=-1)


# ---------------------------------------------------------------------------
# Axis-angle
# ---------------------------------------------------------------------------

def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] (via quaternions)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(mat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(mat))


def _sin_half_over_angle(angle: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, with the series 0.5 - angle^2 / 48 below 1e-6."""
    small = torch.abs(angle) < 1e-6
    return torch.where(small, 0.5 - (angle * angle) / 48.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> unit quaternions [..., 4] (w, x, y, z)."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angle * 0.5
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over_angle(angle, half)],
                     dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] (w, x, y, z) -> axis-angle [..., 3]."""
    norm = torch.linalg.norm(quat[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norm, quat[..., :1])
    return quat[..., 1:] / _sin_half_over_angle(2.0 * half, half)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] (w, x, y, z) -> rotation matrices [..., 3, 3]
    (normalised by the squared norm)."""
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    return _stack33(
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    )


def matrix_to_quaternion(mat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y,
    z) with a non-negative real part: of the four candidate quaternions the
    one with the largest pivot, chosen without branches."""
    m00, m11, m22 = mat[..., 0, 0], mat[..., 1, 1], mat[..., 2, 2]
    m21, m12 = mat[..., 2, 1], mat[..., 1, 2]
    m02, m20 = mat[..., 0, 2], mat[..., 2, 0]
    m10, m01 = mat[..., 1, 0], mat[..., 0, 1]

    # Squared magnitudes of (w, x, y, z), clipped at zero.
    q_abs_sq = torch.stack([1.0 + m00 + m11 + m22,
                            1.0 + m00 - m11 - m22,
                            1.0 - m00 + m11 - m22,
                            1.0 - m00 - m11 + m22], dim=-1)
    q_abs = torch.sqrt(torch.clamp_min(q_abs_sq, 0.0))

    # Candidate quaternions, one per pivot component.
    cand_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)     # [..., 4, 4]
    cands = cands / (2.0 * torch.clamp_min(q_abs, 0.1))[..., None]

    best = torch.argmax(q_abs_sq, dim=-1)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    quat = torch.take_along_dim(cands, index, dim=-2)[..., 0, :]
    return standardize_quaternion(quat / torch.linalg.norm(quat, dim=-1, keepdim=True))


def standardize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    """The same rotation with a non-negative real part."""
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] (w, x, y, z), sign as it
    falls."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product with a non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quat: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternions [..., 4]."""
    return torch.cat([quat[..., :1], -quat[..., 1:]], dim=-1)


def quaternion_apply(quat: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., 3] by unit quaternions [..., 4]: q p q^-1 with raw
    products (standardising mid-chain would flip the intermediate's vector
    part)."""
    p = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(quat, p), quaternion_invert(quat))
    return out[..., 1:]


# ---------------------------------------------------------------------------
# The twelve euler conventions
# ---------------------------------------------------------------------------

_AXIS_INDEX = {"X": 0, "Y": 1, "Z": 2}


def _validate_convention(convention: str) -> None:
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    for letter in convention:
        if letter not in _AXIS_INDEX:
            raise ValueError(f"Invalid letter {letter} in convention string.")


def _single_axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation about one coordinate axis; angle [...] -> [..., 3, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        return _stack33(one, zero, zero, zero, c, -s, zero, s, c)
    if axis == "Y":
        return _stack33(c, zero, s, zero, one, zero, -s, zero, c)
    return _stack33(c, -s, zero, s, c, zero, zero, zero, one)


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles [..., 3] under any 3-letter convention -> [..., 3, 3]:
    ``angles[..., i]`` rotates about axis ``convention[i]`` and the three
    matrices compose left to right (R = R0 @ R1 @ R2)."""
    _validate_convention(convention)
    if euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    r0 = _single_axis_rotation(convention[0], euler_angles[..., 0])
    r1 = _single_axis_rotation(convention[1], euler_angles[..., 1])
    r2 = _single_axis_rotation(convention[2], euler_angles[..., 2])
    return r0 @ r1 @ r2


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor,
                    horizontal: bool, tait_bryan: bool) -> torch.Tensor:
    """The first or third euler angle from the matrix entries that are
    constant multiples of its sine and cosine."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(mat: torch.Tensor, convention: str) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> euler angles [..., 3] under any
    3-letter convention; the inverse of `euler_angles_to_matrix` away from
    gimbal lock."""
    _validate_convention(convention)
    if mat.shape[-2:] != (3, 3):
        raise ValueError(f"Invalid rotation matrix shape {mat.shape}.")
    i0 = _AXIS_INDEX[convention[0]]
    i2 = _AXIS_INDEX[convention[2]]
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            mat[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0), -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(mat[..., i0, i0], -1.0, 1.0))
    first = _angle_from_tan(convention[0], convention[1], mat[..., i2], False, tait_bryan)
    third = _angle_from_tan(convention[2], convention[1], mat[..., i0, :], True, tait_bryan)
    return torch.stack([first, central, third], dim=-1)


# ---------------------------------------------------------------------------
# Random rotations, drawn from a torch.Generator
# ---------------------------------------------------------------------------

def random_quaternions(generator: torch.Generator | None, n: int,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """[n, 4] uniform random unit quaternions with a non-negative real part."""
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    norm = torch.sqrt(torch.sum(o * o, dim=1))
    signed = torch.where(o[:, 0] < 0, -norm, norm)
    return o / signed[:, None]


def random_rotations(generator: torch.Generator | None, n: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """[n, 3, 3] uniform random rotation matrices."""
    return quaternion_to_matrix(random_quaternions(generator, n, dtype, device))


def random_rotation(generator: torch.Generator | None, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """A single [3, 3] uniform random rotation matrix."""
    return random_rotations(generator, 1, dtype, device)[0]


# ---------------------------------------------------------------------------
# The continuous 6D representation (Zhou et al.)
# ---------------------------------------------------------------------------

def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation [..., 6] -> matrices [..., 3, 3]
    (Gram-Schmidt on the two rows, the third their cross product)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(mat: torch.Tensor) -> torch.Tensor:
    """Matrices [..., 3, 3] -> 6D representation [..., 6] (the first two rows)."""
    return mat[..., :2, :].reshape(*mat.shape[:-2], 6)


def _stack33(*entries: torch.Tensor) -> torch.Tensor:
    """Nine [...] tensors in row-major order -> [..., 3, 3]."""
    return torch.stack(entries, dim=-1).reshape(*entries[0].shape, 3, 3)
