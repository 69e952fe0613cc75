"""SE(3) pose helpers on batched [..., 4, 4] matrices.

PyTorch counterpart of `dro_sfm_tpu/geometry/pose.py`: 6-DoF vectors are
[t | r] (translation first, then euler rotation), as the pose head emits.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.geometry.rotations import euler_to_matrix


class Pose:
    """A batch of rigid transforms stored as [..., 4, 4] matrices."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        eye = torch.eye(4, dtype=dtype, device=device)
        return cls(eye.expand(*batch_shape, 4, 4))

    @classmethod
    def from_vec(cls, vec: torch.Tensor, mode: str = "euler") -> "Pose":
        """6-DoF vectors [..., 6] = [tx ty tz rx ry rz] -> poses."""
        return cls(pose_vec_to_mat(vec, mode))

    def inverse(self) -> "Pose":
        return Pose(invert_pose(self.mat))

    def transform_points(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points [..., N, 3] or [..., H, W, 3] (channel-last): the
        rotation and translation broadcast over the spatial dims between the
        pose's batch dims and the coordinate axis."""
        spatial = points.ndim - self.mat.ndim + 1
        batch = self.mat.shape[:-2]
        rot = self.mat[..., :3, :3].reshape(*batch, *([1] * spatial), 3, 3)
        trans = self.mat[..., :3, 3].reshape(*batch, *([1] * spatial), 3)
        return torch.einsum("...ij,...j->...i", rot, points) + trans


def pose_vec_to_mat(vec: torch.Tensor, mode: str = "euler") -> torch.Tensor:
    """6-DoF vectors [..., 6] -> [..., 4, 4] transforms."""
    if mode != "euler":
        raise ValueError(f"Unsupported rotation mode: {mode}")
    trans, rot_vec = vec[..., :3], vec[..., 3:]
    top = torch.cat([euler_to_matrix(rot_vec), trans[..., None]], dim=-1)
    bottom = vec.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*vec.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def invert_pose(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 4, 4] rigid transforms (R^T, -R^T t)."""
    rot_t = mat[..., :3, :3].transpose(-2, -1)
    trans = -(rot_t @ mat[..., :3, 3:4])
    top = torch.cat([rot_t, trans], dim=-1)
    bottom = mat.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*mat.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)
