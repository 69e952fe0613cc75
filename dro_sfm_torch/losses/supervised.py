"""Supervised depth + pose losses with the gamma decay over predictions.

PyTorch counterpart of `dro_sfm_tpu/losses/supervised.py`: a masked L1 on
inverse depth over every refinement prediction, plus a pose loss measured as
the difference of the pixel coordinates that ground-truth depth reprojects
to under the ground-truth and the predicted pose; each weighted by
``gamma ** (P - 1 - p)`` and normalised by the weights. Also the generic
single-term losses (l1, mse, berhu, silog, abs_rel) chosen by method suffix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from dro_sfm_torch.geometry.camera import Camera
from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.losses.progressive import progressive_scale_mask
from dro_sfm_torch.ops.depth_ops import depth2inv


@dataclasses.dataclass(frozen=True)
class SupervisedLossConfig:
    min_depth: float = 0.1
    max_depth: float = 100.0
    gamma: float = 0.85
    # drop the coarsest remaining prediction after every this fraction of
    # training (0 = off)
    progressive_scaling: float = 0.0


def _decay_weights(p: int, cfg: SupervisedLossConfig, progress, like):
    """[P] weights gamma^(P-1-p), masked by progressive scaling."""
    w = cfg.gamma ** torch.arange(p - 1, -1, -1, dtype=like.dtype,
                                  device=like.device)
    return w * progressive_scale_mask(p, cfg.progressive_scaling, progress,
                                      like.dtype, like.device)


def supervised_depth_loss(inv_depths: torch.Tensor, gt_inv_depth: torch.Tensor,
                          cfg: SupervisedLossConfig,
                          progress=0.0) -> torch.Tensor:
    """Gamma-decayed masked L1 on inverse depth.

    inv_depths [P,B,H,W,1]; gt_inv_depth [B,H,W,1]. The mask keeps ground
    truth strictly inside (1/max_depth, 1/min_depth); the mean runs over all
    pixels, the masked ones counting as zero.
    """
    p = inv_depths.shape[0]
    valid = ((gt_inv_depth > 1.0 / cfg.max_depth)
             & (gt_inv_depth < 1.0 / cfg.min_depth)).to(inv_depths.dtype)[None]
    per_pred = (valid * (gt_inv_depth[None] - inv_depths).abs()).mean(
        dim=tuple(range(1, inv_depths.ndim)))                  # [P]
    w = _decay_weights(p, cfg, progress, inv_depths)
    return (per_pred * w).sum() / w.sum()


def _reproject_coords(depth: torch.Tensor, pose_mats: torch.Tensor,
                      K: torch.Tensor):
    """Normalised reference-view coordinates of the target pixels lifted
    with ``depth``.

    depth [B,H,W,1]; pose_mats [..., B, 4, 4] (leading axes broadcast);
    returns (coords [..., B, H, W, 2], valid [..., B, H, W, 2]).
    """
    points = Camera(K).reconstruct(depth, frame="w")           # [B,H,W,3]
    lead = pose_mats.shape[:-3]
    ref_cam = Camera(K.expand(*lead, *K.shape), Pose(pose_mats))
    coords = ref_cam.project(points.expand(*lead, *points.shape), frame="w",
                             normalize=True)
    return coords, (coords >= -1.0) & (coords <= 1.0)


def supervised_pose_loss(pose_vecs: torch.Tensor, gt_pose_context: torch.Tensor,
                         gt_depth: torch.Tensor, K: torch.Tensor,
                         cfg: SupervisedLossConfig,
                         progress=0.0) -> torch.Tensor:
    """Reprojection-difference pose loss.

    pose_vecs [B,N,P,6]; gt_pose_context [B,N,4,4] (target -> context);
    gt_depth [B,H,W,1]. Coordinates under the ground-truth and the
    predicted pose, masked by both in-bounds masks and a ground-truth depth
    inside (min_depth, max_depth / 4), |difference| clamped at 1, mean over
    all pixels, then over views, gamma-weighted over predictions.
    """
    b, n, p = pose_vecs.shape[:3]
    depth_mask = ((gt_depth > cfg.min_depth)
                  & (gt_depth < cfg.max_depth / 4.0))           # [B,H,W,1]
    pred = Pose.from_vec(pose_vecs.permute(2, 1, 0, 3), "euler").mat  # [P,N,B,4,4]
    gt = gt_pose_context.transpose(0, 1).expand(n, b, 4, 4)

    coords_pred, mask_pred = _reproject_coords(gt_depth, pred, K)   # [P,N,B,H,W,2]
    coords_gt, mask_gt = _reproject_coords(gt_depth, gt, K)         # [N,B,H,W,2]

    valid = (mask_gt[None] & mask_pred).to(gt_depth.dtype)
    valid = valid * depth_mask[None, None]
    diff = valid * (coords_pred - coords_gt[None]).abs().clamp_max(1.0)
    per_pred = diff.mean(dim=tuple(range(2, diff.ndim))).mean(dim=1)  # [P]
    w = _decay_weights(p, cfg, progress, diff)
    return (per_pred * w).sum() / w.sum()


def supervised_depth_pose_loss(
        inv_depths: torch.Tensor, gt_depth: torch.Tensor,
        pose_vecs: torch.Tensor, gt_pose_context: torch.Tensor,
        K: torch.Tensor, cfg: SupervisedLossConfig = SupervisedLossConfig(),
        progress=0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Depth loss + pose loss, with both terms and their sum as metrics."""
    loss_depth = supervised_depth_loss(inv_depths, depth2inv(gt_depth), cfg,
                                       progress)
    loss_pose = supervised_pose_loss(pose_vecs, gt_pose_context, gt_depth, K,
                                     cfg, progress)
    loss = loss_depth + loss_pose
    return loss, {"depth_loss": loss_depth, "pose_loss": loss_pose,
                  "all_loss": loss}


def berhu_loss(pred: torch.Tensor, gt: torch.Tensor,
               threshold: float = 0.2) -> torch.Tensor:
    """BerHu (reverse Huber) loss."""
    huber_c = threshold * (pred - gt).max()
    diff = (pred - gt).abs()
    over = diff > huber_c
    sq = torch.where(over, diff * diff, torch.zeros_like(diff))
    return (diff.sum() + sq.sum()) / (diff.numel() + over.sum())


def silog_loss(pred: torch.Tensor, gt: torch.Tensor, ratio: float = 10.0,
               ratio2: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss."""
    log_diff = torch.log(pred * ratio) - torch.log(gt * ratio)
    silog1 = (log_diff ** 2).mean()
    silog2 = ratio2 * log_diff.mean() ** 2
    return torch.sqrt(silog1 - silog2) * ratio


def get_loss_fn(method: str):
    """The single-term loss named by the suffix of ``method``."""
    if method.endswith("l1"):
        return lambda x, y: (x - y).abs().mean()
    if method.endswith("mse"):
        return lambda x, y: ((x - y) ** 2).mean()
    if method.endswith("berhu"):
        return berhu_loss
    if method.endswith("silog"):
        return silog_loss
    if method.endswith("abs_rel"):
        return lambda x, y: ((x - y).abs() / x).mean()
    raise ValueError(f"Unknown supervised loss {method}")
