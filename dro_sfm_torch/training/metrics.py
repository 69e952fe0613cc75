"""Depth and pose evaluation metrics (masked, batched).

PyTorch counterpart of `dro_sfm_tpu/training/metrics.py`:

* `compute_depth_metrics`: 9 depth metrics per sample with min/max-depth
  validity masks, the garg and eigen_nyu crops, optional median scaling to
  the ground truth and optional DeMoN scaling (ground truth divided by the
  first context view's translation norm);
* `compute_pose_metrics` (numpy): rotation angle and translation angle in
  degrees, and the scale-fitted translation error in cm.

The median takes the lower-middle element, as ``torch.median`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dro_sfm_torch.ops.image import resize_bilinear

DEPTH_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log",
                      "a1", "a2", "a3", "SILog", "l1_inv")
POSE_METRIC_NAMES = ("rot_ang", "t_ang", "t_cm")
ALL_METRIC_NAMES = DEPTH_METRIC_NAMES + POSE_METRIC_NAMES
METRIC_MODES = ("", "_pp", "_gt", "_pp_gt")


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """The config's ``model.params``."""
    crop: str = ""
    min_depth: float = 0.0
    max_depth: float = 80.0


def _crop_mask(h: int, w: int, crop: str) -> Optional[np.ndarray]:
    """The evaluation crop as a [h, w] mask (None for no crop)."""
    if crop == "garg":
        y1, y2 = int(0.40810811 * h), int(0.99189189 * h)
        x1, x2 = int(0.03594771 * w), int(0.96405229 * w)
    elif crop == "eigen_nyu":
        y1, y2, x1, x2 = 20, 459, 24, 615
    else:
        return None
    m = np.zeros((h, w), dtype=bool)
    m[y1:y2, x1:x2] = True
    return m


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values`` [..., N] where ``mask``, over the last axis:
    the lower-middle element (the first one when nothing is masked in)."""
    big = torch.finfo(values.dtype).max
    filled = torch.where(mask, values, torch.full_like(values, big))
    sorted_vals = torch.sort(filled, dim=-1).values
    idx = torch.clamp((mask.sum(-1) - 1) // 2, min=0)
    return sorted_vals.gather(-1, idx[..., None])[..., 0]


def _single_depth_metrics(gt: torch.Tensor, pred: torch.Tensor,
                          valid: torch.Tensor, cfg: MetricsConfig,
                          use_gt_scale: bool) -> torch.Tensor:
    """Metrics [..., 9] of each sample; gt, pred and valid are [..., H*W]."""
    count = valid.sum(-1)
    safe_count = torch.clamp(count, min=1).to(gt.dtype)
    vf = valid.to(gt.dtype)

    if use_gt_scale:
        ratio = torch.where(valid, gt / pred, torch.ones_like(gt))
        scale = masked_median(ratio, valid)
        pred = torch.clamp(pred * scale[..., None], cfg.min_depth, cfg.max_depth)
    pred = torch.clamp(pred, cfg.min_depth, cfg.max_depth)

    def mmean(x):
        return (x * vf).sum(-1) / safe_count

    # Guard logs and divisions on masked-out entries.
    gt_s = torch.where(valid, gt, torch.ones_like(gt))
    pred_s = torch.where(valid, pred, torch.ones_like(pred))

    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    a1 = mmean((thresh < 1.25).to(gt.dtype))
    a2 = mmean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = mmean((thresh < 1.25 ** 3).to(gt.dtype))

    diff = gt_s - pred_s
    abs_rel = mmean(torch.abs(diff) / gt_s)
    sq_rel = mmean(diff * diff / gt_s)
    rmse = torch.sqrt(mmean(diff * diff))
    log_diff = torch.log(gt_s) - torch.log(pred_s)
    rmse_log = torch.sqrt(mmean(log_diff * log_diff))
    l1_inv = mmean(torch.abs(1.0 / pred_s - 1.0 / gt_s))
    silog = torch.sqrt(torch.clamp(
        mmean(log_diff * log_diff)
        - ((log_diff * vf).sum(-1) ** 2) / (safe_count ** 2), min=0.0))

    metrics = torch.stack([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3,
                           silog, l1_inv], dim=-1)
    # A sample with no valid pixel contributes zeros.
    return torch.where((count > 0)[..., None], metrics, torch.zeros_like(metrics))


def compute_depth_metrics(gt: torch.Tensor, pred: torch.Tensor,
                          cfg: MetricsConfig, use_gt_scale: bool = True,
                          gt_pose: Optional[torch.Tensor] = None,
                          demon_scaling: bool = False,
                          reduce: bool = True) -> torch.Tensor:
    """Depth metrics: the mean over samples [9], or per sample [B,9] with
    ``reduce=False``.

    gt [B,Hg,Wg,1]; pred [B,H,W,1] (resized to the ground truth's size,
    ``align_corners=True``). With ``demon_scaling`` (and ``use_gt_scale``)
    the ground truth is divided by the first context view's translation norm
    (``gt_pose`` [B,N,4,4]) and no crop applies.
    """
    b, hg, wg = gt.shape[0], gt.shape[1], gt.shape[2]
    pred = resize_bilinear(pred, (hg, wg), align_corners=True)
    pred = torch.clamp(pred, min=1e-6)

    valid = (gt > cfg.min_depth) & (gt < cfg.max_depth)
    cm = _crop_mask(hg, wg, cfg.crop)
    if cm is not None and not demon_scaling:
        valid = valid & torch.from_numpy(cm).to(gt.device)[None, :, :, None]

    gt_flat = gt.reshape(b, -1)
    pred_flat = pred.reshape(b, -1)
    valid_flat = valid.reshape(b, -1)

    if demon_scaling and use_gt_scale:
        t_norm = torch.linalg.norm(gt_pose[:, 0, :3, 3], dim=-1)    # [B]
        gt_flat = gt_flat / t_norm[:, None]

    per_sample = _single_depth_metrics(gt_flat, pred_flat, valid_flat, cfg,
                                       use_gt_scale)
    return per_sample.mean(dim=0) if reduce else per_sample


def compute_pose_metrics(gt_pose: np.ndarray, pred_pose: np.ndarray) -> np.ndarray:
    """Pose metrics [3] of the first sample's first context view.

    gt_pose [B,N,4,4] target->context ground truth; pred_pose [B,N,4,4].
    """
    gt = np.asarray(gt_pose)[0, 0]
    pr = np.asarray(pred_pose)[0, 0]
    R1, t1 = gt[:3, :3], gt[:3, 3]
    R2, t2 = pr[:3, :3], pr[:3, 3]

    costheta = (np.trace(R1.T @ R2) - 1.0) / 2.0
    rdeg = np.degrees(np.arccos(np.clip(costheta, -1.0, 1.0)))

    t1mag = np.sqrt(t1 @ t1)
    t2mag = np.sqrt(t2 @ t2)
    cost = np.clip((t1 @ t2) / max(t1mag * t2mag, 1e-12), -1.0, 1.0)
    tdeg = np.degrees(np.arccos(cost))

    a = (t1 @ t2) / max(t2 @ t2, 1e-12)
    tcm = 100.0 * np.sqrt(np.sum((t1 - a * t2) ** 2))
    return np.array([rdeg, tdeg, tcm], dtype=np.float32)
