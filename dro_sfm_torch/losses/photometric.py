"""Multi-view photometric (self-supervised) loss with the gamma decay.

PyTorch counterpart of `dro_sfm_tpu/losses/photometric.py`: for every
prediction p and context view n the target image is synthesised by warping
the context view with (inv_depth_p, pose_{n,p}); the residual is L1 + SSIM,
reduced over views (joint minimum with the automask, or the mean), weighted
by ``gamma ** (P - 1 - p)`` over predictions, plus the edge-aware smoothness
and the optional perceptual term. Plain PyTorch: the warp is
`ops/resample.py:bilinear_sample`, whose gradient reaches the coordinates
through the tap weights (the context images take none).

Under a height split (`parallel/spatial.py`) the images, the depths and the
residuals are the band's rows. The warp samples the context views gathered
to the whole height (3 channels, no gradient) at the band's own pixels,
which `Camera` lifts at their global rows; SSIM and the vertical differences
fetch their neighbours' rows; the clamp's statistics are summed over every
process (the data and the spatial ranks); the reductions over pixels are
`spatial.band_mean`s with the whole image's count (the smoothness's
vertical term over (H - 1) W), and the smoothness's per-image mean of the
inverse depth is summed over the group (`spatial.image_mean`). The
perceptual net resizes to 224x224, which mixes rows across bands: it runs
whole on every rank, on the target and the final warp gathered to the whole
height, and its distance enters through `spatial.whole_term`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from dro_sfm_torch.geometry.camera import Camera
from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.losses.progressive import progressive_scale_mask
from dro_sfm_torch.ops.depth_ops import inv2depth
from dro_sfm_torch.ops.image import gradient_x, gradient_y
from dro_sfm_torch.ops.resample import bilinear_sample
from dro_sfm_torch.ops.ssim import ssim_loss
from dro_sfm_torch.parallel import spatial
from dro_sfm_torch.parallel.collectives import all_reduce_sum
from dro_sfm_torch.parallel.mesh import process_count


@dataclasses.dataclass(frozen=True)
class PhotometricLossConfig:
    """The loss's settings, with the JAX package's fields and defaults."""
    ssim_loss_weight: float = 0.85
    smooth_loss_weight: float = 0.001
    c1: float = 1e-4
    c2: float = 9e-4
    photometric_reduce_op: str = "min"
    clip_loss: float = 0.0
    automask_loss: bool = True
    gamma: float = 0.85
    # Divide by the summed gamma weights (the single-frame tasks: gamma 1.0
    # and this average the decoder scales uniformly).
    normalize_weights: bool = False
    # VGG16 perceptual distance between the target and the final
    # prediction's warps (0 = off).
    percep_loss_weight: float = 0.0
    # Drop the coarsest remaining prediction after every this fraction of
    # training (0 = off).
    progressive_scaling: float = 0.0
    # The 1/2^p smoothness decay weights the first prediction fully (False:
    # refinement iterations), or the last (True: decoder scales stacked
    # coarsest first).
    smooth_finest_last: bool = False


def warp_context(image_ctx: torch.Tensor, inv_depths: torch.Tensor,
                 pose_vecs: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Warp the context views into the target frame for every prediction.

    image_ctx [B,N,H,W,3]; inv_depths [P,B,H,W,1]; pose_vecs [B,N,P,6];
    K [B,3,3] -> warped [P,B,N,H,W,3]. Prediction p warps with the pose of
    the same prediction. Under a height split the depths and the result are
    the band's rows, ``image_ctx`` the whole height.
    """
    p, b = inv_depths.shape[0], inv_depths.shape[1]
    n = image_ctx.shape[1]
    cam = Camera(K[None].expand(p, b, 3, 3))
    points = cam.reconstruct(inv2depth(inv_depths), frame="w")     # [P,B,H,W,3]
    ref_pose = Pose.from_vec(pose_vecs.permute(2, 0, 1, 3), "euler")   # [P,B,N]
    ref_cam = Camera(K[None, :, None].expand(p, b, n, 3, 3), ref_pose)
    coords = ref_cam.project(points[:, :, None].expand(p, b, n, *points.shape[2:]),
                             frame="w", normalize=False)          # [P,B,N,H,W,2]
    return bilinear_sample(image_ctx[None].expand(p, *image_ctx.shape), coords)


def _photometric_residual(est: torch.Tensor, ref: torch.Tensor,
                          cfg: PhotometricLossConfig) -> torch.Tensor:
    """Per-pixel L1 + SSIM residual of [P,B,N,H,W,3] estimates against a
    reference that broadcasts to them: channel-averaged [...,1] with SSIM on,
    the raw 3-channel L1 with ``ssim_loss_weight == 0``."""
    l1 = (est - ref).abs()
    if cfg.ssim_loss_weight > 0.0:
        s = ssim_loss(est, ref, cfg.c1, cfg.c2)
        res = (cfg.ssim_loss_weight * s.mean(dim=-1, keepdim=True)
               + (1.0 - cfg.ssim_loss_weight) * l1.mean(dim=-1, keepdim=True))
    else:
        res = l1
    if cfg.clip_loss > 0.0:
        # Clamp at mean + clip * std, the statistics pooled over everything
        # but the prediction (0) and view (2) axes, the batch included (the
        # global batch and the whole image with several processes: the sums
        # run over every process, data and spatial ranks alike); std with
        # ddof 0.
        dims = (1,) + tuple(range(3, res.ndim))
        if process_count() > 1:
            mean, std = _global_mean_std(res, dims)
        else:
            mean = res.mean(dim=dims, keepdim=True)
            std = res.std(dim=dims, keepdim=True, correction=0)
        res = torch.minimum(res, mean + cfg.clip_loss * std)
    return res


def _global_mean_std(res: torch.Tensor, dims):
    """The mean and the ddof-0 std of ``res`` over ``dims`` and the
    processes, in two passes as ``std`` takes them (differentiable sums)."""
    keep = [1 if d in dims else size for d, size in enumerate(res.shape)]
    n = res.new_full((1,), res.numel() // math.prod(keep))
    first = all_reduce_sum(torch.cat([res.sum(dim=dims).reshape(-1), n]))
    mean = (first[:-1] / first[-1]).reshape(keep)
    second = all_reduce_sum(((res - mean) ** 2).sum(dim=dims, keepdim=True))
    return mean, torch.sqrt(second / first[-1])


def smoothness_loss(inv_depths: torch.Tensor, image: torch.Tensor,
                    cfg: PhotometricLossConfig, mask=None) -> torch.Tensor:
    """Edge-aware smoothness of the mean-normalised inverse depths
    [P,B,H,W,1] against ``image`` [B,H,W,3]. Prediction p carries 1/2^p
    (1/2^(P-1-p) with ``smooth_finest_last``); ``mask`` [P] drops the
    predictions progressive scaling has dropped, with a matching
    denominator."""
    p = inv_depths.shape[0]
    h = spatial.image_rows(inv_depths.shape[-3])
    mean_inv = spatial.image_mean(inv_depths, (-3, -2, -1), keepdim=True)
    norm = inv_depths / mean_inv.clamp_min(1e-6)
    dx = gradient_x(norm).abs()
    dy = gradient_y(norm).abs()
    wx = torch.exp(-gradient_x(image).abs().mean(dim=-1, keepdim=True))
    wy = torch.exp(-gradient_y(image).abs().mean(dim=-1, keepdim=True))
    sx = spatial.band_mean(dx * wx[None], range(1, dx.ndim))          # [P]
    sy = spatial.band_mean(dy * wy[None], range(1, dy.ndim), rows=h - 1)
    idx = torch.arange(p, dtype=inv_depths.dtype, device=inv_depths.device)
    if cfg.smooth_finest_last:
        idx = (p - 1) - idx
    per_pred = (sx + sy) / 2.0 ** idx
    if mask is None:
        return per_pred.sum() / p
    return (per_pred * mask).sum() / mask.sum().clamp_min(1.0)


def perceptual_term(percep_fn, image: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    """The mean of ``percep_fn(target, warp) -> [B*N,h,w,1]`` between the
    target [B,H,W,3] and its warps [B,N,H,W,3], views folded into the batch.
    Under a height split both are gathered to the whole height and the net
    runs whole on every rank (its 224x224 resize mixes rows across bands);
    the distance enters as a `spatial.whole_term`."""
    final = spatial.gather_rows(warped, -3)                          # [B,N,H,W,3]
    b, n = final.shape[0], final.shape[1]
    tgt = spatial.gather_rows(image, -3)[:, None].expand_as(final)
    with spatial.active(None):
        distance = percep_fn(tgt.reshape(b * n, *final.shape[2:]),
                             final.reshape(b * n, *final.shape[2:])).mean()
    return spatial.whole_term(distance)


def multiview_photometric_loss(
        image: torch.Tensor, context: torch.Tensor, inv_depths: torch.Tensor,
        K: torch.Tensor, pose_vecs: torch.Tensor,
        cfg: PhotometricLossConfig = PhotometricLossConfig(),
        percep_fn=None, progress=0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The self-supervised loss and its terms.

    image [B,H,W,3] and context [B,N,H,W,3] (the un-jittered originals);
    inv_depths [P,B,H,W,1]; K [B,3,3]; pose_vecs [B,N,P,6]. With
    ``cfg.percep_loss_weight > 0``, ``percep_fn(im1, im2) -> [B*,h,w,1]``
    adds the perceptual term on the final prediction's warps, views folded
    into the batch.
    """
    p = inv_depths.shape[0]
    warped = warp_context(spatial.gather_rows(context, 2), inv_depths, pose_vecs,
                          K)                                        # [P,B,N,H,W,3]
    target = image[None, :, None]                                   # [1,B,1,H,W,3]
    residuals = _photometric_residual(warped, target, cfg)          # [P,B,N,H,W,C]

    if cfg.automask_loss:
        # The identity (unwarped) residual does not depend on the
        # prediction: computed once at P=1 and broadcast.
        ident = _photometric_residual(context[None], target, cfg)
        residuals = torch.cat([residuals, ident.expand_as(residuals)], dim=2)

    if cfg.photometric_reduce_op == "min":
        # A joint minimum over views and channels (with SSIM off the
        # residual keeps its 3 channels, and the minimum spans them).
        per_pixel = residuals.amin(dim=2).amin(dim=-1, keepdim=True)   # [P,B,H,W,1]
        per_pred = spatial.band_mean(per_pixel, (1, 2, 3, 4))
    elif cfg.photometric_reduce_op == "mean":
        per_pred = spatial.band_mean(residuals, range(1, residuals.ndim))
    else:
        raise ValueError(cfg.photometric_reduce_op)

    dtype, device = inv_depths.dtype, inv_depths.device
    prog_mask = progressive_scale_mask(p, cfg.progressive_scaling, progress,
                                       dtype, device)
    gamma_w = cfg.gamma ** torch.arange(p - 1, -1, -1, dtype=dtype,
                                        device=device) * prog_mask
    photometric = (per_pred * gamma_w).sum()
    if cfg.normalize_weights:
        photometric = photometric / gamma_w.sum()

    metrics = {"photometric_loss": photometric}
    loss = photometric
    if cfg.smooth_loss_weight > 0.0:
        smooth = cfg.smooth_loss_weight * smoothness_loss(inv_depths, image, cfg,
                                                          mask=prog_mask)
        metrics["smoothness_loss"] = smooth
        loss = loss + smooth
    if cfg.percep_loss_weight > 0.0 and percep_fn is not None:
        percep = cfg.percep_loss_weight * perceptual_term(percep_fn, image, warped[-1])
        metrics["percep_loss"] = percep
        loss = loss + percep
    return loss, metrics
