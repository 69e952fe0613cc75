"""SSIM distance of the photometric loss (plain PyTorch).

PyTorch counterpart of `dro_sfm_tpu/ops/ssim.py`: local statistics from a
3x3 mean filter with reflection padding, C1 = 1e-4, C2 = 9e-4. Both
images are widened by one row each side once (`reflect_rows`: under a
height split the only two exchanges of a call), and the products and the
five pools run on those rows: the same taps in the same order as pooling
each product on its own, bit for bit.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.ops.image import avg_pool_3x3_rows, reflect_rows


def ssim(x: torch.Tensor, y: torch.Tensor,
         c1: float = 1e-4, c2: float = 9e-4) -> torch.Tensor:
    """Per-pixel SSIM similarity of two images [..., H, W, C] whose shapes
    broadcast. Each image's own statistics are pooled at its own shape, so
    a target broadcast over predictions and views is pooled once."""
    xp, yp = reflect_rows(x), reflect_rows(y)
    mu_x = avg_pool_3x3_rows(xp)
    mu_y = avg_pool_3x3_rows(yp)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y

    sigma_x = avg_pool_3x3_rows(xp * xp) - mu_xx
    sigma_y = avg_pool_3x3_rows(yp * yp) - mu_yy
    sigma_xy = avg_pool_3x3_rows(xp * yp) - mu_xy

    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim_loss(x: torch.Tensor, y: torch.Tensor,
              c1: float = 1e-4, c2: float = 9e-4) -> torch.Tensor:
    """Clamped SSIM distance (1 - ssim) / 2 in [0, 1]."""
    return ((1.0 - ssim(x, y, c1, c2)) * 0.5).clamp(0.0, 1.0)
