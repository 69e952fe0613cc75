"""Image resize and horizontal flip on channel-last tensors.

PyTorch counterpart of `resize_bilinear`, `flip_lr` and `flip_intrinsics` in
`dro_sfm_tpu/ops/image.py`.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.ops.resample import bilinear_sample


def resize_bilinear(image: torch.Tensor, shape,
                    align_corners: bool = True) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., shape[0], shape[1], C] bilinearly.

    ``align_corners=True`` spans the corner pixels; ``align_corners=False``
    uses half-pixel centres clamped into the image, the rule of
    ``F.interpolate(..., align_corners=False)`` that the encoder uses.
    """
    ho, wo = int(shape[0]), int(shape[1])
    h, w = image.shape[-3], image.shape[-2]
    if (h, w) == (ho, wo):
        return image
    kw = {"dtype": torch.float32, "device": image.device}
    if align_corners:
        xs = torch.linspace(0.0, w - 1.0, wo, **kw)
        ys = torch.linspace(0.0, h - 1.0, ho, **kw)
    else:
        xs = ((torch.arange(wo, **kw) + 0.5) * (w / wo) - 0.5).clamp(0.0, w - 1.0)
        ys = ((torch.arange(ho, **kw) + 0.5) * (h / ho) - 0.5).clamp(0.0, h - 1.0)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).expand(*image.shape[:-3], ho, wo, 2)
    return bilinear_sample(image, grid)


def flip_lr(image: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., H, W, C]."""
    return torch.flip(image, dims=(-2,))


def flip_intrinsics(K: torch.Tensor, width: int) -> torch.Tensor:
    """Intrinsics [..., 3, 3] of a horizontally flipped image of ``width``:
    fx -> -fx, cx -> width - cx."""
    K = K.clone()
    K[..., 0, 0] = -K[..., 0, 0]
    K[..., 0, 2] = width - K[..., 0, 2]
    return K
