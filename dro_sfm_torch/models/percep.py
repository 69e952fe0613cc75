"""VGG16-slice perceptual feature distance (NCHW, frozen).

PyTorch counterpart of `dro_sfm_tpu/models/percep.py`: ImageNet
normalisation, a 224x224 bilinear resize (half-pixel centres, no
anti-aliasing), the first three VGG16 stages (convolutions ``conv0`` ...
``conv6``, named after the flax tree, with a 2x2 max pool before the second
and third), and the weighted L1 distances of the two images' feature maps,
each resized to the first stage's size and summed. The net takes no
gradient; the distance's gradient reaches the images.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dro_sfm_torch.models.layers import Conv2d
from dro_sfm_torch.ops.image import resize_bilinear

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG16 per stage: (output channels of each conv, max pool before the stage)
_SLICES = (
    ((64, 64), False),
    ((128, 128), True),
    ((256, 256, 256), True),
)


class PercepNet(nn.Module):
    """Three-stage VGG16 feature extractor and weighted L1 distance, built
    on ``device`` with weights drawn from ``generator`` and frozen."""

    def __init__(self, weights: Sequence[float] = (0.15, 0.25, 0.6),
                 resize: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weights = tuple(weights)
        self.resize = resize
        cin, idx = 3, 0
        for channels, _ in _SLICES:
            for ch in channels:
                self.add_module(f"conv{idx}", Conv2d(cin, ch, 3, padding=1,
                                                     generator=generator))
                cin, idx = ch, idx + 1
        self.requires_grad_(False)
        self.to(device)
        self.eval()

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """ImageNet normalisation of [B,H,W,3], then the 224x224 resize."""
        mean = x.new_tensor(_IMAGENET_MEAN)
        std = x.new_tensor(_IMAGENET_STD)
        out = (x - mean) / std
        if self.resize:
            out = resize_bilinear(out, (224, 224), align_corners=False)
        return out

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """im1, im2 [B,H,W,3] -> perceptual distance map [B,h,w,1] at the
        first stage's resolution."""
        x = self.normalize(torch.cat([im1, im2], dim=0)).permute(0, 3, 1, 2)
        total, ref_hw, idx = None, None, 0
        for si, (channels, pool_before) in enumerate(_SLICES):
            if pool_before:
                x = F.max_pool2d(x, 2, stride=2)
            for _ in channels:
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            f1, f2 = x.chunk(2, dim=0)
            if ref_hw is None:
                ref_hw = f1.shape[-2:]
            d = self.weights[si] * (f1 - f2).abs().mean(dim=1, keepdim=True)
            d = resize_bilinear(d.permute(0, 2, 3, 1), ref_hw, align_corners=False)
            total = d if total is None else total + d
        return total
