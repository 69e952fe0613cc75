"""ResNet-18 feature extractor with FPN-style upconv fusion (NCHW).

PyTorch counterpart of `dro_sfm_tpu/models/encoder.py`: conv1 + max-pool +
layers 1-3 (stride 16), bilinear x2 upsampling (half-pixel centres) fused
with the stride-8 skip and, at stride 4, once more with the stride-4 skip
(``upconv2``, ``upconv2_fusion``), projected to ``out_chs``. BatchNorm runs
in eval mode. Submodule names follow the JAX parameter tree
(``layer1_block0``, ``downsample_conv``, ``upconv1_fusion``, ...), so
converted weights load leaf by leaf. Under a height split
(`parallel/spatial.py`) the max-pool fetches its halo rows with -inf
outside the image and the x2 resize one row each side, its source rows
clamped at the image's edges; stride 4 is not split (ROADMAP C).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dro_sfm_torch.models.layers import BatchNorm2d, Conv2d
from dro_sfm_torch.ops.image import resize_bilinear, resize_bilinear_rows
from dro_sfm_torch.parallel import spatial


class BasicBlock(nn.Module):
    """ResNet-18/34 basic residual block (3x3 + 3x3, optional downsample)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"bias": False, "dtype": dtype, "generator": generator}
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1, **kw)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, **kw)
        self.bn2 = BatchNorm2d(features)
        self.has_downsample = stride != 1 or cin != features
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, features, 1, stride=stride,
                                          padding=0, **kw)
            self.downsample_bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """Truncated ResNet-18 with upconv fusion to stride 8 or 4.

    x [B, 3 * num_input_images, H, W] -> [B, out_chs, H/stride, W/stride] in
    ``dtype``.
    """

    def __init__(self, out_chs: int = 32, stride: int = 8,
                 num_input_images: int = 1, layers=(2, 2, 2),
                 dtype=torch.float32, generator=None):
        super().__init__()
        if stride not in (8, 4):
            raise NotImplementedError(f"stride {stride}")
        kw = {"dtype": dtype, "generator": generator}
        self.dtype, self.stride = dtype, stride
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3,
                            bias=False, **kw)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, (blocks, width) in enumerate(zip(layers, (64, 128, 256)),
                                             start=1):
            for bi in range(blocks):
                stride_b = 2 if (li > 1 and bi == 0) else 1
                self.add_module(f"layer{li}_block{bi}",
                                BasicBlock(cin, width, stride_b, **kw))
                cin = width
        self.layers = tuple(layers)
        self.upconv1 = Conv2d(256, 128, 3, padding=1, **kw)
        self.upconv1_fusion = Conv2d(128 + 128, 128, 3, padding=1, **kw)
        if stride == 4:
            self.upconv2 = Conv2d(128, 64, 3, padding=1, **kw)
            self.upconv2_fusion = Conv2d(64 + 64, 64, 3, padding=1, **kw)
        self.out_conv = Conv2d(128 if stride == 8 else 64, out_chs, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 4 and spatial.current() is not None:
            raise NotImplementedError("the stride-4 encoder under a height split "
                                      "(ROADMAP C)")
        y = max_pool(F.relu(self.bn1(self.conv1(x.to(self.dtype)))))
        skips = {}
        for li, blocks in enumerate(self.layers, start=1):
            for bi in range(blocks):
                y = getattr(self, f"layer{li}_block{bi}")(y)
            skips[4 * 2 ** (li - 1)] = y
        y = F.relu(self.upconv1(upsample2(y, skips[8].shape[-2])))
        y = F.relu(self.upconv1_fusion(torch.cat([y, skips[8]], dim=1)))
        if self.stride == 4:
            y = F.relu(self.upconv2(upsample2(y, skips[4].shape[-2])))
            y = F.relu(self.upconv2_fusion(torch.cat([y, skips[4]], dim=1)))
        return self.out_conv(y)


def max_pool(y: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 stride-2 max-pool (pad 1) of NCHW ``y``; under a
    height split on its band, the rows beyond the image -inf."""
    if spatial.current() is None:
        return F.max_pool2d(y, 3, stride=2, padding=1)
    return F.max_pool2d(spatial.conv_rows(y, 3, 2, 1, fill=-math.inf), 3, stride=2,
                        padding=(0, 1))


def upsample2(y: torch.Tensor, rows: int) -> torch.Tensor:
    """The half-pixel bilinear x2 resize of NCHW ``y`` on the channel-last
    view, ``rows`` output rows: stride 16 -> 8, and 8 -> 4 unsplit. Under a
    height split (stride 16 -> 8 only) ``rows`` are this rank's at stride
    8: its band widened by one row each side, source rows clamped at the
    image's edges."""
    band = spatial.current()
    w = y.shape[-1]
    if band is None:
        return resize_bilinear(y.permute(0, 2, 3, 1), (2 * y.shape[-2], 2 * w),
                               align_corners=False).permute(0, 3, 1, 2)
    h16 = band.global_rows(16)
    o0 = band.rows(8)[0]
    ext = spatial.halo(y, 2, 1, 1).permute(0, 2, 3, 1)
    return resize_bilinear_rows(ext, band.rows(16)[0] - 1, h16, (2 * h16, 2 * w),
                                (o0, o0 + rows)).permute(0, 3, 1, 2)
