"""Single-frame depth and pose networks (monodepth2 lineage, NCHW).

PyTorch counterpart of `dro_sfm_tpu/models/single_frame.py`: a ResNet-18
feature pyramid, a U-Net depth decoder with a sigmoid disparity head at
four scales, and a pose net on image pairs; `SingleFrameNet` puts the depth
net and the pose net behind the interface of `DepthPoseNet`. Submodule names
follow the flax tree (``depth_net.encoder.layer1_block0``,
``depth_net.decoder.upconv_4_0``, ``pose_net.squeeze``, ...), so converted
weights load leaf by leaf. Everything runs in fp32; BatchNorm follows the
JAX package's train-mode semantics (`layers.BatchNorm2d`).

Under a height split (`parallel/spatial.py`, a band down to stride 32
active) every map is the band's rows: the convolutions and the stem's
max-pool fetch their halos (`layers.Conv2d`, `encoder.max_pool`), the
decoder's nearest x2 gives the band's rows at the finer stride
(`ops/image.py:upsample_nearest2`), so that the skip connections line up,
the pose net's mean is the whole image's (`spatial.plane_mean`), and the
resize of each scale to full resolution stays inside the band, whose first
row is a multiple of 8.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dro_sfm_torch.models.encoder import BasicBlock, max_pool
from dro_sfm_torch.models.layers import BatchNorm2d, Conv2d
from dro_sfm_torch.ops.depth_ops import disp_to_depth
from dro_sfm_torch.ops.image import resize_nearest, upsample_nearest2
from dro_sfm_torch.parallel import spatial
from dro_sfm_torch.utils.device import resolve_device

ENCODER_WIDTHS = (64, 64, 128, 256, 512)     # channels at strides 2, 4, 8, 16, 32


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResNetFeatures(nn.Module):
    """ResNet-18 feature pyramid: [B, 3 * num_input_images, H, W] -> five
    maps at strides 2, 4, 8, 16 and 32."""

    def __init__(self, num_input_images: int = 1, layers=(2, 2, 2, 2),
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3,
                            bias=False, generator=generator)
        self.bn1 = BatchNorm2d(64)
        self.layers = tuple(layers)
        cin = 64
        for li, (blocks, width) in enumerate(zip(layers, ENCODER_WIDTHS[1:]), 1):
            for bi in range(blocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                self.add_module(f"layer{li}_block{bi}",
                                BasicBlock(cin, width, stride, generator=generator))
                cin = width

    def forward(self, x: torch.Tensor):
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = max_pool(y)
        for li, blocks in enumerate(self.layers, 1):
            for bi in range(blocks):
                y = getattr(self, f"layer{li}_block{bi}")(y)
            feats.append(y)
        return feats


class DepthDecoder(nn.Module):
    """U-Net decoder with a sigmoid disparity at each of ``scales``:
    returns [S] maps [B,1,h_s,w_s], finest first."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3),
                 dec_channels: Sequence[int] = (16, 32, 64, 128, 256),
                 generator=None):
        super().__init__()
        self.scales = tuple(scales)
        cin = ENCODER_WIDTHS[-1]
        for i in range(4, -1, -1):
            ch = dec_channels[i]
            self.add_module(f"upconv_{i}_0", Conv2d(cin, ch, 3, padding=1,
                                                    generator=generator))
            skip = ENCODER_WIDTHS[i - 1] if i > 0 else 0
            self.add_module(f"upconv_{i}_1", Conv2d(ch + skip, ch, 3, padding=1,
                                                    generator=generator))
            if i in self.scales:
                self.add_module(f"dispconv_{i}", Conv2d(ch, 1, 3, padding=1,
                                                        generator=generator))
            cin = ch

    def forward(self, feats):
        outputs = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            x = F.elu(getattr(self, f"upconv_{i}_0")(x))
            x = _nchw(upsample_nearest2(_nhwc(x)))
            if i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = F.elu(getattr(self, f"upconv_{i}_1")(x))
            if i in self.scales:
                outputs[i] = torch.sigmoid(getattr(self, f"dispconv_{i}")(x))
        return [outputs[s] for s in sorted(self.scales)]


class DepthResNet(nn.Module):
    """Single-frame depth net: image [B,3,H,W] -> inverse depths at the
    decoder's scales [B,1,h_s,w_s], finest first, through `disp_to_depth`."""

    def __init__(self, min_depth: float = 0.1, max_depth: float = 100.0,
                 generator=None):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.encoder = ResNetFeatures(generator=generator)
        self.decoder = DepthDecoder(generator=generator)

    def forward(self, image: torch.Tensor):
        disps = self.decoder(self.encoder(image))
        return [disp_to_depth(d, self.min_depth, self.max_depth)[0] for d in disps]


class PoseResNet(nn.Module):
    """Single-frame pose net: a ResNet-18 on (target, context) pairs and a
    pose decoder -> [B,N,6], 0.01 times the spatial mean, reordered from
    [r | t] to the repo's [t | r]."""

    def __init__(self, generator=None):
        super().__init__()
        self.encoder = ResNetFeatures(num_input_images=2, generator=generator)
        self.squeeze = Conv2d(ENCODER_WIDTHS[-1], 256, 1, generator=generator)
        self.pose_0 = Conv2d(256, 256, 3, padding=1, generator=generator)
        self.pose_1 = Conv2d(256, 256, 3, padding=1, generator=generator)
        self.pose_2 = Conv2d(256, 6, 1, generator=generator)

    def forward(self, target: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        """target [B,H,W,3]; refs [B,N,H,W,3] -> [B,N,6]."""
        b, n = refs.shape[0], refs.shape[1]
        pairs = torch.cat([target[:, None].expand_as(refs), refs], dim=-1)
        y = self.encoder(_nchw(pairs.flatten(0, 1)))[-1]
        y = F.relu(self.squeeze(y))
        y = F.relu(self.pose_0(y))
        y = F.relu(self.pose_1(y))
        out = 0.01 * spatial.plane_mean(self.pose_2(y))          # [B*N, 6] = [r | t]
        return torch.cat([out[:, 3:], out[:, :3]], dim=-1).reshape(b, n, 6)


class SingleFrameNet(nn.Module):
    """The depth net and the pose net behind the `DepthPoseNet` interface.

    Built on ``device`` (the card unless the caller asks for the CPU) with
    weights drawn from ``generator`` (seed 0 when None); starts in eval
    mode. The decoder's scales are resized to full resolution (nearest) and
    stacked coarsest first, so ``inv_depths[-1]`` is the finest map; the one
    pose estimate is repeated over the prediction axis. The optimizer gives
    ``pose_net.*`` the pose group's rate.
    """

    def __init__(self, min_depth: float = 0.1, max_depth: float = 100.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.depth_net = DepthResNet(min_depth, max_depth, generator=generator)
        self.pose_net = PoseResNet(generator=generator)
        self.to(device)
        self.eval()

    def forward(self, target: torch.Tensor, refs: torch.Tensor,
                intrinsics: torch.Tensor | None = None,
                last_only: bool = False) -> Dict[str, torch.Tensor]:
        """target [B,H,W,3]; refs [B,N,H,W,3] -> ``inv_depths`` [S,B,H,W,1]
        (S = 1 with ``last_only``: the finest map) and ``pose_vecs``
        [B,N,S,6]. ``intrinsics`` is not used."""
        inv_depths = self.depth_net(_nchw(target))
        h, w = target.shape[1], target.shape[2]
        if last_only:
            inv_depths = inv_depths[:1]
        stacked = torch.stack([_full_resolution(_nhwc(d), h, w) for d in inv_depths[::-1]])
        pose = self.pose_net(target, refs)
        pose_vecs = pose[:, :, None].expand(*pose.shape[:2], stacked.shape[0], 6)
        return {"inv_depths": stacked, "pose_vecs": pose_vecs}


def _full_resolution(d: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A decoder scale [B,h_s,w_s,1] resized (nearest) to [B,h,w,1]. Under
    a height split its band's rows: the band at stride s starts at r0 / s,
    r0 being a multiple of 8 (H/8 divides by S), so the band's rows read
    only its own."""
    band = spatial.current()
    if band is not None:
        s = band.stride_of(d.shape[-3])
        r0 = band.rows(1)[0]
        if r0 % s:
            raise ValueError(f"band {band.index}: rows from {r0} are not aligned at stride {s}")
    return resize_nearest(d, (h, w))
