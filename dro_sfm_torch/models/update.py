"""Recurrent update blocks: separable ConvGRU, heads, motion encoders (NCHW).

PyTorch counterpart of `dro_sfm_tpu/models/update.py`. Submodule names follow
the JAX parameter tree. ``dtype`` is the compute dtype of the convolutions
(bf16 under mixed precision); the final convs of `DepthHead` and `PoseHead`
always run in fp32, since they produce the depth and pose deltas.

Under a height split (`parallel/spatial.py`) the convolutions exchange
their halos themselves (`models/layers.py:Conv2d`), the pose head's mean
over (H, W) is the band's sum summed over the spatial group over the
image's pixel count, so every rank holds the same pose, and the fused
(5,1) GRU pass runs on the band widened by 4 rows each side: q at a row
reads r*h two rows away, and r there reads [h, x] two rows further.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dro_sfm_torch.models.layers import Conv2d
from dro_sfm_torch.ops.gru_pass import gru_sep1d_pass
from dro_sfm_torch.parallel import spatial

# Rows the fused (5,1) pass reads beyond a band: two taps for z, r, two more
# for q's r*h.
GRU_HALO = 4


class DepthHead(nn.Module):
    """Two 3x3 convs -> 1-channel map through an activation."""

    def __init__(self, cin: int, hidden_dim: int = 128, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(cin, hidden_dim, 3, dtype=dtype, generator=generator)
        self.conv2 = Conv2d(hidden_dim, 1, 3, generator=generator)

    def forward(self, x: torch.Tensor, act_fn=torch.tanh) -> torch.Tensor:
        return act_fn(self.conv2(F.relu(self.conv1(x)).float()))


class PoseHead(nn.Module):
    """Two 3x3 convs -> spatial mean -> 6-DoF vector [B, 6], with the last
    three (rotation) channels scaled by 0.01."""

    def __init__(self, cin: int, hidden_dim: int = 128, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(cin, hidden_dim, 3, dtype=dtype, generator=generator)
        self.conv2 = Conv2d(hidden_dim, 6, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = spatial.plane_mean(self.conv2(F.relu(self.conv1(x)).float()))
        return torch.cat([y[:, :3], 0.01 * y[:, 3:]], dim=-1)


class UpMaskNet(nn.Module):
    """Convex-upsampling mask head, output scaled by 0.25 (compute dtype)."""

    def __init__(self, cin: int, hidden_dim: int = 128, ratio: int = 8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.conv1 = Conv2d(cin, hidden_dim * 2, 3, **kw)
        self.conv2 = Conv2d(hidden_dim * 2, ratio * ratio * 9, 1, **kw)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.conv2(F.relu(self.conv1(feat)))


class SepConvGRU(nn.Module):
    """Separable (1x5 then 5x1) convolutional GRU in the compute dtype.

    The z and r gates read the same [h, x] input, so each direction runs
    them as one fused ``convzr`` conv with 2 * hidden_dim outputs, z first,
    then r. The JAX package's ``conv``, ``split`` and ``matmul`` paths are the
    same math here (convolutions in the compute dtype). ``pallas`` runs each
    directional pass as one fused `gru_sep1d_pass` (kernel K5, backward K6
    on the card; the plain version with the same rounding points on the
    CPU), with the same parameters.
    """

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128,
                 dtype=torch.float32, conv_impl: str = "split",
                 generator=None):
        super().__init__()
        if conv_impl not in ("conv", "split", "matmul", "pallas"):
            raise ValueError(f"unknown sep_conv {conv_impl!r}")
        kw = {"dtype": dtype, "generator": generator}
        cin = hidden_dim + input_dim
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.conv_impl = conv_impl
        self.convzr1 = Conv2d(cin, 2 * hidden_dim, (1, 5), **kw)
        self.convq1 = Conv2d(cin, hidden_dim, (1, 5), **kw)
        self.convzr2 = Conv2d(cin, 2 * hidden_dim, (5, 1), **kw)
        self.convq2 = Conv2d(cin, hidden_dim, (5, 1), **kw)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = h.to(self.dtype)
        x = x.to(self.dtype)
        if self.conv_impl == "pallas":
            return self._fused_passes(h, x)
        for convzr, convq in ((self.convzr1, self.convq1),
                              (self.convzr2, self.convq2)):
            zr = torch.sigmoid(convzr(torch.cat([h, x], dim=1)))
            z, r = zr.split(self.hidden_dim, dim=1)
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h

    def _fused_passes(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Both passes channel-minor: h and x are laid out [B,H,W,C] once,
        the (1,5) then the (5,1) pass run there, and h' goes back as an NCHW
        view. Each OIHW weight enters as a [5, Cin, out] view of the fp32
        parameter (`gru_sep1d_pass` casts it). Under a height split the
        (5,1) pass runs on [h, x] widened by `GRU_HALO` rows each side
        (zeros outside the image, as the kernel's own padding) and keeps
        the band's rows."""
        h = h.permute(0, 2, 3, 1).contiguous()
        x = x.permute(0, 2, 3, 1).contiguous()
        d = h.shape[-1]
        for convzr, convq, axis in ((self.convzr1, self.convq1, 2),
                                    (self.convzr2, self.convq2, 1)):
            hp, xp = h, x
            banded = axis == 1 and spatial.current() is not None
            if banded:
                hx = spatial.halo(torch.cat([h, x], dim=-1), 1, GRU_HALO, GRU_HALO)
                hp, xp = hx[..., :d].contiguous(), hx[..., d:].contiguous()
            h = gru_sep1d_pass(hp, xp, convzr.weight.flatten(2).permute(2, 1, 0), convzr.bias,
                               convq.weight.flatten(2).permute(2, 1, 0), convq.bias, axis)
            if banded:
                h = h[:, GRU_HALO:-GRU_HALO].contiguous()
        return h.permute(0, 3, 1, 2)


class ProjectionInputDepth(nn.Module):
    """Encode (inv-depth, cost) into GRU input features: ``out_chs - 1``
    encoded channels with the raw inv-depth appended as the last."""

    def __init__(self, cost_dim: int, hidden_dim: int, out_chs: int,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.convc1 = Conv2d(cost_dim, hidden_dim, 1, **kw)
        self.convc2 = Conv2d(hidden_dim, hidden_dim, 3, **kw)
        self.convd1 = Conv2d(1, hidden_dim, 7, **kw)
        self.convd2 = Conv2d(hidden_dim, 64, 3, **kw)
        self.convd = Conv2d(hidden_dim + 64, out_chs - 1, 3, **kw)

    def forward(self, inv_depth: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(cost))))
        d = F.relu(self.convd2(F.relu(self.convd1(inv_depth))))
        y = F.relu(self.convd(torch.cat([c, d], dim=1)))
        return torch.cat([y, inv_depth.to(y.dtype)], dim=1)


class ProjectionInputPose(nn.Module):
    """Encode (pose vector, cost) into GRU input features: the 6-DoF pose is
    broadcast over the grid and appended as the last six channels."""

    def __init__(self, cost_dim: int, hidden_dim: int, out_chs: int,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.convc1 = Conv2d(cost_dim, hidden_dim, 1, **kw)
        self.convc2 = Conv2d(hidden_dim, hidden_dim, 3, **kw)
        self.convp1 = Conv2d(6, hidden_dim, 7, **kw)
        self.convp2 = Conv2d(hidden_dim, 64, 3, **kw)
        self.convp = Conv2d(hidden_dim + 64, out_chs - 6, 3, **kw)

    def forward(self, pose: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        b, h, w = cost.shape[0], cost.shape[-2], cost.shape[-1]
        c = F.relu(self.convc2(F.relu(self.convc1(cost))))
        pose_map = pose[:, :, None, None].expand(b, 6, h, w)
        p = F.relu(self.convp2(F.relu(self.convp1(pose_map))))
        y = F.relu(self.convp(torch.cat([c, p], dim=1)))
        return torch.cat([y, pose_map.to(y.dtype)], dim=1)


class DepthUpdateCell(nn.Module):
    """One inner depth-refinement step: (hidden, inv-depth, cost, context)
    -> (hidden', inv-depth delta). The caller owns the loop and the cost."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 32,
                 cost_dim: int = 128, dtype=torch.float32,
                 conv_impl: str = "split", generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.encoder = ProjectionInputDepth(cost_dim, hidden_dim, hidden_dim, **kw)
        self.gru = SepConvGRU(hidden_dim, context_dim + hidden_dim,
                              conv_impl=conv_impl, **kw)
        self.head = DepthHead(hidden_dim, hidden_dim, **kw)

    def forward(self, net, inv_depth, cost, context):
        feats = self.encoder(inv_depth, cost)
        net = self.gru(net, torch.cat([context.to(feats.dtype), feats], dim=1))
        return net, self.head(net)


class UpdateMaskHead(nn.Module):
    """Convex-upsampling mask from a depth-GRU hidden state (compute dtype)."""

    def __init__(self, hidden_dim: int = 128, ratio: int = 8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.mask1 = Conv2d(hidden_dim, hidden_dim * 2, 3, **kw)
        self.mask2 = Conv2d(hidden_dim * 2, ratio * ratio * 9, 1, **kw)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask2(F.relu(self.mask1(net)))


class PoseUpdateCell(nn.Module):
    """One inner pose-refinement step: (hidden, pose [B,6], cost, context)
    -> (hidden', pose delta [B,6])."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 32,
                 cost_dim: int = 128, dtype=torch.float32,
                 conv_impl: str = "split", generator=None):
        super().__init__()
        kw = {"dtype": dtype, "generator": generator}
        self.encoder = ProjectionInputPose(cost_dim, hidden_dim, hidden_dim, **kw)
        self.gru = SepConvGRU(hidden_dim, context_dim + hidden_dim,
                              conv_impl=conv_impl, **kw)
        self.head = PoseHead(hidden_dim, hidden_dim, **kw)

    def forward(self, net, pose, cost, context):
        feats = self.encoder(pose, cost)
        net = self.gru(net, torch.cat([context.to(feats.dtype), feats], dim=1))
        return net, self.head(net)
