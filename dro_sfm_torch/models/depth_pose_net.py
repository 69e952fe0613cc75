"""DepthPoseNet — the DRO recurrent depth+pose optimizer (PyTorch).

PyTorch counterpart of `dro_sfm_tpu/models/depth_pose_net.py`: a shared
feature encoder, initial depth and pose heads, then alternating refinement
in which a depth ConvGRU and a pose ConvGRU descend a per-pixel
feature-metric cost (the squared feature difference after warping the
reference features into the target view, kernel K1 on the card).

Public tensors keep the JAX layout: inputs are NHWC, ``inv_depths`` is
[P,B,H,W,1] and ``pose_vecs`` is [B,N,P,6]. Convolutions run in NCHW, on
tensors whose memory is channel-last, so the hand-off to the warp kernel is a
view. The refinement loops are Python loops; the per-iteration projection
invariants are hoisted as in the JAX version.

Dtype policy with ``mixed_precision``: convolutions, GRU hidden states and
context, the cost and the upsampling masks run in bf16; inverse depth,
poses, geometry and the final head convs stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dro_sfm_torch.geometry.camera import (
    invert_intrinsics,
    pixel_grid,
    scale_intrinsics,
)
from dro_sfm_torch.geometry.pose import pose_vec_to_mat
from dro_sfm_torch.models.encoder import ResNetEncoder
from dro_sfm_torch.models.update import (
    DepthHead,
    DepthUpdateCell,
    PoseHead,
    PoseUpdateCell,
    UpdateMaskHead,
    UpMaskNet,
)
from dro_sfm_torch.ops.depth_ops import disp_to_depth, inv2depth
from dro_sfm_torch.ops.tent_warp import warp_cost as _sample_cost
from dro_sfm_torch.ops.upsample import convex_upsample
from dro_sfm_torch.utils.device import resolve_device

WARP_IMPLS = ("pallas", "gather", "matmul")
REMAT_STEPS = (True, "steps", "save_named")   # recompute each step in backward


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    """Parsed network version string: ``it{K}`` total refinement steps,
    ``-h`` 128-d hidden state, ``-out`` normalized depth output,
    ``-seq{L}`` inner sequence length (default 4), ``-inter`` every inner
    step supervised."""
    total_iters: int
    seq_len: int
    hidden_dim: int
    out_normalize: bool
    inter_sup: bool

    @property
    def outer_iters(self) -> int:
        return self.total_iters // self.seq_len

    @property
    def num_predictions(self) -> int:
        """1 (init) + per-outer-iteration collected predictions."""
        per_iter = self.seq_len if self.inter_sup else 1
        return 1 + self.outer_iters * per_iter

    @classmethod
    def parse(cls, version: str) -> "VersionSpec":
        if "it" not in version:
            raise ValueError(f"bad version string: {version}")
        total_iters = int(version.split("-")[0].split("it")[1])
        seq_len = 4
        for token in version.split("-"):
            if "seq" in token:
                seq_len = int(token.split("seq")[1])
        return cls(total_iters=total_iters, seq_len=seq_len,
                   hidden_dim=128 if "h" in version else 64,
                   out_normalize="out" in version,
                   inter_sup="inter" in version)


def _proj_affine(K_scaled, pose_mats):
    """Projection of target pixel p at depth d as one affine map:
    (K R Kinv) p * d + K t. K_scaled [B,3,3]; pose_mats [B,N,4,4] ->
    A [B,N,3,3], b [B,N,3]."""
    Kinv = invert_intrinsics(K_scaled)
    A = torch.einsum("bij,bnjk,bkl->bnil", K_scaled, pose_mats[..., :3, :3], Kinv)
    b = torch.einsum("bij,bnj->bni", K_scaled, pose_mats[..., :3, 3])
    return A, b


def _proj_to_coords(proj):
    """Homogeneous projections [..., 3] -> pixel coords [..., 2], z clamped
    at 1e-5."""
    z = proj[..., 2].clamp_min(1e-5)
    return torch.stack([proj[..., 0] / z, proj[..., 1] / z], dim=-1)


def warp_cost(fmap1, fmaps_ref, depth, pose_vecs, K_scaled,
              impl: str = "pallas"):
    """Per-pixel feature-metric cost for every view.

    fmap1 [B,h,w,C]; fmaps_ref [B,N,h,w,C]; depth [B,h,w,1]; pose_vecs
    [B,N,6]; K_scaled [B,3,3] -> cost [B,N,h,w,C].
    """
    h, w = depth.shape[-3], depth.shape[-2]
    A, b = _proj_affine(K_scaled, pose_vec_to_mat(pose_vecs, "euler"))
    grid = pixel_grid(h, w, dtype=depth.dtype, device=depth.device)
    G = torch.einsum("bnij,hwj->bnhwi", A, grid)
    proj = G * depth[:, None] + b[:, :, None, None, :]
    return _sample_cost(fmap1, fmaps_ref, _proj_to_coords(proj), impl)


def _nchw(x):
    """[B,H,W,C] -> [B,C,H,W] view (channel-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    """[B,C,H,W] -> [B,H,W,C] view."""
    return x.permute(0, 2, 3, 1)


class _DepthStep(nn.Module):
    """One inner depth-refinement step (poses frozen): cost at the current
    inverse depth, averaged over views, then the GRU cell."""

    def __init__(self, spec, context_dim, feat_dim, min_depth, max_depth,
                 dtype, warp_impl, sep_conv, generator):
        super().__init__()
        self.cell = DepthUpdateCell(spec.hidden_dim, context_dim, feat_dim,
                                    dtype, sep_conv, generator)
        self.out_normalize = spec.out_normalize
        self.min_depth, self.max_depth = min_depth, max_depth
        self.warp_impl = warp_impl

    def forward(self, hidden, inv_depth, consts):
        scaled = (disp_to_depth(inv_depth, self.min_depth, self.max_depth)[0]
                  if self.out_normalize else inv_depth)
        depth = inv2depth(scaled)                                  # [B,h,w,1]
        proj = consts["G"] * depth[:, None] + consts["bvec"][:, :, None, None, :]
        cost = _sample_cost(consts["fmap1"], consts["fmaps_ref"],
                            _proj_to_coords(proj), self.warp_impl).mean(dim=1)
        hidden, delta = self.cell(hidden, _nchw(inv_depth), _nchw(cost),
                                  consts["inp"])
        return hidden, inv_depth + _nhwc(delta)


class _PoseStep(nn.Module):
    """One inner pose-refinement step (depth frozen), all views folded into
    the batch."""

    def __init__(self, spec, context_dim, feat_dim, dtype, warp_impl,
                 sep_conv, generator):
        super().__init__()
        self.cell = PoseUpdateCell(spec.hidden_dim, context_dim, feat_dim,
                                   dtype, sep_conv, generator)
        self.warp_impl = warp_impl

    def forward(self, hidden, poses, consts):
        b, n = poses.shape[0], poses.shape[1]
        mats = pose_vec_to_mat(poses, "euler")                     # [B,N,4,4]
        KR = torch.einsum("bij,bnjk->bnik", consts["K"], mats[..., :3, :3])
        Kt = torch.einsum("bij,bnj->bni", consts["K"], mats[..., :3, 3])
        proj = (torch.einsum("bnij,bhwj->bnhwi", KR, consts["points"])
                + Kt[:, :, None, None, :])
        cost = _sample_cost(consts["fmap1"], consts["fmaps_ref"],
                            _proj_to_coords(proj), self.warp_impl)  # [B,N,h,w,C]
        hidden, delta = self.cell(hidden, poses.reshape(b * n, 6),
                                  _nchw(cost.flatten(0, 1)), consts["inp"])
        return hidden, poses + delta.reshape(b, n, 6)


class _OuterIteration(nn.Module):
    """The refinement: each outer iteration detaches the state, runs
    ``seq_len`` depth steps (poses frozen), then ``seq_len`` pose steps
    (depth frozen at the iteration start). Named ``refinement`` in the
    parameter tree, as in the JAX package."""

    def __init__(self, spec, context_dim, feat_dim, ratio, min_depth,
                 max_depth, dtype, warp_impl, sep_conv, remat, generator):
        super().__init__()
        self.spec = spec
        self.remat = remat
        self.min_depth, self.max_depth = min_depth, max_depth
        self.update_block_depth = _DepthStep(
            spec, context_dim, feat_dim, min_depth, max_depth, dtype,
            warp_impl, sep_conv, generator)
        self.update_block_pose = _PoseStep(
            spec, context_dim, feat_dim, dtype, warp_impl, sep_conv, generator)
        self.mask_head = UpdateMaskHead(spec.hidden_dim, ratio, dtype, generator)

    def _step(self, block, hidden, state, consts):
        """One inner step; with ``remat`` its activations are recomputed in
        the backward instead of kept."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, hidden, state, consts, use_reentrant=False)
        return block(hidden, state, consts)

    def forward(self, hidden_d, hidden_p, inv_depth, poses, consts,
                last_only: bool):
        """Only the geometry (inverse depth and poses) is detached between
        outer iterations, not the GRU hidden states, as in the JAX package.
        Returns (kept inv-depths [B,h,w,1], their masks [B,9r^2,h,w] or
        None where ``last_only`` drops them, kept poses [B,N,6])."""
        spec = self.spec
        keep_d, keep_m, keep_p = [], [], []
        for it in range(spec.outer_iters):
            inv_depth, poses = inv_depth.detach(), poses.detach()
            scaled = (disp_to_depth(inv_depth, self.min_depth, self.max_depth)[0]
                      if spec.out_normalize else inv_depth)
            depth_frozen = inv2depth(scaled)
            A, bvec = _proj_affine(consts["K"], pose_vec_to_mat(poses, "euler"))
            depth_consts = {"fmap1": consts["fmap1"],
                            "fmaps_ref": consts["fmaps_ref"],
                            "G": torch.einsum("bnij,hwj->bnhwi", A, consts["grid"]),
                            "bvec": bvec, "inp": consts["inp_d"]}
            pose_consts = {"fmap1": consts["fmap1"],
                           "fmaps_ref": consts["fmaps_ref"],
                           "points": consts["rays"] * depth_frozen,
                           "K": consts["K"], "inp": consts["inp_p"]}
            d_seq, h_seq, p_seq = [], [], []
            for _ in range(spec.seq_len):
                hidden_d, inv_depth = self._step(
                    self.update_block_depth, hidden_d, inv_depth, depth_consts)
                d_seq.append(inv_depth)
                h_seq.append(hidden_d)
            for _ in range(spec.seq_len):
                hidden_p, poses = self._step(
                    self.update_block_pose, hidden_p, poses, pose_consts)
                p_seq.append(poses)
            if not spec.inter_sup:
                d_seq, h_seq, p_seq = d_seq[-1:], h_seq[-1:], p_seq[-1:]
            last_iter = it == spec.outer_iters - 1
            for i, h in enumerate(h_seq):
                # The masks are needed only for predictions that get upsampled.
                wanted = not last_only or (last_iter and i == len(h_seq) - 1)
                keep_m.append(self.mask_head(h) if wanted else None)
            keep_d += d_seq
            keep_p += p_seq
        return keep_d, keep_m, keep_p


class DepthPoseNet(nn.Module):
    """Joint recurrent depth + pose network (the DRO optimizer).

    Built on ``device`` (the card unless the caller asks for the CPU) with
    weights drawn from ``generator`` (a CPU ``torch.Generator``; seed 0 when
    None). ``warp_impl`` takes the JAX names: ``"pallas"`` (the config
    default) is kernels K1 (forward), K2 and K3 (backward) on CUDA tensors
    and their plain versions on CPU tensors; ``"gather"`` and ``"matmul"``
    are the plain version, differentiated by autograd. ``sep_conv`` picks
    the GRU's directional passes (`SepConvGRU`): ``"split"`` (the default),
    ``"conv"`` and ``"matmul"`` are library convolutions; ``"pallas"`` is
    one fused pass each, kernel K5 with backward K6-input and K6-weight on
    CUDA tensors and their plain versions on CPU tensors. ``remat``: True,
    ``"steps"`` or ``"save_named"`` recompute each inner refinement step in
    the backward (``torch.utils.checkpoint``; the JAX package's selective
    ``"save_named"`` policy becomes the whole step); False keeps every
    activation. ``"auto"`` is resolved by the caller for its batch and image
    size (`dro_sfm_torch.models.sfm.resolve_memory_policy`). ``unroll`` is
    accepted and ignored: the loops run eagerly. The module starts in eval
    mode; ``train()`` switches BatchNorm to batch statistics.
    """

    def __init__(self, version: str = "it12-h-out", min_depth: float = 0.1,
                 max_depth: float = 100.0, feat_dim: int = 128,
                 feat_ratio: int = 8, context_dim: int = 32,
                 mixed_precision: bool = False, warp_impl: str = "pallas",
                 sep_conv: str = "split", remat=True, unroll: str = "none",
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if warp_impl not in WARP_IMPLS:
            raise ValueError(f"unknown warp_impl {warp_impl!r}")
        if remat not in REMAT_STEPS and remat is not False:
            raise ValueError(f"remat {remat!r}: want True, False, 'steps' or "
                             "'save_named' ('auto' is resolved by "
                             "models.sfm.resolve_memory_policy)")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.version = version
        self.spec = spec = VersionSpec.parse(version)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.feat_ratio = feat_ratio
        self.mixed_precision = mixed_precision
        self.dtype = dt = torch.bfloat16 if mixed_precision else torch.float32
        hdim = spec.hidden_dim
        g = generator
        self.fnet = ResNetEncoder(feat_dim, feat_ratio, dtype=dt, generator=g)
        self.depth_head = DepthHead(feat_dim, feat_dim, dt, g)
        self.pose_head = PoseHead(2 * feat_dim, feat_dim, dt, g)
        self.upmask_net = UpMaskNet(feat_dim, feat_dim, feat_ratio, dt, g)
        if spec.outer_iters > 0:      # the context nets feed the refinement only
            self.cnet_depth = ResNetEncoder(hdim + context_dim, feat_ratio,
                                            dtype=dt, generator=g)
            self.cnet_pose = ResNetEncoder(hdim + context_dim, feat_ratio,
                                           num_input_images=2, dtype=dt,
                                           generator=g)
            self.refinement = _OuterIteration(
                spec, context_dim, feat_dim, feat_ratio, min_depth, max_depth,
                dt, warp_impl, sep_conv, remat in REMAT_STEPS, g)
        self.to(device)
        self.eval()

    def scale_inv_depth(self, x: torch.Tensor) -> torch.Tensor:
        """Optionally map raw network output to bounded inverse depth."""
        if self.spec.out_normalize:
            return disp_to_depth(x, self.min_depth, self.max_depth)[0]
        return x

    def forward(self, target: torch.Tensor, refs: torch.Tensor,
                intrinsics: torch.Tensor,
                last_only: bool = False) -> Dict[str, torch.Tensor]:
        """target [B,H,W,3]; refs [B,N,H,W,3]; intrinsics [B,3,3] ->
        ``inv_depths`` [P,B,H,W,1] (P = 1 with ``last_only``, else
        spec.num_predictions; the last is the final estimate) and
        ``pose_vecs`` [B,N,P,6]."""
        spec = self.spec
        b, n = refs.shape[0], refs.shape[1]
        h_img, w_img = target.shape[1], target.shape[2]
        hdim, dt = spec.hidden_dim, self.dtype

        # 1) Shared feature encoding of target + refs.
        all_imgs = torch.cat([target[:, None], refs], dim=1)
        fmaps = _nhwc(self.fnet(_nchw(all_imgs.flatten(0, 1))))
        h, w, c = fmaps.shape[1], fmaps.shape[2], fmaps.shape[3]
        if h_img // h != self.feat_ratio:
            raise ValueError(f"image {h_img}x{w_img} is not a multiple of "
                             f"{self.feat_ratio}")
        fmaps = fmaps.reshape(b, n + 1, h, w, c)
        # The warp kernel reads channel-minor contiguous maps: copy once here.
        fmap1 = fmaps[:, 0].contiguous()                           # [B,h,w,C]
        fmaps_ref = fmaps[:, 1:].contiguous()                      # [B,N,h,w,C]

        # 2) Initial pose per view, views folded into the batch.
        pair = torch.cat([fmap1[:, None].expand_as(fmaps_ref), fmaps_ref], dim=-1)
        pose_init = self.pose_head(_nchw(pair.flatten(0, 1))).reshape(b, n, 6)

        # 3) Initial depth and its upsampling mask (unless never upsampled).
        inv_depth = _nhwc(self.depth_head(_nchw(fmap1), act_fn=torch.sigmoid))
        init_upsampled = not last_only or spec.outer_iters == 0
        coarse, poses = [inv_depth], [pose_init]
        masks = [self.upmask_net(_nchw(fmap1)) if init_upsampled else None]

        # 4) Refinement.
        if spec.outer_iters > 0:
            cd = self.cnet_depth(_nchw(target)).to(dt)
            hidden_d, inp_d = torch.tanh(cd[:, :hdim]), torch.relu(cd[:, hdim:])
            pairs = torch.cat([target[:, None].expand_as(refs), refs], dim=-1)
            cp = self.cnet_pose(_nchw(pairs.flatten(0, 1))).to(dt)
            hidden_p, inp_p = torch.tanh(cp[:, :hdim]), torch.relu(cp[:, hdim:])
            K_scaled = scale_intrinsics(intrinsics.float(), 1.0 / self.feat_ratio)
            grid = pixel_grid(h, w, device=target.device)
            rays = torch.einsum("bij,hwj->bhwi", invert_intrinsics(K_scaled), grid)
            consts = {"fmap1": fmap1, "fmaps_ref": fmaps_ref, "K": K_scaled,
                      "grid": grid, "rays": rays, "inp_d": inp_d, "inp_p": inp_p}
            keep_d, keep_m, keep_p = self.refinement(
                hidden_d, hidden_p, inv_depth, pose_init, consts, last_only)
            coarse += keep_d
            masks += keep_m
            poses += keep_p
        if last_only:
            coarse, masks = coarse[-1:], masks[-1:]

        # 5) Convex upsampling + output normalization over all predictions.
        masks = torch.stack([_nhwc(m) for m in masks])             # [P,B,h,w,9r^2]
        inv_depths = self.scale_inv_depth(
            convex_upsample(torch.stack(coarse), masks, ratio=self.feat_ratio))
        return {"inv_depths": inv_depths,                          # [P,B,H,W,1]
                "pose_vecs": torch.stack(poses, dim=2)}            # [B,N,P,6]
