"""Task models: the DepthPoseNet forward with the random flip, and the loss.

PyTorch counterpart of `dro_sfm_tpu/models/sfm.py` for the multi-frame
supervised task (`SupModelMF`). The random horizontal flip flips the images
and the intrinsics (fx -> -fx, cx -> W - cx), which re-parameterises the
pixels without changing the 3D geometry, so the predicted poses stay valid
and only the depth maps are flipped back. The decision is one draw from an
explicit ``torch.Generator`` (the JAX package draws from its PRNG key), or
``do_flip`` forces it; the branch is a Python ``if``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from dro_sfm_torch.losses.supervised import (
    SupervisedLossConfig,
    supervised_depth_pose_loss,
)
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.ops.image import flip_intrinsics, flip_lr

MF_MODEL_NAMES = ("SfmModelMF", "SelfSupModelMF", "SupModelMF",
                  "SemiSupModelMFPose")
SF_MODEL_NAMES = ("SfmModel", "SelfSupModel", "SupModel", "SemiSupModelPose")
PORTED_MODEL_NAMES = ("SupModelMF",)

# Above this many batch-pixels ``remat="auto"`` recomputes the refinement
# steps in the backward; below it every activation is kept. The JAX
# package's threshold, kept so that both resolve an operating point alike.
REMAT_AUTO_BATCH_PIXELS = 2_500_000


def resolve_memory_policy(remat, scan_unroll, batch_size: int,
                          image_shape) -> Tuple[Any, str]:
    """Resolve the "auto" knobs for an operating point.

    ``remat``: True / False / "steps" / "save_named" pass through; "auto"
    (or None) turns step remat on above `REMAT_AUTO_BATCH_PIXELS`
    batch-pixels. ``scan_unroll``: "auto" (or None) becomes "full". Returns
    (remat, scan_unroll).
    """
    batch_pixels = int(batch_size) * int(image_shape[0]) * int(image_shape[1])
    if remat in ("auto", None):
        remat = batch_pixels > REMAT_AUTO_BATCH_PIXELS
    if scan_unroll in ("auto", None):
        scan_unroll = "full"
    if not isinstance(remat, str):
        remat = bool(remat)
    return remat, str(scan_unroll)


@dataclasses.dataclass(frozen=True)
class SfmModelConfig:
    """Task-model configuration with the JAX package's field names.

    ``remat`` must be resolved (`resolve_memory_policy`) before `build_net`
    when it is "auto". Only ``SupModelMF`` is ported; the other multi-frame
    names need the photometric loss and the single-frame names their own
    networks, and raise ``NotImplementedError``.
    """
    name: str = "SupModelMF"
    version: str = "it12-h-out"
    min_depth: float = 0.1
    max_depth: float = 100.0
    flip_lr_prob: float = 0.5
    progressive_scaling: float = 0.0
    mixed_precision: bool = False
    warp_impl: str = "gather"
    sep_conv: str = "split"
    remat: Any = True
    scan_unroll: str = "none"

    def __post_init__(self):
        if self.name in MF_MODEL_NAMES + SF_MODEL_NAMES:
            if self.name not in PORTED_MODEL_NAMES:
                item = "6 (self-supervised path)" if self.name in MF_MODEL_NAMES \
                    else "7 (single-frame models)"
                raise NotImplementedError(
                    f"{self.name} is not ported yet: ROADMAP.md queue A item {item}")
        else:
            raise ValueError(f"Unknown model {self.name}; expected one of "
                             f"{MF_MODEL_NAMES + SF_MODEL_NAMES}")

    @property
    def supervised(self) -> SupervisedLossConfig:
        return SupervisedLossConfig(min_depth=self.min_depth,
                                    max_depth=self.max_depth, gamma=0.85,
                                    progressive_scaling=self.progressive_scaling)

    def build_net(self, device=None,
                  generator: torch.Generator | None = None) -> DepthPoseNet:
        """The network on ``device`` (the card unless the caller asks for
        the CPU), weights drawn from ``generator``."""
        return DepthPoseNet(
            version=self.version, min_depth=self.min_depth,
            max_depth=self.max_depth, mixed_precision=self.mixed_precision,
            warp_impl=self.warp_impl, sep_conv=self.sep_conv, remat=self.remat,
            unroll=self.scan_unroll, device=device, generator=generator)


def forward(net: DepthPoseNet, batch: Dict[str, torch.Tensor],
            train: bool = False, generator: Optional[torch.Generator] = None,
            flip_lr_prob: float = 0.0, last_only: bool = False,
            do_flip: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Run the network on a batch: ``rgb`` [B,H,W,3], ``rgb_context``
    [B,N,H,W,3], ``intrinsics`` [B,3,3] -> ``inv_depths`` [P,B,H,W,1] and
    ``pose_vecs`` [B,N,P,6].

    ``train`` puts the net in train mode (BatchNorm on batch statistics,
    running statistics updated in place) and flips the inputs with
    probability ``flip_lr_prob``: the decision is ``do_flip`` when given,
    else one uniform draw from ``generator`` (no flip without either).
    """
    net.train(train)
    target, refs, K = batch["rgb"], batch["rgb_context"], batch["intrinsics"]
    flip = False
    if train and flip_lr_prob > 0.0:
        if do_flip is None and generator is not None:
            do_flip = bool(torch.rand((), generator=generator) < flip_lr_prob)
        flip = bool(do_flip)
    if flip:
        width = target.shape[2]
        target, refs, K = flip_lr(target), flip_lr(refs), flip_intrinsics(K, width)
    out = net(target, refs, K, last_only=last_only)
    inv_depths = flip_lr(out["inv_depths"]) if flip else out["inv_depths"]
    return {"inv_depths": inv_depths, "pose_vecs": out["pose_vecs"]}


def compute_loss(cfg: SfmModelConfig, output: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor], progress=0.0,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The task loss: for ``SupModelMF`` the supervised depth + pose loss
    against ``depth`` [B,H,W,1] and ``pose_context`` [B,N,4,4]."""
    return supervised_depth_pose_loss(
        output["inv_depths"], batch["depth"], output["pose_vecs"],
        batch["pose_context"], batch["intrinsics"], cfg.supervised,
        progress=progress)


def forward_and_loss(cfg: SfmModelConfig, net: DepthPoseNet,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator], progress=0.0,
                     do_flip: Optional[bool] = None,
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
    """Training closure: the train-mode forward with the random flip, then
    the loss. Returns (loss, (output, metrics))."""
    output = forward(net, batch, train=True, generator=generator,
                     flip_lr_prob=cfg.flip_lr_prob, do_flip=do_flip)
    loss, metrics = compute_loss(cfg, output, batch, progress=progress)
    return loss, (output, metrics)
