"""Task models: the network's forward with the random flip, and the loss.

PyTorch counterpart of `dro_sfm_tpu/models/sfm.py`, for the eight task
names: the multi-frame ones run `DepthPoseNet`, the single-frame ones
`SingleFrameNet`; the loss is supervised (``Sup*``), photometric
(``SelfSup*``), a weighted sum of both (``SemiSup*``) or a zero connected to
the outputs (``SfmModel*``), each under a height split too, on row bands
(`parallel/spatial.py`: every loss term has the whole image's value and
each rank the band's share of its gradient; `SfmModelConfig.deepest_stride`
sets the bands' height rule). The random horizontal flip flips the images
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

from dro_sfm_torch.losses.photometric import (
    PhotometricLossConfig,
    multiview_photometric_loss,
)
from dro_sfm_torch.losses.supervised import (
    SupervisedLossConfig,
    supervised_depth_pose_loss,
)
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.ops.image import flip_intrinsics, flip_lr

MF_MODEL_NAMES = ("SfmModelMF", "SelfSupModelMF", "SupModelMF",
                  "SemiSupModelMFPose")
SF_MODEL_NAMES = ("SfmModel", "SelfSupModel", "SupModel", "SemiSupModelPose")
MODEL_NAMES = MF_MODEL_NAMES + SF_MODEL_NAMES
SELF_SUPERVISED = ("SelfSupModelMF", "SelfSupModel")
SEMI_SUPERVISED = ("SemiSupModelMFPose", "SemiSupModelPose")
SUPERVISED = ("SupModelMF", "SupModel")

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
    when it is "auto". ``percep_pretrained`` names a converted VGG16 file (a
    flax msgpack variables tree) for the perceptual term, which
    `make_percep_fn` loads.
    """
    name: str = "SupModelMF"
    version: str = "it12-h-out"
    min_depth: float = 0.1
    max_depth: float = 100.0
    flip_lr_prob: float = 0.5
    supervised_loss_weight: float = 0.9     # the SemiSup* names only
    progressive_scaling: float = 0.0
    photometric: PhotometricLossConfig = PhotometricLossConfig()
    mixed_precision: bool = False
    warp_impl: str = "gather"
    sep_conv: str = "split"
    remat: Any = True
    scan_unroll: str = "none"
    percep_pretrained: str = ""

    def __post_init__(self):
        if self.name not in MODEL_NAMES:
            raise ValueError(f"Unknown model {self.name}; expected one of {MODEL_NAMES}")

    @property
    def requires_gt_depth(self) -> bool:
        return self.name in SUPERVISED + SEMI_SUPERVISED

    @property
    def requires_gt_pose(self) -> bool:
        return self.requires_gt_depth

    @property
    def single_frame(self) -> bool:
        return self.name in SF_MODEL_NAMES

    @property
    def uses_photometric(self) -> bool:
        """Whether the loss has the photometric term (a SemiSup* name only
        when its supervised weight is below 1)."""
        return self.name in SELF_SUPERVISED or (
            self.name in SEMI_SUPERVISED and self.supervised_loss_weight < 1.0)

    @property
    def batch_keys(self) -> Tuple[str, ...]:
        """The batch entries a training step of this task reads."""
        keys = ("rgb", "rgb_context", "intrinsics")
        if self.requires_gt_depth:
            keys += ("depth",)
        if self.requires_gt_pose:
            keys += ("pose_context",)
        if self.uses_photometric:
            keys += ("rgb_original", "rgb_context_original")
        return keys

    @property
    def deepest_stride(self) -> int:
        """The coarsest stride of the net's maps, which a height split's
        bands must reach (`spatial.Band`): 32 for the single-frame ResNet-18
        pyramid, 16 for `DepthPoseNet`'s encoder."""
        return 32 if self.single_frame else 16

    @property
    def supervised(self) -> SupervisedLossConfig:
        # The single-frame scales are weighted uniformly, the multi-frame
        # refinement iterations with the gamma decay.
        return SupervisedLossConfig(min_depth=self.min_depth,
                                    max_depth=self.max_depth,
                                    gamma=1.0 if self.single_frame else 0.85,
                                    progressive_scaling=self.progressive_scaling)

    @property
    def photometric_cfg(self) -> PhotometricLossConfig:
        photometric = dataclasses.replace(
            self.photometric, progressive_scaling=self.progressive_scaling)
        if self.single_frame:
            return dataclasses.replace(photometric, gamma=1.0,
                                       normalize_weights=True,
                                       smooth_finest_last=True)
        return photometric

    def build_net(self, device=None, generator: torch.Generator | None = None):
        """The network on ``device`` (the card unless the caller asks for
        the CPU), weights drawn from ``generator``: `SingleFrameNet` for the
        single-frame names (fp32), else `DepthPoseNet`."""
        if self.single_frame:
            from dro_sfm_torch.models.single_frame import SingleFrameNet
            return SingleFrameNet(min_depth=self.min_depth, max_depth=self.max_depth,
                                  device=device, generator=generator)
        return DepthPoseNet(
            version=self.version, min_depth=self.min_depth,
            max_depth=self.max_depth, mixed_precision=self.mixed_precision,
            warp_impl=self.warp_impl, sep_conv=self.sep_conv, remat=self.remat,
            unroll=self.scan_unroll, device=device, generator=generator)


def draw_flip(generator: torch.Generator, flip_lr_prob: float) -> bool:
    """One flip decision: a uniform draw from ``generator`` below
    ``flip_lr_prob``."""
    return bool(torch.rand((), generator=generator) < flip_lr_prob)


def forward(net: torch.nn.Module, batch: Dict[str, torch.Tensor],
            train: bool = False, generator: Optional[torch.Generator] = None,
            flip_lr_prob: float = 0.0, last_only: bool = False,
            do_flip: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Run the network (`DepthPoseNet` or `SingleFrameNet`) on a batch:
    ``rgb`` [B,H,W,3], ``rgb_context`` [B,N,H,W,3], ``intrinsics`` [B,3,3]
    -> ``inv_depths`` [P,B,H,W,1] and ``pose_vecs`` [B,N,P,6].

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
            do_flip = draw_flip(generator, flip_lr_prob)
        flip = bool(do_flip)
    if flip:
        width = target.shape[2]
        target, refs, K = flip_lr(target), flip_lr(refs), flip_intrinsics(K, width)
    out = net(target, refs, K, last_only=last_only)
    inv_depths = flip_lr(out["inv_depths"]) if flip else out["inv_depths"]
    return {"inv_depths": inv_depths, "pose_vecs": out["pose_vecs"]}


def compute_loss(cfg: SfmModelConfig, output: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor], progress=0.0, percep_fn=None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The task loss of ``cfg.name``: the photometric term on the
    un-jittered ``rgb_original`` [B,H,W,3] and ``rgb_context_original``
    [B,N,H,W,3]; the supervised term against ``depth`` [B,H,W,1] and
    ``pose_context`` [B,N,4,4]; for the SemiSup* names ``(1 - w)``
    photometric (only when ``w < 1``) plus ``w`` supervised, ``w`` being
    ``supervised_loss_weight``. ``SfmModel*`` give a zero that depends on
    the outputs, so that its backward gives zero gradients."""
    inv_depths = output["inv_depths"]
    pose_vecs = output["pose_vecs"]
    K = batch["intrinsics"]

    def photometric():
        return multiview_photometric_loss(
            batch["rgb_original"], batch["rgb_context_original"], inv_depths, K,
            pose_vecs, cfg.photometric_cfg, percep_fn=percep_fn, progress=progress)

    def supervised():
        return supervised_depth_pose_loss(
            inv_depths, batch["depth"], pose_vecs, batch["pose_context"], K,
            cfg.supervised, progress=progress)

    if cfg.name in SELF_SUPERVISED:
        return photometric()
    if cfg.name in SUPERVISED:
        return supervised()
    if cfg.name in SEMI_SUPERVISED:
        w = cfg.supervised_loss_weight
        loss, metrics = 0.0, {}
        if w < 1.0:
            self_loss, metrics = photometric()
            loss = (1.0 - w) * self_loss
        sup_loss, sup_metrics = supervised()
        return loss + w * sup_loss, {**metrics, **sup_metrics}
    return _connected_zero(inv_depths, pose_vecs), {}


def _connected_zero(*tensors: torch.Tensor) -> torch.Tensor:
    """A zero that depends on ``tensors``, so that its backward gives zero
    gradients; zero whatever they hold (an inf or a NaN times 0 is NaN, so
    those elements are replaced before the product)."""
    return sum((torch.where(torch.isfinite(t), t, 0.0) * 0.0).sum() for t in tensors)


def forward_and_loss(cfg: SfmModelConfig, net: torch.nn.Module,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator], progress=0.0,
                     do_flip: Optional[bool] = None, percep_fn=None,
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
    """Training closure: the train-mode forward with the random flip, then
    the loss. Returns (loss, (output, metrics))."""
    output = forward(net, batch, train=True, generator=generator,
                     flip_lr_prob=cfg.flip_lr_prob, do_flip=do_flip)
    loss, metrics = compute_loss(cfg, output, batch, progress=progress,
                                 percep_fn=percep_fn)
    return loss, (output, metrics)


def make_percep_fn(cfg: SfmModelConfig, device=None):
    """The frozen perceptual distance ``fn(im1, im2)`` on ``device`` (the
    card unless the caller asks for the CPU), or None when the loss has no
    perceptual term. Its VGG16 slices are the converted weights of
    ``cfg.percep_pretrained`` (a flax msgpack variables tree, loaded
    strictly), else drawn from seed 0."""
    if cfg.photometric_cfg.percep_loss_weight <= 0.0 or not cfg.uses_photometric:
        return None
    from dro_sfm_torch.models.percep import PercepNet
    from dro_sfm_torch.utils.device import resolve_device
    net = PercepNet(device=resolve_device(device),
                    generator=torch.Generator().manual_seed(0))
    if cfg.percep_pretrained:
        from dro_sfm_torch.convert import from_jax_variables
        from dro_sfm_torch.training.init_weights import load_msgpack_tree
        net.load_state_dict(from_jax_variables(load_msgpack_tree(cfg.percep_pretrained)),
                            strict=True)
    return net
