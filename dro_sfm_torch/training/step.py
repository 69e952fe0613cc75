"""The training step.

PyTorch counterpart of `make_train_step` in `dro_sfm_tpu/training/step.py`:
forward with the random flip, the task loss, the backward pass, the
optimizer update and the BatchNorm running-statistics update (the last made
by the net's train-mode forward). It runs eagerly on the device the net is
on: on CUDA tensors the refinement's warp cost is kernel K1 forward and K2,
K3 backward.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.models.sfm import SfmModelConfig, forward_and_loss
from dro_sfm_torch.training.state import Optimizer, TrainState
from dro_sfm_torch.utils.device import resolve_device

BATCH_KEYS = ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")


def make_train_step(model_cfg: SfmModelConfig, net: DepthPoseNet,
                    optimizer: Optimizer, device=None,
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The training step on ``device`` (the card unless the caller asks for
    the CPU; ``net`` must already be there):

    ``train_step(state, batch, generator, progress=0.0, do_flip=None)`` ->
    (state one update later, metrics). ``batch`` holds ``rgb``
    [B,H,W,3], ``rgb_context`` [B,N,H,W,3], ``intrinsics`` [B,3,3],
    ``depth`` [B,H,W,1] and ``pose_context`` [B,N,4,4] (arrays or tensors,
    moved to the device as fp32). The flip is drawn from ``generator`` (a
    CPU ``torch.Generator``) unless ``do_flip`` forces it. ``metrics`` holds
    ``loss``, ``depth_loss``, ``pose_loss`` and ``all_loss`` as detached
    0-d tensors on the device (reading one waits for the step).
    """
    device = resolve_device(device)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator],
                   progress: float = 0.0, do_flip: Optional[bool] = None,
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)
                 for k in BATCH_KEYS}
        optimizer.zero_grad()
        loss, (_, metrics) = forward_and_loss(model_cfg, net, batch, generator,
                                              progress=progress, do_flip=do_flip)
        loss.backward()
        optimizer.step(state.step)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return train_step
