"""The training step and the evaluation step.

PyTorch counterpart of `make_train_step` and `make_eval_step` in
`dro_sfm_tpu/training/step.py`. The training step: forward with the random
flip, the task loss, the backward pass, the optimizer update and the
BatchNorm running-statistics update (the last made by the net's train-mode
forward). The evaluation step: the forward and the forward on the flipped
images, their flip fusion, and the depth metrics in four modes. Both run
eagerly on the device the net is on: on CUDA tensors a `DepthPoseNet`'s
warp cost is kernel K1 forward and K2, K3 backward. Both take the
`SingleFrameNet` of the single-frame tasks as well.

With several processes (one device each), the training step computes the
JAX step over the global batch, of which each process holds a shard:
train-mode BatchNorm takes the global batch's statistics, the flip is
process 0's decision, the gradients are averaged before the clip and the
update, and the returned metrics are the means over the processes.

Under a height split (`parallel/mesh.py:Layout`, ``arch.spatial_shards`` =
S > 1) each process holds one band of rows of its data shard's samples
(`parallel/spatial.py:split_rows`): both steps make the band `active`
around the forward and the backward (the image is S times the batch's
rows, the bands reaching the net's deepest stride), the training step's
gradients are summed over the spatial ranks and averaged over the data
shards, and the evaluation step gathers the predicted depth to full height
before its metrics (the ground truth comes whole). Every task runs so.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.models.sfm import (
    SfmModelConfig,
    draw_flip,
    forward,
    forward_and_loss,
    make_percep_fn,
)
from dro_sfm_torch.ops.depth_ops import inv2depth
from dro_sfm_torch.ops.image import flip_intrinsics, flip_lr
from dro_sfm_torch.parallel import spatial
from dro_sfm_torch.parallel.collectives import (
    average_gradients,
    average_metrics,
    broadcast_flag,
)
from dro_sfm_torch.parallel.mesh import current_layout, process_count
from dro_sfm_torch.training.metrics import MetricsConfig, compute_depth_metrics
from dro_sfm_torch.training.state import Optimizer, TrainState
from dro_sfm_torch.utils.depth import post_process_inv_depth
from dro_sfm_torch.utils.device import resolve_device

# What an evaluation step reads, where the batch has it.
EVAL_KEYS = ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")


def make_train_step(model_cfg: SfmModelConfig, net: torch.nn.Module,
                    optimizer: Optimizer, device=None,
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The training step on ``device`` (the card unless the caller asks for
    the CPU; ``net`` must already be there):

    ``train_step(state, batch, generator, progress=0.0, do_flip=None)`` ->
    (state one update later, metrics). ``batch`` holds the entries of
    ``model_cfg.batch_keys`` (arrays or tensors, moved to the device as
    fp32): ``rgb`` [B,H,W,3], ``rgb_context`` [B,N,H,W,3], ``intrinsics``
    [B,3,3]; with ground truth ``depth`` [B,H,W,1] and ``pose_context``
    [B,N,4,4]; with the photometric term ``rgb_original`` and
    ``rgb_context_original``. The flip is drawn from ``generator`` (a CPU
    ``torch.Generator``) unless ``do_flip`` forces it; ``progress`` (the
    fraction of training done) drives progressive scaling. ``metrics`` holds
    ``loss`` and the task's terms as detached 0-d tensors on the device
    (reading one waits for the step). The perceptual net, when the loss has
    that term, is built here (`make_percep_fn`).

    With several processes every process calls it on its equal shard of the
    global batch, with the same ``generator`` state; the flip drawn by
    process 0 holds for all. Under a height split a process's shard is its
    band of rows of its data shard's samples.
    """
    device = resolve_device(device)
    keys = model_cfg.batch_keys
    percep_fn = make_percep_fn(model_cfg, device=device)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator],
                   progress: float = 0.0, do_flip: Optional[bool] = None,
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)
                 for k in keys}
        several = process_count() > 1
        if several and do_flip is None and generator is not None \
                and model_cfg.flip_lr_prob > 0.0:
            do_flip = broadcast_flag(draw_flip(generator, model_cfg.flip_lr_prob))
        optimizer.zero_grad()
        band = spatial.band_for(current_layout(), batch["rgb"].shape[1],
                                model_cfg.deepest_stride)
        with spatial.active(band):
            loss, (_, metrics) = forward_and_loss(model_cfg, net, batch, generator,
                                                  progress=progress, do_flip=do_flip,
                                                  percep_fn=percep_fn)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if several:
            average_gradients(net.parameters())
            metrics = average_metrics(metrics)
        optimizer.step(state.step)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model_cfg: SfmModelConfig, net: torch.nn.Module,
                   metrics_cfg: MetricsConfig, demon_scaling: bool = False,
                   device=None) -> Callable[[Dict], Dict[str, Optional[torch.Tensor]]]:
    """The evaluation step on ``device`` (the card unless the caller asks
    for the CPU; ``net`` must already be there):

    ``eval_step(batch)`` -> ``metrics`` [4,B,9] (modes '', _pp, _gt, _pp_gt
    of `METRIC_MODES`; None without ``depth`` in the batch), ``inv_depth``
    and ``inv_depth_pp`` [B,H,W,1], ``depth_pp`` [B,H,W,1] and ``pose``
    [B,N,4,4]. ``batch`` holds ``rgb``, ``rgb_context``, ``intrinsics`` and,
    for the metrics, ``depth`` (and ``pose_context`` with
    ``demon_scaling``). It runs the net in eval mode under
    ``torch.inference_mode()`` and leaves it in the mode it found.
    """
    device = resolve_device(device)

    def eval_step(batch: Dict) -> Dict[str, Optional[torch.Tensor]]:
        batch = {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)
                 for k in EVAL_KEYS if k in batch}
        was_training = net.training
        band = spatial.band_for(current_layout(), batch["rgb"].shape[1],
                                model_cfg.deepest_stride)
        try:
            with torch.inference_mode(), spatial.active(band):
                return _evaluate(net, batch, metrics_cfg, demon_scaling)
        finally:
            net.train(was_training)

    return eval_step


def _evaluate(net, batch, metrics_cfg, demon_scaling):
    out = forward(net, batch, train=False, last_only=True)
    inv_depth = out["inv_depths"][-1]                          # [B,H,W,1]
    pose_vecs = out["pose_vecs"][:, :, -1]                     # [B,N,6]

    width = batch["rgb"].shape[2]
    flipped = {"rgb": flip_lr(batch["rgb"]),
               "rgb_context": flip_lr(batch["rgb_context"]),
               "intrinsics": flip_intrinsics(batch["intrinsics"], width)}
    out_f = forward(net, flipped, train=False, last_only=True)
    inv_depth_pp = post_process_inv_depth(inv_depth, out_f["inv_depths"][-1],
                                          method="mean")
    if spatial.current() is not None:       # median scaling needs the whole image
        inv_depth, inv_depth_pp = (spatial.gather_rows(t, 1) for t in (inv_depth, inv_depth_pp))
    depth = inv2depth(inv_depth)
    depth_pp = inv2depth(inv_depth_pp)

    metrics = None
    gt = batch.get("depth")
    if gt is not None:
        rows = [compute_depth_metrics(gt, depth_pp if pp else depth, metrics_cfg,
                                      use_gt_scale=gt_scale,
                                      gt_pose=batch.get("pose_context"),
                                      demon_scaling=demon_scaling, reduce=False)
                for pp, gt_scale in ((False, False), (True, False),
                                     (False, True), (True, True))]
        metrics = torch.stack(rows)                            # [4,B,9]
    return {"metrics": metrics, "inv_depth": inv_depth,
            "inv_depth_pp": inv_depth_pp, "depth_pp": depth_pp,
            "pose": Pose.from_vec(pose_vecs, "euler").mat}      # [B,N,4,4]
