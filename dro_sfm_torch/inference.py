"""Serving: checkpoint loading and the batched inference function.

PyTorch counterpart of `make_infer_fn` in `dro_sfm_tpu/inference.py` and of
`build_serving_fn` in `dro_sfm_tpu/export_serving.py`: the network runs in
eval mode with ``last_only=True`` and returns metric depth and the pose
matrices of the context views.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.ops.depth_ops import inv2depth
from dro_sfm_torch.utils.device import resolve_device

_META = ("version", "min_depth", "max_depth", "mixed_precision", "warp_impl",
         "sep_conv", "remat")


def save_model(net: DepthPoseNet, path: str) -> None:
    """Write the port's checkpoint: the state dict and what builds the net."""
    torch.save({"state_dict": net.state_dict(),
                **{k: getattr(net, k) for k in _META}}, path)


def load_model(path: str, device=None) -> DepthPoseNet:
    """Rebuild a `DepthPoseNet` from `save_model`'s file on ``device`` (the
    card unless the caller asks for the CPU). A key the file lacks (files
    written before ``warp_impl``, ``sep_conv`` and ``remat`` were saved)
    takes the `DepthPoseNet` default."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    net = DepthPoseNet(**{k: ckpt[k] for k in _META if k in ckpt}, device=device)
    net.load_state_dict(ckpt["state_dict"], strict=True)
    return net


def make_infer_fn(net: DepthPoseNet, device=None) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """The batched serving function on ``device`` (the card unless the
    caller asks for the CPU):

    (target [B,H,W,3], refs [B,N,H,W,3], K [B,3,3]) ->
    (depth [B,H,W], pose_mats [B,N,4,4]), fp32 tensors on ``device``.
    Inputs may be arrays or tensors; they are moved to ``device`` as fp32.
    """
    device = resolve_device(device)
    net = net.to(device).eval()

    def fn(target, refs, K):
        args = [torch.as_tensor(x).to(device=device, dtype=torch.float32)
                for x in (target, refs, K)]
        with torch.inference_mode():
            out = net(*args, last_only=True)
            inv_depth = out["inv_depths"][-1, ..., 0]              # [B,H,W]
            pose_vecs = out["pose_vecs"][:, :, -1]                 # [B,N,6]
            return inv2depth(inv_depth), Pose.from_vec(pose_vecs, "euler").mat

    return fn
