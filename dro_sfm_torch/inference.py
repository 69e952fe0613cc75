"""Serving: checkpoint loading, the batched inference function, and the
applications behind the inference CLIs.

PyTorch counterpart of `dro_sfm_tpu/inference.py`: the network runs in eval
mode with ``last_only=True`` (`export_serving.build_serving_fn`) and returns
metric depth and the pose matrices of the context views. `load_model` reads
the port's serving file, the port's training checkpoints and the JAX
package's (flax msgpack), and serves the latter two as the JAX `load_model`
does: fp32, the net of the sidecar config's ``version``, ``min_depth or
0.1`` and ``max_depth``.

The applications: multi-view geometric-consistency fusion of depth maps
(`reproject_with_depth`, `check_geometric_consistency`, `geometric_fusion`;
torch on the depth maps' device, batched over the source views where the
JAX package maps over them), the depth filter and the trajectory's
monocular scale chaining (numpy, as in the JAX package).
"""
from __future__ import annotations

import json
import zipfile
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dro_sfm_torch.export_serving import build_serving_fn
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.utils.device import resolve_device

_META = ("version", "min_depth", "max_depth", "mixed_precision", "warp_impl",
         "sep_conv", "remat")


def save_model(net: DepthPoseNet, path: str) -> None:
    """Write the port's checkpoint: the state dict and what builds the net."""
    torch.save({"state_dict": net.state_dict(),
                **{k: getattr(net, k) for k in _META}}, path)


def load_model(path: str, device=None) -> DepthPoseNet:
    """The `DepthPoseNet` of a checkpoint on ``device`` (the card unless the
    caller asks for the CPU); see `load_model_and_config`."""
    return load_model_and_config(path, device)[0]


def load_model_and_config(path: str, device=None):
    """(net, config) from a file on ``device`` (the card unless the caller
    asks for the CPU), loaded strictly:

    * `save_model`'s file: the net it describes (a key the file lacks, from
      files written before ``warp_impl``, ``sep_conv`` and ``remat`` were
      saved, takes the `DepthPoseNet` default); no config (None);
    * a training checkpoint of the port or of the JAX package, with its
      ``<path>.json`` sidecar: the net of the sidecar's config as the JAX
      `load_model` builds it (``version``, ``min_depth or 0.1``,
      ``max_depth``, fp32), with the port's serving defaults
      (``warp_impl="pallas"``: kernel K1; ``sep_conv="split"``), and the
      config (`prepare_config`)."""
    from dro_sfm_torch.convert import from_jax_variables
    from dro_sfm_torch.training.checkpoint import load_checkpoint
    from dro_sfm_torch.utils.config import ConfigNode, prepare_config
    device = resolve_device(device)
    if zipfile.is_zipfile(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            net = DepthPoseNet(**{k: ckpt[k] for k in _META if k in ckpt}, device=device)
            net.load_state_dict(ckpt["state_dict"], strict=True)
            return net, None
    restored = load_checkpoint(path)
    payload = restored["payload"]
    state_dict = (payload["net"] if "net" in payload else from_jax_variables(
        {"params": payload["params"], "batch_stats": payload.get("batch_stats", {})}))
    if "config" not in restored["meta"]:
        raise ValueError(f"{path}: serving a training checkpoint needs the config in "
                         f"its sidecar {path}.json, which has none")
    cfg = prepare_config(ConfigNode(restored["meta"]["config"]))
    net = DepthPoseNet(version=cfg.model.depth_net.version,
                       min_depth=cfg.model.params.min_depth or 0.1,
                       max_depth=cfg.model.params.max_depth, device=device)
    net.load_state_dict(state_dict, strict=True)
    return net, cfg


def make_infer_fn(net: DepthPoseNet, device=None) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """The batched serving function on ``device`` (the card unless the
    caller asks for the CPU):

    (target [B,H,W,3], refs [B,N,H,W,3], K [B,3,3]) ->
    (depth [B,H,W], pose_mats [B,N,4,4]), fp32 tensors on ``device``.
    Inputs may be arrays or tensors; they are moved to ``device`` as fp32.
    """
    device = resolve_device(device)
    serve = build_serving_fn(net.to(device))

    def fn(target, refs, K):
        args = [torch.as_tensor(x).to(device=device, dtype=torch.float32)
                for x in (target, refs, K)]
        with torch.inference_mode():
            return serve(*args)

    return fn


# -- geometric-consistency fusion ----------------------------------------------

def _unproject(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """depth [..., H, W] -> camera-frame points [..., H, W, 3]."""
    h, w = depth.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return (pix @ K_inv.T) * depth[..., None]


def _transform(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """points [V,H,W,3] by T [V,4,4]."""
    return points @ T[:, None, :3, :3].transpose(-1, -2) + T[:, None, None, :3, 3]


def reproject_with_depth(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                         T_ref: torch.Tensor, T_src: torch.Tensor, K: torch.Tensor):
    """Project the reference depth [H,W] into V source views and back.

    ``depth_src`` [V,H,W], ``T_src`` [V,4,4] and ``T_ref`` [4,4] are
    camera-to-world poses; the source depth is sampled nearest (round half
    to even, as ``jnp.round``) with zeros outside. Returns (depth
    reprojected, x, y), each [V,H,W]."""
    v, h, w = depth_src.shape
    K_inv = torch.linalg.inv(K)
    xyz_ref = _unproject(depth_ref, K_inv)[None]                       # [1,H,W,3]
    rel = torch.linalg.inv(T_src) @ T_ref                              # ref -> src
    proj = _transform(xyz_ref, rel) @ K.T
    z = torch.clamp_min(proj[..., 2], 1e-10)
    x_src, y_src = proj[..., 0] / z, proj[..., 1] / z
    xr, yr = torch.round(x_src), torch.round(y_src)
    valid = (xr >= 0) & (xr <= w - 1) & (yr >= 0) & (yr <= h - 1)
    xi = xr.clamp(0, w - 1).long()
    yi = yr.clamp(0, h - 1).long()
    views = torch.arange(v, device=depth_src.device)[:, None, None]
    sampled = torch.where(valid, depth_src[views, yi, xi], 0.0)
    pix_src = torch.stack([x_src, y_src, torch.ones_like(x_src)], dim=-1)
    xyz_src = (pix_src @ K_inv.T) * sampled[..., None]
    xyz_back = _transform(xyz_src, torch.linalg.inv(T_ref) @ T_src)
    depth_reproj = xyz_back[..., 2] * (sampled > 0)
    proj_back = xyz_back @ K.T
    zb = torch.clamp_min(proj_back[..., 2], 1e-10)
    return depth_reproj, proj_back[..., 0] / zb, proj_back[..., 1] / zb


def check_geometric_consistency(depth_ref, depth_src, T_ref, T_src, K,
                                thres_p_dist: float = 1.0, thres_d_diff: float = 0.001):
    """The pixel-distance and relative-depth-difference check against V
    source views: (mask [V,H,W], the reprojected depth where it holds)."""
    h, w = depth_ref.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth_ref.dtype, device=depth_ref.device),
                            torch.arange(w, dtype=depth_ref.dtype, device=depth_ref.device),
                            indexing="ij")
    depth_reproj, x2d, y2d = reproject_with_depth(depth_ref, depth_src, T_ref, T_src, K)
    dist = torch.sqrt((x2d - xs) ** 2 + (y2d - ys) ** 2)
    rel_diff = torch.abs(depth_reproj - depth_ref) / torch.clamp_min(depth_ref, 1e-10)
    mask = (dist < thres_p_dist) & (rel_diff < thres_d_diff)
    return mask, torch.where(mask, depth_reproj, 0.0)


def geometric_fusion(depth_ref: torch.Tensor, depth_srcs: torch.Tensor,
                     T_ref: torch.Tensor, T_srcs: torch.Tensor, K: torch.Tensor,
                     thres_view: int = 2) -> torch.Tensor:
    """Fuse a reference depth [H,W] with V source views (depth_srcs [V,H,W],
    T_srcs [V,4,4], camera-to-world), on their device: pixels consistent in
    fewer than ``thres_view`` views become 0, the rest average the reference
    and the consistent reprojections."""
    masks, reprojs = check_geometric_consistency(depth_ref, depth_srcs, T_ref, T_srcs, K)
    mask_sum = masks.to(depth_ref.dtype).sum(dim=0)
    keep = (mask_sum - thres_view) >= 0
    return (reprojs.sum(dim=0) + depth_ref) / (mask_sum + 1.0) * keep


# -- depth filtering and pose chaining (numpy) ----------------------------------

def filter_depth(depth: np.ndarray, grad_max: float = 0.05, depth_max: float = 10.0,
                 crop_h: int = 0, crop_w: int = 0) -> np.ndarray:
    """Zero out high-gradient, far and border pixels before fusion/export."""
    depth = depth.copy()
    pad = np.pad(depth, [(0, 1), (0, 1)], "constant")
    grad = ((pad[1:, :-1] - pad[:-1, :-1]) ** 2
            + (pad[:-1, 1:] - pad[:-1, :-1]) ** 2)
    depth[grad > grad_max] = 0
    depth[depth > depth_max] = 0
    if crop_h > 0 and crop_w > 0:
        depth[:crop_h, :crop_w] = 0
        depth[-crop_h:, -crop_w:] = 0
    return depth


class TrajectoryAccumulator:
    """Chain per-window relative poses into a global trajectory with
    monocular scale propagation.

    Feed (pose21, pose23) per window: pose21 = T_{prev<-cur}, pose23 =
    T_{next<-cur}. The translation of pose21 is rescaled so that its norm
    matches the previous window's pose23 (the same motion seen from the
    other side), which keeps the scale consistent along the video."""

    def __init__(self):
        self.global_pose: Optional[np.ndarray] = None
        self.pose23_prev: Optional[np.ndarray] = None
        self.trajectory: List[np.ndarray] = []

    def add(self, pose21: np.ndarray, pose23: np.ndarray) -> np.ndarray:
        pose21 = pose21.copy()
        if self.pose23_prev is not None:
            t_prev = np.linalg.norm(self.pose23_prev[:3, 3])
            t_cur = np.linalg.norm(pose21[:3, 3])
            if t_cur > 1e-12:
                pose21[:3, 3] *= t_prev / t_cur
        self.pose23_prev = pose23
        if self.global_pose is None:
            self.global_pose = pose21
        else:
            self.global_pose = self.global_pose @ pose21
        self.trajectory.append(self.global_pose.copy())
        return self.global_pose

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([p.tolist() for p in self.trajectory], f)
