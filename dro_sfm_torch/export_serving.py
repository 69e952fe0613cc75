"""Serving export: freeze a network into `torch.export` programs.

The port's counterpart of `dro_sfm_tpu/export_serving.py`: the network's
weights are baked into serialized `torch.export` programs that a process
loads and calls without the model code or the config,
``load_serving_artifact(dir).call(target, refs, K)``. The signature is
`inference.make_infer_fn`'s::

    (target [B,H,W,3] f32, refs [B,N,H,W,3] f32, K [B,3,3] f32)
        -> (depth [B,H,W] f32, pose_mats [B,N,4,4] f32)

The warp-cost kernel K1 and the fused GRU pass K5 are the `torch.library`
operators ``dro_sfm::warp_diff`` and ``dro_sfm::gru_sep1d_pass``
(`ops/tent_warp.py`, `ops/gru_pass.py`): the programs hold them as nodes, and
the dispatcher runs the kernels when a program runs on the card. Loading a
program therefore needs those registrations: this module imports
``dro_sfm_torch.ops`` and nothing of the models or the config. (The JAX
artifact needs no package at all; a `torch.export` program cannot carry a
kernel that is not an aten operator.)

Platforms: one program a platform (``model.cpu.pt2``, ``model.cuda.pt2``),
each exported with the network on that device. A program fixes the device
of its weights, of the tensors it creates and of its metadata asserts to the
one it was traced on, so one program moved at load time
(`torch.export.passes.move_to_device_pass`) would rewrite a traced graph
instead of running one; a program a platform costs the weights' bytes once
more. Asking for ``"cuda"`` without a card raises; no CPU program is written
in its place.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dro_sfm_torch.geometry.pose import Pose
from dro_sfm_torch.ops import gru_pass, tent_warp  # noqa: F401  (register the operators)
from dro_sfm_torch.ops.depth_ops import inv2depth
from dro_sfm_torch.utils.device import resolve_device

ARTIFACT = "model.{platform}.pt2"
META = "meta.json"
PLATFORMS = ("cpu", "cuda")
# The largest batch of a dynamic-batch program: the card's launch grids (65535
# blocks in y and z) bound some of the net's kernels at 21845 at 192x640.
MAX_BATCH = 1024
# The operators of the port's kernels, as an exported graph names them.
KERNEL_OPS = {"K1": "dro_sfm.warp_diff.default", "K5": "dro_sfm.gru_sep1d_pass.default"}


class ServingModule(nn.Module):
    """The frozen inference function of a `DepthPoseNet` (eval mode,
    ``last_only=True``): metric depth and the context views' pose
    matrices."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, target: torch.Tensor, refs: torch.Tensor, K: torch.Tensor):
        out = self.net(target, refs, K, last_only=True)
        inv_depth = out["inv_depths"][-1, ..., 0]                  # [B,H,W]
        pose_vecs = out["pose_vecs"][:, :, -1]                     # [B,N,6]
        return inv2depth(inv_depth), Pose.from_vec(pose_vecs, "euler").mat


def build_serving_fn(net: nn.Module) -> ServingModule:
    """The serving module of ``net``, on ``net``'s device, in eval mode."""
    return ServingModule(net).eval()


def example_inputs(batch: int, views: int, image_shape: Tuple[int, int], device,
                   seed: int = 0):
    """Seeded (target, refs, K) in [0, 1) with a centred pinhole K, fp32."""
    h, w = image_shape
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    refs = rng.uniform(size=(batch, views, h, w, 3)).astype(np.float32)
    K = np.broadcast_to(np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2],
                                  [0, 0, 1.0]], np.float32), (batch, 3, 3))
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in (target, refs, K))


def export_program(net: nn.Module, batch: int, views: int,
                   image_shape: Tuple[int, int], device,
                   dynamic_batch: bool = False) -> torch.export.ExportedProgram:
    """The `torch.export` program of a copy of ``net`` on ``device``; with
    ``dynamic_batch`` its batch is the symbol ``b``, up to `MAX_BATCH`
    (traced at a batch of at least 2, which torch does not specialise)."""
    device = resolve_device(device)
    module = build_serving_fn(copy.deepcopy(net).to(device))
    args = example_inputs(max(batch, 2) if dynamic_batch else batch, views, image_shape,
                          device)
    shapes = None
    if dynamic_batch:
        b = torch.export.Dim("b", max=MAX_BATCH)
        shapes = {"target": {0: b}, "refs": {0: b}, "K": {0: b}}
    with torch.no_grad():           # inference_mode tensors cannot be traced
        return torch.export.export(module, args, dynamic_shapes=shapes, strict=False)


def kernel_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """How many nodes of each kernel operator (`KERNEL_OPS`) a program's
    graph holds."""
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {k: targets.count(op) for k, op in KERNEL_OPS.items()}


def export_serving_artifact(net: nn.Module, out_dir: str, batch: int, views: int,
                            image_shape: Tuple[int, int],
                            platforms: Sequence[str] = PLATFORMS,
                            dynamic_batch: bool = False,
                            meta_extra: Optional[dict] = None) -> Dict[str, str]:
    """Export ``net`` for (batch, views, image_shape) into ``out_dir``: a
    program for each of ``platforms`` and ``meta.json``. Returns the
    programs' paths by platform. Every platform is checked before anything
    is written: ``"cuda"`` without a card raises."""
    platforms = list(platforms)
    unknown = set(platforms) - set(PLATFORMS)
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms}: want some of {PLATFORMS}")
    for p in platforms:
        resolve_device(p)
    h, w = image_shape
    os.makedirs(out_dir, exist_ok=True)
    paths, sizes, nodes = {}, {}, {}
    for p in platforms:
        program = export_program(net, batch, views, image_shape, p, dynamic_batch)
        paths[p] = os.path.join(out_dir, ARTIFACT.format(platform=p))
        torch.export.save(program, paths[p])
        sizes[p] = os.path.getsize(paths[p])
        nodes[p] = kernel_nodes(program)
    bsig = "b" if dynamic_batch else batch
    meta = {
        "signature": {
            "target": [bsig, h, w, 3], "refs": [bsig, views, h, w, 3], "K": [bsig, 3, 3],
            "outputs": {"depth": [bsig, h, w], "pose_mats": [bsig, views, 4, 4]}},
        "platforms": platforms,
        "dynamic_batch": dynamic_batch,
        "bytes": sum(sizes.values()),
        "kernel_nodes": nodes,
    }
    meta.update(meta_extra or {})
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
    return paths


class ServingArtifact:
    """A loaded serving program on one device; ``call(target, refs, K)``
    takes arrays or tensors (moved to the device as fp32) and returns
    (depth, pose_mats) there."""

    def __init__(self, program: torch.export.ExportedProgram, device: torch.device,
                 meta: Optional[dict] = None):
        self.program, self.device, self.meta = program, device, meta or {}
        self.module = program.module()

    def call(self, target, refs, K) -> Tuple[torch.Tensor, torch.Tensor]:
        args = [torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
                for x in (target, refs, K)]
        with torch.inference_mode():
            return self.module(*args)


def load_serving_artifact(path: str, device=None) -> ServingArtifact:
    """Load the program of an exported artifact (its directory, or one
    ``.pt2`` file) for ``device`` (the card unless the caller asks for the
    CPU). Raises if the artifact has no program for that device type."""
    device = resolve_device(device)
    meta = None
    if os.path.isdir(path):
        meta_path = os.path.join(path, META)
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        path = os.path.join(path, ARTIFACT.format(platform=device.type))
        if not os.path.isfile(path):
            have = meta["platforms"] if meta else []
            raise FileNotFoundError(f"{path}: the artifact has no program for "
                                    f"{device.type} (it has {have})")
    elif not os.path.basename(path) == ARTIFACT.format(platform=device.type):
        raise ValueError(f"{path} is not the {device.type} program of an artifact "
                         f"({ARTIFACT.format(platform=device.type)})")
    return ServingArtifact(torch.export.load(path), device, meta)


def serving_roundtrip_check(net: nn.Module, artifact_dir: str, batch: int, views: int,
                            image_shape: Tuple[int, int], atol: float = 1e-4,
                            device=None) -> float:
    """Hold the artifact's program for ``device`` to the live
    `make_infer_fn` on seeded inputs: raise `RuntimeError` if depth or the
    pose matrices part by more than ``atol``; returns max |Δdepth|."""
    from dro_sfm_torch.inference import make_infer_fn
    device = resolve_device(device)
    args = example_inputs(batch, views, image_shape, device)
    live = make_infer_fn(net, device)(*args)
    frozen = load_serving_artifact(artifact_dir, device).call(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(live, frozen)]
    if not all(e <= atol for e in errs):   # not `assert`: deploy jobs may run -O
        raise RuntimeError(f"serving artifact diverges from the live model on {device}: "
                           f"max |depth delta| {errs[0]}, max |pose delta| {errs[1]}, "
                           f"atol {atol}")
    return errs[0]
