"""Rank functions of the height-split tests (`tests/test_torch_spatial_*.py`),
kept apart so that a spawned rank imports torch and the port only.

An operator case (`op_case`) is a dict of numpy arrays and names: the
module's state, the whole inputs, each input's row dimension and stride
(None: the input is whole on every rank), the output's, and a cotangent of
the whole output. `run_op` runs it on one band (or on the whole tensor with
no band) and returns the output, the inputs' gradients and the parameters'
gradients of ``sum(output * cotangent)``: a rank takes its band's rows of the
cotangent, or 1/S of it where the output is whole on every rank (each rank
holds a share of that objective, so the shares' gradients sum to the whole's)
unless the operator shares its gradient itself (``share``: a loss term
through `spatial.band_mean` or `spatial.whole_term`). A case's bands reach
stride ``deepest`` (default 16).
"""
from __future__ import annotations

import numpy as np
import torch

from tests._torch_dist import save

# name -> (cin, cout, kernel, stride, pad, bias)
CONVS = {"conv3x3": (4, 5, 3, 1, 1, True), "conv7x7s2": (3, 4, 7, 2, 3, False),
         "conv1x1s2": (4, 5, 1, 2, 0, False), "conv3x3s2": (4, 5, 3, 2, 1, False),
         "conv5x1": (4, 5, (5, 1), 1, (2, 0), True)}


def build_op(case):
    """(module or None, forward(module, inputs)) of an operator case."""
    from dro_sfm_torch.losses import photometric
    from dro_sfm_torch.models import encoder, layers, percep, single_frame, update
    from dro_sfm_torch.models.depth_pose_net import warp_cost
    from dro_sfm_torch.ops import image, ssim
    from dro_sfm_torch.ops.upsample import convex_upsample
    from dro_sfm_torch.parallel import spatial
    name, meta = case["name"], case.get("meta", {})
    module = None
    if name in CONVS:
        cin, cout, k, stride, pad, bias = CONVS[name]
        module = layers.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)
        fwd = lambda m, i: m(i["x"])                                    # noqa: E731
    elif name == "maxpool":
        fwd = lambda m, i: encoder.max_pool(i["x"])                     # noqa: E731
    elif name == "resize_x2":
        def fwd(m, i):
            band = spatial.current()
            rows = (2 * i["x"].shape[-2] if band is None
                    else band.rows(8)[1] - band.rows(8)[0])
            return encoder.upsample2(i["x"], rows)
    elif name in ("gru_split", "gru_fused"):
        module = update.SepConvGRU(meta["hdim"], meta["cx"],
                                   conv_impl="split" if name == "gru_split" else "pallas")
        fwd = lambda m, i: m(i["h"], i["x"])                            # noqa: E731
    elif name == "convex_upsample":
        fwd = lambda m, i: convex_upsample(i["depth"], i["mask"], 8)    # noqa: E731
    elif name == "pose_head":
        module = update.PoseHead(meta["cin"], meta["hidden"])
        fwd = lambda m, i: m(i["x"])                                    # noqa: E731
    elif name == "batchnorm":
        module = layers.BatchNorm2d(meta["c"]).train()
        fwd = lambda m, i: m(i["x"])                                    # noqa: E731
    elif name == "warp_cost":
        def fwd(m, i):
            return warp_cost(i["fmap1"], spatial.gather_rows(i["fmaps_ref"], 2), i["depth"],
                             i["pose"], i["K"], "pallas")
    elif name == "encoder":
        module = encoder.ResNetEncoder(meta["out"]).train()
        fwd = lambda m, i: m(i["x"])                                    # noqa: E731
    elif name == "reflect_pool":
        fwd = lambda m, i: image.avg_pool_3x3_reflect(i["x"])           # noqa: E731
    elif name == "ssim":
        fwd = lambda m, i: ssim.ssim_loss(i["x"], i["y"])               # noqa: E731
    elif name == "gradient_y":
        fwd = lambda m, i: image.gradient_y(i["x"])                     # noqa: E731
    elif name.startswith("nearest_x2"):
        fwd = lambda m, i: image.upsample_nearest2(i["x"])              # noqa: E731
    elif name == "smoothness":
        def fwd(m, i):
            return photometric.smoothness_loss(i["inv_depths"], i["image"],
                                               photometric.PhotometricLossConfig())
    elif name.startswith("photometric_"):
        cfg = photometric.PhotometricLossConfig(**meta["cfg"])
        if cfg.percep_loss_weight > 0:
            module = percep.PercepNet(resize=False, device="cpu")

        def fwd(m, i):
            loss, _ = photometric.multiview_photometric_loss(
                i["image"], i["context"], i["inv_depths"], i["K"], i["pose_vecs"], cfg,
                percep_fn=m, progress=meta["progress"])
            return loss
    elif name == "percep_share":
        module = percep.PercepNet(resize=False, device="cpu")
        fwd = lambda m, i: photometric.perceptual_term(m, i["image"], i["warps"])  # noqa: E731
    elif name == "depth_decoder":
        module = single_frame.DepthDecoder()

        def fwd(m, i):
            feats = [i[f"f{k}"] for k in range(5)]
            h, w = 2 * feats[0].shape[-2], 2 * feats[0].shape[-1]
            return torch.stack([single_frame._full_resolution(single_frame._nhwc(d), h, w)
                                for d in m(feats)[::-1]])
    elif name == "pose_resnet":
        module = single_frame.PoseResNet().train()
        fwd = lambda m, i: m(i["target"], i["refs"])                    # noqa: E731
    else:
        raise KeyError(name)
    if module is not None:
        module.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()},
                               strict=True)
    return module, fwd


def band_rows(a, where, band):
    """``a``'s rows of ``band`` (``where`` = (dim, stride)), or ``a``."""
    if band is None or where is None:
        return a
    dim, stride = where
    r0, r1 = band.rows(stride)
    index = [slice(None)] * a.ndim
    index[dim] = slice(r0, r1)
    return a[tuple(index)]


def run_op(case, band=None):
    """(output, inputs' gradients, parameters' gradients, buffers after) of
    ``case`` on ``band`` (None: the whole tensors, no band)."""
    from dro_sfm_torch.parallel import spatial
    module, fwd = build_op(case)
    inputs = {k: torch.from_numpy(np.ascontiguousarray(band_rows(v, case["rows"].get(k), band)))
              for k, v in case["inputs"].items()}
    for k, v in inputs.items():
        if k not in case.get("fixed", ()):
            v.requires_grad_()
    w = torch.from_numpy(np.ascontiguousarray(band_rows(case["w"], case["out"], band)))
    if band is not None and case["out"] is None and not case.get("share"):
        w = w / band.shards
    with spatial.active(band):
        y = fwd(module, inputs)
        (y.float() * w).sum().backward()
    params = {} if module is None else {k: p.grad.clone() for k, p in module.named_parameters()
                                        if p.grad is not None}
    buffers = {} if module is None else {k: b.clone() for k, b in module.named_buffers()}
    return (y.detach(), {k: v.grad for k, v in inputs.items() if v.grad is not None},
            params, buffers)


def ops_rank(rank, world, cases, out_dir):
    """Every operator case on this rank's band (the default group is the
    spatial group: D = 1)."""
    from dro_sfm_torch.parallel.spatial import Band
    torch.manual_seed(0)
    out = {}
    for key, case in cases.items():
        out[key] = run_op(case, Band(case["height"], world, rank,
                                     deepest=case.get("deepest", 16)))
    save(out_dir, rank, out)


# -- the step ------------------------------------------------------------------------

def band_shard(batch, layout):
    """This rank's data shard's band of the numpy ``batch`` as tensors (the
    whole batch without ``layout``)."""
    from dro_sfm_torch.parallel import spatial
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if layout is None:
        return batch
    per = batch["rgb"].shape[0] // layout.data
    lo = layout.data_index * per
    return spatial.split_rows({k: v[lo:lo + per] for k, v in batch.items()}, layout)


def split_step_rank(rank, world, job, out_dir):
    """The port's training step on this rank's data shard's band under
    ``job["spatial"]`` = S (D = world / S), rank 0 drawing the flip
    ``job["flip"]`` and the others the opposite; then, with ``job["forward"]``,
    the loss of a train-mode forward on ``job["forward"]``'s batch."""
    from dro_sfm_torch.parallel.mesh import make_layout
    from tests._torch_dist import flip_generator_for, port_step
    layout = make_layout(job["spatial"])
    shard = band_shard(job["batch"], layout)
    flip = job["flip"] if rank == 0 else not job["flip"]
    metrics, grads, after = port_step(job["tcfg"], job["state_dict"], shard,
                                      flip_generator_for(flip))
    out = {"metrics": metrics, "grads": grads, "after": after,
           "rows": shard["rgb"].shape[1]}
    if "forward" in job:
        out["forward"] = forward_loss(job["tcfg"], job["state_dict"], job["forward"], layout)
    save(out_dir, rank, out)


def tasks_rank(rank, world, job, out_dir):
    """Each case of ``job["cases"]`` on this rank's data shard's band under
    ``job["spatial"]`` = S: a training step (``"step"``, rank 0 drawing the
    flip ``case["flip"]`` and the others the opposite) or the loss and terms
    of a train-mode forward without the flip (``"forward"``)."""
    from dro_sfm_torch.parallel.mesh import make_layout
    from tests._torch_dist import flip_generator_for, port_step
    layout = make_layout(job["spatial"])
    out = {}
    for name, case in job["cases"].items():
        if case["kind"] == "forward":
            out[name] = forward_loss(case["tcfg"], case["state_dict"], case["batch"], layout)
            continue
        shard = band_shard(case["batch"], layout)
        flip = case["flip"] if rank == 0 else not case["flip"]
        metrics, grads, after = port_step(case["tcfg"], case["state_dict"], shard,
                                          flip_generator_for(flip))
        out[name] = {"metrics": metrics, "grads": grads, "after": after,
                     "rows": shard["rgb"].shape[1]}
    save(out_dir, rank, out)


def forward_loss(tcfg, state_dict, batch, layout=None):
    """The loss and its terms of a train-mode forward (no flip) on
    ``batch`` (this rank's data shard and band under ``layout``)."""
    from dro_sfm_torch.models.sfm import forward_and_loss
    from dro_sfm_torch.parallel import spatial
    net = tcfg.build_net(device="cpu")
    net.load_state_dict(state_dict, strict=True)
    batch = band_shard(batch, layout)
    band = spatial.band_for(layout, batch["rgb"].shape[1], tcfg.deepest_stride)
    with torch.no_grad(), spatial.active(band):
        loss, (_, metrics) = forward_and_loss(tcfg, net, batch, None, do_flip=False)
    return {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}


# -- the Trainer ---------------------------------------------------------------------

def split_trainer_rank(rank, world, cfg_path, overrides, out_dir):
    """`Trainer.fit` on the CPU of the config at ``cfg_path`` with
    ``overrides`` (``arch.spatial_shards`` among them); then one evaluation
    batch of one sample."""
    from pathlib import Path

    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import load_config
    cfg = load_config(str(cfg_path), {**overrides, "checkpoint": {
        "filepath": str(Path(out_dir) / f"ckpt_rank{rank}")}})
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.fit()
    batch = next(iter(trainer.val_loaders[0]))
    one = {k: v[:1] for k, v in batch.items()}
    placed = trainer._place(one)
    out = trainer.eval_step_for(False)(placed)
    save(out_dir, rank, {
        "metrics": metrics, "step": trainer.state.step,
        "saved": [p for _, p in trainer.checkpointer.saved],
        "code": (Path(trainer.checkpointer.dirpath) / "code.tar.gz").exists(),
        "state": {k: v.clone() for k, v in trainer.net.state_dict().items()},
        "placed": {k: tuple(v.shape) for k, v in placed.items()},
        "eval": {k: v for k, v in out.items() if v is not None}})
