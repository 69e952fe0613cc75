"""Every task with image heights split over spawned gloo ranks (CPU): the
training step against JAX's ``forward_and_loss`` on the whole batch and
against the port in one process, and the `Trainer` against one process.

The steps, at ``it4-h-out``, 64x96, N=2, on the smooth images, the
un-jittered originals and the scaled heads of
`tests/test_torch_selfsup_step.py`, the flip on, rank 0 drawing it and the
others the opposite decision:
- ``SelfSupModelMF`` on D=2 x S=2 (``sep_conv="split"``, its B=2 batches of
  seeds 0 and 1 the global batch of 4), with the ``mean`` over views and no
  automask, as `tests/test_torch_selfsup_step.py` holds the step (the
  ``min``'s near-ties turn rounding into gradient jumps);
- on D=1 x S=2 and the B=2 batch of seed 0: ``SelfSupModelMF`` with
  ``sep_conv="pallas"`` (the fused GRU pass's plain versions on the band
  widened by 4 rows), ``SemiSupModelMFPose`` (supervised weight 0.9),
  ``SelfSupModelMF`` with ``percep_loss_weight`` 0.1 (the VGG16 net, seeded
  weights that both packages read from one msgpack file, whole on every rank
  on the gathered target and final warp), and the single-frame
  ``SelfSupModel`` and ``SupModel`` (the ResNets' bands down to stride 32:
  64 rows over 2 hold 1 row each at stride 32), the same loss; and the
  config default, the ``min`` with the automask, with ``clip_loss`` 0.5
  (the clamp's statistics summed over both ranks): the loss and its terms
  of a train-mode forward without the flip.
Bars: the loss and its terms against JAX's ``forward_and_loss`` on the whole
batch 1e-4 relative (`tests/test_torch_spatial_step.py`); each step against
the port in one process on the whole batch at `tests/test_torch_dist_train.py`'s
bars (the loss and its terms 1e-5 relative, BatchNorm statistics 1e-5, each
gradient leaf within relative L2 1e-2, the parameters after Adam within 0.05
lr, and within 2 lr where the gradient lies within the leaf's bar of zero),
except that a leaf's bar is the larger of 1e-2 and twice fp32's own reach
on it, asked for only when a leaf passes 1e-2 (a split step as close to the
exact gradient as one process's lies within twice that of it). The reach:
for `DepthPoseNet` the one-process step on the same samples in another
order (1, 0, 3, 2), which moves the train-mode context encoders of the
D=2 x S=2 self-supervised step by up to 1.48e-2
(``cnet_depth.layer3_block1.bn1.bias``; the split step lies 1.49e-2 from one
process there), above the 1e-2 that the supervised step keeps; for the
single-frame nets the same step in fp64, from which one process's fp32
``SelfSupModel`` step lies up to 4.04e-2 on its train-mode depth encoder's
leaves (the split 3.38e-2 from one process there). These numbers:
``python -m tests._torch_spatial_reach step SelfSupModelMF --world 4`` and
``step SelfSupModel``. The forward's loss against one process 1e-5; every
rank holds the same metrics, gradients and state, bit for bit.

The `Trainer`s: ``configs/train_synthetic_selfsup.yaml`` (``SelfSupModelMF``,
the ``min`` with the automask) cut to ``it4-h-out`` at 32x48 (16 rows a
rank, the bands' least at stride 16), and
``configs/overfit_synthetic_single_frame.yaml`` (``SupModel``) at 64x64 (32
rows a rank, one at stride 32, the least for S = 2): one epoch of 2 steps
of 2 samples, validated on 3 samples (the second batch padded), as
`tests/test_torch_spatial_trainer.py` runs ``SupModelMF``. The ranks'
validation metrics equal those of a one-process `Trainer` that resumes the
split run's checkpoint, at that file's bars (the pose metrics 1e-5
relative, the depth metrics 2e-3 relative, a1-a3 1e-3 absolute: the bands
sum in another order, which the refinement amplifies); the resumed net
equals the ranks' bit for bit, and an evaluation batch of one sample is
split by height, its depth gathered whole.
"""
import dataclasses
import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models.layers import Conv2d
from dro_sfm_torch.models.sfm import forward_and_loss
from dro_sfm_torch.training.metrics import POSE_METRIC_NAMES
from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config
from tests._torch_dist import flip_generator_for, load, port_step, run_ranks
from tests._torch_spatial import forward_loss, split_trainer_rank, tasks_rank
from tests.test_torch_dist_train import assert_metrics_close, assert_stats_close, global_batch
from tests.test_torch_init_weights import write_msgpack
from tests.test_torch_modules import fill_variables
from tests.test_torch_selfsup_step import SMOOTH_LOSS, task_batch, task_setup
from tests.test_torch_spatial_trainer import split_overrides
from tests.test_torch_train_step import LR, key_with_flip

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
VERSION = "it4-h-out"
DEFAULT_CLIP = {"clip_loss": 0.5}
RECIPES = {"selfsup": ("train_synthetic_selfsup.yaml", (32, 48), "SelfSupModelMF"),
           "single_frame": ("overfit_synthetic_single_frame.yaml", (64, 64), "SupModel")}


def jax_loss(jcfg, jnet, variables, batch, flip, percep_fn=None):
    """JAX's loss and terms of the train-mode forward on the whole batch."""
    key = key_with_flip(flip)
    loss, (_, metrics, _) = jax.jit(lambda v, bt: jsfm.forward_and_loss(
        jcfg, jnet, v, bt, key, percep_fn=percep_fn))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}


def setup_case(name, loss, **overrides):
    """(JAX config, net, variables, the port's config) of task ``name``."""
    _, jcfg, jnet, variables, tcfg = task_setup(name, loss, version=VERSION, **overrides)
    return jcfg, jnet, variables, tcfg


def percep_files(tmp_path):
    """A seeded VGG16 tree in a msgpack file, and JAX's net on it."""
    jnet = JaxPercepNet()
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    pvars = fill_variables(lambda k: jnet.init(k, dummy, dummy), seed=5)
    path = write_msgpack(tmp_path / "vgg16.msgpack", serialization.to_state_dict(pvars))
    return path, (lambda a, b: jnet.apply(pvars, a, b))


def leaf_reach(tcfg, sd, batch, single):
    """Each gradient leaf's relative L2 between ``single`` (the one-process
    fp32 step on ``batch``) and a yardstick of fp32's own reach: for the
    single-frame nets the same forward and backward in fp64; for
    `DepthPoseNet`, which casts to its compute dtype inside, the one-process
    step on the samples in the order 1, 0, 3, 2 (1, 0 of two)."""
    if tcfg.single_frame:
        net = tcfg.build_net(device="cpu")
        net.load_state_dict(sd, strict=True)
        net.double()
        for m in net.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = torch.float64
        loss, _ = forward_and_loss(tcfg, net, {k: torch.from_numpy(v).double()
                                               for k, v in batch.items()},
                                   flip_generator_for(True))
        loss.backward()
        grads = {k: p.grad for k, p in net.named_parameters()}
    else:
        order = [i ^ 1 for i in range(batch["rgb"].shape[0])]
        _, grads, _ = port_step(tcfg, sd, {k: torch.from_numpy(v[order])
                                           for k, v in batch.items()}, flip_generator_for(True))
    return {k: ((grads[k].double() - g.double()).norm() / g.double().norm()).item()
            for k, g in single[1].items() if g.norm() > 0}


def assert_step_within_reach(got, single, reach):
    """A split step against one process (module docstring); ``reach()``
    gives each leaf's order-of-sums reach, asked for only when a leaf lies
    beyond 1e-2."""
    metrics, grads, after = single
    assert_metrics_close(got["metrics"], metrics, 1e-5)
    beyond = any((got["grads"][k].double() - g.double()).norm() > 1e-2 * g.double().norm()
                 for k, g in grads.items())
    reach = reach() if beyond else {}
    bars = {k: max(1e-2, 2.0 * reach.get(k, 0.0)) for k in grads}
    for k, g in grads.items():
        g, x = g.double(), got["grads"][k].double()
        err = (x - g).norm().item()
        assert err <= bars[k] * g.norm().item(), (k, err / g.norm().item(), bars[k])
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got["after"][k], v)
        elif k not in grads:
            assert_stats_close(got["after"], {k: v.numpy()}, 1e-5)
        else:
            err = (got["after"][k] - v).abs()
            assert err.max() <= 2.0 * LR + 1e-6, k
            sign_may_flip = grads[k].abs() <= bars[k] * grads[k].norm()
            assert torch.all((err <= 0.05 * LR) | sign_may_flip), k


def check_ranks(ranks, name):
    """One global step (or forward) on every rank: the same bits."""
    first = ranks[0][name]
    for other in ranks[1:]:
        got = other[name]
        if "grads" not in first:
            assert got == first
            continue
        assert got["metrics"] == first["metrics"]
        for part in ("grads", "after"):
            assert all(torch.equal(got[part][k], v) for k, v in first[part].items())
    return first


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """D=2 x S=2: ``SelfSupModelMF``, ``sep_conv="split"``."""
    batch = global_batch(task_batch)
    jcfg, jnet, variables, tcfg = setup_case("SelfSupModelMF", SMOOTH_LOSS)
    sd = from_jax_variables(variables)
    job = {"spatial": 2, "cases": {"selfsup_split": {
        "kind": "step", "tcfg": tcfg, "state_dict": sd, "batch": batch, "flip": True}}}
    out = tmp_path_factory.mktemp("tasks_dxs")
    run_ranks(tasks_rank, 4, out, job, str(out))
    ranks = load(out, 4)
    shutil.rmtree(out)                  # the ranks' gradients and states: hundreds of MB
    single = port_step(tcfg, sd, {k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_generator_for(True))
    return (check_ranks(ranks, "selfsup_split"), single,
            functools.partial(leaf_reach, tcfg, sd, batch, single),
            jax_loss(jcfg, jnet, variables, batch, flip=True))


# name -> (task, loss settings, config overrides): the D=1 x S=2 steps, on the
# B=2 batch of seed 0
STEPS = {
    "selfsup_pallas": ("SelfSupModelMF", SMOOTH_LOSS, {"sep_conv": "pallas"}),
    "semisup": ("SemiSupModelMFPose", SMOOTH_LOSS, {}),
    "percep": ("SelfSupModelMF", {**SMOOTH_LOSS, "percep_loss_weight": 0.1}, {}),
    "selfsup_single_frame": ("SelfSupModel", SMOOTH_LOSS, {}),
    "sup_single_frame": ("SupModel", SMOOTH_LOSS, {}),
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """D=1 x S=2: the steps of `STEPS` and the default loss's forward with
    the clamp. Each case's (rank 0's result, one process's, the reach,
    JAX's loss and terms)."""
    tmp = tmp_path_factory.mktemp("tasks_s2")
    path, jpercep = percep_files(tmp)
    batch = task_batch(0)
    cases, refs = {}, {}
    for name, (task, loss, over) in STEPS.items():
        percep = {"percep_pretrained": path} if name == "percep" else {}
        jcfg, jnet, variables, tcfg = setup_case(task, loss, **over)
        tcfg = dataclasses.replace(tcfg, **percep)
        sd = from_jax_variables(variables)
        cases[name] = {"kind": "step", "tcfg": tcfg, "state_dict": sd, "batch": batch,
                       "flip": True}
        single = port_step(tcfg, sd, {k: torch.from_numpy(v) for k, v in batch.items()},
                           flip_generator_for(True))
        refs[name] = (single, functools.partial(leaf_reach, tcfg, sd, batch, single),
                      jax_loss(jcfg, jnet, variables, batch, flip=True,
                               percep_fn=jpercep if name == "percep" else None))
    jcfg, jnet, variables, tcfg = setup_case("SelfSupModelMF", DEFAULT_CLIP)
    sd = from_jax_variables(variables)
    cases["default_clip"] = {"kind": "forward", "tcfg": tcfg, "state_dict": sd, "batch": batch}
    refs["default_clip"] = (forward_loss(tcfg, sd, batch), None,
                            jax_loss(dataclasses.replace(jcfg, flip_lr_prob=0.0), jnet,
                                     variables, batch, flip=False))
    run_ranks(tasks_rank, 2, tmp, {"spatial": 2, "cases": cases}, str(tmp), timeout=400)
    ranks = load(tmp, 2)
    shutil.rmtree(tmp)
    return {name: (check_ranks(ranks, name), *refs[name]) for name in cases}


def test_four_ranks_selfsup_hold_their_bands(four_ranks):
    got, _, _, _ = four_ranks
    assert got["rows"] == 32


def test_four_ranks_selfsup_match_jax_forward_and_loss(four_ranks):
    got, _, _, jmetrics = four_ranks
    assert set(got["metrics"]) == {"loss", "photometric_loss", "smoothness_loss"}
    assert_metrics_close(got["metrics"], jmetrics, 1e-4)


def test_four_ranks_selfsup_match_one_process(four_ranks):
    got, single, reach, _ = four_ranks
    assert_step_within_reach(got, single, reach)


@pytest.mark.parametrize("name", list(STEPS))
def test_two_ranks_step_matches_jax_and_one_process(two_ranks, name):
    got, single, reach, jmetrics = two_ranks[name]
    assert got["rows"] == 32
    assert_metrics_close(got["metrics"], jmetrics, 1e-4)
    assert_step_within_reach(got, single, reach)
    if name == "percep":
        assert got["metrics"]["percep_loss"] > 0


def test_default_loss_with_clip_matches_jax(two_ranks):
    """``min`` with the automask and ``clip_loss`` 0.5: the loss only."""
    got, single, _, jmetrics = two_ranks["default_clip"]
    assert_metrics_close(got, single, 1e-5)
    assert_metrics_close(got, jmetrics, 1e-4)


# -- the Trainers ----------------------------------------------------------------------

def recipe_overrides(which, shards=2):
    over = split_overrides(shards)
    over["datasets"]["augmentation"] = {"image_shape": RECIPES[which][1]}
    return over


@pytest.fixture(scope="module", params=list(RECIPES))
def fitted(request, tmp_path_factory):
    which = request.param
    out = tmp_path_factory.mktemp(f"split_fit_{which}")
    config = ROOT / "configs" / RECIPES[which][0]
    run_ranks(split_trainer_rank, 2, out, str(config), recipe_overrides(which), str(out))
    ranks = load(out, 2)
    for r in range(2):
        (out / f"rank{r}.pt").unlink()
    yield which, config, out, ranks
    shutil.rmtree(out)                  # the checkpoints


def test_split_trainer_validates_as_one_process(fitted):
    which, config, out, ranks = fitted
    assert [r["step"] for r in ranks] == [2, 2]
    (ckpt,) = ranks[0]["saved"]
    assert ranks[1]["saved"] == []
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
    cfg = load_config(str(config), {**recipe_overrides(which, 1),
                                    "checkpoint": {"filepath": str(out / "one")}})
    trainer = Trainer(cfg, resume=ckpt, device="cpu")
    assert trainer.model_cfg.name == RECIPES[which][2]
    for k, v in trainer.net.state_dict().items():
        assert torch.equal(v, ranks[0]["state"][k]), k
    single = trainer.validate()
    for r in ranks:
        for k, v in single.items():
            assert r["metrics"][k] == ranks[0]["metrics"][k], k
            if k.startswith(POSE_METRIC_NAMES):
                bar = {"rtol": 1e-5, "atol": 1e-7}
            elif k.startswith(("a1", "a2", "a3")):
                bar = {"rtol": 0.0, "atol": 1e-3}
            else:
                bar = {"rtol": 2e-3, "atol": 0.0}
            np.testing.assert_allclose(r["metrics"][k], v, err_msg=k, **bar)
        assert np.isfinite(r["metrics"]["avg_train-loss"])


def test_an_eval_batch_of_one_is_split_by_height(fitted):
    which, _, _, ranks = fitted
    h, w = RECIPES[which][1]
    for r in ranks:
        assert r["placed"]["rgb"] == (1, h // 2, w, 3)
        assert r["placed"]["depth"] == (1, h, w, 1)           # the ground truth whole
        assert r["eval"]["inv_depth"].shape == (1, h, w, 1)
        assert r["eval"]["metrics"].shape == (4, 1, 9)
    for k, v in ranks[0]["eval"].items():
        assert torch.equal(ranks[1]["eval"][k], v), k
