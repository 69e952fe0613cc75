"""The port's training in two processes (gloo, CPU) against the JAX
package's step over the whole global batch, and against the port in one
process.

The step: ``SupModelMF`` at ``it8-h-out``, 64x96, N=2, the weights and
batches of `tests/test_torch_train_step.py` (two of its B=2 batches, seeds 0
and 1, make the global batch of 4), the flip on. JAX's ``make_train_step``
takes the whole batch in this process; two spawned ranks of the port take 2
samples each, rank 0 drawing the flip and rank 1 the other decision, so the
step must take rank 0's. Bars:
- against JAX, those of `tests/test_torch_train_step.py`: the loss and its
  terms 1e-5 relative; per-leaf gradients cosine >= 0.999 and relative L2 <=
  5e-2 on the train-mode encoders, <= 1e-2 elsewhere; the parameters after
  one Adam step within 0.05 lr, and within 2 lr where the gradient lies
  within its 5e-2 bar of zero; BatchNorm statistics 1e-4;
- against the port in one process on the whole batch, where only the order
  of the sums differs: the loss and its terms 1e-5 relative, the BatchNorm
  statistics 1e-5 (of the largest element); each gradient leaf cosine >=
  0.9999 and relative L2 <= 1e-2, and the parameters after Adam within 0.05
  lr, and within 2 lr where the gradient lies within 1e-2 of its leaf's norm
  of zero. The gradient bar is the order of the sums' own reach at this
  depth: the 16 recurrent steps amplify rounding, so that the port in one
  process, given the same 4 samples in the order 1, 0, 3, 2, moves leaves
  by up to 7.9e-3 (median 3.3e-4), and with only the BatchNorm sums taken in
  fp64 by up to 2.6e-4; the two ranks lie up to 5.4e-3 from one process
  (median 1.0e-4), the loss 2.4e-7;
- the two ranks hold the same gradients and state, bit for bit.
The self-supervised step with ``clip_loss`` 2.0 (the clamp's statistics
pooled over the global batch), on the smooth images and the mean over views
of `tests/test_torch_selfsup_step.py` (its seeds 0 and 1), against the port
in one process with the bars above, and against JAX with those of
`tests/test_torch_train_step.py` but 2e-2 on the leaves outside the
encoders: on these 4 samples JAX's own fp32 gradient moves the mask head's
leaves by 1.4e-2 (up to 1.8e-2 elsewhere) when the samples come in the order
1, 0, 3, 2, and the port in one process lies 1.6e-2 from it there, with or
without the clamp.

The Trainer: two ranks fit ``configs/overfit_synthetic.yaml`` cut to
``it4-h-out`` at 32x48, one epoch of 2 steps of 2 samples a rank, validated
on 3 samples (rank 1's shard padded). Their validation equals a
single-process Trainer's on the saved weights (1e-5 relative; the pose
metrics, per batch, that of the shards' batches); only rank 0
writes a checkpoint; SIGTERM to rank 1 alone stops both at the same step
with one emergency checkpoint, rank 0's; a validation shard that loses a
sample makes both ranks raise. Then the train CLI under the launcher.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_tpu.utils.config import load_config as j_load_config
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.data import make_loader
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.metrics import (
    DEPTH_METRIC_NAMES,
    METRIC_MODES,
    POSE_METRIC_NAMES,
    compute_pose_metrics,
)
from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config
from tests._torch_dist import (
    flip_generator_for,
    load,
    port_step,
    run_ranks,
    train_step_rank,
    trainer_rank,
)
from tests.test_torch_modules import fill_variables
from tests.test_torch_selfsup_step import SMOOTH_LOSS, task_batch, task_setup
from tests.test_torch_train_step import (
    CFG,
    LR,
    assert_grads_close,
    jax_grads_as_port,
    key_with_flip,
    make_batch,
    stats_as_port,
)
from tests.test_torch_trainer import TINY_YAML

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


def global_batch(make):
    """The global batch of 4: ``make(0)`` then ``make(1)``."""
    a, b = make(0), make(1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def jax_gradients(jcfg, jnet, variables, batch, flip):
    """JAX's loss, metrics, gradients (in the port's names) and BatchNorm
    statistics of one forward + backward on ``batch``."""
    key = key_with_flip(flip)

    def loss_fn(params):
        loss, (_, metrics, updates) = jsfm.forward_and_loss(
            jcfg, jnet, {"params": params, "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return loss, (metrics, updates)

    (loss, (metrics, updates)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return ({"loss": float(loss), **{k: float(v) for k, v in metrics.items()}},
            jax_grads_as_port(grads, variables["batch_stats"]),
            stats_as_port(updates["batch_stats"]))


def two_ranks(tmp_path, tcfg, variables, batch, flip=True):
    job = {"tcfg": tcfg, "state_dict": from_jax_variables(variables), "batch": batch,
           "flip": flip}
    run_ranks(train_step_rank, WORLD, tmp_path, job, str(tmp_path))
    ranks = load(tmp_path, WORLD)
    for other in ranks[1:]:                  # one global step on every rank
        assert other["metrics"] == ranks[0]["metrics"]
        for part in ("grads", "after"):
            assert all(torch.equal(other[part][k], v) for k, v in ranks[0][part].items())
    return ranks[0]


def assert_metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def assert_stats_close(after, want, bar):
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(after[k].numpy(), v, rtol=bar,
                                   atol=bar * np.abs(v).max(), err_msg=k)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """The JAX step, the port's step in one process and in two, from the
    same weights on the same global batch."""
    batch = global_batch(make_batch)
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    tcfg = tsfm.SfmModelConfig(**{**CFG, "warp_impl": "pallas"})
    jmetrics, jgrads, jstats = jax_gradients(jcfg, jnet, variables, batch, flip=True)
    cfg = j_load_config()
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    key = key_with_flip(True, fold=0)
    jstate = j_create_state(jnet, key, None, tx, init_variables=variables)
    jstate, jstep_metrics = j_make_train_step(jcfg, jnet)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jafter = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    single = port_step(tcfg, from_jax_variables(variables),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_generator_for(True))
    ranks = two_ranks(tmp_path_factory.mktemp("step"), tcfg, variables, batch)
    before = {k: v.numpy() for k, v in from_jax_variables(variables).items()}
    return {"jax": (jmetrics, jgrads, jstats, float(jstep_metrics["loss"]), jafter),
            "single": single, "ranks": ranks, "before": before}


def as_numpy(grads):
    return {k: v.numpy() for k, v in grads.items()}


def test_two_ranks_match_jax_on_the_global_batch(supervised):
    jmetrics, jgrads, jstats, jstep_loss, _ = supervised["jax"]
    r = supervised["ranks"]
    np.testing.assert_allclose(r["metrics"]["loss"], jstep_loss, rtol=1e-5)
    assert_metrics_close(r["metrics"], jmetrics, 1e-5)
    assert_grads_close(as_numpy(r["grads"]), jgrads)
    assert_stats_close(r["after"], jstats, 1e-4)


def test_two_ranks_take_jaxs_adam_step(supervised):
    *_, jafter = supervised["jax"]
    r, before = supervised["ranks"], supervised["before"]
    for k, exp in jafter.items():
        if k.endswith("num_batches_tracked"):
            continue
        got = r["after"][k].numpy()
        if k not in r["grads"]:
            np.testing.assert_allclose(got, exp, atol=1e-4, rtol=1e-4, err_msg=k)
            continue
        assert np.abs(got - before[k]).max() > 0.5 * LR, k
        err = np.abs(got - exp)
        assert err.max() <= 2.0 * LR + 1e-6, k
        g = r["grads"][k].numpy()
        flipped = err > 0.05 * LR
        assert np.all(np.abs(g[flipped]) <= 5e-2 * np.linalg.norm(g)), k


def assert_same_step(r, single):
    """Two ranks against one process on the whole batch (module docstring)."""
    metrics, grads, after = single
    assert_metrics_close(r["metrics"], metrics, 1e-5)
    for k, g in grads.items():
        g, got = g.double(), r["grads"][k].double()
        cos = (got * g).sum() / (got.norm() * g.norm())
        assert cos >= 0.9999 and (got - g).norm() <= 1e-2 * g.norm(), k
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(r["after"][k], v)
        elif k not in grads:
            assert_stats_close(r["after"], {k: v.numpy()}, 1e-5)
        else:
            err = (r["after"][k] - v).abs()
            assert err.max() <= 2.0 * LR + 1e-6, k
            sign_may_flip = grads[k].abs() <= 1e-2 * grads[k].norm()
            assert torch.all((err <= 0.05 * LR) | sign_may_flip), k


def test_two_ranks_match_one_process(supervised):
    assert_same_step(supervised["ranks"], supervised["single"])


def test_two_ranks_clip_loss_matches_jax(tmp_path):
    """``clip_loss`` 2.0: the clamp at mean + 2 std, its statistics pooled
    over the global batch."""
    loss = {**SMOOTH_LOSS, "clip_loss": 2.0}
    _, jcfg, jnet, variables, tcfg = task_setup("SelfSupModelMF", loss)
    batch = global_batch(task_batch)
    jmetrics, jgrads, jstats = jax_gradients(jcfg, jnet, variables, batch, flip=True)
    r = two_ranks(tmp_path, tcfg, variables, batch)
    assert_metrics_close(r["metrics"], jmetrics, 1e-5)
    assert_grads_close(as_numpy(r["grads"]), jgrads, bar_elsewhere=2e-2)
    assert_stats_close(r["after"], jstats, 1e-4)
    assert_same_step(r, port_step(tcfg, from_jax_variables(variables),
                                  {k: torch.from_numpy(v) for k, v in batch.items()},
                                  flip_generator_for(True)))


# -- the Trainer ---------------------------------------------------------------------

def trainer_overrides(epochs):
    small = {"num_workers": 1, "batch_size": 2}
    return {"arch": {"max_epochs": epochs},
            "model": {"depth_net": {"version": "it4-h-out"}},
            "datasets": {"augmentation": {"image_shape": (32, 48)},
                         "train": {**small, "split": ["8"], "repeat": [1]},
                         "validation": {**small, "split": ["3"]}}}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    run_ranks(trainer_rank, WORLD, out, str(ROOT / "configs" / "overfit_synthetic.yaml"),
              trainer_overrides(1), str(out), None)
    return out, load(out, WORLD)


def test_two_rank_trainer_validates_as_one_process(fitted):
    """The depth metrics (sums over the valid samples) equal one process's.
    The pose metrics are the JAX package's per batch (each batch's first
    sample, padded batches included), so they are held to one process's
    evaluation of the two shards' batches."""
    out, ranks = fitted
    assert [r["step"] for r in ranks] == [2, 2]
    (ckpt,) = ranks[0]["saved"]
    cfg = load_config(str(ROOT / "configs" / "overfit_synthetic.yaml"),
                      {**trainer_overrides(1), "checkpoint": {"filepath": str(out / "one")}})
    trainer = Trainer(cfg, resume=ckpt, device="cpu")
    single = trainer.validate()
    evaluate = trainer.eval_step_for(False)
    pose = np.mean([compute_pose_metrics(b["pose_context"],
                                         evaluate(trainer._place(b))["pose"].numpy())
                    for shard in range(WORLD)
                    for b in make_loader(trainer.val_datasets[0], 2, "validation",
                                         num_workers=1, num_shards=WORLD, shard_id=shard)],
                   axis=0)
    for mode in METRIC_MODES:
        want = {**{m + mode: single[m + mode] for m in DEPTH_METRIC_NAMES},
                **{m + mode: v for m, v in zip(POSE_METRIC_NAMES, pose)}}
        for r in ranks:
            for k, v in want.items():
                np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-7,
                                           err_msg=k)


def test_only_rank0_writes_checkpoints(fitted):
    _, ranks = fitted
    assert len(ranks[0]["files"]) == 1 and ranks[0]["files"][0].startswith("epoch=00_")
    assert ranks[1]["files"] == [] and ranks[1]["saved"] == []


def test_a_shard_that_loses_a_sample_fails_every_rank(fitted):
    _, ranks = fitted
    assert [r["missing_sample"] for r in ranks] == \
        ["distributed eval saw 2 samples, expected 3"] * WORLD


def test_sigterm_on_one_rank_stops_both(tmp_path):
    run_ranks(trainer_rank, WORLD, tmp_path, str(ROOT / "configs" / "overfit_synthetic.yaml"),
              trainer_overrides(2), str(tmp_path), 1)
    ranks = load(tmp_path, WORLD)
    assert [r["step"] for r in ranks] == [2, 2]          # the epoch's end, together
    assert [r["metrics"] for r in ranks] == [{}, {}]
    assert ranks[0]["files"] == ["preempt_epoch=00.ckpt"] and ranks[1]["files"] == []


def test_train_cli_under_the_launcher(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(epochs=1, ckpt=tmp_path / "ckpt", save=tmp_path / "save"))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "dro_sfm_torch.scripts.launch_multihost",
                          "--nprocs", "2", "--backend", "gloo", "--", "-m",
                          "dro_sfm_torch.scripts.train", str(cfg), "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count('"abs_rel_pp_gt"') == 1        # printed by rank 0 alone
    metrics = json.loads(res.stdout[res.stdout.rindex("\n{") + 1:])
    assert np.isfinite(metrics["abs_rel_pp_gt"])
    (path,) = sorted((tmp_path / "ckpt").glob("*.ckpt"))
    assert json.loads(Path(str(path) + ".json").read_text())["step"] == 1
