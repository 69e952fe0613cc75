"""The port's training step with image heights split over spawned gloo ranks
(CPU), against JAX's ``forward_and_loss`` on the whole batch and against the
port in one process.

``SupModelMF`` at ``it4-h-out`` (the config of `tests/test_spatial.py`),
64x96, N=2, the weights and batches of `tests/test_torch_train_step.py` (its
B=2 batches of seeds 0 and 1 make the global batch of 4), the flip on:
- D=2 x S=2 (four ranks, two samples and 32 rows a rank) with
  ``sep_conv="split"``;
- D=1 x S=2 with ``sep_conv="pallas"`` (the fused GRU pass's plain versions
  on the band widened by 4 rows), and one forward at 80x96, where the
  stride-16 maps' 5 rows split 3 + 2.
Rank 0 draws the flip and the others the opposite decision, so the step must
take rank 0's. Bars:
- the loss and its terms against JAX's ``forward_and_loss`` on the whole
  batch: 1e-4 relative, the bar `tests/test_spatial.py` holds JAX's own
  (data, spatial) mesh to;
- against the port in one process on the whole batch, those of
  `tests/test_torch_dist_train.py`: the loss and its terms 1e-5 relative,
  BatchNorm statistics 1e-5, each gradient leaf cosine >= 0.9999 and
  relative L2 <= 1e-2, the parameters after Adam within 0.05 lr (2 lr where
  the gradient lies within 1e-2 of its leaf's norm of zero);
- every rank holds the same metrics, gradients and state, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.geometry.pose import pose_vec_to_mat
from dro_sfm_torch.models import sfm as tsfm
from tests._torch_dist import flip_generator_for, load, port_step, run_ranks
from tests._torch_spatial import forward_loss, split_step_rank
from tests.test_torch_dist_train import assert_metrics_close, assert_same_step
from tests.test_torch_modules import fill_variables
from tests.test_torch_train_step import CFG, key_with_flip

torch.set_num_threads(2)
SPLIT_CFG = {**CFG, "version": "it4-h-out"}


def make_batch(seed, h=64, w=96, b=2, n=2):
    """`tests/test_torch_train_step.py:make_batch` at ``h`` rows."""
    rng = np.random.default_rng(seed)
    K = np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2], [0, 0, 1.0]], np.float32)
    gt_vecs = torch.from_numpy(rng.normal(0, 0.05, size=(b, n, 6)).astype(np.float32))
    return {"rgb": rng.uniform(size=(b, h, w, 3)).astype(np.float32),
            "rgb_context": rng.uniform(size=(b, n, h, w, 3)).astype(np.float32),
            "intrinsics": np.broadcast_to(K, (b, 3, 3)).copy(),
            "depth": rng.uniform(0.1, 40.0, size=(b, h, w, 1)).astype(np.float32),
            "pose_context": pose_vec_to_mat(gt_vecs).numpy()}


def global_batch(h=64):
    a, b = make_batch(0, h), make_batch(1, h)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def jax_loss(jcfg, jnet, variables, batch, flip):
    """JAX's loss and terms of the train-mode forward on the whole batch."""
    key = key_with_flip(flip)
    loss, (_, metrics, _) = jax.jit(lambda v, bt: jsfm.forward_and_loss(
        jcfg, jnet, v, bt, key))(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}


def split_ranks(tmp_path, job, world):
    run_ranks(split_step_rank, world, tmp_path, job, str(tmp_path))
    ranks = load(tmp_path, world)
    for other in ranks[1:]:                  # one global step on every rank
        assert other["metrics"] == ranks[0]["metrics"]
        for part in ("grads", "after"):
            assert all(torch.equal(other[part][k], v) for k, v in ranks[0][part].items())
    return ranks


@pytest.fixture(scope="module")
def setup():
    batch = global_batch()
    jcfg = jsfm.SfmModelConfig(**SPLIT_CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    return batch, jcfg, jnet, variables


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """D=2 x S=2, ``sep_conv="split"``."""
    batch, jcfg, jnet, variables = setup
    tcfg = tsfm.SfmModelConfig(**{**SPLIT_CFG, "warp_impl": "pallas"})
    job = {"tcfg": tcfg, "state_dict": from_jax_variables(variables), "batch": batch,
           "flip": True, "spatial": 2}
    ranks = split_ranks(tmp_path_factory.mktemp("dxs"), job, 4)
    single = port_step(tcfg, from_jax_variables(variables),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_generator_for(True))
    return ranks, single, jax_loss(jcfg, jnet, variables, batch, flip=True)


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """D=1 x S=2, ``sep_conv="pallas"``, and a forward at 80x96."""
    batch, jcfg, jnet, variables = setup
    tcfg = tsfm.SfmModelConfig(**{**SPLIT_CFG, "warp_impl": "pallas", "sep_conv": "pallas"})
    sd = from_jax_variables(variables)
    batch80 = global_batch(80)
    job = {"tcfg": tcfg, "state_dict": sd, "batch": batch, "flip": True, "spatial": 2,
           "forward": batch80}
    ranks = split_ranks(tmp_path_factory.mktemp("s2"), job, 2)
    single = port_step(tcfg, sd, {k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_generator_for(True))
    return (ranks, single, jax_loss(jcfg, jnet, variables, batch, flip=True),
            forward_loss(tcfg, sd, batch80),
            jax_loss(dataclasses.replace(jcfg, flip_lr_prob=0.0), jnet, variables, batch80,
                     flip=False))


def test_four_ranks_hold_their_bands(four_ranks):
    ranks, _, _ = four_ranks
    assert [r["rows"] for r in ranks] == [32] * 4


def test_four_ranks_match_jax_forward_and_loss(four_ranks):
    ranks, _, jmetrics = four_ranks
    assert_metrics_close(ranks[0]["metrics"], jmetrics, 1e-4)


def test_four_ranks_match_one_process(four_ranks):
    ranks, single, _ = four_ranks
    assert_same_step(ranks[0], single)


def test_two_ranks_fused_gru_match_jax_and_one_process(two_ranks):
    ranks, single, jmetrics, _, _ = two_ranks
    assert_metrics_close(ranks[0]["metrics"], jmetrics, 1e-4)
    assert_same_step(ranks[0], single)


def test_forward_at_80_rows(two_ranks):
    """80 rows over 2: the stride-16 maps hold 3 and 2 rows."""
    ranks, _, _, single, jmetrics = two_ranks
    for r in ranks:
        assert r["forward"] == ranks[0]["forward"]
    assert_metrics_close(ranks[0]["forward"], single, 1e-5)
    assert_metrics_close(ranks[0]["forward"], jmetrics, 1e-4)
