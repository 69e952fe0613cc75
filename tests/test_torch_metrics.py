"""The port's evaluation metrics against the JAX package's (fp32, CPU).

Bars: 1e-5 relative (and 1e-6 absolute) on every metric, median and fused
map. The means sum a few thousand fp32 terms in another order than XLA's,
which moves them by about 1e-7 relative; SILog subtracts two such means.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.training import metrics as jm
from dro_sfm_tpu.utils.depth import post_process_inv_depth as jax_post_process
from dro_sfm_torch.training import metrics as tm
from dro_sfm_torch.utils.depth import fuse_inv_depth, post_process_inv_depth

RTOL, ATOL = 1e-5, 1e-6


def depth_batch(seed=0, b=3, h=24, w=40, hg=None, wg=None):
    rng = np.random.default_rng(seed)
    hg, wg = hg or h, wg or w
    gt = rng.uniform(0.5, 30.0, size=(b, hg, wg, 1)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0             # invalid pixels
    gt[-1] = 0.0                                           # a sample with none valid
    pred = (rng.uniform(0.5, 30.0, size=(b, h, w, 1))).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    pose[:, :, :3, 3] = rng.normal(0, 0.3, size=(b, 2, 3))
    return gt, pred, pose


@pytest.mark.parametrize("crop", ["", "garg"])
@pytest.mark.parametrize("use_gt_scale", [False, True])
@pytest.mark.parametrize("demon", [False, True])
@pytest.mark.parametrize("resize", [False, True])
def test_depth_metrics_match_jax(crop, use_gt_scale, demon, resize):
    gt, pred, pose = depth_batch(hg=36 if resize else None, wg=60 if resize else None)
    cfg = dict(crop=crop, min_depth=0.2, max_depth=20.0)
    kw = dict(use_gt_scale=use_gt_scale, demon_scaling=demon, reduce=False)
    ours = tm.compute_depth_metrics(torch.from_numpy(gt), torch.from_numpy(pred),
                                    tm.MetricsConfig(**cfg), gt_pose=torch.from_numpy(pose),
                                    **kw).numpy()
    ref = np.asarray(jm.compute_depth_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                              jm.MetricsConfig(**cfg),
                                              gt_pose=jnp.asarray(pose), **kw))
    assert ours.shape == ref.shape == (3, 9)
    np.testing.assert_array_equal(ours[-1], 0.0)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    reduced = tm.compute_depth_metrics(torch.from_numpy(gt), torch.from_numpy(pred),
                                       tm.MetricsConfig(**cfg), gt_pose=torch.from_numpy(pose),
                                       use_gt_scale=use_gt_scale, demon_scaling=demon)
    np.testing.assert_allclose(reduced.numpy(), ours.mean(0), rtol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 64])
def test_masked_median_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    values = rng.normal(size=64).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[rng.permutation(64)[:n_valid]] = True
    ref = float(jm.masked_median(jnp.asarray(values), jnp.asarray(mask)))
    assert float(tm.masked_median(torch.from_numpy(values), torch.from_numpy(mask))) == ref
    batched = tm.masked_median(torch.from_numpy(np.stack([values, -values])),
                               torch.from_numpy(np.stack([mask, mask])))
    assert batched.shape == (2,) and float(batched[0]) == ref


def test_crop_masks_match_jax():
    for crop, (h, w) in (("garg", (192, 640)), ("eigen_nyu", (480, 640)), ("", (8, 8))):
        a, b = tm._crop_mask(h, w, crop), jm._crop_mask(h, w, crop)
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("method", ["mean", "max", "min"])
def test_post_process_matches_jax(method):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.05, 1.0, size=(2, 16, 48, 1)).astype(np.float32)
    b = rng.uniform(0.05, 1.0, size=(2, 16, 48, 1)).astype(np.float32)
    ours = post_process_inv_depth(torch.from_numpy(a), torch.from_numpy(b), method).numpy()
    ref = np.asarray(jax_post_process(jnp.asarray(a), jnp.asarray(b), method))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        fuse_inv_depth(torch.from_numpy(a), torch.from_numpy(b), "median")


def test_pose_metrics_match_jax():
    rng = np.random.default_rng(2)
    from dro_sfm_torch.geometry.pose import pose_vec_to_mat
    gt = pose_vec_to_mat(torch.from_numpy(rng.normal(0, 0.1, (2, 2, 6)).astype(np.float32))).numpy()
    pred = pose_vec_to_mat(torch.from_numpy(rng.normal(0, 0.1, (2, 2, 6)).astype(np.float32))).numpy()
    ours = tm.compute_pose_metrics(gt, pred)
    np.testing.assert_allclose(ours, jm.compute_pose_metrics(gt, pred), rtol=RTOL)
    np.testing.assert_allclose(tm.compute_pose_metrics(gt, gt), 0.0, atol=2e-2)


def test_names_match_jax():
    assert tm.DEPTH_METRIC_NAMES == jm.DEPTH_METRIC_NAMES
    assert tm.ALL_METRIC_NAMES == jm.ALL_METRIC_NAMES
    assert tm.METRIC_MODES == jm.METRIC_MODES
