"""The port's supervised losses and their geometry against the JAX package
(fp32, CPU).

Same numpy inputs on both sides. Tolerances: 1e-6 relative on the loss
scalars and 1e-5 absolute and relative on their input gradients (means of
some thousand fp32 terms, summed in another order); 1e-5 on projected
coordinates (a 3x3 product and a division); exact for flips and masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.geometry import camera as jcam
from dro_sfm_tpu.geometry.pose import Pose as JPose
from dro_sfm_tpu.losses import progressive as jprog
from dro_sfm_tpu.losses import supervised as jsup
from dro_sfm_tpu.ops import image as jimg
from dro_sfm_torch.geometry import camera as tcam
from dro_sfm_torch.geometry.pose import Pose as TPose
from dro_sfm_torch.losses import progressive as tprog
from dro_sfm_torch.losses import supervised as tsup
from dro_sfm_torch.ops import image as timg

torch.set_num_threads(2)
B, N, P, H, W = 2, 2, 3, 12, 20
TOL = {"atol": 1e-5, "rtol": 1e-5}


def intrinsics():
    return np.array([[[0.8 * W, 0, (W - 1) / 2], [0, 0.9 * H, (H - 1) / 2],
                      [0, 0, 1.0]]] * B, np.float32)


def pose_mats(rng, shape, scale=0.05):
    vec = rng.normal(0, scale, size=(*shape, 6)).astype(np.float32)
    return np.asarray(JPose.from_vec(jnp.asarray(vec), "euler").mat)


def loss_inputs(rng):
    return {
        "inv_depths": rng.uniform(0.01, 3.0, size=(P, B, H, W, 1)).astype(np.float32),
        "gt_depth": rng.uniform(0.1, 40.0, size=(B, H, W, 1)).astype(np.float32),
        "pose_vecs": rng.normal(0, 0.05, size=(B, N, P, 6)).astype(np.float32),
        "gt_pose": pose_mats(rng, (B, N)),
        "K": intrinsics(),
    }


@pytest.mark.parametrize("progress", [None, 0.0, 0.45, 0.99])
def test_supervised_depth_pose_loss_matches_jax(rng, progress):
    """The combined loss, its terms and its gradients in the predictions;
    ``progress`` None runs without progressive scaling, else with a 0.3
    threshold at that point of training."""
    d = loss_inputs(rng)
    kw = {"min_depth": 0.2, "max_depth": 80.0,
          "progressive_scaling": 0.0 if progress is None else 0.3}
    jcfg, tcfg = jsup.SupervisedLossConfig(**kw), tsup.SupervisedLossConfig(**kw)
    prog = 0.0 if progress is None else progress

    def jfn(inv, pv):
        return jsup.supervised_depth_pose_loss(
            inv, jnp.asarray(d["gt_depth"]), pv, jnp.asarray(d["gt_pose"]),
            jnp.asarray(d["K"]), jcfg, progress=prog)

    (jl, jm), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["inv_depths"]), jnp.asarray(d["pose_vecs"]))
    inv = torch.from_numpy(d["inv_depths"]).requires_grad_()
    pv = torch.from_numpy(d["pose_vecs"]).requires_grad_()
    tl, tm = tsup.supervised_depth_pose_loss(
        inv, torch.from_numpy(d["gt_depth"]), pv, torch.from_numpy(d["gt_pose"]),
        torch.from_numpy(d["K"]), tcfg, progress=prog)
    tl.backward()
    assert set(tm) == set(jm) == {"depth_loss", "pose_loss", "all_loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tm["pose_loss"].detach()) > 0 and float(tm["depth_loss"].detach()) > 0
    np.testing.assert_allclose(inv.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(pv.grad.numpy(), np.asarray(jg[1]), **TOL)


@pytest.mark.parametrize("threshold", [0.0, 0.25, 0.3])
@pytest.mark.parametrize("progress", [0.0, 0.25, 0.3, 0.61, 1.0])
def test_progressive_scale_mask_matches_jax(threshold, progress):
    for p in (1, 4, 9):
        expected = np.asarray(jprog.progressive_scale_mask(p, threshold, progress))
        got = tprog.progressive_scale_mask(p, threshold, progress)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("method", ["sparse-l1", "mse", "berhu", "silog", "abs_rel"])
def test_single_term_losses_match_jax(rng, method):
    pred = rng.uniform(0.5, 10.0, size=(B, H, W, 1)).astype(np.float32)
    gt = rng.uniform(0.5, 10.0, size=(B, H, W, 1)).astype(np.float32)
    expected = float(jsup.get_loss_fn(method)(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(tsup.get_loss_fn(method)(torch.from_numpy(pred), torch.from_numpy(gt)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    with pytest.raises(ValueError):
        tsup.get_loss_fn("nope")


def test_berhu_and_silog_direct(rng):
    pred = rng.uniform(0.5, 10.0, size=(64,)).astype(np.float32)
    gt = rng.uniform(0.5, 10.0, size=(64,)).astype(np.float32)
    for jf, tf in ((jsup.berhu_loss, tsup.berhu_loss), (jsup.silog_loss, tsup.silog_loss)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(pred), torch.from_numpy(gt))),
                                   float(jf(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_camera_reconstruct_project_match_jax(rng, normalize):
    """`Camera.reconstruct` (to the world frame through ``Tcw``'s inverse)
    and `Camera.project` (z clamped at 1e-5, ``2x / (W - 1) - 1``), and
    their composition `view_synthesis_coords`, with some points behind the
    reference camera."""
    K = intrinsics()
    depth = rng.uniform(0.5, 5.0, size=(B, H, W, 1)).astype(np.float32)
    near = depth.copy()
    near[:, 0, :4, 0] = [1e-3, 1e-2, 0.05, 0.1]  # lands near or behind z = 0
    Tcw = pose_mats(rng, (B,), scale=0.3)
    jc, jref = jcam.Camera(jnp.asarray(K)), jcam.Camera(jnp.asarray(K), JPose(jnp.asarray(Tcw)))
    tc, tref = tcam.Camera(torch.from_numpy(K)), tcam.Camera(torch.from_numpy(K),
                                                            TPose(torch.from_numpy(Tcw)))
    for frame in ("c", "w"):
        jp = jref.reconstruct(jnp.asarray(near), frame=frame)
        tp = tref.reconstruct(torch.from_numpy(near), frame=frame)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        # the same points on both sides: near z = 0 a division amplifies
        # any difference in the points
        np.testing.assert_allclose(
            tref.project(torch.from_numpy(np.asarray(jp)), frame=frame,
                         normalize=normalize).numpy(),
            np.asarray(jref.project(jp, frame=frame, normalize=normalize)),
            rtol=1e-5, atol=1e-4)
    expected = jcam.view_synthesis_coords(jnp.asarray(depth), jc, jref, normalize)
    got = tcam.view_synthesis_coords(torch.from_numpy(depth), tc, tref, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        tc.reconstruct(torch.from_numpy(depth), frame="x")


def test_pose_identity_inverse_transform(rng):
    T = pose_mats(rng, (B, N), scale=0.3)
    pts = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TPose(torch.from_numpy(T)).inverse().transform_points(torch.from_numpy(pts)).numpy(),
        np.asarray(JPose(jnp.asarray(T)).inverse().transform_points(jnp.asarray(pts))),
        **TOL)
    eye = TPose.identity((B, N))
    assert eye.mat.shape == (B, N, 4, 4)
    assert torch.equal(eye.transform_points(torch.from_numpy(pts)), torch.from_numpy(pts))


def test_flip_lr_and_flip_intrinsics_match_jax(rng):
    img = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.flip_lr(torch.from_numpy(img)).numpy(),
                                  np.asarray(jimg.flip_lr(jnp.asarray(img))))
    K = intrinsics()
    got = timg.flip_intrinsics(torch.from_numpy(K), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jimg.flip_intrinsics(jnp.asarray(K), W)))
    assert np.array_equal(K, intrinsics())             # the input is left alone
