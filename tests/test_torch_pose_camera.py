"""The port's `Pose`, `pose_vec_to_mat` and camera scaling against the JAX
package's (CPU, fp32, within 1e-6 on values of order 1): the axis-angle
mode, `Pose.from_rt`, its accessors, composition, ``@`` and indexing,
`scale_intrinsics` with separate x and y scales, and `Camera.scaled`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dro_sfm_tpu.geometry.camera as jcam
import dro_sfm_tpu.geometry.pose as jpose
import dro_sfm_torch.geometry.camera as tcam
import dro_sfm_torch.geometry.pose as tpose

TOL = 1e-6


def same(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["euler", "axis_angle"])
def test_pose_vec_to_mat_modes(mode):
    rng = np.random.default_rng(0)
    vec = rng.normal(0, 0.5, (2, 5, 6)).astype(np.float32)
    vec[0, 0, 3:] = 0.0                        # the identity rotation
    vec[0, 1, 3:] = [1e-8, 0.0, 0.0]           # below the series threshold
    got = tpose.pose_vec_to_mat(torch.from_numpy(vec), mode)
    same(got, jpose.pose_vec_to_mat(jnp.asarray(vec), mode))
    same(tpose.Pose.from_vec(torch.from_numpy(vec), mode).mat,
         jpose.Pose.from_vec(jnp.asarray(vec), mode).mat)


def test_pose_vec_to_mat_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unsupported rotation mode: quat"):
        tpose.pose_vec_to_mat(torch.zeros(6), "quat")


def test_pose_algebra():
    rng = np.random.default_rng(1)
    vec = rng.normal(0, 0.5, (4, 6)).astype(np.float32)
    other = rng.normal(0, 0.5, (4, 6)).astype(np.float32)
    tp, to = (tpose.Pose.from_vec(torch.from_numpy(v), "axis_angle") for v in (vec, other))
    jp, jo = (jpose.Pose.from_vec(jnp.asarray(v), "axis_angle") for v in (vec, other))
    same(tp.rotation, jp.rotation)
    same(tp.translation, jp.translation)
    assert tp.shape == jp.shape == (4, 4, 4)
    same(tp.compose(to).mat, jp.compose(jo).mat)
    same((tp @ to).mat, (jp @ jo).mat)
    pts = rng.normal(size=(4, 7, 3)).astype(np.float32)
    same(tp @ torch.from_numpy(pts), jp @ jnp.asarray(pts), 1e-5)
    same(tp[1:3].mat, jp[1:3].mat)
    same(tp[2].mat, jp[2].mat)
    assert repr(tp[1:3]) == repr(jp[1:3]) == "Pose(shape=(2, 4, 4))"
    rot = np.array(jp.rotation)
    trans = rng.normal(size=(3,)).astype(np.float32)       # broadcast over the batch
    same(tpose.Pose.from_rt(torch.from_numpy(rot), torch.from_numpy(trans)).mat,
         jpose.Pose.from_rt(jnp.asarray(rot), jnp.asarray(trans)).mat)
    same((tp @ tp.inverse()).mat, np.broadcast_to(np.eye(4), (4, 4, 4)), 1e-5)


@pytest.mark.parametrize("scales", [(0.5,), (0.25, 0.5), (1.5, 0.75)])
def test_scale_intrinsics_and_camera_scaled(scales):
    K = np.array([[[100.0, 0.0, 63.5], [0.0, 90.0, 47.5], [0.0, 0.0, 1.0]],
                  [[50.0, 0.0, 31.0], [0.0, 55.0, 24.0], [0.0, 0.0, 1.0]]], np.float32)
    got = tcam.scale_intrinsics(torch.from_numpy(K), *scales)
    same(got, jcam.scale_intrinsics(jnp.asarray(K), *scales))
    tc = tcam.Camera(torch.from_numpy(K)).scaled(*scales)
    jc = jcam.Camera(jnp.asarray(K)).scaled(*scales)
    same(tc.K, jc.K)
    same(tc.Tcw.mat, jc.Tcw.mat)
    cam = tcam.Camera(torch.from_numpy(K))
    assert cam.scaled(1.0) is cam and cam.scaled(1.0, 1.0) is cam


def test_scale_intrinsics_one_scale_keeps_its_bits():
    """The existing callers' single scale gives the same bits as before."""
    K = torch.tensor([[192.0 * 0.58, 0.0, 319.5], [0.0, 640.0 * 1.92, 95.5], [0, 0, 1.0]])
    s = 1.0 / 8
    want = K.clone()
    want[0, 0] *= s
    want[1, 1] *= s
    want[:2, 2] = (want[:2, 2] + 0.5) * s - 0.5
    assert torch.equal(tcam.scale_intrinsics(K, s), want)
