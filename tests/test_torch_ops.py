"""dro_sfm_torch ops and geometry against the JAX package (fp32, CPU).

The same numpy inputs go through each JAX function and its PyTorch
counterpart. Unless a test says otherwise the tolerance is 1e-5 absolute
(plus 1e-5 relative): both sides compute in fp32 with the same formula, so
only the order of a few roundings differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.geometry import camera as jcam
from dro_sfm_tpu.geometry import pose as jpose
from dro_sfm_tpu.geometry import rotations as jrot
from dro_sfm_tpu.ops import depth_ops as jdepth
from dro_sfm_tpu.ops import image as jimage
from dro_sfm_tpu.ops import resample as jresample
from dro_sfm_tpu.ops import upsample as jupsample
from dro_sfm_torch.geometry import camera as tcam
from dro_sfm_torch.geometry import pose as tpose
from dro_sfm_torch.geometry import rotations as trot
from dro_sfm_torch.ops import depth_ops as tdepth
from dro_sfm_torch.ops import image as timage
from dro_sfm_torch.ops import resample as tresample
from dro_sfm_torch.ops import upsample as tupsample

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-5}


def both(fn_j, fn_t, *arrays, **kw):
    """Run a JAX and a torch function on the same numpy inputs."""
    out_j = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    out_t = fn_t(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
                 **kw)
    return out_j, out_t


def close(out_j, out_t, **tol):
    np.testing.assert_allclose(np.asarray(out_t, np.float32),
                               np.asarray(out_j, np.float32), **(tol or TOL))


@pytest.mark.parametrize("name", ["inv2depth", "depth2inv"])
def test_depth_inverse(rng, name):
    x = rng.uniform(-1.0, 5.0, size=(2, 6, 8, 1)).astype(np.float32)
    x[0, 0, :3, 0] = [0.0, -0.5, 1e-7]       # non-positive and tiny values
    close(*both(getattr(jdepth, name), getattr(tdepth, name), x))


def test_disp_to_depth_clamps_straight_through(rng):
    disp = rng.uniform(-0.5, 1.5, size=(2, 5, 7, 1)).astype(np.float32)
    (sj, dj), (st, dt) = both(jdepth.disp_to_depth, tdepth.disp_to_depth,
                              disp, min_depth=0.1, max_depth=100.0)
    close(sj, st)
    close(dj, dt, atol=1e-4, rtol=1e-5)      # depth reaches 100: 1e-6 rel
    assert float(st.min()) >= 1.0 / 100.0 - 1e-7
    # identity gradient through the clamp, including outside [0, 1]
    x = torch.from_numpy(disp).requires_grad_()
    tdepth.disp_to_depth(x, 0.1, 100.0)[0].sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 10.0 - 0.01, rtol=1e-6)


def test_euler_to_matrix(rng):
    ang = rng.uniform(-np.pi, np.pi, size=(4, 3, 3)).astype(np.float32)
    close(*both(jrot.euler_to_matrix, trot.euler_to_matrix, ang))


def test_pose_vec_to_mat_and_inverse(rng):
    vec = rng.normal(size=(2, 3, 6)).astype(np.float32)
    mj, mt = both(jpose.pose_vec_to_mat, tpose.pose_vec_to_mat, vec)
    close(mj, mt)
    close(jpose.invert_pose(mj), tpose.invert_pose(mt))
    close(jpose.Pose.from_vec(jnp.asarray(vec), "euler").mat,
          tpose.Pose.from_vec(torch.from_numpy(vec), "euler").mat)
    eye = tpose.invert_pose(mt) @ mt
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)


def test_pixel_grid():
    close(jcam.pixel_grid(5, 7), tcam.pixel_grid(5, 7))


def test_scale_and_invert_intrinsics(rng):
    K = np.zeros((3, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(50, 200, 3), rng.uniform(50, 200, 3)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = rng.uniform(20, 60, 3), rng.uniform(10, 40, 3), 1.0
    sj = jcam.scale_intrinsics(jnp.asarray(K), 0.125)
    st = tcam.scale_intrinsics(torch.from_numpy(K), 0.125)
    close(sj, st)
    close(jcam.invert_intrinsics(sj), tcam.invert_intrinsics(st))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample(rng, dtype):
    """bf16 images: both sides cast the fp32 weights to bf16 and sum the taps
    in bf16 in the same order; 1e-5 still holds except where a rounding
    differs, so the bar is one bf16 step (2^-7 relative to values near 3)."""
    img = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)
    coords = rng.uniform(-2.0, 11.0, size=(2, 4, 7, 2))
    coords[0, 0] = np.stack([np.arange(7) - 1.0, np.full(7, 2.0)], -1)  # integers
    coords = coords.astype(np.float32)
    out_j = jresample.bilinear_sample(jnp.asarray(img).astype(dtype),
                                      jnp.asarray(coords))
    out_t = tresample.bilinear_sample(
        torch.from_numpy(img).to(getattr(torch, dtype)), torch.from_numpy(coords))
    assert out_t.dtype == getattr(torch, dtype)
    close(out_j, out_t.float(), **(TOL if dtype == "float32" else {"atol": 3e-2, "rtol": 0}))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape", [(12, 18), (3, 4), (6, 9)])
def test_resize_bilinear(rng, align_corners, shape):
    img = rng.normal(size=(2, 6, 9, 4)).astype(np.float32)
    close(*both(jimage.resize_bilinear, timage.resize_bilinear, img,
                shape=shape, align_corners=align_corners))


def test_neighborhood_3x3(rng):
    x = rng.normal(size=(2, 5, 6, 1)).astype(np.float32)
    close(*both(jupsample.neighborhood_3x3, tupsample.neighborhood_3x3, x))


@pytest.mark.parametrize("mask_dtype", ["float32", "bfloat16"])
def test_convex_upsample(rng, mask_dtype):
    """fp32: 1e-5. bf16 mask: both sides run the softmax in bf16 and round
    at other places, so the blend may differ by a few bf16 steps of the
    weights (2^-8 relative) on depths of order 1: 2e-2."""
    depth = rng.uniform(0.5, 2.0, size=(3, 2, 4, 5, 1)).astype(np.float32)
    mask = rng.normal(size=(3, 2, 4, 5, 9 * 16)).astype(np.float32)
    jm = jnp.asarray(mask).astype(mask_dtype)
    tm = torch.from_numpy(mask).to(getattr(torch, mask_dtype))
    out_j = jupsample.convex_upsample(jnp.asarray(depth), jm, ratio=4)
    out_t = tupsample.convex_upsample(torch.from_numpy(depth), tm, ratio=4)
    assert out_t.shape == (3, 2, 16, 20, 1) and out_t.dtype == torch.float32
    tol = TOL if mask_dtype == "float32" else {"atol": 2e-2, "rtol": 0}
    close(out_j, out_t, **tol)
