"""The port's rotation library against the JAX package's (CPU, fp32).

Every function of `dro_sfm_torch/geometry/rotations.py` on the same seeded
numpy inputs as its counterpart in `dro_sfm_tpu/geometry/rotations.py`,
within 1e-5 (absolute, on values of order 1): the twelve euler conventions
both ways, angles near 0 and near pi, and the sign rule of quaternion
standardisation. Round trips against the angles drawn (not a comparison
with JAX) allow 1e-4, fp32's reach through an arc sine or an arc tangent.
The random draws take a `torch.Generator` where JAX takes a key, so they
are held by their properties (unit norm, a non-negative real part,
orthogonal matrices with determinant 1), not by their values.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dro_sfm_tpu.geometry.rotations as jrot
import dro_sfm_torch.geometry.rotations as trot

TOL = 1e-5
CONVENTIONS = ["".join(c) for c in itertools.product("XYZ", repeat=3)
               if c[1] not in (c[0], c[2])]


def same(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def rotations(rng, n=64):
    """Random rotation matrices, plus the identity and rotations by angles
    near 0 and near pi."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.concatenate([rng.uniform(-np.pi, np.pi, n - 8),
                            [0.0, 1e-7, 1e-5, 1e-3, np.pi - 1e-3, np.pi - 1e-5, np.pi, -np.pi]])
    aa = (axis * angle[:, None]).astype(np.float32)
    return np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa))), aa


def test_conventions_are_twelve():
    assert len(CONVENTIONS) == 12


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_both_ways(convention):
    rng = np.random.default_rng(1)
    angles = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    # away from gimbal lock: the central angle off 0 and +-pi/2 (or 0, pi)
    if convention[0] == convention[2]:
        angles[:, 1] = rng.uniform(0.2, np.pi - 0.2, 64)
    else:
        angles[:, 1] = rng.uniform(-np.pi / 2 + 0.2, np.pi / 2 - 0.2, 64)
    mat = trot.euler_angles_to_matrix(torch.from_numpy(angles), convention)
    same(mat, jrot.euler_angles_to_matrix(jnp.asarray(angles), convention))
    mats, _ = rotations(rng)
    for m in (mat.numpy(), mats):
        same(trot.matrix_to_euler_angles(torch.from_numpy(m), convention),
             jrot.matrix_to_euler_angles(jnp.asarray(m), convention))
    # round trip away from gimbal lock
    same(trot.matrix_to_euler_angles(mat, convention), angles, 1e-4)


@pytest.mark.parametrize("bad", ["XY", "XXY", "XYY", "XAZ", "XYZW"])
def test_invalid_conventions_raise_as_in_jax(bad):
    a = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jrot.euler_angles_to_matrix(jnp.asarray(a), bad)
    with pytest.raises(ValueError) as got:
        trot.euler_angles_to_matrix(torch.from_numpy(a), bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        trot.matrix_to_euler_angles(torch.zeros(2, 3, 3), bad)


def test_pose_head_euler_both_ways():
    rng = np.random.default_rng(2)
    angles = rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
    mat = trot.euler_to_matrix(torch.from_numpy(angles))
    same(mat, jrot.euler_to_matrix(jnp.asarray(angles)))
    same(trot.matrix_to_euler(mat), jrot.matrix_to_euler(jnp.asarray(mat.numpy())))
    same(trot.matrix_to_euler(mat), angles, 1e-4)
    # gimbal lock: y = +-pi/2, where x is 0 and z takes the in-plane angle
    lock = np.array([[0.3, np.pi / 2, 0.2], [-0.4, -np.pi / 2, 0.1]], np.float32)
    m = np.asarray(jrot.euler_to_matrix(jnp.asarray(lock)))
    same(trot.matrix_to_euler(torch.from_numpy(m)), jrot.matrix_to_euler(jnp.asarray(m)))


def test_axis_angle_and_quaternions_near_zero_and_pi():
    rng = np.random.default_rng(3)
    mats, aa = rotations(rng)
    q = trot.axis_angle_to_quaternion(torch.from_numpy(aa))
    same(q, jrot.axis_angle_to_quaternion(jnp.asarray(aa)))
    same(trot.axis_angle_to_matrix(torch.from_numpy(aa)), mats)
    same(trot.quaternion_to_axis_angle(q), jrot.quaternion_to_axis_angle(jnp.asarray(q.numpy())))
    same(trot.quaternion_to_matrix(q), jrot.quaternion_to_matrix(jnp.asarray(q.numpy())))
    tq = trot.matrix_to_quaternion(torch.from_numpy(mats))
    jq = np.asarray(jrot.matrix_to_quaternion(jnp.asarray(mats)))
    # at an angle of pi the real part is 0 and q, -q are the same rotation:
    # both packages pick the sign from the same fp32 entries
    same(tq, jq)
    same(trot.matrix_to_axis_angle(torch.from_numpy(mats)),
         jrot.matrix_to_axis_angle(jnp.asarray(mats)))
    # the round trip away from pi
    keep = np.linalg.norm(aa, axis=1) < np.pi - 1e-2
    same(trot.matrix_to_axis_angle(torch.from_numpy(mats[keep])), aa[keep], 1e-4)


def test_standardize_quaternion_sign_rule():
    q = np.array([[-0.5, 0.5, 0.5, 0.5], [0.5, -0.5, 0.5, 0.5], [0.0, -1.0, 0.0, 0.0],
                  [-0.0, 0.0, 1.0, 0.0], [-1e-30, 0.6, 0.8, 0.0]], np.float32)
    got = trot.standardize_quaternion(torch.from_numpy(q))
    want = np.asarray(jrot.standardize_quaternion(jnp.asarray(q)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))
    assert got[0, 0] > 0 and got[2, 1] == -1.0 and got[4, 0] > 0


def test_quaternion_products_and_apply():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(32, 4)).astype(np.float32)
    b = rng.normal(size=(32, 4)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    same(trot.quaternion_raw_multiply(ta, tb), jrot.quaternion_raw_multiply(ja, jb))
    same(trot.quaternion_multiply(ta, tb), jrot.quaternion_multiply(ja, jb))
    assert (trot.quaternion_multiply(ta, tb)[:, 0] >= 0).all()
    same(trot.quaternion_invert(ta), jrot.quaternion_invert(ja))
    p = rng.normal(size=(32, 3)).astype(np.float32)
    got = trot.quaternion_apply(ta, torch.from_numpy(p))
    same(got, jrot.quaternion_apply(ja, jnp.asarray(p)))
    same(got, np.einsum("nij,nj->ni", np.asarray(jrot.quaternion_to_matrix(ja)), p))


def test_rotation_6d_both_ways():
    rng = np.random.default_rng(5)
    d6 = rng.normal(size=(32, 6)).astype(np.float32)
    mat = trot.rotation_6d_to_matrix(torch.from_numpy(d6))
    same(mat, jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    same(trot.matrix_to_rotation_6d(mat), jrot.matrix_to_rotation_6d(jnp.asarray(mat.numpy())))
    same(trot.rotation_6d_to_matrix(trot.matrix_to_rotation_6d(mat)), mat.numpy())


def test_batch_dims_and_vmap():
    """Leading batch dims of any rank, and `torch.func.vmap`."""
    rng = np.random.default_rng(6)
    aa = rng.normal(size=(2, 3, 3)).astype(np.float32)
    got = trot.axis_angle_to_matrix(torch.from_numpy(aa))
    assert got.shape == (2, 3, 3, 3)
    same(got, jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    mapped = torch.func.vmap(trot.matrix_to_quaternion)(got.reshape(6, 3, 3))
    same(mapped, jrot.matrix_to_quaternion(jnp.asarray(got.numpy().reshape(6, 3, 3))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_rotations_properties(dtype):
    gen = torch.Generator().manual_seed(0)
    q = trot.random_quaternions(gen, 1000, dtype)
    assert q.shape == (1000, 4) and q.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    assert torch.allclose(q.norm(dim=1), torch.ones(1000, dtype=dtype), atol=tol)
    assert (q[:, 0] >= 0).all()
    R = trot.random_rotations(gen, 1000, dtype)
    eye = torch.eye(3, dtype=dtype).expand(1000, 3, 3)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=10 * tol)
    assert torch.allclose(torch.linalg.det(R), torch.ones(1000, dtype=dtype), atol=10 * tol)
    # uniform on SO(3): the mean of the matrices tends to 0
    assert R.mean(0).abs().max() < 0.1
    one = trot.random_rotation(gen, dtype)
    assert one.shape == (3, 3) and torch.allclose(one @ one.T, eye[0], atol=10 * tol)
    # the same seed draws the same rotations
    again = trot.random_rotations(torch.Generator().manual_seed(0), 3, dtype)
    first = trot.random_rotations(torch.Generator().manual_seed(0), 3, dtype)
    assert torch.equal(again, first)
