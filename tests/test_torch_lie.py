"""The port's SO(3)/SE(3) maps against the JAX package's (CPU, fp32).

`hat`, `so3_exp`, `so3_log`, `se3_exp` and `se3_log` of
`dro_sfm_torch/ba/lie.py` on the same seeded inputs as
`dro_sfm_tpu/ba/lie.py`, at rotation angles 0, 1e-6 (below the series
threshold), moderate and near pi, within 1e-5. The forward-mode Jacobian at
the zero twist (where Gauss-Newton takes it) must be finite and equal to
JAX's within 1e-5; the unguarded map's is NaN, which is why the guards are
there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import dro_sfm_tpu.ba.lie as jlie
import dro_sfm_torch.ba.lie as tlie

TOL = 1e-5


def same(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def twists(angle, n=8, seed=0):
    """[n, 6] twists with rotation angle ``angle`` and translations of order 1."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)), axis * angle], 1).astype(np.float32)


ANGLES = [0.0, 1e-6, 0.3, 1.7, np.pi - 1e-3]


def test_hat():
    phi = twists(0.7)[:, 3:]
    same(tlie.hat(torch.from_numpy(phi)), jlie.hat(jnp.asarray(phi)), 0)


@pytest.mark.parametrize("angle", ANGLES)
def test_exp_and_log(angle):
    xi = twists(angle)
    T = tlie.se3_exp(torch.from_numpy(xi))
    same(T, jlie.se3_exp(jnp.asarray(xi)))
    same(tlie.so3_exp(torch.from_numpy(xi[:, 3:])), jlie.so3_exp(jnp.asarray(xi[:, 3:])))
    Tn = T.numpy()
    same(tlie.se3_log(T), jlie.se3_log(jnp.asarray(Tn)))
    same(tlie.so3_log(T[:, :3, :3]), jlie.so3_log(jnp.asarray(Tn[:, :3, :3])))
    if angle < 3.0:                                   # the round trip, away from pi
        same(tlie.se3_log(T), xi, 1e-4)


@pytest.mark.parametrize("angle", [0.0, 1e-6, 0.3])
def test_forward_jacobian_at_zero_matches_jax(angle):
    """d/dxi log(T0 exp(xi)) at xi = 0: finite, and JAX's."""
    T0 = np.array(jlie.se3_exp(jnp.asarray(twists(angle, n=1, seed=3)[0])))

    def t_fn(xi):
        return tlie.se3_log(torch.from_numpy(T0) @ tlie.se3_exp(xi))

    def j_fn(xi):
        return jlie.se3_log(jnp.asarray(T0) @ jlie.se3_exp(xi))

    got = jacfwd(t_fn)(torch.zeros(6))
    want = jax.jacfwd(j_fn)(jnp.zeros(6))
    assert torch.isfinite(got).all()
    same(got, want)
    rot = jacfwd(lambda p: tlie.so3_log(tlie.so3_exp(p)))(torch.zeros(3))
    same(rot, jax.jacfwd(lambda p: jlie.so3_log(jlie.so3_exp(p)))(jnp.zeros(3)))
    same(rot, np.eye(3))


def test_unguarded_angle_has_nan_tangent_at_zero():
    """The reason for the double `where`: sqrt's tangent at 0 is NaN."""
    _, jvp_out = torch.func.jvp(lambda p: torch.sqrt((p * p).sum()), (torch.zeros(3),),
                                (torch.ones(3),))
    assert torch.isnan(jvp_out)


def test_vmap_over_twists():
    xi = twists(0.5, n=5)
    got = torch.func.vmap(tlie.se3_exp)(torch.from_numpy(xi))
    same(got, jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
