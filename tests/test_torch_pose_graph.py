"""The port's pose-graph optimization against the JAX package's (CPU, fp32).

`build_normal_equations` (with repeated edges, which both must sum, and
weights), `optimize_pose_graph` (least squares and the IRLS Cauchy
reweighting at c = 0.15, on noisy measurements with an outlier edge) and
`total_edge_error` of `dro_sfm_torch/ba/pose_graph.py` against
`dro_sfm_tpu/ba/pose_graph.py` on the same seeded inputs. Bars: H and b
within 1e-4 of JAX's relative to their largest entry (fp32 sums of
Jacobian products in another order), poses within 1e-4 and the edge error
within 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dro_sfm_tpu.ba.lie as jlie
import dro_sfm_tpu.ba.pose_graph as jpg
import dro_sfm_torch.ba.pose_graph as tpg


def graph(seed=0, k=7, noise=0.05, meas_noise=0.0):
    """A trajectory's noisy poses, edges with repeats and loops, and the
    measurements (exact, or with ``meas_noise`` and one outlier edge)."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(k - 1):
        xi = np.concatenate([rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.15])
        gt.append(gt[-1] @ np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32))))
    gt = np.stack(gt)
    ei = np.array(list(range(k - 1)) + [0, 2, 1, 1, 3], np.int64)
    ej = np.array(list(range(1, k)) + [4, 6, 2, 2, 5], np.int64)   # (1, 2) three times
    Z = np.linalg.inv(gt[ei]) @ gt[ej]
    if meas_noise:
        dz = rng.normal(size=(len(ei), 6)) * meas_noise
        dz[-1] *= 20.0                                             # an outlier edge
        Z = Z @ np.asarray(jlie.se3_exp(jnp.asarray(dz, jnp.float32)))
    dx = rng.normal(size=(k, 6)) * noise
    dx[0] = 0.0
    init = gt @ np.asarray(jlie.se3_exp(jnp.asarray(dx, jnp.float32)))
    weights = rng.uniform(0.5, 1.5, len(ei))
    return {"init": init.astype(np.float32), "ei": ei, "ej": ej, "Z": Z.astype(np.float32),
            "w": weights.astype(np.float32), "gt": gt}


def jax_args(g):
    return (jnp.asarray(g["init"]), jnp.asarray(g["ei"], jnp.int32),
            jnp.asarray(g["ej"], jnp.int32), jnp.asarray(g["Z"]))


def torch_args(g):
    return (torch.from_numpy(g["init"]), torch.from_numpy(g["ei"]),
            torch.from_numpy(g["ej"]), torch.from_numpy(g["Z"]))


def test_normal_equations_sum_repeated_edges():
    g = graph()
    H, b = tpg.build_normal_equations(*torch_args(g), torch.from_numpy(g["w"]))
    Hj, bj = jpg.build_normal_equations(*jax_args(g), jnp.asarray(g["w"]))
    Hj, bj = np.asarray(Hj), np.asarray(bj)
    assert H.shape == (42, 42) and b.shape == (42,)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=0, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(b.numpy(), bj, rtol=0, atol=1e-4 * np.abs(bj).max())
    # the repeated edge counts three times: drop two copies and H changes
    keep = np.ones(len(g["ei"]), bool)
    keep[-2:-1] = False
    H2, _ = tpg.build_normal_equations(torch.from_numpy(g["init"]),
                                       torch.from_numpy(g["ei"][keep]),
                                       torch.from_numpy(g["ej"][keep]),
                                       torch.from_numpy(g["Z"][keep]),
                                       torch.from_numpy(g["w"][keep]))
    assert (H - H2)[6:18, 6:18].abs().max() > 1e-2


@pytest.mark.parametrize("robust_c,meas_noise", [(0.0, 0.0), (0.0, 0.02), (0.15, 0.02)])
def test_optimize_pose_graph_matches_jax(robust_c, meas_noise):
    g = graph(seed=1, meas_noise=meas_noise)
    got = tpg.optimize_pose_graph(*torch_args(g), weights=torch.from_numpy(g["w"]), iters=10,
                                  robust_c=robust_c)
    want = np.asarray(jpg.optimize_pose_graph(*jax_args(g), weights=jnp.asarray(g["w"]),
                                              iters=10, robust_c=robust_c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert torch.equal(got[0], torch.from_numpy(g["init"][0]))       # the anchor
    if meas_noise == 0.0:
        np.testing.assert_allclose(got.numpy(), g["gt"], rtol=0, atol=1e-3)


def test_default_weights_and_anchor():
    g = graph(seed=2)
    got = tpg.optimize_pose_graph(*torch_args(g), iters=4, anchor=3)
    want = np.asarray(jpg.optimize_pose_graph(*jax_args(g), iters=4, anchor=3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert torch.equal(got[3], torch.from_numpy(g["init"][3]))


def test_total_edge_error_matches_jax():
    g = graph(seed=3, meas_noise=0.02)
    got = float(tpg.total_edge_error(*torch_args(g)))
    want = float(jpg.total_edge_error(*jax_args(g)))
    assert got == pytest.approx(want, rel=1e-5)
    refined = tpg.optimize_pose_graph(*torch_args(g), iters=10)
    assert float(tpg.total_edge_error(refined, *torch_args(g)[1:])) < got
