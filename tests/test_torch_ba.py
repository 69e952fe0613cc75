"""The port's dense bundle adjustment against the JAX package's (CPU, fp32).

The problem is `tests/test_ba.py:_ba_problem`'s (4 keyframes of the wavy
surface at 24x32, every ordered pair an edge) with the same seeded pose
noise as its tests, in both packages. Bars, each against JAX on the same
inputs:

* residuals within 1e-6; Jacobians within 5e-5 (the largest entry is
  about 1.3) where the four taps of the sample lie inside the image, and
  within 1e-2 where the sample straddles the border (there both fp32
  Jacobians lie up to 5e-3 from the fp64 one, `test_edge_residual_and_
  jacobians`);
* H and b within 1e-5 of their largest entry; the Schur solve of JAX's H
  and b within 1e-5;
* the cost within 1e-5 relative;
* `optimize_dense_ba` over 6 iterations, with and without the LM guard:
  poses within 1e-4, log-scales within 1e-5, and the guard's accept
  sequence equal to JAX's (read from JAX's own loop through a callback on
  its cost);
* `pool_depth` bit for bit; a one-stage schedule equal to the plain
  optimizer bit for bit (as `tests/test_ba.py` holds JAX's) and to JAX's
  schedule within the optimizer's bars; the GNC and coarse-to-fine
  schedules, `estimate_edge_relatives` and the robust pipeline within the
  same bars (weights within 1e-4 relative: a weight divides the mean
  residual by 0.01).

At 32 keyframes of 48x64 (the benchmark's problem from
`tools/torch_bench_ba.py`, whose numpy copy of the JAX tests' problem is
held bit for bit here): 6 iterations with JAX's accepts and within fp32's
reach on this problem, 5e-4 on poses and 5e-5 on log-scales (its
Schur-reduced system amplifies summation-order rounding about 100x in 6
iterations; JAX's own fp32 run lies 2.8e-4 from the port's fp64 one); the
port alone: the LM guard never ends above its start, and 24 iterations cut
the ATE at least 4.5x with the scales within 0.015,
`tests/test_ba.py:245-286`'s bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dro_sfm_tpu.ba.dense_ba as J
from dro_sfm_tpu.ba.lie import se3_exp as jse3_exp
import dro_sfm_torch.ba.dense_ba as T
from dro_sfm_torch.visualization.trajectory import absolute_trajectory_error
from tests.test_ba import _ba_problem, _trajectory_problem
from tools.torch_bench_ba import build_problem, trajectory_problem

POSE_TOL, SCALE_TOL = 1e-4, 1e-5


def noisy(seed=0, sigma=0.04, k=4, **kw):
    """`_ba_problem` with `tests/test_ba.py`'s pose noise, in both packages."""
    rng = np.random.default_rng(seed)
    jp, gt = _ba_problem(rng, k=k, **kw)
    noise = jnp.asarray(rng.normal(size=(k, 6)) * sigma, jnp.float32).at[0].set(0.0)
    jp = jp._replace(poses=jp.poses @ jse3_exp(noise))
    tp = T.BAProblem(*(torch.from_numpy(np.array(x)) for x in jp))
    return jp, tp


@pytest.fixture(scope="module")
def problem():
    return noisy()


def close(got, want, tol, rel_to=None):
    want = np.asarray(want)
    scale = 1.0 if rel_to is None else float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


def all_taps_inside(jp, stride):
    """[E, M]: whether the four taps of a pixel's sample lie inside frame j
    (projected in fp64 from JAX's inputs)."""
    K = np.asarray(jp.K, np.float64)
    h, w = jp.depths.shape[1:]
    ys, xs = np.meshgrid(np.arange(0, h, stride), np.arange(0, w, stride), indexing="ij")
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    out = []
    for i, j in zip(np.asarray(jp.edges_i), np.asarray(jp.edges_j)):
        pts = rays * np.asarray(jp.depths[i], np.float64)[::stride, ::stride, None]
        rel = np.linalg.inv(np.asarray(jp.poses[j], np.float64)) @ np.asarray(jp.poses[i],
                                                                               np.float64)
        proj = (pts @ rel[:3, :3].T + rel[:3, 3]) @ K.T
        u, v = (np.floor(proj[..., a] / proj[..., 2]) for a in (0, 1))
        out.append(((u >= 0) & (u + 1 < w) & (v >= 0) & (v + 1 < h)).reshape(-1))
    return np.stack(out)


@pytest.mark.parametrize("stride", [1, 2])
def test_edge_residual_and_jacobians(problem, stride):
    """Every edge's residuals and Jacobians, entry by entry. Where a sample
    straddles the image border, d_j is the in-image taps' average
    renormalised by their weight sum, and its derivative divides by that
    sum squared: there fp32 rounding grows to about 5e-3 in both packages
    (JAX's fp32 Jacobian against fp64), so those pixels have their own bar."""
    jp, tp = problem
    zero = jnp.zeros(7)

    def one(ti, tj, di, dj):
        def fn(pi, pj):
            return J._edge_residual(pi, pj, ti, tj, di, dj, jp.K, stride)
        return (fn(zero, zero), jax.jacfwd(fn, argnums=0)(zero, zero),
                jax.jacfwd(fn, argnums=1)(zero, zero))

    want = jax.jit(jax.vmap(one))(jp.poses[jp.edges_i], jp.poses[jp.edges_j],
                                  jp.depths[jp.edges_i], jp.depths[jp.edges_j])
    got = T._edge_system(tp.poses[tp.edges_i], tp.poses[tp.edges_j],
                         tp.depths[tp.edges_i], tp.depths[tp.edges_j], tp.K, stride, 0.0)
    close(got[0], want[0], 1e-6)
    inside = all_taps_inside(jp, stride)
    assert inside.mean() > 0.8
    for g, w_ in zip(got[1:], want[1:]):
        err = np.abs(g.numpy() - np.asarray(w_)).max(-1)
        assert err[inside].max() <= 5e-5 and err[~inside].max() <= 1e-2, (
            err[inside].max(), err[~inside].max())
    assert (got[0] != 0).float().mean() > 0.5 and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("robust_c", [0.0, 0.25])
def test_accumulate_schur_and_cost(problem, robust_c):
    jp, tp = problem
    H, b = T._accumulate(tp, 1, robust_c)
    Hj, bj = jax.jit(J._accumulate, static_argnums=(1, 2))(jp, 1, robust_c)
    assert H.shape == (4, 7, 4, 7) and b.shape == (4, 7)
    close(H, Hj, 1e-5, rel_to=True)
    close(b, bj, 1e-5, rel_to=True)
    Hj_t, bj_t = torch.from_numpy(np.array(Hj)), torch.from_numpy(np.array(bj))
    for lam in (1e-2, 4e-2):
        dxi, dsig = T._schur_solve(Hj_t, bj_t, 4, lam, 0)
        dxi_j, dsig_j = J._schur_solve(Hj, bj, 4, lam, 0)
        close(dxi, dxi_j, 1e-5, rel_to=True)
        close(dsig, dsig_j, 1e-5, rel_to=True)
        assert torch.all(dxi[0] == 0) and dsig[0] == 0
    cost = float(T._total_cost(tp, 2, robust_c))
    assert cost == pytest.approx(float(J._total_cost(jp, 2, robust_c)), rel=1e-5)


def jax_run(jp, stride, iters, robust_c, max_step, lm_guard):
    """JAX's `_gn_loop` as `optimize_dense_ba` runs it, with its accept
    sequence read from the costs it computes (a callback on its cost_fn)."""
    costs = []

    def cost_fn(p):
        c = J._total_cost(p, stride, robust_c)
        jax.debug.callback(lambda v: costs.append(np.float32(v)), c, ordered=True)
        return c

    fn = jax.jit(lambda prob: J._gn_loop(
        prob, lambda p: J._accumulate(p, stride, robust_c), iters, 1e-2, 0, max_step,
        cost_fn=cost_fn if lm_guard else None))
    poses, sigmas = fn(jp)
    accepts, cost = [], costs[0] if costs else None
    for c in costs[1:]:
        accepts.append(bool(c <= cost))
        cost = c if accepts[-1] else cost
    return np.array(poses), np.array(sigmas), accepts


@pytest.mark.parametrize("lm_guard", [True, False])
@pytest.mark.parametrize("stride,robust_c,max_step", [(1, 0.25, 0.05), (2, 0.5, 0.15)])
def test_optimize_dense_ba_matches_jax(problem, lm_guard, stride, robust_c, max_step):
    jp, tp = problem
    kw = dict(stride=stride, iters=6, robust_c=robust_c, max_step=max_step, lm_guard=lm_guard)
    poses, sigmas = T.optimize_dense_ba(tp, **kw)
    want_p, want_s = (np.asarray(x) for x in J.optimize_dense_ba(jp, **kw))
    close(poses, want_p, POSE_TOL)
    close(sigmas, want_s, SCALE_TOL)
    # the accept sequence, from both loops
    cb_p, cb_s, want_acc = jax_run(jp, stride, 6, robust_c, max_step, lm_guard)
    close(torch.from_numpy(cb_p), want_p, 1e-6)
    p2, s2, acc = T._gn_loop(tp, lambda p: T._accumulate(p, stride, robust_c), 6, 1e-2, 0,
                             max_step, (lambda p: T._total_cost(p, stride, robust_c))
                             if lm_guard else None)
    assert torch.equal(p2, poses) and torch.equal(s2, sigmas)
    if lm_guard:
        assert acc.tolist() == want_acc and len(want_acc) == 6
    else:
        assert acc is None and want_acc == []


def test_lm_guard_rejects_like_jax_from_far():
    """From well outside the basin (twist noise 0.25) the guard rejects
    steps: the same decisions as JAX's."""
    jp, tp = noisy(seed=3, sigma=0.25)
    cb_p, cb_s, want_acc = jax_run(jp, 2, 6, 0.25, 0.1, True)
    p, s, acc = T._gn_loop(tp, lambda q: T._accumulate(q, 2, 0.25), 6, 1e-2, 0, 0.1,
                           lambda q: T._total_cost(q, 2, 0.25))
    assert acc.tolist() == want_acc and not all(want_acc)
    close(p, cb_p, POSE_TOL)
    close(s, cb_s, SCALE_TOL)


def test_pool_depth_bit_exact():
    rng = np.random.default_rng(2)
    d = rng.uniform(1.0, 9.0, (3, 26, 34)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = 0.0
    d[0, :4, :4] = 0.0                                       # a cell with no valid tap
    for factor in (1, 2, 4):
        got = T.pool_depth(torch.from_numpy(d), factor)
        want = np.asarray(J.pool_depth(jnp.asarray(d), factor))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want), factor
    t = torch.from_numpy(d)
    assert T.pool_depth(t, 1) is t


def test_one_stage_schedule_equals_plain(problem):
    jp, tp = problem
    p1, s1 = T.optimize_dense_ba(tp, stride=2, iters=4, robust_c=0.25, max_step=0.1)
    p2, s2 = T.optimize_dense_ba_scheduled(tp, stages=((1, 0.25, 4, 0.1),), stride=2)
    assert torch.equal(p1, p2) and torch.equal(s1, s2)
    want_p, want_s = J.optimize_dense_ba_scheduled(jp, stages=((1, 0.25, 4, 0.1),), stride=2)
    close(p2, want_p, POSE_TOL)
    close(s2, want_s, SCALE_TOL)


@pytest.mark.parametrize("schedule", ["gnc", "c2f"])
def test_schedules_match_jax(schedule):
    jp, tp = noisy(seed=3, sigma=0.06, h=32, w=48)
    if schedule == "gnc":
        stages = tuple((f, c, 4, s) for f, c, _, s in J.GNC_STAGES)
        got = T.optimize_dense_ba_scheduled(tp, stages=stages, stride=2)
        want = J.optimize_dense_ba_scheduled(jp, stages=stages, stride=2)
    else:
        got = T.optimize_dense_ba_c2f(tp, iters=3, stride=1)
        want = J.optimize_dense_ba_c2f(jp, iters=3, stride=1)
    close(got[0], want[0], POSE_TOL)
    close(got[1], want[1], SCALE_TOL)
    assert T.GNC_STAGES == J.GNC_STAGES and T.C2F_STAGES == J.C2F_STAGES
    assert T.EDGE_STAGES == J.EDGE_STAGES


@pytest.fixture(scope="module")
def relatives():
    """Both packages' two-frame alignments of a problem with twist noise 0.12."""
    jp, tp = noisy(seed=4, sigma=0.12)
    stages = ((2.0, 10, 0.5), (0.25, 4, 0.15))
    got = T.estimate_edge_relatives(tp, stride=2, stages=stages)
    want = J.estimate_edge_relatives(jp, stride=2, stages=stages)
    return jp, tp, got, want


def test_estimate_edge_relatives_match_jax(relatives):
    _, _, (meas, w), (meas_j, w_j) = relatives
    close(meas, meas_j, POSE_TOL)
    # a weight divides the mean residual by 0.01, which scales its rounding
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4)
    assert (w > 0).all()


def test_robust_pipeline_matches_jax():
    jp, tp = noisy(seed=4, sigma=0.12)
    stages = ((1, 2.0, 3, 0.3), (1, 0.25, 3, 0.1))
    got = T.optimize_dense_ba_robust(tp, stages=stages, stride=2, pgo_iters=5)
    want = J.optimize_dense_ba_robust(jp, stages=stages, stride=2, pgo_iters=5)
    close(got[0], want[0], POSE_TOL)
    close(got[1], want[1], SCALE_TOL)


def test_bench_problem_copy_is_bit_exact():
    """`tools/torch_bench_ba.py`'s numpy problem is `tests/test_ba.py`'s."""
    jp, gt = _trajectory_problem(np.random.default_rng(0), k=9, h=12, w=16)
    poses, depths, K, ei, ej = trajectory_problem(9, 12, 16)
    for got, want in ((poses, gt), (poses, jp.poses), (depths, jp.depths), (K, jp.K),
                      (ei, jp.edges_i), (ej, jp.edges_j)):
        assert np.array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def bench32():
    return build_problem(32, 48, 64)


def test_bench_problem_matches_jax_within_fp32_reach(bench32, capsys):
    """32 keyframes, 6 iterations: the same accepts as JAX, and poses and
    log-scales within fp32's reach on this problem (the bars of
    `chip_smoke.py`'s card-against-CPU check). The JAX package's fp32 run
    lies that far from the port's fp64 one too (printed; run with -s)."""
    problem, _, _ = bench32
    jp = J.BAProblem(*(jnp.asarray(t.numpy()) for t in problem))
    want_p, want_s, want_acc = jax_run(jp, 2, 6, 0.25, 0.05, True)
    p, s, acc = T._gn_loop(problem, lambda q: T._accumulate(q, 2, 0.25), 6, 1e-2, 0, 0.05,
                           lambda q: T._total_cost(q, 2, 0.25))
    assert acc.tolist() == want_acc
    close(p, want_p, 5e-4)
    close(s, want_s, 5e-5)
    p64, s64 = T.optimize_dense_ba(T.BAProblem(*(t.double() if t.is_floating_point() else t
                                                 for t in problem)), stride=2, iters=6)
    with capsys.disabled():
        print(f"\nk=32, 6 iterations, from the port's fp64 run: JAX fp32 poses "
              f"{np.abs(want_p - p64.numpy()).max():.3e}, log-scales "
              f"{np.abs(want_s - s64.numpy()).max():.3e}; the port's fp32 "
              f"{float((p.double() - p64).abs().max()):.3e} / "
              f"{float((s.double() - s64).abs().max()):.3e}")


def test_lm_guard_monotone_cost(bench32):
    problem, _, _ = bench32
    far = problem._replace(poses=problem.poses @ T.se3_exp(
        torch.from_numpy(np.random.default_rng(5).normal(size=(32, 6)).astype(np.float32)
                         * 0.15) * torch.arange(32).clamp_max(1)[:, None]))
    cost0 = float(T._total_cost(far, 2, 0.25))
    poses, sigmas = T.optimize_dense_ba(far, stride=2, iters=4, robust_c=0.25, max_step=0.1)
    refined = far._replace(poses=poses, depths=far.depths * torch.exp(sigmas)[:, None, None])
    assert float(T._total_cost(refined, 2, 0.25)) <= cost0 * (1 + 1e-6)


def test_ate_cut_at_24_iterations(bench32):
    problem, gt, scale_noise = bench32
    ate0 = absolute_trajectory_error(list(problem.poses.numpy()), list(gt))
    poses, sigmas = T.optimize_dense_ba(problem, stride=2, iters=24, damping=1e-2,
                                        max_step=0.1)
    ate1 = absolute_trajectory_error(list(poses.numpy()), list(gt))
    assert ate1 < ate0 / 4.5, (ate0, ate1)
    np.testing.assert_allclose(np.exp(sigmas.numpy()) * scale_noise, 1.0, atol=0.015)
