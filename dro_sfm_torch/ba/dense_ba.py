"""Dense bundle adjustment with Schur-complement reduction.

PyTorch counterpart of `dro_sfm_tpu/ba/dense_ba.py`: refine keyframe poses
and per-keyframe depth scales over a covisibility graph by minimising dense
depth-reprojection consistency, with the structure variables (the scales)
eliminated by an exact Schur complement.

Model
-----
Parameters per keyframe i: a pose twist xi_i in se(3) (T_i <- T_i0
exp(xi_i)) and a log depth scale sigma_i (D_i <- e^{sigma_i} D_i). For each
covisibility edge (i, j), a static pixel subgrid of frame i is unprojected
with its scaled depth, moved into frame j and compared with frame j's
scaled depth sampled bilinearly at the projection:

    r_p = (z_ij(p) - e^{sigma_j} D_j[pi_j(p)]) * valid(p)

The Gauss-Newton normal equations split into pose blocks A [6K, 6K], scale
blocks C [K, K] and their coupling B [6K, K]; the scales are eliminated
exactly:

    (A - B C^-1 B^T) dxi = -(b_pose - B C^-1 b_scale)

Each edge's Jacobians come from forward-mode AD (`torch.func.jacfwd`) under
`torch.func.vmap` over the edges, as the JAX module takes `jax.jacfwd`
under `jax.vmap`. Every entry point runs with TF32 off (`fp32_matmuls`),
the counterpart of JAX's "highest" matmul precision, and on the device of
its inputs; an iteration waits for the host nowhere (the solves are the
``_ex`` variants, the LM guard's accept is a `torch.where` on the card).

The edge split (`make_sharded_*`, and ``group`` of the schedules) is the
port's counterpart of the JAX module's mesh: each process of a
`torch.distributed` group takes its contiguous slice of the edges, sums its
partial H, b and LM cost with the others' (`parallel.all_reduce_sum`) and
solves the small reduced system itself, the same on every process.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from dro_sfm_torch.ba.lie import se3_exp
from dro_sfm_torch.ba.pose_graph import _inv, anchor_mask, optimize_pose_graph, scatter_blocks
from dro_sfm_torch.ba.precision import fp32_matmuls
from dro_sfm_torch.geometry.camera import scale_intrinsics
from dro_sfm_torch.parallel.collectives import all_reduce_sum


class BAProblem(NamedTuple):
    poses: torch.Tensor        # [K,4,4] camera->world initial estimates
    depths: torch.Tensor       # [K,h,w] keyframe depth maps
    K: torch.Tensor            # [3,3] shared intrinsics (depth resolution)
    edges_i: torch.Tensor      # [E] target keyframe index per edge
    edges_j: torch.Tensor      # [E] source keyframe index per edge


def _edge_residual(params_i, params_j, T_i0, T_j0, D_i, D_j, K, stride):
    """Masked depth-consistency residuals [M] for one edge."""
    xi_i, sigma_i = params_i[:6], params_i[6]
    xi_j, sigma_j = params_j[:6], params_j[6]
    T_i = T_i0 @ se3_exp(xi_i)
    T_j = T_j0 @ se3_exp(xi_j)

    h, w = D_i.shape
    ys = torch.arange(0, h, stride, dtype=D_i.dtype, device=D_i.device)
    xs = torch.arange(0, w, stride, dtype=D_i.dtype, device=D_i.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d = D_i[::stride, ::stride] * torch.exp(sigma_i)

    pix = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    rays = pix @ _inv(K).T
    pts_i = rays * d[..., None]
    rel = _inv(T_j) @ T_i
    pts_j = pts_i @ rel[:3, :3].T + rel[:3, 3]
    proj = pts_j @ K.T
    z = proj[..., 2]
    u = proj[..., 0] / torch.clamp_min(z, 1e-6)
    v = proj[..., 1] / torch.clamp_min(z, 1e-6)

    # Bilinear sample of D_j at (u, v), zeros outside. The spread of the four
    # taps masks samples that straddle a depth discontinuity. The tangents
    # flow through wx and wy; floor and the integer casts carry none.
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    wx = u - x0
    wy = v - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    acc = torch.zeros_like(u)
    wsum = torch.zeros_like(u)
    tap_min = torch.full_like(u, float("inf"))
    tap_max = torch.zeros_like(u)
    for dy, dx, wt in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                       (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = x0i + dx
        yi = y0i + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        val = D_j[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        ok = ok & (val > 0)
        acc = acc + wt * torch.where(ok, val, 0.0)
        wsum = wsum + wt * ok
        tap_min = torch.minimum(tap_min, torch.where(ok, val, float("inf")))
        tap_max = torch.maximum(tap_max, torch.where(ok, val, 0.0))
    d_j = torch.where(wsum > 1e-6, acc / torch.clamp_min(wsum, 1e-6), 0.0)
    smooth = (tap_max - tap_min) < 0.05 * torch.clamp_min(tap_max, 1e-6)

    # The mask is built from detached values: it carries no tangent (JAX's
    # stop_gradient).
    valid = ((d.detach() > 0) & (z.detach() > 1e-3) & (d_j.detach() > 0)
             & smooth.detach()).to(D_i.dtype)
    r = (z - d_j * torch.exp(sigma_j)) / torch.clamp_min(z, 1e-3)
    return (r * valid).reshape(-1)


def _edge_residual_twice(params_i, params_j, T_i0, T_j0, D_i, D_j, K, stride):
    r = _edge_residual(params_i, params_j, T_i0, T_j0, D_i, D_j, K, stride)
    return r, r


def _edge_system(T_i0, T_j0, D_i, D_j, K, stride, robust_c):
    """GN blocks of every edge at zero perturbation: (r [E,M], J_i [E,M,7],
    J_j [E,M,7]) for the edges' poses [E,4,4] and depths [E,h,w].

    Residuals get IRLS Cauchy weights w = 1 / (1 + (r/c)^2), applied as
    sqrt(w) to both r and J, so that depth-discontinuity and occlusion
    outliers do not bias the solution.
    """
    zero = T_i0.new_zeros(7)
    (J_i, J_j), r = vmap(
        jacfwd(_edge_residual_twice, argnums=(0, 1), has_aux=True),
        in_dims=(None, None, 0, 0, 0, 0, None, None))(
            zero, zero, T_i0, T_j0, D_i, D_j, K, stride)
    if robust_c > 0:
        w = torch.sqrt(1.0 / (1.0 + (r / robust_c) ** 2))
        r = r * w
        J_i = J_i * w[..., None]
        J_j = J_j * w[..., None]
    return r, J_i, J_j


def _robust_rho(r: torch.Tensor, robust_c: float) -> torch.Tensor:
    """Cauchy robust cost rho(r) (0.5 r^2 when robust_c == 0): the objective
    whose IRLS linearisation `_edge_system` builds, so a step that raises it
    is one the linearisation did not model (the LM guard rejects it)."""
    if robust_c <= 0:
        return 0.5 * r * r
    return 0.5 * robust_c * robust_c * torch.log1p((r / robust_c) ** 2)


def _residuals(T_i, T_j, D_i, D_j, K, stride) -> torch.Tensor:
    """The residuals [E, M] of edges with poses [E,4,4] and depths [E,h,w]."""
    zero = T_i.new_zeros(7)
    return vmap(_edge_residual, in_dims=(None, None, 0, 0, 0, 0, None, None))(
        zero, zero, T_i, T_j, D_i, D_j, K, stride)


def _total_cost(problem: BAProblem, stride: int, robust_c: float):
    """Total robust cost over all edges at the current estimate. Like the
    JAX module's it is a sum, not normalised by the valid-pixel count."""
    ei, ej = problem.edges_i, problem.edges_j
    r = _residuals(problem.poses[ei], problem.poses[ej], problem.depths[ei],
                   problem.depths[ej], problem.K, stride)
    return _robust_rho(r, robust_c).sum()


def _accumulate(problem: BAProblem, stride: int, robust_c: float = 0.0):
    """Dense normal equations over all edges: H [K,7,K,7], b [K,7]."""
    k = problem.poses.shape[0]
    ei, ej = problem.edges_i, problem.edges_j
    r, J_i, J_j = _edge_system(problem.poses[ei], problem.poses[ej], problem.depths[ei],
                               problem.depths[ej], problem.K, stride, robust_c)
    H = problem.poses.new_zeros((k, 7, k, 7))
    b = problem.poses.new_zeros((k, 7))
    return scatter_blocks(H, b, ei, ej, J_i, J_j, r)


def _schur_solve(H: torch.Tensor, b: torch.Tensor, k: int, damping,
                 anchor: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eliminate the scale block and solve the reduced pose system.

    H [k,7,k,7], b [k,7] -> (pose deltas [k,6], scale deltas [k]). The
    anchor's pose and scale rows and columns are masked out (1 on the
    diagonal), which also makes edges (anchor, anchor) contribute nothing.
    """
    dtype, device = H.dtype, H.device
    A = H[:, :6, :, :6].reshape(6 * k, 6 * k)
    B = H[:, :6, :, 6].reshape(6 * k, k)
    C = H[:, 6, :, 6].reshape(k, k)
    b_p = b[:, :6].reshape(6 * k)
    b_s = b[:, 6].reshape(k)

    # Gauge fixing: anchor keyframe ``anchor``'s pose and scale.
    ms = anchor_mask(k, anchor, dtype, device)
    mp = ms[:, None].expand(k, 6).reshape(-1)
    A = A * mp[:, None] * mp[None, :] + torch.diag(1.0 - mp)
    B = B * mp[:, None] * ms[None, :]
    C = C * ms[:, None] * ms[None, :] + torch.diag(1.0 - ms)
    b_p = b_p * mp
    b_s = b_s * ms

    # Levenberg-Marquardt damping relative to the diagonal, so that weakly
    # constrained directions take small steps.
    A = A + damping * torch.diag(torch.diagonal(A)) + 1e-8 * torch.eye(6 * k, dtype=dtype,
                                                                        device=device)
    C = C + damping * torch.diag(torch.diagonal(C)) + 1e-8 * torch.eye(k, dtype=dtype,
                                                                        device=device)

    Cinv = _inv(C)
    H_red = A - B @ Cinv @ B.T
    b_red = b_p - B @ (Cinv @ b_s)
    dxi = -torch.linalg.solve_ex(H_red, b_red)[0]
    dsigma = -Cinv @ (b_s + B.T @ dxi)
    return (dxi * mp).reshape(k, 6), dsigma * ms


def _gn_loop(problem: BAProblem, accumulate_fn, iters: int, damping: float,
             anchor: int, max_step: float, cost_fn=None,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The Gauss-Newton iteration shared by the one-process and the
    edge-split optimizers, parameterised by how the normal equations
    (``accumulate_fn``) and the cost (``cost_fn``) are summed. Returns
    (poses, log-scales, the LM guard's accept decisions [iters] or None).

    With ``cost_fn`` (problem -> scalar robust cost) the loop runs as
    Levenberg-Marquardt with an accept/reject guard: a candidate step that
    raises the robust cost is discarded and the damping multiplied by 4; an
    accepted step halves it, floored at ``damping``. Without ``cost_fn`` it
    is plain fixed-damping GN.
    """
    k = problem.poses.shape[0]

    def candidate(poses, sigmas, lam):
        scaled = problem._replace(poses=poses,
                                  depths=problem.depths * torch.exp(sigmas)[:, None, None])
        H, b = accumulate_fn(scaled)
        dxi, dsigma = _schur_solve(H, b, k, lam, anchor)
        # Trust region: clip each keyframe's twist norm, so that one
        # ill-conditioned iteration cannot leave the basin.
        norm = torch.linalg.norm(dxi, dim=-1, keepdim=True)
        dxi = dxi * torch.clamp_max(max_step / torch.clamp_min(norm, 1e-12), 1.0)
        dsigma = torch.clamp(dsigma, -max_step, max_step)
        return poses @ se3_exp(dxi), sigmas + dsigma

    poses = problem.poses
    sigmas = poses.new_zeros(k)
    if cost_fn is None:
        for _ in range(iters):
            poses, sigmas = candidate(poses, sigmas, damping)
        return poses, sigmas, None

    floor = torch.full((), damping, dtype=poses.dtype, device=poses.device)
    lam = floor
    cost = cost_fn(problem)
    accepts = []
    for _ in range(iters):
        new_poses, new_sigmas = candidate(poses, sigmas, lam)
        new_cost = cost_fn(problem._replace(
            poses=new_poses, depths=problem.depths * torch.exp(new_sigmas)[:, None, None]))
        accept = new_cost <= cost
        poses = torch.where(accept, new_poses, poses)
        sigmas = torch.where(accept, new_sigmas, sigmas)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.maximum(lam * 0.5, floor), lam * 4.0)
        accepts.append(accept)
    return poses, sigmas, torch.stack(accepts)


def optimize_dense_ba(problem: BAProblem, stride: int = 4, iters: int = 8,
                      damping: float = 1e-2, anchor: int = 0,
                      robust_c: float = 0.25, max_step: float = 0.05,
                      lm_guard: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton dense BA. Returns (refined poses [K,4,4], log-scales [K]).

    ``lm_guard`` enables the Levenberg-Marquardt accept/reject loop (a
    monotone robust cost, `_gn_loop`); without it the loop is raw
    fixed-damping GN.
    """
    with fp32_matmuls():
        poses, sigmas, _ = _gn_loop(
            problem, lambda p: _accumulate(p, stride, robust_c), iters, damping, anchor,
            max_step, cost_fn=(lambda p: _total_cost(p, stride, robust_c))
            if lm_guard else None)
    return poses, sigmas


# ---------------------------------------------------------------------------
# The edge split over the processes of a group
# ---------------------------------------------------------------------------

def _local_edges(problem: BAProblem, group) -> BAProblem:
    """This process's contiguous slice of the edges."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    e = problem.edges_i.shape[0]
    if e % world:
        raise ValueError(f"{e} edges do not split over {world} processes: pad them with "
                         "(anchor, anchor) edges")
    n = e // world
    return problem._replace(edges_i=problem.edges_i[rank * n:(rank + 1) * n],
                            edges_j=problem.edges_j[rank * n:(rank + 1) * n])


def make_sharded_accumulate(group=None, stride: int = 4, robust_c: float = 0.0):
    """The normal equations with the edges split over the processes of
    ``group`` (a `torch.distributed` process group; None is the default
    group): each process accumulates the H and b of its contiguous slice of
    the edges, and `all_reduce_sum` adds them up (keyframe state replicated,
    edge work split).

    Every process must call the result with the same problem. The edge count
    must divide by the group's size: pad with (0, 0) edges. Such an edge is
    harmless only because pose 0 is the anchor: its H and b land in the
    anchor's rows and columns, which `_schur_solve` masks out. With another
    anchor, pad with (anchor, anchor) edges.
    """
    def run(problem: BAProblem):
        H, b = _accumulate(_local_edges(problem, group), stride, robust_c)
        return all_reduce_sum(H, group), all_reduce_sum(b, group)

    return run


def make_sharded_cost(group=None, stride: int = 4, robust_c: float = 0.0):
    """The LM guard's robust cost with the edges split as
    `make_sharded_accumulate` splits them, summed over the processes."""
    def run(problem: BAProblem):
        return all_reduce_sum(_total_cost(_local_edges(problem, group), stride, robust_c),
                              group)

    return run


def make_sharded_optimizer(group=None, stride: int = 4, iters: int = 8,
                           damping: float = 1e-2, anchor: int = 0,
                           robust_c: float = 0.25, max_step: float = 0.05,
                           lm_guard: bool = True):
    """Dense BA with its edges split over the processes of ``group``: the
    GN/Schur loop of `optimize_dense_ba` whose every iteration accumulates
    H, b (and, with ``lm_guard``, the robust cost) from each process's slice
    of the edges (`make_sharded_accumulate`'s contract) and solves the
    reduced system on every process. Equal to `optimize_dense_ba` up to the
    order of the sums."""
    accumulate = make_sharded_accumulate(group, stride, robust_c)
    cost_fn = make_sharded_cost(group, stride, robust_c) if lm_guard else None

    def run(problem: BAProblem) -> Tuple[torch.Tensor, torch.Tensor]:
        with fp32_matmuls():
            poses, sigmas, _ = _gn_loop(problem, accumulate, iters, damping, anchor,
                                        max_step, cost_fn=cost_fn)
        return poses, sigmas

    return run


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def pool_depth(depths: torch.Tensor, factor: int) -> torch.Tensor:
    """Valid-aware average pooling of [K,h,w] depth maps by ``factor``: zeros
    (invalid depth) are left out of the average, and a cell with no valid
    tap stays 0. The taps are summed one by one in row-major order, the
    order of the JAX module's reduction on the CPU."""
    if factor == 1:
        return depths
    k, h, w = depths.shape
    hh, ww = h // factor, w // factor
    d = depths[:, :hh * factor, :ww * factor].reshape(k, hh, factor, ww, factor)
    valid = (d > 0).to(depths.dtype)
    taps = d * valid
    s = torch.zeros_like(depths[:, :hh, :ww])
    c = torch.zeros_like(s)
    for a in range(factor):
        for b in range(factor):
            s = s + taps[:, :, a, :, b]
            c = c + valid[:, :, a, :, b]
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), 0.0)


# A continuation stage: (depth pyramid factor, IRLS robust_c, GN iters,
# trust-region max_step).
Stage = Tuple[int, float, int, float]

# Graduated non-convexity: start near-quadratic (a large robust_c: a wide
# basin, outliers still pull), finish sharply robust.
GNC_STAGES: Tuple[Stage, ...] = (
    (1, 2.0, 10, 0.3), (1, 0.5, 10, 0.15), (1, 0.25, 10, 0.1))

# Depth-pyramid coarse-to-fine: coarse stages run on factor^2-fold fewer
# residuals. It does not widen the basin (pooling biases the geometry, which
# is the residual here); prefer GNC_STAGES for robustness.
C2F_STAGES: Tuple[Stage, ...] = (
    (4, 0.25, 8, 0.1), (2, 0.25, 8, 0.1), (1, 0.25, 8, 0.1))


def optimize_dense_ba_scheduled(problem: BAProblem,
                                stages: Tuple[Stage, ...] = GNC_STAGES,
                                stride: int = 2, damping: float = 1e-2,
                                anchor: int = 0, group=None,
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuation dense BA: the GN/Schur loop over a stage schedule.

    Each stage ``(factor, robust_c, iters, max_step)`` runs ``iters``
    LM-guarded GN iterations on ``pool_depth(depths, factor)`` (intrinsics
    scaled to match by the pixel-centre rule) with its IRLS threshold and
    trust region, from the previous stage's estimate; each stage sees the
    depths pre-scaled by the running log-scales, and the corrections add up.
    With ``group`` (a process group, `torch.distributed.group.WORLD` for
    the default one) every stage splits its edges over the group's
    processes (`make_sharded_optimizer`); None runs in this process alone.
    Returns (refined poses [K,4,4], accumulated log-scales [K]).
    """
    k = problem.poses.shape[0]
    poses = problem.poses
    sigma = problem.poses.new_zeros(k)
    for factor, robust_c, iters, max_step in stages:
        K_f = scale_intrinsics(problem.K, 1.0 / factor) if factor > 1 else problem.K
        level = problem._replace(
            poses=poses,
            depths=pool_depth(problem.depths, factor) * torch.exp(sigma)[:, None, None],
            K=K_f.to(problem.K.dtype))
        if group is not None:
            run = make_sharded_optimizer(group, stride=stride, iters=iters, damping=damping,
                                         anchor=anchor, robust_c=robust_c, max_step=max_step)
            poses, ds = run(level)
        else:
            poses, ds = optimize_dense_ba(level, stride=stride, iters=iters, damping=damping,
                                          anchor=anchor, robust_c=robust_c, max_step=max_step)
        sigma = sigma + ds
    return poses, sigma


def optimize_dense_ba_c2f(problem: BAProblem, levels: Tuple[int, ...] = (4, 2, 1),
                          iters: int = 8, stride: int = 2, damping: float = 1e-2,
                          anchor: int = 0, robust_c: float = 0.25, max_step: float = 0.1,
                          group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depth-pyramid coarse-to-fine preset of
    `optimize_dense_ba_scheduled` (`C2F_STAGES` says when to prefer it)."""
    stages = tuple((f, robust_c, iters, max_step) for f in levels)
    return optimize_dense_ba_scheduled(problem, stages, stride=stride, damping=damping,
                                       anchor=anchor, group=group)


# ---------------------------------------------------------------------------
# The robust pipeline: two-frame alignments -> pose graph -> dense BA
# ---------------------------------------------------------------------------

# Two-frame alignment continuation: (robust_c, iters, max_step). A long
# wide-kernel stage first, then a sharp polish for inlier accuracy.
EDGE_STAGES: Tuple[Tuple[float, int, float], ...] = (
    (2.0, 30, 0.5), (0.25, 8, 0.15))


def _frame_j_residual_twice(params_j, T_i, T_j, D_i, D_j, K, stride):
    r = _edge_residual(torch.zeros_like(params_j), params_j, T_i, T_j, D_i, D_j, K, stride)
    return r, r


def estimate_edge_relatives(problem: BAProblem, stride: int = 2,
                            damping: float = 1e-2,
                            stages: Tuple[Tuple[float, int, float], ...] = EDGE_STAGES,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent two-frame alignment of every covisibility edge.

    For each edge (i, j), holds frame i fixed and Gauss-Newton-refines frame
    j's 6-DoF pose and log depth scale against the dense depth-consistency
    residual: a [7,7] solve per edge, all edges at once, over the ``stages``
    (robust_c, iters, max_step) continuation. Returns (measurements Z_ij
    [E,4,4] = refined T_i^-1 T_j, weights [E] = valid-pixel fraction x
    1 / (1 + mean robust residual / 0.01)).

    As in the JAX module, the valid fraction counts the pixels with |r| > 0
    (a valid pixel with an exact zero residual counts as invalid) and the
    residual scale 0.01 is fixed.
    """
    with fp32_matmuls():
        ei, ej = problem.edges_i, problem.edges_j
        T_i, T_cur = problem.poses[ei], problem.poses[ej]
        D_i, D_j = problem.depths[ei], problem.depths[ej]
        sig = problem.poses.new_zeros(ei.shape[0])
        zero = problem.poses.new_zeros(7)
        eye = torch.eye(7, dtype=T_i.dtype, device=T_i.device)
        system = vmap(jacfwd(_frame_j_residual_twice, has_aux=True),
                      in_dims=(None, 0, 0, 0, 0, None, None))
        for robust_c, iters, max_step in stages:
            for _ in range(iters):
                J, r = system(zero, T_i, T_cur, D_i, D_j * torch.exp(sig)[:, None, None],
                              problem.K, stride)
                if robust_c > 0:
                    w = torch.sqrt(1.0 / (1.0 + (r / robust_c) ** 2))
                    r = r * w
                    J = J * w[..., None]
                H = J.transpose(1, 2) @ J
                H = H + damping * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
                    + 1e-8 * eye
                d = -torch.linalg.solve_ex(H, (J.transpose(1, 2) @ r[..., None])[..., 0])[0]
                norm = torch.linalg.norm(d[:, :6], dim=-1, keepdim=True)
                # Right-multiplied twist and additive log-scale: the
                # semantics of _edge_residual's params_j.
                T_cur = T_cur @ se3_exp(
                    d[:, :6] * torch.clamp_max(max_step / torch.clamp_min(norm, 1e-12), 1.0))
                sig = sig + torch.clamp(d[:, 6], -max_step, max_step)
        r = _residuals(T_i, T_cur, D_i, D_j * torch.exp(sig)[:, None, None], problem.K,
                       stride)
        nonzero = (torch.abs(r) > 0).to(r.dtype)
        valid_frac = nonzero.mean(-1)
        weight = valid_frac / (1.0 + (torch.abs(r).sum(-1)
                                      / torch.clamp_min(nonzero.sum(-1), 1.0)) / 0.01)
        return _inv(T_i) @ T_cur, weight


def optimize_dense_ba_robust(problem: BAProblem, stages: Tuple[Stage, ...] | None = None,
                             stride: int = 2, damping: float = 1e-2, anchor: int = 0,
                             group=None, pgo_iters: int = 15,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The robust pipeline: two-frame alignments -> pose graph -> dense BA.

    1. `estimate_edge_relatives`: local two-frame refinements, whose basin
       does not shrink as the trajectory's noise grows.
    2. `optimize_pose_graph` on the measured relatives with the IRLS Cauchy
       reweighting at c = 0.15: it re-initialises the trajectory near the
       global optimum.
    3. The GNC-scheduled dense BA (LM-guarded, ``stages`` or `GNC_STAGES`)
       polishes poses and scales jointly from there, its edges split over
       ``group``'s processes when one is given.
    """
    measurements, weights = estimate_edge_relatives(problem, stride=stride, damping=damping)
    poses = optimize_pose_graph(problem.poses, problem.edges_i, problem.edges_j,
                                measurements, weights=weights, iters=pgo_iters,
                                anchor=anchor, robust_c=0.15)
    return optimize_dense_ba_scheduled(
        problem._replace(poses=poses), stages=GNC_STAGES if stages is None else stages,
        stride=stride, damping=damping, anchor=anchor, group=group)
