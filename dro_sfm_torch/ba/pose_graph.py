"""Pose-graph optimization over keyframes (damped Gauss-Newton).

PyTorch counterpart of `dro_sfm_tpu/ba/pose_graph.py`: refine a trajectory
of keyframe poses from relative-pose measurements (the network's
sliding-window predictions, loop closures, ground-truth priors, or the
two-frame alignments of `dense_ba.estimate_edge_relatives`).

Residual per edge (i, j): r = log(Z_ij^-1 T_i^-1 T_j) in se(3), with Z_ij
the measured relative transform and T_* camera-to-world poses. Each edge's
Jacobians come from forward-mode AD (`torch.func.jacfwd`) under
`torch.func.vmap` over the edges, as the JAX module takes `jax.jacfwd`
under `jax.vmap`. Pose ``anchor`` fixes the gauge.

The solve runs in fp32 with TF32 off (`fp32_matmuls`) for the call, as
`optimize_dense_ba` does; the JAX module pins no precision here, and on its
CPU and GPU backends fp32 is fp32 already.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from dro_sfm_torch.ba.lie import se3_exp, se3_log
from dro_sfm_torch.ba.precision import fp32_matmuls


def edge_residual(xi_i: torch.Tensor, xi_j: torch.Tensor, T_i0: torch.Tensor,
                  T_j0: torch.Tensor, Z_ij: torch.Tensor) -> torch.Tensor:
    """Residual [6] for one edge at perturbed poses T = T0 exp(xi)."""
    T_i = T_i0 @ se3_exp(xi_i)
    T_j = T_j0 @ se3_exp(xi_j)
    rel = _inv(Z_ij) @ _inv(T_i) @ T_j
    return se3_log(rel)


def anchor_mask(k: int, anchor: int, dtype, device) -> torch.Tensor:
    """[k]: 1, and 0 at ``anchor``. Made on the device by a comparison: an
    assignment of a Python number to one element copies it from the host,
    which waits for the card."""
    return (torch.arange(k, device=device) != anchor).to(dtype)


def _inv(A: torch.Tensor) -> torch.Tensor:
    """The LU inverse without its error check, which would wait for the
    card (``torch.linalg.inv`` reads the factorisation's status back)."""
    return torch.linalg.inv_ex(A)[0]


def _edge_residual_twice(xi_i, xi_j, T_i0, T_j0, Z_ij):
    r = edge_residual(xi_i, xi_j, T_i0, T_j0, Z_ij)
    return r, r


def _edge_system(T_i0, T_j0, Z_ij, weight):
    """(r [E,6], J_i [E,6,6], J_j [E,6,6]) at xi = 0 for every edge, each
    multiplied by its edge's weight [E]."""
    zero = T_i0.new_zeros(6)
    (J_i, J_j), r = vmap(jacfwd(_edge_residual_twice, argnums=(0, 1), has_aux=True),
                         in_dims=(None, None, 0, 0, 0))(zero, zero, T_i0, T_j0, Z_ij)
    w = weight[:, None]
    return r * w, J_i * w[..., None], J_j * w[..., None]


def scatter_blocks(H: torch.Tensor, b: torch.Tensor, edges_i: torch.Tensor,
                   edges_j: torch.Tensor, J_i: torch.Tensor, J_j: torch.Tensor,
                   r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add every edge's Gauss-Newton blocks into H [k, n, k, n] and b [k, n]
    from its residuals r [E, m] and Jacobians J_i, J_j [E, m, n], summing
    repeated edges as JAX's ``H.at[ei, :, ej, :].add`` does: in H's
    [k, k, n, n] view with ``index_put_(accumulate=True)``, in JAX's order
    (ii, jj, ij, ji, then b's i and j)."""
    blocks = H.permute(0, 2, 1, 3)                 # a view: [k, k, n, n]
    blocks.index_put_((edges_i, edges_i), J_i.transpose(1, 2) @ J_i, accumulate=True)
    blocks.index_put_((edges_j, edges_j), J_j.transpose(1, 2) @ J_j, accumulate=True)
    blocks.index_put_((edges_i, edges_j), J_i.transpose(1, 2) @ J_j, accumulate=True)
    blocks.index_put_((edges_j, edges_i), J_j.transpose(1, 2) @ J_i, accumulate=True)
    b.index_put_((edges_i,), torch.einsum("emi,em->ei", J_i, r), accumulate=True)
    b.index_put_((edges_j,), torch.einsum("emi,em->ei", J_j, r), accumulate=True)
    return H, b


def build_normal_equations(poses: torch.Tensor, edges_i: torch.Tensor,
                           edges_j: torch.Tensor, measurements: torch.Tensor,
                           weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """H [6K, 6K] and b [6K] from every edge (vmapped, then scattered)."""
    k = poses.shape[0]
    r, J_i, J_j = _edge_system(poses[edges_i], poses[edges_j], measurements, weights)
    H = poses.new_zeros((k, 6, k, 6))
    b = poses.new_zeros((k, 6))
    H, b = scatter_blocks(H, b, edges_i, edges_j, J_i, J_j, r)
    return H.reshape(6 * k, 6 * k), b.reshape(6 * k)


def _edge_residuals(poses, edges_i, edges_j, measurements):
    zero = poses.new_zeros(6)
    return vmap(edge_residual, in_dims=(None, None, 0, 0, 0))(
        zero, zero, poses[edges_i], poses[edges_j], measurements)


def optimize_pose_graph(poses: torch.Tensor, edges_i: torch.Tensor,
                        edges_j: torch.Tensor, measurements: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        iters: int = 10, damping: float = 1e-6,
                        anchor: int = 0, robust_c: float = 0.0) -> torch.Tensor:
    """Damped Gauss-Newton PGO.

    poses [K,4,4] (camera-to-world initial estimates); edges (i, j) index
    tensors [E]; measurements [E,4,4] of T_i^-1 T_j; returns the refined
    poses [K,4,4] with pose ``anchor`` held fixed.

    ``robust_c`` > 0 reweights every iteration by the Cauchy factor of the
    edge residual's norm, w = weights / (1 + (|r| / c)^2). As in the JAX
    module the factor multiplies r and J, so the normal equations see its
    square.
    """
    with fp32_matmuls():
        if weights is None:
            weights = poses.new_ones(edges_i.shape[0])
        k = poses.shape[0]
        m = anchor_mask(k, anchor, poses.dtype, poses.device)[:, None].expand(k, 6).reshape(-1)
        eye = torch.eye(6 * k, dtype=poses.dtype, device=poses.device)
        for _ in range(iters):
            w = weights
            if robust_c > 0:
                s = torch.linalg.norm(_edge_residuals(poses, edges_i, edges_j, measurements),
                                      dim=-1)
                w = weights / (1.0 + (s / robust_c) ** 2)
            H, b = build_normal_equations(poses, edges_i, edges_j, measurements, w)
            # Gauge fixing: zero the anchor's rows and columns, 1 on the diagonal.
            H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
            b = b * m
            H = H + damping * eye
            delta = -torch.linalg.solve_ex(H, b)[0].reshape(k, 6)
            poses = poses @ se3_exp(delta * m.reshape(k, 6))
        return poses


def total_edge_error(poses, edges_i, edges_j, measurements) -> torch.Tensor:
    """Sum of squared edge residual norms (a convergence diagnostic)."""
    return (_edge_residuals(poses, edges_i, edges_j, measurements) ** 2).sum()
