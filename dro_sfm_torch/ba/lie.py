"""SE(3) Lie-group maps for bundle adjustment (batched torch).

PyTorch counterpart of `dro_sfm_tpu/ba/lie.py`: exp and log maps of SO(3)
and SE(3) used by the Gauss-Newton optimizers of `dro_sfm_torch.ba`.
Twists are xi = [rho | phi] (translation first, rotation second, the
repo's 6-DoF layout).

Every map is differentiable at the identity: the angle guards use the
squared-norm double-`where` pattern, so no derivative passes through
``sqrt(0)`` or ``1/0``. Gauss-Newton takes its Jacobians with forward-mode
AD (`torch.func.jacfwd`) exactly at zero twists, where a plain
``sqrt(theta_sq)`` gives a NaN tangent in torch as in JAX.
"""
from __future__ import annotations

import torch


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(phi[..., 0])
    return torch.stack([
        torch.stack([zeros, -phi[..., 2], phi[..., 1]], dim=-1),
        torch.stack([phi[..., 2], zeros, -phi[..., 0]], dim=-1),
        torch.stack([-phi[..., 1], phi[..., 0], zeros], dim=-1),
    ], dim=-2)


def _safe_theta(phi: torch.Tensor):
    """(theta [..., 1, 1], theta^2, small-mask) with NaN-free tangents at
    phi = 0."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta_sq < 1e-10
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    return theta, theta_sq, small


def _where_small(small, series, exact_num, exact_den):
    """``series`` where ``small``, else ``exact_num / exact_den`` with the
    denominator set to 1 where ``small`` (the second `where` of the guard)."""
    return torch.where(small, series,
                       exact_num / torch.where(small, torch.ones_like(exact_den), exact_den))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) [..., 3] -> SO(3) [..., 3, 3], Taylor-safe."""
    theta, theta_sq, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = _where_small(small, 0.5 - theta_sq / 24.0, 1.0 - torch.cos(theta), theta_sq)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) [..., 3, 3] -> so(3) [..., 3], atan2-based and NaN-free at I."""
    # w = sin(theta) * axis
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    # [..., 1]: under forward AD torch gives a 0-d tensor times a Python
    # float a float64 tangent, so the trace keeps its trailing axis.
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = w_sq < 1e-10
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(w_sq), w_sq))
    theta = torch.atan2(sin_theta, cos_theta)
    # log = theta / sin(theta) * w; near zero, theta / sin -> 1 + theta^2 / 6
    scale = torch.where(small, 1.0 + w_sq / 6.0, theta / sin_theta)
    return scale * w


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] = [rho | phi] -> SE(3) [..., 4, 4], exact through
    the left Jacobian V."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta, theta_sq, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    b = _where_small(small, 0.5 - theta_sq / 24.0, 1.0 - torch.cos(theta), theta_sq)
    c = _where_small(small, 1.0 / 6.0 - theta_sq / 120.0, theta - torch.sin(theta),
                     theta_sq * theta)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    V = eye + b * K + c * K2
    t = torch.einsum("...ij,...j->...i", V, rho)
    top = torch.cat([R, t[..., None]], dim=-1)
    # eye's last row, made on the device: a tensor from a Python list would be
    # a copy from the host, which waits for the card
    bottom = torch.eye(4, dtype=xi.dtype, device=xi.device)[3:].expand(*xi.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) [..., 4, 4] -> twist [..., 6] = [rho | phi]."""
    phi = so3_log(T[..., :3, :3])
    theta, theta_sq, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    # V^-1 = I - K / 2 + coef K^2,
    # coef = (1 - theta cos(theta / 2) / (2 sin(theta / 2))) / theta^2
    half = 0.5 * theta
    cot = 1.0 - half * torch.cos(half) / torch.where(small, torch.ones_like(half),
                                                     torch.sin(half))
    cot_term = _where_small(small, 1.0 / 12.0 + theta_sq / 720.0, cot, theta_sq)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    Vinv = eye - 0.5 * K + cot_term * K2
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)
