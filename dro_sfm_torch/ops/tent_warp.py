"""Bilinear warp kernels of the DRO refinement and their gradients: K1 (the
fused warp-subtract cost), K4 (the bare warp, f32 out), K2 (feature
gradient) and K3 (coordinate gradient), each with its plain version.

PyTorch counterpart of `dro_sfm_tpu/ops/pallas/tent_warp.py`:
`warp_diff` ↔ `tent_warp_diff` (a `torch.autograd.Function` whose backward
follows `_tent_warp_diff_bwd`), `tent_warp` ↔ `tent_warp` (backward
`_tent_warp_bwd`: K2 and K3 with sign +1) and `warp_cost` ↔
`pallas_warp_cost`.

On CUDA tensors the entry points launch the hand-written Hopper kernels —
`dro_sfm_torch/csrc/tent_warp_fwd.cu` forward (K1, K4),
`csrc/tent_warp_bwd.cu` backward — or raise; they never fall back. On CPU
tensors they run the plain versions: `warp_diff_plain` and
`tent_warp_plain` on top of `bilinear_sample`, `warp_diff_bwd_feat_plain`
and `warp_diff_bwd_coords_plain`. K1, K4 and their plain versions compute
the bilinear taps in fp32 in the same order, so they agree bit for bit
before the final rounding to the output dtype; K2 sums with atomics and K3
reduces channels in another order, so the backward agrees with its plain
version to fp32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from dro_sfm_torch.kernels import LaunchCounter, entry, launch, on_device
from dro_sfm_torch.ops.resample import bilinear_sample, bilinear_taps

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

K1_COUNTER = LaunchCounter()
K2_COUNTER = LaunchCounter()
K3_COUNTER = LaunchCounter()
K4_COUNTER = LaunchCounter()


def warp_diff_plain(f1: torch.Tensor, features: torch.Tensor,
                    coords: torch.Tensor, n_views: int) -> torch.Tensor:
    """``f1 - bilinear_sample(features, coords)`` in plain PyTorch.

    f1 [B, P, C]; features [B*n_views, h, w, C]; coords [B*n_views, P, 2]
    fp32 -> [B*n_views, P, C] in f1's dtype, sampled and subtracted in fp32.
    """
    bn, p = coords.shape[0], coords.shape[1]
    warped = bilinear_sample(features.float(), coords.reshape(bn, 1, p, 2))
    base = f1.float().repeat_interleave(n_views, dim=0)
    return (base - warped.reshape(bn, p, -1)).to(f1.dtype)


def tent_warp_plain(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample(features, coords)`` in plain PyTorch (K4's plain
    version): features [B, h, w, C], coords [B, P, 2] fp32 -> [B, P, C]
    fp32, sampled in fp32."""
    b, p = coords.shape[0], coords.shape[1]
    return bilinear_sample(features.float(), coords.reshape(b, 1, p, 2)).reshape(b, p, -1)


def warp_diff_bwd_feat_plain(coords: torch.Tensor, g: torch.Tensor, h: int,
                             w: int, dtype: torch.dtype,
                             sign: float = -1.0) -> torch.Tensor:
    """Feature gradient of the warp in plain PyTorch (K2's plain version):
    ``sign * W^T g``, each pixel's ``sign * (weight * g)`` added into its
    four taps' rows with ``index_add_`` in fp32; sign -1 for `warp_diff`,
    +1 for `tent_warp`. coords [bn, P, 2] fp32, g [bn, P, C] -> [bn, h, w, C]
    in ``dtype`` (the features')."""
    bn, c = coords.shape[0], g.shape[-1]
    index, valid, weight, _, _ = bilinear_taps(coords, h, w)
    gf = g.float()
    out = torch.zeros(bn * h * w, c, dtype=torch.float32, device=g.device)
    for t in range(4):
        ok = valid[t]
        out.index_add_(0, index[t][ok], sign * (weight[t][ok][:, None] * gf[ok]))
    return out.reshape(bn, h, w, c).to(dtype)


def warp_diff_bwd_coords_plain(features: torch.Tensor, coords: torch.Tensor,
                               g: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Coordinate gradient of the warp in plain PyTorch (K3's plain
    version): per pixel ``sign * <g, dW/dx F>`` and ``sign * <g, dW/dy F>``
    from the tap differences, out-of-view taps zero; sign -1 for
    `warp_diff`, +1 for `tent_warp`. At an integer coordinate k the taps are
    k and k+1, so the result is the right-sided subgradient
    ``F[k+1] - F[k]``. features [bn, h, w, C], coords [bn, P, 2] fp32, g
    [bn, P, C] (fp32, or the features' dtype) -> [bn, P, 2] fp32."""
    bn, h, w, c = features.shape
    index, valid, _, wx, wy = bilinear_taps(coords, h, w)
    flat = features.reshape(bn * h * w, c).float()
    f = flat[index.reshape(-1)].reshape(4, *coords.shape[:2], c)
    f = f * valid[..., None]
    wx, wy = wx[..., None], wy[..., None]
    ex = (1 - wy) * (f[1] - f[0]) + wy * (f[3] - f[2])
    ey = (1 - wx) * (f[2] - f[0]) + wx * (f[3] - f[1])
    gf = g.float()
    return sign * torch.stack([(gf * ex).sum(-1), (gf * ey).sum(-1)], dim=-1)


def _check(f1, features, coords, n_views):
    if features.ndim != 4 or f1.ndim != 3 or coords.ndim != 3:
        raise ValueError("warp_diff wants f1 [B,P,C], features [B*N,h,w,C], "
                         f"coords [B*N,P,2]; got {tuple(f1.shape)}, "
                         f"{tuple(features.shape)}, {tuple(coords.shape)}")
    bn, h, w, c = features.shape
    b, p, c1 = f1.shape
    if (c1 != c or bn != b * n_views or tuple(coords.shape) != (bn, p, 2)):
        raise ValueError(f"warp_diff shape mismatch: f1 {tuple(f1.shape)}, "
                         f"features {tuple(features.shape)}, coords "
                         f"{tuple(coords.shape)}, n_views {n_views}")
    if f1.dtype != features.dtype or f1.dtype not in _DTYPE_CODE:
        raise TypeError(f"warp_diff wants f1 and features of one dtype in "
                        f"{list(_DTYPE_CODE)}; got {f1.dtype}, {features.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"warp_diff wants fp32 coords; got {coords.dtype}")
    devices = {f1.device, features.device, coords.device}
    if len(devices) != 1:
        raise ValueError(f"warp_diff inputs on several devices: {devices}")


def _kernel(name: str, argtypes):
    """The C entry point ``name`` of library tent_warp_fwd (K1, K4) or
    tent_warp_bwd (K2, K3), typed."""
    fwd = name in ("tent_warp_fwd_diff", "tent_warp_fwd")
    return entry("tent_warp_fwd" if fwd else "tent_warp_bwd", name, argtypes)


def _require_contiguous(op, **tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{op} kernel wants a contiguous {name} "
                             f"(channel-minor); got strides {t.stride()}")


def _vectorized(c, *tensors):
    """16-byte channel accesses are allowed: C * element size a multiple of
    16 and every pointer 16-byte aligned."""
    return (c * tensors[0].element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _launch_k1(f1, features, coords, n_views):
    _require_contiguous("warp_diff", f1=f1, features=features, coords=coords)
    if coords.data_ptr() % 8:
        raise ValueError("warp_diff kernel wants 8-byte aligned coords")
    fn = _kernel("tent_warp_fwd_diff", [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    bn, h, w, c = features.shape
    p = f1.shape[1]
    out = torch.empty((bn, p, c), dtype=f1.dtype, device=f1.device)
    launch(fn, f1.device, f1.data_ptr(), features.data_ptr(), coords.data_ptr(),
         out.data_ptr(), bn, n_views, p, h, w, c, _DTYPE_CODE[f1.dtype],
         int(_vectorized(c, f1, features, out)))
    K1_COUNTER.launches += 1
    return out


def _launch_k2(coords, g, h, w, dtype, sign):
    _require_contiguous("warp backward (features)", coords=coords, g=g)
    fn = _kernel("tent_warp_bwd_feat", [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    bn, p, c = g.shape
    out = torch.zeros((bn, h, w, c), dtype=torch.float32, device=g.device)
    launch(fn, g.device, coords.data_ptr(), g.data_ptr(), out.data_ptr(), bn, p, h,
           w, c, _DTYPE_CODE[g.dtype], int(_vectorized(c, g, out)), float(sign))
    K2_COUNTER.launches += 1
    return out if dtype == torch.float32 else out.to(dtype)


def _launch_k3(features, coords, g, sign):
    _require_contiguous("warp backward (coords)", features=features,
                        coords=coords, g=g)
    if g.dtype not in (features.dtype, torch.float32):
        raise TypeError(f"K3 wants g in fp32 or the features' dtype; got {g.dtype} "
                        f"with {features.dtype} features")
    fn = _kernel("tent_warp_bwd_coords", [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    bn, h, w, c = features.shape
    p = g.shape[1]
    out = torch.empty((bn, p, 2), dtype=torch.float32, device=g.device)
    vectorized = _vectorized(c, features) and _vectorized(c, g)
    launch(fn, g.device, features.data_ptr(), coords.data_ptr(), g.data_ptr(),
           out.data_ptr(), bn, p, h, w, c, _DTYPE_CODE[features.dtype],
           _DTYPE_CODE[g.dtype], int(vectorized), float(sign))
    K3_COUNTER.launches += 1
    return out


def warp_diff_bwd_feat(coords: torch.Tensor, g: torch.Tensor, h: int, w: int,
                       dtype: torch.dtype, sign: float = -1.0) -> torch.Tensor:
    """Feature gradient ``sign * W^T g`` of the warp (sign -1 for
    `warp_diff`, +1 for `tent_warp`): coords [bn, P, 2] fp32, g [bn, P, C]
    (fp32 or bf16) -> [bn, h, w, C] in ``dtype``, accumulated in fp32. CUDA
    tensors go to kernel K2, CPU tensors to `warp_diff_bwd_feat_plain`."""
    return on_device("warp_diff_bwd_feat", g.device,
                     lambda: _launch_k2(coords, g, h, w, dtype, sign),
                     lambda: warp_diff_bwd_feat_plain(coords, g, h, w, dtype, sign))


def warp_diff_bwd_coords(features: torch.Tensor, coords: torch.Tensor,
                         g: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Coordinate gradient of the warp (right-sided at integer coordinates;
    sign -1 for `warp_diff`, +1 for `tent_warp`): features [bn, h, w, C],
    coords [bn, P, 2] fp32, g [bn, P, C] in the features' dtype or fp32 ->
    [bn, P, 2] fp32. CUDA tensors go to kernel K3, CPU tensors to
    `warp_diff_bwd_coords_plain`."""
    return on_device("warp_diff_bwd_coords", g.device,
                     lambda: _launch_k3(features, coords, g, sign),
                     lambda: warp_diff_bwd_coords_plain(features, coords, g, sign))


def _warp_diff_fwd(f1, features, coords, n_views):
    return on_device("warp_diff", f1.device,
                     lambda: _launch_k1(f1, features, coords, n_views),
                     lambda: warp_diff_plain(f1, features, coords, n_views))


class _WarpDiff(torch.autograd.Function):
    """`warp_diff` with the backward of `_tent_warp_diff_bwd`: saves
    (features, coords); d_f1 is the fp32 sum of g over the views in g's
    dtype, d_features is K2 (sign -1), d_coords is K3 (sign -1). Only the
    gradients autograd asks for are computed."""

    @staticmethod
    def forward(ctx, f1, features, coords, n_views):
        ctx.n_views = n_views
        ctx.save_for_backward(features, coords)
        return _warp_diff_fwd(f1, features, coords, n_views)

    @staticmethod
    def backward(ctx, g):
        features, coords = ctx.saved_tensors
        # g arrives from diff * diff and the view mean: not always contiguous.
        g = g.contiguous()
        need_f1, need_feat, need_coords = ctx.needs_input_grad[:3]
        d_f1 = d_feat = d_coords = None
        if need_f1:
            bn, p, c = g.shape
            d_f1 = g.float().reshape(bn // ctx.n_views, ctx.n_views, p, c).sum(1)
            d_f1 = d_f1.to(g.dtype)
        if need_feat:
            d_feat = warp_diff_bwd_feat(coords, g, features.shape[1],
                                        features.shape[2], features.dtype)
        if need_coords:
            d_coords = warp_diff_bwd_coords(features, coords, g)
        return d_f1, d_feat, d_coords, None


def warp_diff(f1: torch.Tensor, features: torch.Tensor, coords: torch.Tensor,
              n_views: int) -> torch.Tensor:
    """Fused warp-subtract ``f1 - bilinear_sample(features, coords)``,
    differentiable in all three tensors.

    f1 [B, P, C] (each target broadcast over its ``n_views`` reference maps);
    features [B*n_views, h, w, C]; coords [B*n_views, P, 2] fp32 pixel
    coordinates -> [B*n_views, P, C] in f1's dtype (fp32 or bf16, the same as
    features'). Sampling is grid_sample with zeros padding and
    align_corners=True. CUDA tensors go to kernel K1 (backward K2, K3), CPU
    tensors to the plain versions.
    """
    _check(f1, features, coords, n_views)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (f1, features, coords)):
        return _WarpDiff.apply(f1, features, coords, n_views)
    return _warp_diff_fwd(f1, features, coords, n_views)


def _launch_k4(features, coords):
    _require_contiguous("tent_warp", features=features, coords=coords)
    if coords.data_ptr() % 8:
        raise ValueError("tent_warp kernel wants 8-byte aligned coords")
    fn = _kernel("tent_warp_fwd", [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    b, h, w, c = features.shape
    p = coords.shape[1]
    out = torch.empty((b, p, c), dtype=torch.float32, device=features.device)
    launch(fn, features.device, features.data_ptr(), coords.data_ptr(), out.data_ptr(),
           b, p, h, w, c, _DTYPE_CODE[features.dtype],
           int(_vectorized(c, features) and _vectorized(c, out)))
    K4_COUNTER.launches += 1
    return out


def _tent_warp_fwd(features, coords):
    return on_device("tent_warp", features.device,
                     lambda: _launch_k4(features, coords),
                     lambda: tent_warp_plain(features, coords))


class _TentWarp(torch.autograd.Function):
    """`tent_warp` with the backward of `_tent_warp_bwd`: d_features is K2
    with sign +1 (in the features' dtype), d_coords is K3 with sign +1 on
    the fp32 cotangent."""

    @staticmethod
    def forward(ctx, features, coords):
        ctx.save_for_backward(features, coords)
        return _tent_warp_fwd(features, coords)

    @staticmethod
    def backward(ctx, g):
        features, coords = ctx.saved_tensors
        g = g.contiguous()
        need_feat, need_coords = ctx.needs_input_grad
        d_feat = d_coords = None
        if need_feat:
            d_feat = warp_diff_bwd_feat(coords, g, features.shape[1], features.shape[2],
                                        features.dtype, sign=1.0)
        if need_coords:
            d_coords = warp_diff_bwd_coords(features, coords, g, sign=1.0)
        return d_feat, d_coords


def tent_warp(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample ``features`` [B, h, w, C] (fp32 or bf16) at pixel
    ``coords`` [B, P, 2] fp32 -> [B, P, C] fp32 (grid_sample, zeros
    padding, align_corners=True; any P), differentiable in both. CUDA
    tensors go to kernel K4 (backward K2, K3 with sign +1), CPU tensors to
    the plain versions."""
    if features.ndim != 4 or coords.ndim != 3 or coords.shape[-1] != 2 or (
            coords.shape[0] != features.shape[0]):
        raise ValueError(f"tent_warp wants features [B,h,w,C] and coords [B,P,2]; got "
                         f"{tuple(features.shape)}, {tuple(coords.shape)}")
    if features.dtype not in _DTYPE_CODE or coords.dtype != torch.float32:
        raise TypeError(f"tent_warp wants fp32 or bf16 features and fp32 coords; got "
                        f"{features.dtype}, {coords.dtype}")
    if features.device != coords.device:
        raise ValueError(f"tent_warp inputs on several devices: {features.device}, "
                         f"{coords.device}")
    if torch.is_grad_enabled() and (features.requires_grad or coords.requires_grad):
        return _TentWarp.apply(features, coords)
    return _tent_warp_fwd(features, coords)


def warp_cost(fmap1: torch.Tensor, fmaps_ref: torch.Tensor,
              coords: torch.Tensor, impl: str = "pallas") -> torch.Tensor:
    """Multi-view squared feature difference after warping.

    fmap1 [B,h,w,C]; fmaps_ref [B,N,h,w,C]; coords [B,N,h,w,2] pixel coords
    -> cost [B,N,h,w,C] in fmap1's dtype. ``impl="pallas"`` goes through
    `warp_diff` (the kernels on CUDA tensors); ``"gather"`` and ``"matmul"``,
    the JAX package's other samplers, run the plain version on any device
    and differentiate it with autograd.
    """
    b, n, h, w, c = fmaps_ref.shape
    f1 = fmap1.reshape(b, h * w, c)
    features = fmaps_ref.reshape(b * n, h, w, c)
    flat_coords = coords.reshape(b * n, h * w, 2)
    if impl == "pallas":
        diff = warp_diff(f1, features, flat_coords, n)
    elif impl in ("gather", "matmul"):
        _check(f1, features, flat_coords, n)
        diff = warp_diff_plain(f1, features, flat_coords, n)
    else:
        raise ValueError(f"unknown warp_impl {impl!r}")
    diff = diff.reshape(b, n, h, w, c)
    return diff * diff
