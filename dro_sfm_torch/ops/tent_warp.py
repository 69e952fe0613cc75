"""Fused warp-subtract cost of the DRO refinement (kernel K1) and its plain
version.

PyTorch counterpart of `dro_sfm_tpu/ops/pallas/tent_warp.py`:
`warp_diff` ↔ `tent_warp_diff` (forward only: this package has no backward
yet) and `warp_cost` ↔ `pallas_warp_cost`.

On a CUDA tensor `warp_diff` launches the hand-written Hopper kernel
(`dro_sfm_torch/csrc/tent_warp_fwd.cu`) or raises; it never falls back. On a
CPU tensor it runs `warp_diff_plain`, the same function in plain PyTorch on
top of `bilinear_sample`. The kernel and the plain version compute the
bilinear taps in fp32 in the same order, so they agree bit for bit before the
final rounding to the output dtype.
"""
from __future__ import annotations

import ctypes

import torch

from dro_sfm_torch.ops.resample import bilinear_sample

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Number of times a wrapper launched its kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


K1_COUNTER = LaunchCounter()


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


def _launch_k1(f1, features, coords, n_views):
    for name, t in (("f1", f1), ("features", features), ("coords", coords)):
        if not t.is_contiguous():
            raise ValueError(f"warp_diff kernel wants a contiguous {name} "
                             f"(channel-minor); got strides {t.stride()}")
    if coords.data_ptr() % 8:
        raise ValueError("warp_diff kernel wants 8-byte aligned coords")
    from dro_sfm_torch import kernels

    lib = kernels.load("tent_warp_fwd")
    fn = lib.tent_warp_fwd_diff
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    bn, h, w, c = features.shape
    p = f1.shape[1]
    out = torch.empty((bn, p, c), dtype=f1.dtype, device=f1.device)
    vectorized = (c * f1.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (f1, features, out))
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(f1.data_ptr(), features.data_ptr(), coords.data_ptr(),
                 out.data_ptr(), bn, n_views, p, h, w, c,
                 _DTYPE_CODE[f1.dtype], int(vectorized), stream)
    if err != 0:
        raise RuntimeError(f"tent_warp_fwd_diff launch failed: CUDA error {err}")
    K1_COUNTER.launches += 1
    return out


def warp_diff(f1: torch.Tensor, features: torch.Tensor, coords: torch.Tensor,
              n_views: int) -> torch.Tensor:
    """Fused warp-subtract ``f1 - bilinear_sample(features, coords)``.

    f1 [B, P, C] (each target broadcast over its ``n_views`` reference maps);
    features [B*n_views, h, w, C]; coords [B*n_views, P, 2] fp32 pixel
    coordinates -> [B*n_views, P, C] in f1's dtype (fp32 or bf16, the same as
    features'). Sampling is grid_sample with zeros padding and
    align_corners=True. CUDA tensors go to kernel K1, CPU tensors to
    `warp_diff_plain`.
    """
    _check(f1, features, coords, n_views)
    if f1.device.type == "cuda":
        return _launch_k1(f1, features, coords, n_views)
    if f1.device.type == "cpu":
        return warp_diff_plain(f1, features, coords, n_views)
    raise ValueError(f"warp_diff has no path for device {f1.device}")


def warp_cost(fmap1: torch.Tensor, fmaps_ref: torch.Tensor,
              coords: torch.Tensor, impl: str = "pallas") -> torch.Tensor:
    """Multi-view squared feature difference after warping.

    fmap1 [B,h,w,C]; fmaps_ref [B,N,h,w,C]; coords [B,N,h,w,2] pixel coords
    -> cost [B,N,h,w,C] in fmap1's dtype. ``impl="pallas"`` goes through
    `warp_diff` (the kernel on CUDA tensors); ``"gather"`` and ``"matmul"``,
    the JAX package's other samplers, run the plain version on any device.
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
