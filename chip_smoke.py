#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check their kernels.

    python3 chip_smoke.py              # on one card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device: the card's name and power limit, torch and CUDA versions; TF32 is
   switched off for cuDNN convolutions and matmuls so that fp32 means fp32;
2. build: every kernel of the path from ``dro_sfm_torch/csrc`` with nvcc;
3. kernel vs plain: K1 (`warp_diff`) against its plain PyTorch version at
   the serving shapes (B=1 and 8, bf16 and fp32) and at edge cases, with
   timings of the kernel, the plain version and a library yardstick;
4. serving: DepthPoseNet it12-h-out (bf16, random weights from a seed)
   answers requests through `make_infer_fn` at 192x640, N=2, B=1 and B=8;
   K1's launch count is reset just before and read just after, and must be
   24 per request;
5. end to end: the same net and inputs with the plain warp on the card,
   compared with the kernel run in fp32 and in bf16;
6. profile: device time by kernel over one B=8 request (torch.profiler),
   and the card's busy share of that request;
7. K2/K3 vs plain: the warp-cost backward kernels (`warp_diff_bwd_feat`,
   `warp_diff_bwd_coords`) against their plain versions at the training
   shapes (B=1 and 8, bf16 and fp32) and at edge cases, each beside its
   stated tolerance, with timings of the kernel, the plain version, the
   library yardstick (`grid_sampler_2d_backward`) and the bound;
8. training: the supervised step (SupModelMF it12-h-out, bf16, 192x640,
   N=2, B=8) through `make_train_step`, from random weights with the heads'
   last convolution scaled down (`start_weights`): one warm-up step and 10
   timed steps; every launch count is reset just before and read just
   after, and must be 24 (K1), 24 (K2) and 18 (K3) per step; the loss
   finite at every step, every parameter and BatchNorm statistic moved, and
   Adam's moments finite;
9. training end to end: one step's gradients with the kernels against the
   plain warp on the card (B=2, flip off), fp32 with TF32 off and bf16,
   each leaf against a stated bar; the bars must fail planted faults (K2 or
   K3 leaving out one tap), as must phase 7's;
10. profile: device time by kernel over one B=8 train step, and the card's
   busy share of it;
11. K4 vs plain: the bare warp `tent_warp` and its gradient (K2 and K3 with
   sign +1) at the warp shapes and the edge cases; the entry point's path
   (counts reset before, read after) launches K4, K2 and K3 once each;
12. K5/K6 vs plain: the fused GRU pass and its two backward kernels at the
   path's depth and pose shapes, both axes, bf16 and fp32, B=1, and edge
   cases, each beside its bar, with planted faults and timings against the
   bound and the split path's pass;
13. serving with ``sep_conv="pallas"``: B=1 and B=8 through `make_infer_fn`,
   24 K1 and 48 K5 launches a request, the split path timed in turns; both
   paths' outputs compared in fp32 and bf16;
14. training with ``sep_conv="pallas"``: as phase 8, launches a step K1 24,
   K2 24, K3 18, K5 48, K6-input 48, K6-weight 48;
15. its gradients through K5/K6 against the plain GRU pass (B=2, fp32 and
   bf16);
16. profile of one of its train steps.

``--only`` runs a subset of the phases after the build and prints no result
line. The last three lines of standard output are the ``kernels`` JSON line
(K1-K6; launches from the training paths, K4's from its entry point's path),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 on the tensor cores, dense
SERVE_H, SERVE_W, VIEWS, REQUESTS = 192, 640, 2, 20
K1_STEPS_PER_REQUEST = 24          # it12: 3 outer x (4 depth + 4 pose) steps
TRAIN_B, TRAIN_STEPS = 8, 10
# Per train step: K1 and K2 run in all 24 refinement steps. K3 runs where the
# coordinates need a gradient: not in the first depth and the first pose step
# of each outer iteration, whose coordinates come from the detached state.
TRAIN_LAUNCHES = {"K1": 24, "K2": 24, "K3": 3 * (3 + 3)}
# With sep_conv="pallas" every refinement step runs two GRU passes (K5) and
# their backward (K6-input, K6-weight) besides.
TRAIN_LAUNCHES_PALLAS = {**TRAIN_LAUNCHES, "K5": 48, "K6-input": 48, "K6-weight": 48}
HEAD_SCALE = 0.1                   # on the random heads' last convolution
# Kernel vs plain bf16 gradients: a leaf's bar is BF16_BAR, or
# BF16_SHARE of bf16's own error where that reaches BF16_OWN_NOISY.
BF16_BAR, BF16_OWN_NOISY, BF16_SHARE = 2e-2, 0.1, 0.25


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events). A sleep kernel holds the stream while the host enqueues the
    calls, so the events time the device work and not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)           # ~100 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound(f1, features, coords):
    """Least time of one K1 call on this card: each f1, coords and out byte
    once plus the feature rows these coordinates reference, over the memory
    rate; 9 fp32 operations per output element over the fp32 rate."""
    bn, h, w, c = features.shape
    x0, y0 = coords[..., 0].floor(), coords[..., 1].floor()
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            img = torch.arange(bn, device=coords.device)[:, None].expand_as(xi)
            rows.append(((img * h + yi) * w + xi)[ok].long())
    n_rows = torch.unique(torch.cat(rows)).numel()
    out_bytes = coords.shape[0] * coords.shape[1] * c * f1.element_size()
    n_bytes = (f1.numel() * f1.element_size() + n_rows * c * features.element_size()
               + coords.numel() * 4 + out_bytes)
    ops = 9 * coords.shape[0] * coords.shape[1] * c
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def k1_inputs(gen, b, n, h, w, c, dtype, kind):
    """f1 [b,h*w,c], features [b*n,h,w,c], coords [b*n,h*w,2] on the card.
    ``kind``: "serving" (the pixel grid moved by a near-identity pose, a few
    pixels of noise, some pixels out of view), "integer", "outside" (-10),
    "far" (+-1e8)."""
    dev = "cuda"
    p = h * w
    f1 = torch.randn(b, p, c, generator=gen, device=dev).to(dtype)
    features = torch.randn(b * n, h, w, c, generator=gen, device=dev).to(dtype)
    gy, gx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(1, p, 2).float()
    if kind == "serving":
        coords = grid + 1.5 * torch.randn(b * n, p, 2, generator=gen, device=dev)
    elif kind == "integer":
        coords = grid + torch.randint(-2, 3, (b * n, 1, 2), generator=gen, device=dev)
    elif kind == "outside":
        coords = torch.full((b * n, p, 2), -10.0, device=dev)
    elif kind == "far":
        sign = torch.randint(0, 2, (b * n, p, 2), generator=gen, device=dev) * 2 - 1
        coords = torch.where(torch.rand(b * n, p, 2, generator=gen, device=dev) < 0.5,
                             1e8 * sign, grid.expand(b * n, p, 2))
    else:
        raise ValueError(kind)
    return f1, features, coords.float().contiguous()


def k1_tolerance(dtype, ref):
    """Stated bar for kernel vs plain. The kernel repeats the plain version's
    fp32 operations in the same order without fused multiply-adds, so they
    should agree exactly; the bar still allows one rounding step of the
    output dtype (bf16: 2^-7 relative; fp32: 2^-22 relative)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    return rel * ref.float().abs().max().item() + 1e-30


def phase_k1(warp_diff, warp_diff_plain):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            cases.append((f"serving B={b}", b, VIEWS, 24, 80, 128, dtype, "serving"))
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("6x10", 2, VIEWS, 6, 10, 128, dtype, "serving"),
                  ("6x10 C=6", 2, VIEWS, 6, 10, 6, dtype, "serving"),
                  ("integer", 1, VIEWS, 24, 80, 128, dtype, "integer"),
                  ("outside -10", 1, VIEWS, 24, 80, 128, dtype, "outside"),
                  ("far +-1e8", 1, VIEWS, 24, 80, 128, dtype, "far")]
    results = {}
    for name, b, n, h, w, c, dtype, kind in cases:
        f1, features, coords = k1_inputs(gen, b, n, h, w, c, dtype, kind)
        out = warp_diff(f1, features, coords, n)
        torch.cuda.synchronize()
        ref = warp_diff_plain(f1, features, coords, n)
        err = (out.float() - ref.float()).abs().max().item()
        tol = k1_tolerance(dtype, ref)
        dt = str(dtype).replace("torch.", "")
        line = f"K1 {name:12s} {dt:8s} max_abs_err {err:.3e} tol {tol:.3e}"
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            base = f1.repeat_interleave(n, 0)
            if not torch.equal(out[outside], base[outside]):
                fail(f"K1 {name} {dt}: out-of-view pixels are not f1 - 0")
        if err > tol or not torch.isfinite(out).all():
            fail(line)
        if name.startswith("serving"):
            # grid_sample wants the grid in the features' dtype (bf16 here
            # costs it ~0.3 px of precision; it is timed, never used).
            grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)],
                                -1) * 2 - 1).to(dtype)
            feat_nchw = features.permute(0, 3, 1, 2)      # channel-last view

            def library():
                warped = F.grid_sample(feat_nchw, grid[:, None], mode="bilinear",
                                       padding_mode="zeros", align_corners=True)
                return (f1.view(b, 1, h * w, c)
                        - warped.view(b, n, c, h * w).transpose(-1, -2))

            lib_err = (library().reshape_as(ref).float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: warp_diff(f1, features, coords, n))
            plain_ms = time_ms(lambda: warp_diff_plain(f1, features, coords, n))
            library_ms = time_ms(library)
            bound_ms, bound_by = k1_bound(f1, features, coords)
            line += (f" | kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                     f"{library_ms:.4f} ms (err {lib_err:.2e}) bound {bound_ms:.4f} ms"
                     f" ({bound_by})")
            results[(b, dt)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": library_ms}
        print(line, flush=True)
    return results


def make_request(gen, b):
    target = torch.rand(b, SERVE_H, SERVE_W, 3, generator=gen)
    refs = torch.rand(b, VIEWS, SERVE_H, SERVE_W, 3, generator=gen)
    K = torch.tensor([[0.58 * SERVE_W, 0.0, 0.5 * SERVE_W],
                      [0.0, 1.92 * SERVE_H, 0.5 * SERVE_H],
                      [0.0, 0.0, 1.0]]).expand(b, 3, 3).contiguous()
    return target.cuda(), refs.cuda(), K.cuda()


def phase_serving(DepthPoseNet, make_infer_fn, counters, gpu):
    net = DepthPoseNet(version="it12-h-out", mixed_precision=True,
                       warp_impl="pallas", device="cuda",
                       generator=torch.Generator().manual_seed(0))
    infer = make_infer_fn(net, device="cuda")
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    K1_COUNTER = counters["K1"]
    for c in counters.values():              # the serving path starts here
        c.reset()
    for b, req in requests.items():
        before = K1_COUNTER.launches
        infer(*req)                          # warm-up request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            depth, mats = infer(*req)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        ms = times[len(times) // 2]
        launched = K1_COUNTER.launches - before
        if launched != K1_STEPS_PER_REQUEST * (REQUESTS + 1):
            fail(f"serving B={b}: K1 launched {launched} times for "
                 f"{REQUESTS + 1} requests, want {K1_STEPS_PER_REQUEST} each")
        if depth.shape != (b, SERVE_H, SERVE_W) or mats.shape != (b, VIEWS, 4, 4):
            fail(f"serving B={b}: shapes {tuple(depth.shape)}, {tuple(mats.shape)}")
        if not (torch.isfinite(depth).all() and torch.isfinite(mats).all()):
            fail(f"serving B={b}: non-finite output")
        if not ((depth >= 0.1 - 1e-4) & (depth <= 100.0 + 1e-2)).all():
            fail(f"serving B={b}: depth outside [min_depth, max_depth]")
        print(f"serving it12-h-out bf16 192x640 N=2 B={b}: median {ms:.2f} ms/request "
              f"(min {times[0]:.2f}, max {times[-1]:.2f}, {REQUESTS} requests) "
              f"{1e3 * b / ms:.1f} frames/s, K1 {launched // (REQUESTS + 1)} "
              f"launches/request, peak {torch.cuda.max_memory_allocated() / 2**20:.0f}"
              f" MiB on {gpu}", flush=True)
    launches = K1_COUNTER.launches           # the serving path ends here
    if counters["K2"].launches or counters["K3"].launches:
        fail("serving launched a backward kernel")
    return net, requests, launches


def phase_end_to_end(DepthPoseNet, net_bf16, requests):
    """Kernel vs plain warp through the whole net on the card. The kernel
    repeats the plain version bit for bit, so the two runs differ only where
    library convolutions vary from run to run: the bar is 1e-5 relative (L2)
    in fp32 and 1e-2 in bf16."""
    req = requests[1]
    state = net_bf16.state_dict()
    for mp, bar in ((False, 1e-5), (True, 1e-2)):
        outs = {}
        for impl in ("pallas", "gather"):
            net = DepthPoseNet(version="it12-h-out", mixed_precision=mp,
                               warp_impl=impl, device="cuda")
            net.load_state_dict(state, strict=True)
            with torch.inference_mode():
                outs[impl] = net(*req, last_only=True)
        for key in ("inv_depths", "pose_vecs"):
            a, b = outs["pallas"][key], outs["gather"][key]
            rel = ((a - b).norm() / b.norm()).item()
            line = (f"end to end {'bf16' if mp else 'fp32'} {key}: kernel vs plain "
                    f"rel L2 {rel:.3e} (bar {bar:.0e}), max abs "
                    f"{(a - b).abs().max().item():.3e}")
            if not (rel <= bar and torch.isfinite(a).all()):
                fail(line)
            print(line, flush=True)


def profile_request(net, requests, make_infer_fn):
    """Device time by kernel over one B=8 request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    infer = make_infer_fn(net, device="cuda")
    req = requests[8]
    infer(*req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(*req)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    print(f"profile B=8: wall {wall_us:.0f} us, device busy {total:.0f} us "
          f"({100 * total / wall_us:.1f}%)", flush=True)
    if total == 0:
        print("profile B=8: the profiler recorded no device time (not measured)")
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e):9.0f} us {e.count:5d}x  {e.key[:90]}")
    for e in kernels:
        if "tent_warp" in e.key:
            print(f"profile B=8: K1 {device_us(e):.0f} us over {e.count} launches, "
                  f"{device_us(e) / e.count:.2f} us each")


def k2_bound(coords, g, h, w, dtype):
    """Least time of one K2 call: g and coords read once and d_features
    written once in its dtype, over the memory rate; one multiply and one
    add per channel of each in-view tap over the fp32 rate."""
    bn, p, c = g.shape
    n_bytes = (g.numel() * g.element_size() + coords.numel() * 4
               + bn * h * w * c * torch.finfo(dtype).bits // 8)
    ops = 2 * c * int(_taps(coords, h, w)[1].sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def k3_bound(features, coords, g):
    """Least time of one K3 call: g, coords and the feature rows the taps
    reference read once, d_coords written once, over the memory rate; per
    channel of each pixel with a tap in view, 4 tap differences, 4
    weightings, 2 sums and 2 products with g accumulated (12 operations)
    over the fp32 rate."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    n_rows = torch.unique(index[valid]).numel()
    n_bytes = (g.numel() * g.element_size() + coords.numel() * 4
               + n_rows * c * features.element_size() + coords.numel() * 4)
    ops = 12 * c * int(valid.any(0).sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _taps(coords, h, w):
    from dro_sfm_torch.ops.resample import bilinear_taps
    return bilinear_taps(coords, h, w)


def k2_tolerance(coords, g, h, w, dtype, ref):
    """Stated bar for K2 vs plain. Both sum the same fp32 products into each
    feature element, K2 with atomics in run-dependent order, the plain
    version with index_add_: a reordering of n adds moves the sum by at most
    n * 2^-24 of the sum of magnitudes. The bar allows 64 adds (a near-
    identity warp sends 4 to 16 taps to an element) against the largest
    sum of |w g|; in bf16 one rounding step (2^-7 of the largest output)
    comes on top, since a reordered fp32 sum may round to the neighbour."""
    from dro_sfm_torch.ops.tent_warp import warp_diff_bwd_feat_plain
    mag = warp_diff_bwd_feat_plain(coords, g.float().abs(), h, w, torch.float32)
    tol = 64 * 2.0 ** -24 * mag.abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * ref.float().abs().max().item()
    return tol + 1e-30


def k3_tolerance(features, coords, g):
    """Stated bar for K3 vs plain: the C channel products of a pixel are
    summed in another order (16 lanes then a shuffle tree, against torch's
    reduction), each order within C * 2^-24 of the sum of magnitudes; the
    bar is twice that against the largest per-pixel sum of |g| times the
    four taps' |F|, which bounds sum |g * dF|."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    f = features.reshape(bn * h * w, c).float().abs()[index.reshape(-1)]
    f = (f.reshape(4, *coords.shape[:2], c) * valid[..., None]).sum(0)
    scale = (g.float().abs() * f).sum(-1).max().item()
    return 2 * c * 2.0 ** -24 * scale + 1e-30


def phase_k23(gen):
    """K2 and K3 against their plain versions at the training shapes and at
    the edge cases; returns the B=8 timings by dtype."""
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
    )
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            cases.append((f"training B={b}", b, VIEWS, 24, 80, 128, dtype, "serving"))
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("6x10", 2, VIEWS, 6, 10, 128, dtype, "serving"),
                  ("6x10 C=6", 2, VIEWS, 6, 10, 6, dtype, "serving"),
                  ("integer", 1, VIEWS, 24, 80, 128, dtype, "integer"),
                  ("outside -10", 1, VIEWS, 24, 80, 128, dtype, "outside"),
                  ("far +-1e8", 1, VIEWS, 24, 80, 128, dtype, "far")]
    results = {}
    for name, b, n, h, w, c, dtype, kind in cases:
        _, features, coords = k1_inputs(gen, b, n, h, w, c, dtype, kind)
        g = torch.randn(b * n, h * w, c, generator=gen, device="cuda").to(dtype)
        d_feat = warp_diff_bwd_feat(coords, g, h, w, dtype)
        d_co = warp_diff_bwd_coords(features, coords, g)
        torch.cuda.synchronize()
        ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype)
        ref_co = warp_diff_bwd_coords_plain(features, coords, g)
        dt = str(dtype).replace("torch.", "")
        err2 = (d_feat.float() - ref_feat.float()).abs().max().item()
        err3 = (d_co - ref_co).abs().max().item()
        tol2 = k2_tolerance(coords, g, h, w, dtype, ref_feat)
        tol3 = k3_tolerance(features, coords, g)
        line = (f"K2/K3 {name:12s} {dt:8s} K2 max_abs_err {err2:.3e} tol {tol2:.3e}"
                f" | K3 max_abs_err {err3:.3e} tol {tol3:.3e}")
        if d_feat.dtype != dtype or d_co.dtype != torch.float32:
            fail(f"{line}: dtypes {d_feat.dtype}, {d_co.dtype}")
        if not (torch.isfinite(d_feat).all() and torch.isfinite(d_co).all()):
            fail(f"{line}: non-finite gradient")
        if err2 > tol2 or err3 > tol3:
            fail(line)
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            if (d_co[outside] != 0).any():
                fail(f"K3 {name} {dt}: out-of-view pixels have a coordinate gradient")
            if kind == "outside" and (d_feat != 0).any():
                fail(f"K2 {name} {dt}: out-of-view pixels scattered into the features")
        if kind == "integer":
            # every pixel with a tap in view has a nonzero coordinate gradient
            inview = _taps(coords, h, w)[1].any(0)
            nonzero = (d_co[inview] != 0).any(-1).float().mean().item()
            line += f" | nonzero d_coords in view {100 * nonzero:.2f}%"
            if nonzero < 0.99:
                fail(f"K3 {name} {dt}: the right-sided subgradient is missing ({line})")
        if name.startswith("training"):
            # the bars must fail a kernel that leaves out one tap
            bad2 = faulty_backward("K2")[1](coords, g, h, w, dtype)
            bad3 = faulty_backward("K3")[1](features, coords, g)
            e2 = (bad2.float() - ref_feat.float()).abs().max().item()
            e3 = (bad3 - ref_co).abs().max().item()
            line += f" | planted faults: K2 err {e2:.3e}, K3 err {e3:.3e}"
            if e2 <= tol2 or e3 <= tol3:
                fail(f"{line}: a bar passes a kernel that leaves out a tap")
            results[(b, dt)] = time_k23(features, coords, g, dtype)
            r = results[(b, dt)]
            line += (f" | K2 kernel {r['K2']['ms']:.4f} ms plain {r['K2']['plain_ms']:.4f}"
                     f" library {r['K2']['library_ms']:.4f} bound {r['K2']['bound_ms']:.4f}"
                     f" | K3 kernel {r['K3']['ms']:.4f} ms plain {r['K3']['plain_ms']:.4f}"
                     f" library {r['K3']['library_ms']:.4f} bound {r['K3']['bound_ms']:.4f}"
                     f" | library K2+K3 in one call {r['library_both_ms']:.4f} ms")
            r["K2"]["max_abs_err"], r["K3"]["max_abs_err"] = err2, err3
        print(line, flush=True)
    return results


def time_k23(features, coords, g, dtype):
    """Kernel, plain, library and bound times of K2 and K3 on one input.
    The library yardstick is ATen's `grid_sampler_2d_backward` on the same
    tensors (channel-last views, normalised grid in the features' dtype),
    asked for the input gradient (K2), the grid gradient (K3), or both."""
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
    )
    bn, h, w, c = features.shape
    p = coords.shape[1]
    grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)], -1)
            * 2 - 1).to(dtype)[:, None]                        # [bn,1,P,2]
    feat_nchw = features.permute(0, 3, 1, 2)
    g_nchw = g.reshape(bn, 1, p, c).permute(0, 3, 1, 2)

    def library(mask):
        return torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, feat_nchw, grid, 0, 0, True, mask)

    out = {"K2": {"ms": time_ms(lambda: warp_diff_bwd_feat(coords, g, h, w, dtype)),
                  "plain_ms": time_ms(lambda: warp_diff_bwd_feat_plain(coords, g, h, w,
                                                                       dtype)),
                  "library_ms": time_ms(lambda: library([True, False]))},
           "K3": {"ms": time_ms(lambda: warp_diff_bwd_coords(features, coords, g)),
                  "plain_ms": time_ms(lambda: warp_diff_bwd_coords_plain(features, coords,
                                                                         g)),
                  "library_ms": time_ms(lambda: library([False, True]))},
           "library_both_ms": time_ms(lambda: library([True, True]))}
    out["K2"]["bound_ms"], out["K2"]["bound_by"] = k2_bound(coords, g, h, w, dtype)
    out["K3"]["bound_ms"], out["K3"]["bound_by"] = k3_bound(features, coords, g)
    return out


def make_train_batch(b, h=SERVE_H, w=SERVE_W, n=VIEWS, seed=0):
    """The synthetic batch of the JAX package's training benchmark: uniform
    images, depth uniform in [1, 60], identity context poses, on the card."""
    gen = torch.Generator().manual_seed(seed)
    K = torch.tensor([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2],
                      [0, 0, 1.0]])
    batch = {"rgb": torch.rand(b, h, w, 3, generator=gen),
             "rgb_context": torch.rand(b, n, h, w, 3, generator=gen),
             "intrinsics": K.expand(b, 3, 3).contiguous(),
             "depth": 1.0 + 59.0 * torch.rand(b, h, w, 1, generator=gen),
             "pose_context": torch.eye(4).expand(b, n, 4, 4).contiguous()}
    return {k: v.cuda() for k, v in batch.items()}


def train_config(**overrides):
    from dro_sfm_torch.models.sfm import SfmModelConfig, resolve_memory_policy
    remat, unroll = resolve_memory_policy("auto", "auto", TRAIN_B, (SERVE_H, SERVE_W))
    kw = dict(name="SupModelMF", version="it12-h-out", min_depth=0.2, max_depth=80.0,
              flip_lr_prob=0.5, mixed_precision=True, warp_impl="pallas",
              remat=remat, scan_unroll=unroll)
    return SfmModelConfig(**{**kw, **overrides})


def start_weights(cfg):
    """The net the training phases start from: random weights from seed 0
    with the last convolution of every depth and pose head scaled by
    HEAD_SCALE. At the unscaled random weights the refinement's poses run to
    10 and the gradient norm to 1e24 (the JAX package's step does the same
    from its own random weights), Adam's second moment overflows for
    millions of elements and those stop moving."""
    net = cfg.build_net(device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in net.named_parameters():
            if k.endswith("head.conv2.weight"):
                p.mul_(HEAD_SCALE)
    return net


def grad_norm(params):
    return torch.sqrt(sum((p.grad.double() ** 2).sum() for p in params
                          if p.grad is not None)).item()


def phase_train(counters, gpu, sep_conv="split", want=TRAIN_LAUNCHES):
    """The training path: SupModelMF it12-h-out bf16 192x640 N=2 B=8 with
    ``sep_conv``; ``want`` the launches of each kernel a step (others 0)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    cfg = train_config(sep_conv=sep_conv)
    want = {k: want.get(k, 0) for k in counters}
    net = start_weights(cfg)
    opt = make_optimizer(net, steps_per_epoch=1000)     # config-default Adam, StepLR
    state = create_train_state(net, opt, device="cuda")
    train_step = make_train_step(cfg, net, opt, device="cuda")
    batch = make_train_batch(TRAIN_B)
    flips = torch.Generator().manual_seed(1)
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for c in counters.values():              # the training path starts here
        c.reset()
    params = dict(net.named_parameters())
    per_step, times, losses, norms = [], [], [], []
    for i in range(TRAIN_STEPS + 1):         # one warm-up step, then timed
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        start = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, flips)
        torch.cuda.synchronize()
        if i > 0:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"].item())
        per_step.append({k: c.launches - start[k] for k, c in counters.items()})
        if i in (0, TRAIN_STEPS):            # outside the timed steps
            norms.append(grad_norm(params.values()))
    launches = {k: c.launches for k, c in counters.items()}   # the path ends here
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"train step {i}: launches {got}, want {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"training: non-finite loss {losses}")
    # Every parameter and every BatchNorm statistic moved, and no element of
    # Adam's moments overflowed (an infinite second moment freezes its
    # element: the update m / sqrt(v) is zero).
    after = net.state_dict()
    stale = [k for k, v in before.items()
             if not k.endswith("num_batches_tracked") and torch.equal(v, after[k])]
    if stale:
        fail(f"training: parameters or statistics never moved: {stale[:5]}")
    moments = state.optimizer.torch_optimizer.state
    n_bad = sum(int((~torch.isfinite(moments[p][m])).sum())
                for p in params.values() for m in ("exp_avg", "exp_avg_sq"))
    if n_bad:
        fail(f"training: {n_bad} elements of Adam's moments are not finite")
    print(f"training: all {len(params)} parameter tensors and every BatchNorm "
          f"statistic moved, Adam's moments finite; gradient norm {norms[0]:.3e} "
          f"(first step) -> {norms[-1]:.3e} (last step)", flush=True)
    if state.step != TRAIN_STEPS + 1:
        fail(f"training: state.step {state.step}")
    times.sort()
    ms = times[len(times) // 2]
    print(f"training SupModelMF it12-h-out bf16 192x640 N=2 B={TRAIN_B} remat={cfg.remat} "
          f"sep_conv={sep_conv}: "
          f"median {ms:.2f} ms/step (min {times[0]:.2f}, max {times[-1]:.2f}, "
          f"{TRAIN_STEPS} steps) {1e3 * TRAIN_B / ms:.1f} frames/s, peak {peak:.0f} MiB, "
          f"launches/step {per_step[-1]}, loss {losses[0]:.4f} -> {losses[-1]:.4f} on {gpu}",
          flush=True)
    return state, train_step, batch, launches


def train_gradients(cfg, state_dict, batch):
    """Parameter gradients of one training forward + backward (flip off)."""
    from dro_sfm_torch.models.sfm import forward_and_loss
    net = cfg.build_net(device="cuda")
    net.load_state_dict(state_dict, strict=True)
    loss, _ = forward_and_loss(cfg, net, batch, None, do_flip=False)
    loss.backward()
    return {k: p.grad.detach().double() for k, p in net.named_parameters()}, loss.item()


def faulty_backward(kernel):
    """The warp backward with one planted fault: kernel K2 or K3 (``kernel``
    "K2" or "K3") leaves out the (0, 0) tap of every pixel, the heaviest
    tap of a near-identity warp. It runs the real kernel and takes that
    tap's share back out. Returns (name of the `ops.tent_warp` function to
    replace, the faulty function)."""
    from dro_sfm_torch.ops import tent_warp
    from dro_sfm_torch.ops.resample import bilinear_taps
    k2, k3 = tent_warp.warp_diff_bwd_feat, tent_warp.warp_diff_bwd_coords

    def feat(coords, g, h, w, dtype):
        out = k2(coords, g, h, w, torch.float32)
        index, valid, weight, _, _ = bilinear_taps(coords, h, w)
        ok = valid[0]
        out.view(-1, g.shape[-1]).index_add_(0, index[0][ok],
                                             weight[0][ok][:, None] * g.float()[ok])
        return out.to(dtype)

    def coords_grad(features, coords, g):
        # d = -<g, e> with e_x = (1-wy)(F01 - F00) + ..., e_y = (1-wx)(F10 - F00)
        # + ...: without F00, d_x loses (1-wy)<g, F00> and d_y (1-wx)<g, F00>.
        out = k3(features, coords, g)
        bn, h, w, c = features.shape
        index, valid, _, wx, wy = bilinear_taps(coords, h, w)
        f00 = features.reshape(-1, c).float()[index[0]] * valid[0][..., None]
        dot = (g.float() * f00).sum(-1)
        return out - torch.stack([(1 - wy) * dot, (1 - wx) * dot], dim=-1)

    return {"K2": ("warp_diff_bwd_feat", feat),
            "K3": ("warp_diff_bwd_coords", coords_grad)}[kernel]


def bf16_bar(own):
    """The bf16 bar of one leaf, given bf16's own error there (the plain
    warp's bf16 gradient against its fp32 gradient, relative L2)."""
    return BF16_BAR if own < BF16_OWN_NOISY else max(BF16_BAR, BF16_SHARE * own)


def compare_grads(got_all, ref_all, fp32_ref=None, fp32_bar=1e-4):
    """Each leaf of ``got_all`` against ``ref_all`` in fp64: fp32 bars
    (cosine >= 0.99999, rel L2 <= ``fp32_bar``) when ``fp32_ref`` is None,
    else bf16 bars from bf16's own error against ``fp32_ref``. Returns
    (leaves beyond their bar, leaves whose bf16 bar is relaxed, (worst rel
    L2, its leaf), worst cosine); the entries of the two lists are (leaf,
    rel L2, cosine, own error or None, bar). A zero gradient must stay zero;
    a non-finite one is beyond every bar."""
    beyond, relaxed, worst, worst_cos = [], [], (-1.0, ""), 1.0
    for k, ref in ref_all.items():
        got = got_all[k]
        if not torch.isfinite(got).all() or (ref.norm().item() == 0
                                             and got.norm().item() != 0):
            beyond.append((k, math.inf, 0.0, None, 0.0))
            continue
        if ref.norm().item() == 0:
            continue
        r, cos = rel_l2(got, ref), cosine(got, ref)
        if fp32_ref is None:
            own, bar, ok = None, fp32_bar, r <= fp32_bar and cos >= 0.99999
        else:
            own = rel_l2(ref, fp32_ref[k])
            bar = bf16_bar(own)
            ok = r <= bar
            if own >= BF16_OWN_NOISY:
                relaxed.append((k, r, cos, own, bar))
        if not ok:
            beyond.append((k, r, cos, own, bar))
        worst, worst_cos = max(worst, (r, k)), min(worst_cos, cos)
    return beyond, relaxed, worst, worst_cos


def rel_l2(a, b):
    return (a - b).norm().item() / b.norm().item()


def cosine(a, b):
    return (a * b).sum().item() / (a.norm().item() * b.norm().item())


def phase_train_end_to_end():
    """Gradients of one step through the kernels against the plain warp on
    the card, same weights and batch, B=2, flip off, deterministic library
    algorithms (cuDNN's, and index_add_ without atomics), so that the runs
    differ by the warp's backward alone. The weights are those the training
    phase starts from (`start_weights`).

    fp32 (TF32 off): every leaf at cosine >= 0.99999 and relative L2 <= 1e-4
    (K2 sums with atomics and K3 reduces channels in another order: fp32
    reordering, carried through the backward).

    bf16: every leaf at relative L2 <= 2e-2 (BF16_BAR), except where bf16's
    own error (the plain warp's bf16 gradient against its fp32 gradient)
    reaches 0.1: those leaves, where bf16's gradient sums with deep
    cancellation, may differ by 0.25 of that error. The relaxed leaves are
    printed with their readings.

    Planted faults (`faulty_backward`: K2, then K3, leaves out one tap) must
    fail the fp32 bar, and the K3 fault the bf16 bar. A K2 fault moves no
    leaf by more than K2's share of it, printed here (under 1% on the chip),
    which bf16's own error hides: phase 7's bar on K2 alone catches it.

    Leaves are compared in fp64; a zero gradient stays zero."""
    from dro_sfm_torch.ops import tent_warp
    state_dict = start_weights(train_config()).state_dict()
    batch = make_train_batch(2, seed=2)
    grads, losses = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # ops with no deterministic twin
        torch.use_deterministic_algorithms(True, warn_only=True)
        for mp in (False, True):
            for impl, fault in (("pallas", None), ("gather", None), ("pallas", "K2"),
                                ("pallas", "K3")):
                cfg = train_config(mixed_precision=mp, warp_impl=impl, remat=False)
                name, fn = faulty_backward(fault) if fault else (None, None)
                real = getattr(tent_warp, name) if fault else None
                if fault:
                    setattr(tent_warp, name, fn)
                try:
                    grads[mp, fault or impl], losses[mp, fault or impl] = \
                        train_gradients(cfg, state_dict, batch)
                finally:
                    if fault:
                        setattr(tent_warp, name, real)
        torch.use_deterministic_algorithms(False)

    fp32_ref = grads[False, "gather"]
    top = max(g.norm().item() for g in fp32_ref.values())
    for mp, dt in ((False, "fp32"), (True, "bf16")):
        ref_all = grads[mp, "gather"]
        own_ref = fp32_ref if mp else None
        beyond, relaxed, worst, worst_cos = compare_grads(grads[mp, "pallas"], ref_all,
                                                          own_ref)
        for k, r, cos, own, bar in beyond:
            print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own {own} "
                  f"bar {bar:.3e}")
        if beyond:
            fail(f"end to end training {dt}: {len(beyond)} leaves beyond their bar")
        extra = (f"; bar {BF16_BAR:g}, relaxed on {len(relaxed)} leaves (own error >= "
                 f"{BF16_OWN_NOISY:g}), listed below" if mp else "")
        print(f"end to end training {dt} B=2: kernel vs plain gradients over "
              f"{len(ref_all)} leaves (largest fp32 norm {top:.3e}), worst rel L2 "
              f"{worst[0]:.3e} ({worst[1]}), worst cosine {worst_cos:.7f}, loss "
              f"{losses[mp, 'pallas']:.6f} vs {losses[mp, 'gather']:.6f}{extra}",
              flush=True)
        for k, r, cos, own, bar in relaxed:
            print(f"  relaxed: {k} rel L2 {r:.3e} own {own:.3e} bar {bar:.3e}")
        for fault in ("K2", "K3"):
            beyond, _, worst, _ = compare_grads(grads[mp, fault], ref_all, own_ref)
            print(f"end to end training {dt}, planted fault ({fault} leaves out one "
                  f"tap): {len(beyond)} leaves beyond their bar, worst rel L2 "
                  f"{worst[0]:.3e} ({worst[1]})", flush=True)
            if not beyond and (fault == "K3" or not mp):
                fail(f"end to end training {dt}: the bar passes a {fault} that leaves "
                     "out a tap")


# --- K4: the bare warp `tent_warp` -------------------------------------------

def k4_bound(features, coords):
    """Least time of one K4 call: the feature rows the taps reference,
    coords and the fp32 output once over the memory rate; 8 fp32 operations
    per output element over the fp32 rate."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    n_rows = torch.unique(index[valid]).numel()
    n_bytes = (n_rows * c * features.element_size() + coords.numel() * 4
               + coords.shape[0] * coords.shape[1] * c * 4)
    ops = 8 * coords.shape[0] * coords.shape[1] * c
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_k4(gen, counters):
    """K4 (`tent_warp`) against `tent_warp_plain`, and its gradient (K2 and
    K3 with sign +1, K3 on the fp32 cotangent beside bf16 features) against
    the plain versions, at the warp shapes (16 maps of 24x80x128, bf16 and
    fp32) and the edge cases. Bars: K1's for the forward (the same taps and
    fp32 sums: one rounding step of the fp32 output), phase 7's for K2 and
    K3. The B=8 bf16 case is driven through the entry point with every count
    reset just before and read just after (the K4 path): K4, K2 and K3 one
    launch each. Returns (timings, launches of that path)."""
    from dro_sfm_torch.ops.tent_warp import (
        tent_warp,
        tent_warp_plain,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat_plain,
    )
    cases = [(f"warp B={b}", b, 24, 80, 128, dt, "serving")
             for dt in (torch.bfloat16, torch.float32) for b in (1, 8)]
    for dt in (torch.bfloat16, torch.float32):
        cases += [("6x10", 2, 6, 10, 128, dt, "serving"), ("6x10 C=6", 2, 6, 10, 6, dt, "serving"),
                  ("integer", 1, 24, 80, 128, dt, "integer"),
                  ("outside -10", 1, 24, 80, 128, dt, "outside"),
                  ("far +-1e8", 1, 24, 80, 128, dt, "far")]
    timings, path = {}, None
    for name, b, h, w, c, dtype, kind in cases:
        _, features, coords = k1_inputs(gen, b, VIEWS, h, w, c, dtype, kind)
        g = torch.randn(b * VIEWS, h * w, c, generator=gen, device="cuda")   # fp32
        feat = features.clone().requires_grad_()
        co = coords.clone().requires_grad_()
        main = name == "warp B=8" and dtype == torch.bfloat16
        if main:
            for cnt in counters.values():          # the K4 path starts here
                cnt.reset()
        out = tent_warp(feat, co)
        d_feat, d_co = torch.autograd.grad(out, (feat, co), g)
        torch.cuda.synchronize()
        if main:
            path = {k: cnt.launches for k, cnt in counters.items()}   # and ends here
        ref = tent_warp_plain(features, coords)
        ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype, sign=1.0)
        ref_co = warp_diff_bwd_coords_plain(features, coords, g, sign=1.0)
        dt = str(dtype).replace("torch.", "")
        err = (out - ref).abs().max().item()
        err2 = (d_feat.float() - ref_feat.float()).abs().max().item()
        err3 = (d_co - ref_co).abs().max().item()
        tol = k1_tolerance(torch.float32, ref)
        tol2 = k2_tolerance(coords, g, h, w, dtype, ref_feat)
        tol3 = k3_tolerance(features, coords, g)
        line = (f"K4 {name:12s} {dt:8s} max_abs_err {err:.3e} tol {tol:.3e} | d_features "
                f"{err2:.3e} tol {tol2:.3e} | d_coords {err3:.3e} tol {tol3:.3e}")
        if (out.dtype, d_feat.dtype, d_co.dtype) != (torch.float32, dtype, torch.float32):
            fail(f"{line}: dtypes {out.dtype}, {d_feat.dtype}, {d_co.dtype}")
        if not all(torch.isfinite(t).all() for t in (out, d_feat, d_co)):
            fail(f"{line}: non-finite")
        if err > tol or err2 > tol2 or err3 > tol3:
            fail(line)
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            if (out[outside] != 0).any() or (d_co[outside] != 0).any():
                fail(f"K4 {name} {dt}: out-of-view pixels sample or get a gradient")
        if main:
            grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)], -1)
                    * 2 - 1).to(dtype)[:, None]
            feat_nchw = features.permute(0, 3, 1, 2)
            r = {"max_abs_err": err,
                 "ms": time_ms(lambda: tent_warp(features, coords)),
                 "plain_ms": time_ms(lambda: tent_warp_plain(features, coords)),
                 "library_ms": time_ms(lambda: F.grid_sample(
                     feat_nchw, grid, mode="bilinear", padding_mode="zeros",
                     align_corners=True))}
            r["bound_ms"], r["bound_by"] = k4_bound(features, coords)
            timings = r
            line += (f" | kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} library "
                     f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']})"
                     f" | path launches {path}")
        print(line, flush=True)
    want = {"K4": 1, "K2": 1, "K3": 1}
    if {k: v for k, v in path.items() if v} != want:
        fail(f"the K4 path launched {path}, want {want}")
    return timings, path


# --- K5, K6: the fused separable-GRU pass ------------------------------------

GRU_D, GRU_CX = 128, 160           # it12-h-out: hidden 128, context 32 + encoder 128


def gru_inputs(gen, b, h, w, d, cx, dtype):
    """h, x [b,h,w,*] in ``dtype``, fp32 weights He-normal over the 5*C1
    fan-in and small biases, a cotangent g; all on the card."""
    c1 = d + cx
    dev = "cuda"
    std = math.sqrt(2.0 / (5 * c1))
    return {"h": torch.tanh(torch.randn(b, h, w, d, generator=gen, device=dev)).to(dtype),
            "x": torch.relu(torch.randn(b, h, w, cx, generator=gen, device=dev)).to(dtype),
            "wzr": std * torch.randn(5, c1, 2 * d, generator=gen, device=dev),
            "bzr": 0.1 * torch.randn(2 * d, generator=gen, device=dev),
            "wq": std * torch.randn(5, c1, d, generator=gen, device=dev),
            "bq": 0.1 * torch.randn(d, generator=gen, device=dev),
            "g": torch.randn(b, h, w, d, generator=gen, device=dev).to(dtype)}


def gru_bars(dtype):
    """Stated bars for K5/K6 vs plain, relative to the largest element of
    the plain result. fp32: 2^-14, for sums of up to 5 * 288 * 2 products
    (and, in the weight gradients, of every pixel of the batch) taken in
    another order. bf16: a reordered fp32 sum may round a gate, q, daq or
    dazr to the neighbouring bf16 value (2^-8 relative), and the outputs
    round once more: the forward 2^-6 (two rounding steps of the output), dh
    and dx 2^-5 (a flipped daq or dazr reaches them through a transposed
    conv, then dh rounds), the fp32 weight and bias gradients 2^-7 (a
    flipped daq or dazr moves one of the summed terms by 2^-8 of itself)."""
    if dtype == torch.float32:
        return {"fwd": 2.0 ** -14, "act": 2.0 ** -14, "weight": 2.0 ** -14}
    return {"fwd": 2.0 ** -6, "act": 2.0 ** -5, "weight": 2.0 ** -7}


GRU_GRADS = ("dh", "dx", "dwzr", "dbzr", "dwq", "dbq")


def gru_flops(inp, factor):
    """Multiply-adds x 2 of ``factor`` x D output channels of 5-tap convs
    over C1 inputs at every pixel: 3 for K5 and K6-weight, 6 for K6-input."""
    b, h, w, d = inp["h"].shape
    return 2.0 * b * h * w * 5 * (d + inp["x"].shape[-1]) * factor * d


def gru_bound(inp, factor, n_bytes):
    dtype = inp["h"].dtype
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    by_ops, by_bytes = gru_flops(inp, factor) / peak, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


def gru_bounds(inp):
    """Least times of K5, K6-input, K6-weight on this input: the operations
    over the tensor-core bf16 or the fp32 rate, against the bytes of each
    input read once and each output written once (K6-input's outputs include
    r*h, daq and dazr, which K6-weight reads)."""
    e = inp["h"].element_size()
    b, h, w, d = inp["h"].shape
    cx, n = inp["x"].shape[-1], b * h * w
    w_bytes = 5 * (d + cx) * 3 * d * e
    act = n * (d + cx) * e
    return {"K5": gru_bound(inp, 3, act + n * d * e + w_bytes),
            "K6-input": gru_bound(inp, 6, act + 2 * n * d * e + n * (d + cx) * e
                                  + 4 * n * d * e + w_bytes),
            "K6-weight": gru_bound(inp, 3, act + 4 * n * d * e + 5 * (d + cx) * 3 * d * 4)}


def split_pass(inp, axis):
    """The yardstick: one directional pass of `SepConvGRU`'s split path on the
    same tensors (NCHW views, cuDNN convolutions and the gate glue) and a
    function running its backward (autograd, retaining the graph)."""
    from dro_sfm_torch.models.update import SepConvGRU
    b, hh, ww, d = inp["h"].shape
    dtype = inp["h"].dtype
    gru = SepConvGRU(d, inp["x"].shape[-1], dtype=dtype, conv_impl="split").cuda()
    convzr, convq = (gru.convzr1, gru.convq1) if axis == 2 else (gru.convzr2, gru.convq2)
    with torch.no_grad():
        for conv, name in ((convzr, "wzr"), (convq, "wq")):
            wt = inp[name].permute(2, 1, 0)                     # [out, C1, 5]
            conv.weight.copy_(wt[:, :, None, :] if axis == 2 else wt[:, :, :, None])
            conv.bias.copy_(inp["b" + name[1:]])
    h = inp["h"].permute(0, 3, 1, 2).requires_grad_()
    x = inp["x"].permute(0, 3, 1, 2).requires_grad_()

    def fwd():
        zr = torch.sigmoid(convzr(torch.cat([h, x], dim=1)))
        z, r = zr.split(d, dim=1)
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q

    out = fwd()
    g = inp["g"].permute(0, 3, 1, 2)
    params = [h, x, convzr.weight, convzr.bias, convq.weight, convq.bias]
    return fwd, lambda: torch.autograd.grad(out, params, g, retain_graph=True)


def k5_fault(inp, axis, gru_pass):
    """K5 leaving out tap 0 of the candidate conv: the real kernel with that
    tap's weights zeroed."""
    wq = inp["wq"].clone()
    wq[0] = 0
    return gru_pass.gru_pass_fwd(inp["h"], inp["x"], inp["wzr"], inp["bzr"], wq,
                                 inp["bq"], axis)


def k6_fault(inp, axis, gru_pass, dh, dx):
    """K6-input leaving out tap 0 of the daq transposed conv (the tap that
    pairs daq[s - 2] with Wq[4]): the real kernel's dh and dx with that tap's
    share taken back out, the share from the plain version's daq and r."""
    args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
    cdt = inp["h"].dtype
    hs = gru_pass._shift_last(args[0], axis)
    xs = gru_pass._shift_last(args[1], axis)
    d = hs.shape[-1]
    _, z, r, _, q, _ = gru_pass._recompute(hs, xs, args[2].to(cdt), args[3],
                                           args[4].to(cdt), args[5])
    gf = gru_pass._shift_last(inp["g"], axis).float()
    daq = ((gf * z.float()) * (1.0 - q.float() * q.float())).to(cdt)
    share = gru_pass._taps(daq.float())[0] @ args[4][4].to(cdt).float().t()
    share = gru_pass._shift_last(share, axis)
    r = gru_pass._shift_last(r, axis).float()
    return ((dh.float() - share[..., :d] * r).to(dh.dtype),
            (dx.float() - share[..., d:]).to(dx.dtype))


def phase_gru(gen):
    """K5, K6-input and K6-weight against their plain versions on the card:
    the depth pass's shape of the training path (B=8, 24x80, D=128, Cx=160)
    and the pose pass's (B*N=16), both axes, bf16 and fp32; B=1; D=32 Cx=24
    (not multiples of 16); a 3-pixel line; 6x10. Each result beside its bar
    (`gru_bars`); the bars must fail K5 leaving out a tap and K6-input
    leaving out a tap of a transposed conv (`k5_fault`, `k6_fault`). At the
    path's shapes (bf16 and fp32): kernel, plain, split-pass and bound
    times. Returns the timings at the depth shape, bf16, horizontal pass."""
    from dro_sfm_torch.ops import gru_pass
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, what in ((8, "depth"), (16, "pose"), (1, "B=1")):
            for axis in (2, 1):
                cases.append((what, b, 24, 80, GRU_D, GRU_CX, dtype, axis))
        for axis in (2, 1):
            cases += [("D32 Cx24", 2, 8, 16, 32, 24, dtype, axis),
                      ("3-px line", 2, 3, 7, 32, 24, dtype, axis),
                      ("6x10", 2, 6, 10, GRU_D, GRU_CX, dtype, axis)]
    timings = {}
    for what, b, hh, ww, d, cx, dtype, axis in cases:
        inp = gru_inputs(gen, b, hh, ww, d, cx, dtype)
        args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
        out = gru_pass.gru_pass_fwd(*args, axis)
        grads = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
        torch.cuda.synchronize()
        ref = gru_pass.gru_pass_plain(*args, axis)
        refs = gru_pass.gru_pass_bwd_plain(*args, inp["g"], axis)
        bars = gru_bars(dtype)
        dt = str(dtype).replace("torch.", "")

        def rel(a, r):
            return (a.float() - r.float()).abs().max().item() / max(
                r.float().abs().max().item(), 1e-30)

        errs = {"K5": rel(out, ref)}
        line = (f"K5/K6 {what:9s} {b:2d}x{hh}x{ww} D={d} Cx={cx} axis {axis} {dt:8s} "
                f"K5 {errs['K5']:.2e} (bar {bars['fwd']:.1e})")
        bad = errs["K5"] > bars["fwd"] or out.dtype != dtype
        for name, got, want in zip(GRU_GRADS, grads, refs):
            bar = bars["act" if name in ("dh", "dx") else "weight"]
            errs[name] = rel(got, want)
            line += f" {name} {errs[name]:.2e}"
            bad |= (errs[name] > bar or got.shape != want.shape or got.dtype != want.dtype
                    or not torch.isfinite(got).all())
        line += f" (bars {bars['act']:.1e}, {bars['weight']:.1e})"
        if bad or not torch.isfinite(out).all():
            fail(line)
        f5 = rel(k5_fault(inp, axis, gru_pass), ref)
        f6 = max(rel(a, r) for a, r in zip(k6_fault(inp, axis, gru_pass, *grads[:2]),
                                           refs[:2]))
        line += f" | planted faults: K5 {f5:.2e}, K6-input {f6:.2e}"
        if f5 <= bars["fwd"] or f6 <= bars["act"]:
            fail(f"{line}: a bar passes a kernel that leaves out a tap")
        if what in ("depth", "pose") and (axis == 2 or dtype == torch.bfloat16):
            r = time_gru(inp, axis, gru_pass)
            for k in r:
                r[k]["max_abs_err"] = max(errs[n] for n in (
                    ("K5",) if k == "K5" else ("dh", "dx") if k == "K6-input"
                    else GRU_GRADS[2:]))
            line += "".join(f" | {k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} "
                            f"split {v['library_ms']:.4f} bound {v['bound_ms']:.4f}"
                            for k, v in r.items())
            timings[(what, dt, axis)] = r
        print(line, flush=True)
    return timings


def time_gru(inp, axis, gru_pass):
    """Kernel, plain, split-pass and bound times of K5, K6-input and
    K6-weight on one input. The plain time of both K6 halves is that of
    `gru_pass_bwd_plain`, which computes all six gradients; the split time of
    K5 is the split pass's forward, of K6-input its backward (all its
    gradients: cuDNN's data and weight gradients of both convolutions and
    the glue), of K6-weight the same."""
    args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
    prep = gru_pass._Prepared(*args)
    _, _, scratch = gru_pass._launch_k6_input(prep, inp["g"], axis)
    split_fwd, split_bwd = split_pass(inp, axis)
    bwd_plain = time_ms(lambda: gru_pass.gru_pass_bwd_plain(*args, inp["g"], axis), reps=5)
    split_bwd_ms = time_ms(split_bwd)
    out = {"K5": {"ms": time_ms(lambda: gru_pass._launch_k5(prep, axis)),
                  "plain_ms": time_ms(lambda: gru_pass.gru_pass_plain(*args, axis), reps=5),
                  "library_ms": time_ms(split_fwd)},
           "K6-input": {"ms": time_ms(lambda: gru_pass._launch_k6_input(prep, inp["g"], axis)),
                        "plain_ms": bwd_plain, "library_ms": split_bwd_ms},
           "K6-weight": {"ms": time_ms(lambda: gru_pass._launch_k6_weight(prep, scratch, axis)),
                         "plain_ms": bwd_plain, "library_ms": split_bwd_ms}}
    for k, (ms, by) in gru_bounds(inp).items():
        out[k]["bound_ms"], out[k]["bound_by"] = ms, by
    return out


def phase_serving_pallas(DepthPoseNet, make_infer_fn, counters, state, gpu):
    """Serving with ``sep_conv="pallas"``: the same it12-h-out bf16 weights
    as phase 4, B=1 and B=8 through `make_infer_fn`, every count reset just
    before and read just after: K1 24 and K5 48 launches a request, no other
    kernel. The split path is timed in the same phase, requests alternating.
    Then, from `tame_weights` (the random eval-mode net is chaotic: two fp32
    runs that sum in another order part by tens of percent), the outputs of
    both paths on the card in fp32 (TF32 off), bar 1e-4
    relative L2 (the same math; the fused pass sums its convolutions in
    another order than cuDNN, through 24 recurrent steps); in bf16 each
    path's distance to fp32 is printed, the fused path's held to the bar
    5e-2 of the CPU tests' bf16 net. Returns the launches."""
    nets = {}
    for sep in ("pallas", "split"):
        nets[sep] = DepthPoseNet(version="it12-h-out", mixed_precision=True,
                                 warp_impl="pallas", sep_conv=sep, device="cuda")
        nets[sep].load_state_dict(state, strict=True)
    infer = {k: make_infer_fn(v, device="cuda") for k, v in nets.items()}
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    for c in counters.values():              # the pallas serving path starts here
        c.reset()
    for b, req in requests.items():
        for f in infer.values():
            f(*req)                          # warm-up requests
        torch.cuda.synchronize()
        times = {"pallas": [], "split": []}
        counted = {k: 0 for k in counters}
        for _ in range(REQUESTS):
            for sep in ("pallas", "split"):
                before = {k: c.launches for k, c in counters.items()}
                t0 = time.perf_counter()
                depth, mats = infer[sep](*req)
                torch.cuda.synchronize()
                times[sep].append(1e3 * (time.perf_counter() - t0))
                if sep == "pallas":
                    for k, c in counters.items():
                        counted[k] += c.launches - before[k]
                    if not (torch.isfinite(depth).all() and torch.isfinite(mats).all()):
                        fail(f"serving pallas B={b}: non-finite output")
        per_req = {k: v // REQUESTS for k, v in counted.items() if v}
        want = {"K1": K1_STEPS_PER_REQUEST, "K5": 2 * K1_STEPS_PER_REQUEST}
        if per_req != want or any(v % REQUESTS for v in counted.values()):
            fail(f"serving pallas B={b}: launches {counted} over {REQUESTS} requests, want "
                 f"{want} each")
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        print(f"serving sep_conv=pallas it12-h-out bf16 192x640 N=2 B={b}: median "
              f"{med['pallas']:.2f} ms/request (min {min(times['pallas']):.2f}, max "
              f"{max(times['pallas']):.2f}) {1e3 * b / med['pallas']:.1f} frames/s | "
              f"sep_conv=split in turns: median {med['split']:.2f} ms (min "
              f"{min(times['split']):.2f}, max {max(times['split']):.2f}) | launches/request "
              f"{per_req} on {gpu}", flush=True)
    launches = {k: c.launches for k, c in counters.items()}   # the path ends here
    state = tame_weights(state)
    req = requests[1]
    outs = {}
    for mp in (False, True):
        for sep in ("pallas", "split"):
            net = DepthPoseNet(version="it12-h-out", mixed_precision=mp, warp_impl="pallas",
                               sep_conv=sep, device="cuda")
            net.load_state_dict(state, strict=True)
            with torch.inference_mode():
                outs[mp, sep] = net(*req, last_only=True)
    for key in ("inv_depths", "pose_vecs"):
        ref = outs[False, "split"][key]
        rel32 = rel_l2(outs[False, "pallas"][key], ref)
        rel16 = {sep: rel_l2(outs[True, sep][key], ref) for sep in ("pallas", "split")}
        line = (f"serving end to end {key}: pallas vs split fp32 rel L2 {rel32:.3e} (bar "
                f"1e-4); bf16 vs fp32: pallas {rel16['pallas']:.3e} (bar 5e-2), split "
                f"{rel16['split']:.3e}")
        if not (rel32 <= 1e-4 and rel16["pallas"] <= 5e-2):
            fail(line)
        print(line, flush=True)
    return launches


def tame_weights(state, seed=0):
    """The weights of the CPU parity tests (`tests/test_torch_modules.py:
    fill_variables`), drawn with torch from ``seed``: convolution kernels
    N(0, 1/fan_in) (the last convolution of the depth and pose heads times
    0.3), convolution biases N(0, 0.01), BatchNorm scales U(0.5, 1.5), shifts
    and means N(0, 0.1), variances U(0.5, 2). At the seed-0 random weights the
    eval-mode refinement at 192x640 is chaotic (the split path's fp32 and bf16
    runs part by 0.15 relative L2, and fp32 runs that sum in another order by
    up to 0.7); at these it is not."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        module, leaf = k.rsplit(".", 1)
        if leaf == "weight" and v.ndim == 4:
            gain = 0.3 if k.endswith("head.conv2.weight") else 1.0
            new = torch.randn(v.shape, generator=gen) * gain / math.sqrt(v[0].numel())
        elif leaf == "running_var":
            new = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
        elif "bn" in module.rsplit(".", 1)[-1] and leaf == "weight":
            new = 0.5 + torch.rand(v.shape, generator=gen)
        elif leaf == "running_mean" or "bn" in module.rsplit(".", 1)[-1]:
            new = 0.1 * torch.randn(v.shape, generator=gen)
        else:
            new = 0.01 * torch.randn(v.shape, generator=gen)
        out[k] = new.to(device=v.device, dtype=v.dtype)
    return out


@contextlib.contextmanager
def swapped_gru(gru_pass, fwd, bwd):
    """Context: `gru_sep1d_pass` runs ``fwd`` and ``bwd`` in place of
    `gru_pass_fwd` and `gru_pass_bwd` (on CUDA tensors too)."""
    real = gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd
    gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd = fwd, bwd
    try:
        yield
    finally:
        gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd = real


def without_wq_tap0(fn):
    """``fn`` (`gru_pass_fwd` or `gru_pass_bwd`) run with tap 0 of the
    candidate conv's weights zeroed: the kernel leaving out that tap (K6
    in its recompute and in the transposed conv of daq)."""
    def run(h, x, wzr, bzr, wq, bq, *rest):
        wq = wq.clone()
        wq[0] = 0
        return fn(h, x, wzr, bzr, wq, bq, *rest)
    return run


GRU_E2E_FLOOR_FACTOR = 4


def phase_train_pallas_end_to_end():
    """One step's gradients with ``sep_conv="pallas"`` through K5/K6 against
    the same step through the plain GRU pass on the card (B=2, flip off,
    deterministic library algorithms), at `tame_weights`, fp32 (TF32 off)
    and bf16, each leaf against a stated bar.

    fp32: cosine >= 0.99999 and rel L2 <= max(1e-4, 4 x the floor), the
    floor being the widest per-leaf distance between the split path and
    the plain pass on the same step: the same math in fp32, cuDNN's sum
    order against the plain version's, carried through 24 recurrent steps
    and the backward. bf16: phase 9's bars (`compare_grads`), bf16's own
    error taken from the plain pass's bf16 and fp32 gradients.

    Planted faults, in fp32 and bf16: K5 leaving out tap 0 of the candidate
    conv, and K6 doing so (`without_wq_tap0`); each must put leaves beyond
    the bars.

    Why `tame_weights`: at the start weights of phase 8 the training
    forward amplifies a reordered fp32 sum, so the kernel and the plain
    pass part by tens of percent there, as far as the split path and the
    plain pass do; both readings are printed, not held. Phase 9 holds the
    warp kernels at the start weights because K1 repeats its plain version
    bit for bit, so both of its runs share one forward."""
    from dro_sfm_torch.ops import gru_pass
    start = start_weights(train_config()).state_dict()
    batch = make_train_batch(2, seed=2)
    kernel = (gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd)
    swaps = {"plain": (gru_pass.gru_pass_plain, gru_pass.gru_pass_bwd_plain),
             "K5 fault": (without_wq_tap0(kernel[0]), kernel[1]),
             "K6 fault": (kernel[0], without_wq_tap0(kernel[1]))}

    def run(state, mp, variant):
        cfg = train_config(mixed_precision=mp, remat=False,
                           sep_conv="split" if variant == "split" else "pallas")
        with swapped_gru(gru_pass, *swaps.get(variant, kernel)):
            return train_gradients(cfg, state, batch)

    grads, losses = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        chaos = {v: run(start, False, v)[0] for v in ("kernel", "plain", "split")}
        tame = tame_weights(start)
        for mp in (False, True):
            for v in ("kernel", "plain", "K5 fault", "K6 fault") + (() if mp else ("split",)):
                grads[mp, v], losses[mp, v] = run(tame, mp, v)
        torch.use_deterministic_algorithms(False)
    floors = {}
    for name, got, ref in (("start weights fp32: K5/K6 vs plain", chaos["kernel"],
                            chaos["plain"]),
                           ("start weights fp32: split vs plain", chaos["split"],
                            chaos["plain"]),
                           ("tame weights fp32: split vs plain (the floor)",
                            grads[False, "split"], grads[False, "plain"])):
        _, _, floors[name], worst_cos = compare_grads(got, ref)
        print(f"end to end training sep_conv=pallas, {name}, printed, not held: worst rel "
              f"L2 {floors[name][0]:.3e} ({floors[name][1]}), worst cosine {worst_cos:.7f}",
              flush=True)
    fp32_bar = max(1e-4, GRU_E2E_FLOOR_FACTOR * floors[name][0])
    failed = []
    for mp, dt in ((False, "fp32"), (True, "bf16")):
        ref, own = grads[mp, "plain"], (grads[False, "plain"] if mp else None)
        beyond, relaxed, worst, worst_cos = compare_grads(grads[mp, "kernel"], ref, own,
                                                          fp32_bar)
        for k, r, cos, own_err, bar in beyond:
            print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own {own_err} "
                  f"bar {bar:.3e}")
        bar_text = (f"bar {BF16_BAR:g}, {len(relaxed)} leaves on relaxed bars" if mp
                    else f"bar {fp32_bar:.3e}")
        print(f"end to end training sep_conv=pallas {dt} B=2 at tame weights: K5/K6 vs "
              f"plain GRU pass over {len(ref)} leaves, {len(beyond)} beyond their bar "
              f"({bar_text}), worst rel L2 {worst[0]:.3e} ({worst[1]}), worst cosine "
              f"{worst_cos:.7f}, loss {losses[mp, 'kernel']:.6f} vs "
              f"{losses[mp, 'plain']:.6f}", flush=True)
        if beyond:
            failed.append(f"{dt}: {len(beyond)} leaves beyond their bar")
        for fault in ("K5 fault", "K6 fault"):
            n, _, worst, _ = compare_grads(grads[mp, fault], ref, own, fp32_bar)
            print(f"end to end training sep_conv=pallas {dt}, planted {fault} (tap 0 of Wq "
                  f"left out): {len(n)} leaves beyond their bar, worst rel L2 "
                  f"{worst[0]:.3e} ({worst[1]})", flush=True)
            if not n:
                failed.append(f"{dt}: the bar passes the planted {fault}")
    if failed:
        fail("end to end training sep_conv=pallas " + "; ".join(failed))


def device_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_train_step(state, train_step, batch):
    """Device time by kernel over one B=8 train step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    flips = torch.Generator().manual_seed(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, flips)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    print(f"profile train step B={TRAIN_B}: wall {wall_us:.0f} us, device busy "
          f"{total:.0f} us ({100 * total / wall_us:.1f}%), {sum(e.count for e in kernels)}"
          " kernel launches", flush=True)
    if total == 0:
        print("profile train step: the profiler recorded no device time (not measured)")
    for e in sorted(kernels, key=device_us, reverse=True)[:20]:
        print(f"  {device_us(e):9.0f} us {e.count:5d}x  {e.key[:90]}")
    for e in kernels:
        if "tent_warp" in e.key or "gru_pass" in e.key:
            print(f"profile train step: {e.key[:60]} {device_us(e):.0f} us over "
                  f"{e.count} launches, {device_us(e) / e.count:.2f} us each")


PHASES = ("k1", "serving", "e2e", "profile", "k23", "train", "train_e2e", "train_profile",
          "k4", "gru", "serving_pallas", "train_pallas", "train_pallas_e2e",
          "train_pallas_profile")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run after the build (all by "
                             "default; the result lines are printed only for all)")
    only = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on an NVIDIA GPU")
    unknown = set(only) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}; phases are {PHASES}")
    sys.path.insert(0, str(ROOT))

    from dro_sfm_torch import kernels
    from dro_sfm_torch.inference import make_infer_fn
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.ops.gru_pass import K5_COUNTER, K6I_COUNTER, K6W_COUNTER
    from dro_sfm_torch.ops.tent_warp import (
        K1_COUNTER,
        K2_COUNTER,
        K3_COUNTER,
        K4_COUNTER,
        warp_diff,
        warp_diff_plain,
    )
    counters = {"K1": K1_COUNTER, "K2": K2_COUNTER, "K3": K3_COUNTER, "K4": K4_COUNTER,
                "K5": K5_COUNTER, "K6-input": K6I_COUNTER, "K6-weight": K6W_COUNTER}
    clock = {"start": time.perf_counter()}

    def phase(name, fn, *args):
        """Run phase ``name`` if asked for, printing its seconds."""
        if name not in only:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    # 1) device
    gpu = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(TF32 off: fp32 runs in fp32)", flush=True)

    # 2) build: every kernel, one nvcc each, all started together
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} {entry[:60]}: {line.strip()}")

    # 3) K1 vs plain
    k1 = phase("k1", phase_k1, warp_diff, warp_diff_plain)

    # 4) serving (its K1 launches are checked there)
    served = phase("serving", phase_serving, DepthPoseNet, make_infer_fn, counters, gpu)
    if served is not None:
        net, requests, serve_launches = served
        if serve_launches == 0:
            fail("the serving path never launched K1")
        state = net.state_dict()
        # 5) end to end, kernel vs plain; 6) profile
        phase("e2e", phase_end_to_end, DepthPoseNet, net, requests)
        phase("profile", profile_request, net, requests, make_infer_fn)
        del net, requests

    # 7) K2/K3 vs plain
    k23 = phase("k23", phase_k23, torch.Generator(device="cuda").manual_seed(1))

    # 8) training (a main path: its K1-K3 launches go into the kernels line)
    trained = phase("train", phase_train, counters, gpu)
    if trained is not None:
        _, _, _, launches = trained
        for name in TRAIN_LAUNCHES:
            if launches[name] == 0:
                fail(f"the training path never launched {name}")
        # 9) training end to end, kernel vs plain warp; 10) profile
        phase("train_e2e", phase_train_end_to_end)
        phase("train_profile", profile_train_step, *trained[:3])
        del trained

    # 11) K4 vs plain, and the K4 path (the entry point tent_warp)
    k4 = phase("k4", phase_k4, torch.Generator(device="cuda").manual_seed(2), counters)

    # 12) K5/K6 vs plain
    gru = phase("gru", phase_gru, torch.Generator(device="cuda").manual_seed(3))

    # 13) serving with sep_conv="pallas" (K1 24 and K5 48 launches a request)
    if "serving_pallas" in only:
        if served is None:
            fail("phase serving_pallas needs phase serving's weights")
        phase("serving_pallas", phase_serving_pallas, DepthPoseNet, make_infer_fn,
              counters, state, gpu)

    # 14) training with sep_conv="pallas" (a main path: K5, K6 launches)
    trained_p = phase("train_pallas", phase_train, counters, gpu, "pallas",
                      TRAIN_LAUNCHES_PALLAS)
    if trained_p is not None:
        launches_p = trained_p[3]
        for name in TRAIN_LAUNCHES_PALLAS:
            if launches_p[name] == 0:
                fail(f"the sep_conv=pallas training path never launched {name}")
        # 15) its gradients against the plain GRU pass; 16) profile
        phase("train_pallas_e2e", phase_train_pallas_end_to_end)
        phase("train_pallas_profile", profile_train_step, *trained_p[:3])
        del trained_p
    print(f"all phases: {time.perf_counter() - clock['start']:.1f} s", flush=True)
    if set(only) != set(PHASES):
        print(f"ran phases {only} only: no result line", flush=True)
        return 0

    src = "dro_sfm_torch/csrc/"
    warp = "dro_sfm_tpu/ops/pallas/tent_warp.py:"
    gru_tpu = "dro_sfm_tpu/ops/pallas/gru_pass.py:"
    timed = k23[(8, "bfloat16")]
    gru_timed = gru[("depth", "bfloat16", 2)]
    lines = [
        {"name": "tent_warp_fwd_diff (K1)", "route": "cuda",
         "source": src + "tent_warp_fwd.cu", "replaces": warp + "182",
         "launches": launches["K1"], **k1[(8, "bfloat16")]},
        {"name": "tent_warp_bwd_feat (K2)", "route": "cuda",
         "source": src + "tent_warp_bwd.cu", "replaces": warp + "264",
         "launches": launches["K2"], **timed["K2"]},
        {"name": "tent_warp_bwd_coords (K3)", "route": "cuda",
         "source": src + "tent_warp_bwd.cu", "replaces": warp + "205",
         "launches": launches["K3"], **timed["K3"]},
        {"name": "tent_warp_fwd (K4)", "route": "cuda",
         "source": src + "tent_warp_fwd.cu", "replaces": warp + "125",
         "launches": k4[1]["K4"], **k4[0]},
        {"name": "gru_pass_fwd (K5)", "route": "cuda",
         "source": src + "gru_pass_fwd.cu", "replaces": gru_tpu + "270",
         "launches": launches_p["K5"], **gru_timed["K5"]},
        {"name": "gru_pass_bwd_input (K6-input)", "route": "cuda",
         "source": src + "gru_pass_bwd.cu", "replaces": gru_tpu + "287",
         "launches": launches_p["K6-input"], **gru_timed["K6-input"]},
        {"name": "gru_pass_bwd_weight (K6-weight)", "route": "cuda",
         "source": src + "gru_pass_bwd.cu", "replaces": gru_tpu + "287",
         "launches": launches_p["K6-weight"], **gru_timed["K6-weight"]},
    ]
    print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
