#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check its kernels.

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
   and the card's busy share of that request.

The last three lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
SERVE_H, SERVE_W, VIEWS, REQUESTS = 192, 640, 2, 20
K1_STEPS_PER_REQUEST = 24          # it12: 3 outer x (4 depth + 4 pose) steps


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


def phase_serving(DepthPoseNet, make_infer_fn, K1_COUNTER, gpu):
    net = DepthPoseNet(version="it12-h-out", mixed_precision=True,
                       warp_impl="pallas", device="cuda",
                       generator=torch.Generator().manual_seed(0))
    infer = make_infer_fn(net, device="cuda")
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    K1_COUNTER.reset()                       # the main path starts here
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
    launches = K1_COUNTER.launches           # the main path ends here
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
    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

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


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))

    from dro_sfm_torch import kernels
    from dro_sfm_torch.inference import make_infer_fn
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.ops.tent_warp import K1_COUNTER, warp_diff, warp_diff_plain

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

    # 2) build
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3) kernel vs plain
    k1 = phase_k1(warp_diff, warp_diff_plain)

    # 4) serving (the main path)
    net, requests, launches = phase_serving(DepthPoseNet, make_infer_fn,
                                            K1_COUNTER, gpu)
    if launches == 0:
        fail("the serving path never launched K1")

    # 5) end to end, kernel vs plain
    phase_end_to_end(DepthPoseNet, net, requests)

    # 6) profile
    profile_request(net, requests, make_infer_fn)

    line = {"name": "tent_warp_fwd_diff (K1)", "route": "cuda",
            "source": "dro_sfm_torch/csrc/tent_warp_fwd.cu",
            "replaces": "dro_sfm_tpu/ops/pallas/tent_warp.py:182",
            "launches": launches, **k1[(8, "bfloat16")]}
    print(json.dumps({"kernels": [line]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
