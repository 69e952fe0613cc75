#!/usr/bin/env python3
"""Time K4, the bare warp (`dro_sfm_torch/csrc/tent_warp_fwd.cu:tent_warp_fwd`),
against another build of it on one NVIDIA GPU, at the warp shapes of
`chip_smoke.py` phase k4: 16 maps of 24x80x128 in bf16 (B=8), 2 maps (B=1),
and 16 in fp32.

Timed: K4 on the wrapper's plan, its "unaligned" variant (the features one
element past an aligned address), `grid_sample` and, with ``--baseline``,
another build of K4, each first checked against the plain version (it must
give its bits); and an empty kernel, whose cold time is what a call timed
by its own events costs beyond its work (the launch after the flush and the
events). All are timed warm (`chip_smoke.time_ms`) and cold
(`chip_smoke.time_cold_ms`) in rounds, the order reversed every other round,
so that they are compared within one call on one card. Printed: the median
and the spread over the rounds of each, beside the bound.

    python3 tools/torch_tent_warp_k4_variants.py
    python3 tools/torch_tent_warp_k4_variants.py --baseline OTHER/dro_sfm_torch/csrc/tent_warp_fwd.cu

``--baseline`` builds a `tent_warp_fwd.cu` of the earlier design (one group
of 16 lanes a pixel, per-element stores), whose C entry takes (feat, coords,
out, bn, P, h, w, C, dtype, vectorized, stream), with the same nvcc flags.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dro_sfm_torch import kernels  # noqa: E402
from dro_sfm_torch.ops import tent_warp as tw  # noqa: E402

POINTS = (("B=8 bf16", 8, torch.bfloat16), ("B=1 bf16", 1, torch.bfloat16),
          ("B=8 fp32", 8, torch.float32))


def build_baseline(src: Path) -> ctypes.CDLL:
    out = kernels.build_dir() / "libk4_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.tent_warp_fwd.restype = ctypes.c_int
    lib.tent_warp_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def baseline_fn(lib, features, coords):
    b, h, w, c = features.shape
    p = coords.shape[1]

    def run():
        out = torch.empty((b, p, c), dtype=torch.float32, device="cuda")
        err = lib.tent_warp_fwd(features.data_ptr(), coords.data_ptr(), out.data_ptr(), b,
                                p, h, w, c, tw._DTYPE_CODE[features.dtype], 1,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline K4 launch failed: CUDA error {err}")
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, help="another tent_warp_fwd.cu to time")
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line(), flush=True)
    lib = build_baseline(args.baseline) if args.baseline else None
    sms = kernels.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for point, b, dtype in POINTS:
        _, features, coords = chip_smoke.k1_inputs(gen, b, chip_smoke.VIEWS, 24, 80, 128,
                                                   dtype, "serving")
        bn, h, w, c = features.shape
        n_pix = bn * coords.shape[1]
        ref = tw.tent_warp_plain(features, coords)
        runs = {}
        for feat in (features, chip_smoke.misaligned(features)):
            plan = tw.k4_plan(n_pix, c, feat.element_size(), feat.data_ptr(), 0, sms)
            name = (f"{plan.variant} tile {plan.tile_pix} x {plan.tiles_per_block} "
                    f"grid {plan.grid}")
            runs[name] = lambda f=feat: tw.tent_warp(f, coords)
        if lib is not None:
            runs["baseline (other build)"] = baseline_fn(lib, features, coords)
        for name, fn in runs.items():
            if not torch.equal(fn(), ref):
                print(f"{point} {name}: differs from the plain version", flush=True)
                return 1
        grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)], -1)
                * 2 - 1).to(dtype)[:, None]
        feat_nchw = features.permute(0, 3, 1, 2)
        runs["grid_sample"] = lambda: F.grid_sample(feat_nchw, grid, mode="bilinear",
                                                    padding_mode="zeros", align_corners=True)
        runs["empty kernel"] = lambda: torch.cuda._sleep(0)
        warm = {k: [] for k in runs}
        cold = {k: [] for k in runs}
        for rnd in range(args.rounds):
            order = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
            for k in order:
                warm[k].append(1e3 * chip_smoke.time_ms(runs[k]))
                cold[k].append(1e3 * chip_smoke.time_cold_ms(runs[k]))
        bound, by = chip_smoke.k4_bound(features, coords)
        print(f"{point}: bound {1e3 * bound:.2f} us ({by}); us, median [min-max] of "
              f"{args.rounds} rounds", flush=True)
        for k in runs:
            wm, cm = statistics.median(warm[k]), statistics.median(cold[k])
            print(f"  {k:36s} warm {wm:7.2f} [{min(warm[k]):.2f}-{max(warm[k]):.2f}] "
                  f"({100 * 1e3 * bound / wm:5.1f}% of bound)  cold {cm:7.2f} "
                  f"[{min(cold[k]):.2f}-{max(cold[k]):.2f}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
