#!/usr/bin/env python3
"""Time the GRU backward kernels K6-input and K6-weight
(`dro_sfm_torch/csrc/gru_pass_bwd.cu`) built with other settings of their
tile engine (`csrc/gru_gemm.cuh`: the blocks an SM K6-input's register
budget is cut for), on one NVIDIA GPU, at the depth and pose passes of
it12-h-out training (bf16, both axes). Each setting's gradients must equal
the default build's bit for bit. Two diagnostic builds leave the main
loop's copies or its products out (wrong results, not compared): their
times split a kernel's time between feeding the tensor cores and using
them. For every build the depth pass along W is also profiled kernel by
kernel. Last, K6-weight's split of the pixels (the grid's blocks an SM) is
varied on the default build.

    python3 tools/torch_gru_k6_tiles.py
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dro_sfm_torch import kernels  # noqa: E402
from dro_sfm_torch.ops import gru_pass  # noqa: E402

VARIANTS = {"default (K6-input: register budget for 4 blocks/SM)": [],
            "K6-input register budget for 3 blocks/SM": ["-DGRU_GEMM_MIN_BLOCKS=3"],
            "K6-input register budget for 2 blocks/SM": ["-DGRU_GEMM_MIN_BLOCKS=2"],
            "diagnostic: no copies": ["-DGRU_GEMM_SKIP_COPIES"],
            "diagnostic: no products": ["-DGRU_GEMM_SKIP_PRODUCTS"]}
# K6-weight's split of the pixels, in blocks an SM for the whole grid (the
# wrapper's `_K6W_BLOCKS_PER_SM`), timed on the default build.
GRID_BLOCKS_PER_SM = (2, 4, 1)


def kernel_times(prep, g, scratch, axis, reps=10):
    """Mean device us of each K6 kernel over ``reps`` calls of each half, in
    the second of two profiler sessions (the first can drop launches)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gru_pass._launch_k6_input(prep, g, axis)
                gru_pass._launch_k6_weight(prep, scratch, axis)
            torch.cuda.synchronize()
    return ", ".join(f"{chip_smoke.kernel_name(e.key)} {chip_smoke.device_us(e) / reps:.1f}"
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and chip_smoke.kernel_name(e.key).startswith("gru_pass_bwd"))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line(), flush=True)
    base = list(kernels.NVCC_FLAGS)
    started = {}
    for name, extra in VARIANTS.items():           # one nvcc each, all together
        kernels.NVCC_FLAGS[:] = base + extra
        started[name] = (kernels.library_path("gru_pass_bwd"),
                         kernels._start_build("gru_pass_bwd"))
    kernels.NVCC_FLAGS[:] = base
    for name, (_, build) in started.items():
        kernels._finish_build("gru_pass_bwd", build)
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = {what: chip_smoke.gru_inputs(gen, b, 24, 80, chip_smoke.GRU_D, chip_smoke.GRU_CX,
                                          torch.bfloat16)
              for what, b in (("depth", 8), ("pose", 16))}
    ref = {}
    for name, (path, _) in started.items():
        kernels._loaded["gru_pass_bwd"] = ctypes.CDLL(str(path))
        diagnostic = name.startswith("diagnostic")
        line, per_kernel = f"{name:48s}", ""
        for what, inp in inputs.items():
            args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
            for axis in (2, 1):
                grads = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
                same = diagnostic or all(torch.equal(a, b) for a, b in zip(
                    grads, ref.setdefault((what, axis), grads)))
                prep = gru_pass._Prepared(*args)
                _, _, scratch = gru_pass._launch_k6_input(prep, inp["g"], axis)
                t_in = chip_smoke.time_ms(
                    lambda: gru_pass._launch_k6_input(prep, inp["g"], axis))
                t_w = chip_smoke.time_ms(
                    lambda: gru_pass._launch_k6_weight(prep, scratch, axis))
                line += (f" | {what} axis {axis}: input {1e3 * t_in:7.1f} us weight "
                         f"{1e3 * t_w:7.1f} us{'' if same else ' DIFFERS'}")
                if what == "depth" and axis == 2:
                    per_kernel = kernel_times(prep, inp["g"], scratch, axis)
        print(line, flush=True)
        print(f"{'':48s} | depth axis 2 by kernel, us: {per_kernel}", flush=True)
    kernels._loaded["gru_pass_bwd"] = ctypes.CDLL(str(next(iter(started.values()))[0]))
    default = gru_pass._K6W_BLOCKS_PER_SM
    for per_sm in GRID_BLOCKS_PER_SM:
        gru_pass._K6W_BLOCKS_PER_SM = per_sm
        line = f"K6-weight grid of {per_sm} blocks an SM"
        for what, inp in inputs.items():
            args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
            for axis in (2, 1):
                prep = gru_pass._Prepared(*args)
                _, _, scratch = gru_pass._launch_k6_input(prep, inp["g"], axis)
                grads = gru_pass._launch_k6_weight(prep, scratch, axis)
                same = all(torch.equal(a, b) for a, b in zip(grads, ref[(what, axis)][2:]))
                t_w = chip_smoke.time_ms(
                    lambda: gru_pass._launch_k6_weight(prep, scratch, axis))
                line += (f" | {what} axis {axis}: {1e3 * t_w:7.1f} us"
                         f"{'' if same else ' (other split: sums in another order)'}")
        print(line, flush=True)
    gru_pass._K6W_BLOCKS_PER_SM = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
