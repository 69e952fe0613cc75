#!/usr/bin/env python3
"""How far apart two bf16 implementations of the fused GRU pass lie in a
whole training step's gradients, on one NVIDIA GPU: the stride-8 and the
stride-4 net (`feat_ratio` 8 and 4, it12-h-out at 192x640), B=2 and B=8,
at `chip_smoke.tame_weights`, flip off, deterministic library algorithms,
remat.

For each point it takes one step's gradients in fp32 through the plain GRU
pass and in bf16 through the plain pass, K5/K6 and the split path (cuDNN's
convolutions), and prints for K5/K6 and for the split path: the leaves
beyond phase 15's bf16 bar (`chip_smoke.compare_grads`), the largest
distance to the bf16 plain pass as a share of bf16's own error (the bf16
plain pass against the fp32 one), and the largest error against the fp32
plain pass as a multiple of bf16's own. It is the yardstick behind the
bf16 bar of `chip_smoke.py` phase `stride4`.

    python3 tools/torch_gru_bf16_reach.py
"""
from __future__ import annotations

import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dro_sfm_torch import kernels  # noqa: E402
from dro_sfm_torch.ops import gru_pass  # noqa: E402


def step_gradients(ratio, tame, batch):
    """fp32 through the plain pass; bf16 through the plain pass, K5/K6 and
    the split path."""
    plain = (gru_pass.gru_pass_plain, gru_pass.gru_pass_bwd_plain)
    kern = (gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd)
    runs = [(False, "plain", "pallas", plain), (True, "plain", "pallas", plain),
            (True, "kernel", "pallas", kern), (True, "split", "split", kern)]
    grads = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        for mp, name, sep, swap in runs:
            cfg = cs.train_config(mixed_precision=mp, sep_conv=sep, remat=True)
            with cs.swapped_gru(gru_pass, *swap):
                grads[mp, name] = cs.train_gradients(cfg, tame, batch, ratio)[0]
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
    return grads


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this tool runs on an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    gpu = cs.nvidia_smi_line()
    starts = {8: cs.start_weights(cs.train_config()).state_dict(),
              4: cs.stride4_net().state_dict()}
    for ratio, start in starts.items():
        tame = cs.tame_weights(start)
        for b in (2, 8):
            g = step_gradients(ratio, tame, cs.make_train_batch(b, seed=2))
            fp32, plain = g[False, "plain"], g[True, "plain"]
            leaves = [k for k in fp32 if fp32[k].norm() > 0]
            own = {k: max(cs.rel_l2(plain[k], fp32[k]), 1e-30) for k in leaves}
            for name in ("kernel", "split"):
                beyond, _, worst, _ = cs.compare_grads(g[True, name], plain, fp32)
                share = max((cs.rel_l2(g[True, name][k], plain[k]) / own[k], k) for k in leaves)
                err = max((cs.rel_l2(g[True, name][k], fp32[k]) / own[k], k) for k in leaves)
                print(f"feat_ratio={ratio} B={b} bf16 {name} vs plain GRU pass: {len(beyond)} "
                      f"leaves beyond phase 15's bar, worst {worst[0]:.3e} ({worst[1]}); "
                      f"largest share of own {share[0]:.3f} ({share[1]}); its error against "
                      f"fp32 plain over plain's own: max {err[0]:.3f} ({err[1]}) on {gpu}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
