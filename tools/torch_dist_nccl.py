#!/usr/bin/env python3
"""Training in several processes on several NVIDIA GPUs of one host, NCCL
between them: the port's step on one rank a card against one process on
the whole batch, and `Trainer.fit` on every card.

    python3 tools/torch_dist_nccl.py            # on a host with 2 or more cards

It builds the kernels, then runs this file with ``--worker`` under
`dro_sfm_torch.scripts.launch_multihost`, one rank a card (NCCL; the host
values on the gloo group beside it). Each rank:

1. rank 0 alone, before it joins the group: the one-process step on the
   global batch of `chip_smoke.dist_batch` (SupModelMF it12-h-out 192x640,
   B=8, `chip_smoke.tame_weights`, the flip off), in bf16 and fp32;
2. the step on its shard (B=8 / ranks), bf16 then fp32, rank 0 drawing no
   flip and the others a flip (rank 0's holds): the launches a step (K1 24,
   K2 24, K3 18), the gradients equal on every rank bit for bit, and on
   rank 0 within `chip_smoke.dist_verdict`'s bars of the one-process step;
3. 3 timed steps and a profiled one: ms a step, and the host's time inside
   the ``collective:`` spans of `dro_sfm_torch.parallel.collectives`;
4. `Trainer.fit` on ``configs/train_synthetic_192x640.yaml`` cut to one
   epoch of 2 steps a rank (64 scenes, B=8 a rank) and one validation
   batch a rank: the launches a step and an eval batch, equal losses and
   metrics on every rank, one checkpoint, rank 0's.

Every rank prints its lines; a failure exits non-zero, and the launcher
stops the other ranks.
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BUILD = ROOT / "build" / "dist_nccl"


def check(ok, msg):
    if not ok:
        print(f"FAILED on rank {os.environ.get('RANK')}: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def worker():
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dro_sfm_torch.parallel.collectives import SPAN
    from dro_sfm_torch.parallel.mesh import local_device, maybe_init_distributed
    from dro_sfm_torch.training.trainer import Trainer
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = local_device()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counters = cs.counter_map()
    gpu = cs.nvidia_smi_line()
    start = cs.tame_weights(cs.start_weights(cs.train_config()).state_dict())
    batch = cs.dist_batch()
    fp32 = cs.train_config(mixed_precision=False)
    if rank == 0:                     # one process on the whole batch, no group yet
        ref = cs.dist_step(cs.train_config(), start, batch, None, do_flip=False)[3:]
        ref32 = cs.dist_step(fp32, start, batch, None, do_flip=False)[3:]
        own = cs.leaf_errors(ref[1], ref32[1])
    check(maybe_init_distributed(device) and dist.get_backend() == "nccl",
          "no NCCL process group from the environment")
    check(cs.TRAIN_B % world == 0, f"B={cs.TRAIN_B} does not split over {world} ranks")
    per = cs.TRAIN_B // world
    shard = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}

    for c in counters.values():
        c.reset()
    net, step, state, metrics, grads, after = cs.dist_step(
        cs.train_config(), start, shard, cs.flip_generator_for(rank != 0))
    launches = {k: c.launches for k, c in counters.items()}
    check(launches == {k: cs.TRAIN_LAUNCHES.get(k, 0) for k in counters},
          f"launches a step {launches}")
    results = {"bf16": (metrics, grads, after)}
    results["fp32"] = cs.dist_step(fp32, start, shard, cs.flip_generator_for(rank != 0))[3:]
    for what, (_, g, _) in results.items():
        flat = torch.cat([v.reshape(-1) for v in g.values()])
        mine = flat.clone()
        dist.broadcast(flat, src=0)
        check(torch.equal(flat, mine), f"{what} gradients differ from rank 0's")
    if rank == 0:
        failures, worst, rel = cs.dist_verdict(results["bf16"], ref, own)
        failures32, worst32, rel32 = cs.dist_verdict(results["fp32"], ref32)
        check(not failures and not failures32,
              f"against one process: {failures[:4]} {failures32[:4]}")
        print(f"dist_nccl {world} ranks, one card each (NCCL), B={per} a rank, against one "
              f"process on B={cs.TRAIN_B}: bf16 loss relative {rel:.2e} (bar {cs.BF16_BAR:g}), "
              f"worst leaf {worst[0]:.3e} ({worst[1]}, own error "
              f"{own.get(worst[1], 0.0):.3e}); fp32 loss relative {rel32:.2e} (bar 1e-5), "
              f"worst leaf {worst32[0]:.3e} ({worst32[1]}, bar 1e-2); gradients equal on "
              f"every rank; launches a step {launches}; on {gpu}", flush=True)

    flips = torch.Generator().manual_seed(5)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, shard, flips)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, shard, flips)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = {e.key[len(SPAN):]: (e.count, e.cpu_time_total / 1e3) for e in prof.key_averages()
             if e.key.startswith(SPAN) and e.device_type == torch.autograd.DeviceType.CPU}
    in_spans = sum(t for _, t in spans.values())
    print(f"dist_nccl rank {rank}: ms a step {' / '.join(f'{v:.2f}' for v in times)}; "
          f"collectives' share of the profiled step (host time in the collective spans) "
          f"{in_spans:.2f} of {wall:.2f} ms ({100 * in_spans / wall:.1f}%): "
          + ", ".join(f"{k} {n}x {t:.2f} ms" for k, (n, t) in sorted(spans.items())),
          flush=True)
    del net, step, state
    torch.cuda.empty_cache()

    cfg = cs.trainer_config(max_epochs=1)
    cfg.checkpoint.filepath = str(BUILD / "ckpt")
    cfg.save.folder = str(BUILD / "depth")
    cfg.datasets.train.split = [str(2 * cs.TRAIN_B * world)]
    trainer = Trainer(cfg, device=device)
    train = trainer.train_step = cs.CountedStep(trainer.train_step, counters, timed=True)
    evaluate = cs.CountedStep(trainer.eval_step_for(False), counters)
    trainer._eval_steps[False] = evaluate
    for c in counters.values():
        c.reset()
    fitted = trainer.fit()
    check(len(train.launches) == 2 and len(evaluate.launches) == 1,
          f"{len(train.launches)} steps, {len(evaluate.launches)} eval batches")
    for what, calls, want in (("train step", train.launches, cs.TRAIN_LAUNCHES),
                              ("eval batch", evaluate.launches, cs.EVAL_LAUNCHES)):
        for got in calls:
            check(got == {k: want.get(k, 0) for k in counters}, f"{what} launches {got}")
    losses = [m["loss"].item() for _, m in train.outputs]
    values = torch.tensor(losses + [fitted["abs_rel_pp_gt"], fitted["rot_ang"]],
                          dtype=torch.float64, device=device)
    mine = values.clone()
    dist.broadcast(values, src=0)
    check(torch.equal(values, mine) and all(math.isfinite(v) for v in mine.tolist()),
          f"losses and metrics {mine.tolist()} against rank 0's {values.tolist()}")
    dist.barrier()
    files = sorted(p.name for p in (BUILD / "ckpt").glob("*.ckpt"))
    check(len(files) == 1 and len(trainer.checkpointer.saved) == (rank == 0),
          f"checkpoints {files}, this rank's {trainer.checkpointer.saved}")
    print(f"dist_nccl rank {rank} Trainer.fit: ms a step "
          f"{' / '.join(f'{v:.2f}' for v in train.ms)}, losses {losses}, abs_rel_pp_gt "
          f"{fitted['abs_rel_pp_gt']!r} (equal on every rank), checkpoint {files[0]} by "
          f"rank 0 alone; launches a step {train.launches[-1]}", flush=True)
    dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        cs.fail("this check needs a host with two or more NVIDIA GPUs")
    import shutil

    from dro_sfm_torch import kernels
    shutil.rmtree(BUILD, ignore_errors=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    nprocs = torch.cuda.device_count()
    try:
        res = subprocess.run([sys.executable, "-m", "dro_sfm_torch.scripts.launch_multihost",
                              "--nprocs", str(nprocs), "--", __file__, "--worker"],
                             cwd=ROOT, timeout=900)
    finally:
        shutil.rmtree(BUILD, ignore_errors=True)
    print(f"dist_nccl: {nprocs} ranks, exit code {res.returncode}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
