#!/usr/bin/env python3
"""The height split (``arch.spatial_shards``) over the NVIDIA GPUs of one host,
NCCL between them: the port's training step on one row band a card against
one process on the whole batch, at D=1 x S=4 and at D=2 x S=2.

    python3 tools/torch_spatial_nccl.py                  # on a host with 4 cards
    python3 tools/torch_spatial_nccl.py --task SelfSupModelMF   # the photometric loss
    python3 tools/torch_spatial_nccl.py --device cpu --version it4-h-out \\
        --height 64 --width 96                           # 4 gloo ranks on the CPU

It builds the kernels (on the cards), then runs this file with ``--worker``
under `dro_sfm_torch.scripts.launch_multihost`, once a layout, one rank a
card. Each rank:

1. rank 0 alone, before it joins the group: the one-process step on the
   global batch (``--task``, SupModelMF by default; it12-h-out at 192x640
   by default, B=4, N=2, `chip_smoke.tame_weights`, the flip off; noise
   images, which are also the photometric loss's un-jittered originals) in
   bf16 and fp32, its peak memory and ms a step; for a task with the
   photometric loss also the fp32 step on the samples in the order 1, 0,
   3, 2 (each leaf's order-of-sums reach, `chip_smoke.dist_verdict`);
2. the split (`parallel/mesh.py:make_layout`): the step on its data
   shard's band, bf16 then fp32, rank 0 drawing no flip and the others a
   flip (rank 0's holds): the launches a step on the card (K1 24, K2 24, K3
   18), the gradients and the parameters after Adam equal on every rank bit
   for bit, and on rank 0 within `chip_smoke.dist_verdict`'s bars of the
   one-process step (the fp32 loss within 1e-5 relative; bf16 leaves of a
   photometric task printed only, as `chip_smoke.spatial_leaves_held` says);
3. 3 timed bf16 steps, then one with torch's sync debug mode on (the host
   synchronisations of a step, by the line that made them, as
   `chip_smoke.py` phase ba counts them) and one profiled
   (`torch.profiler`, host and card): ms a step, peak memory, the host's
   time inside the ``collective:`` spans and their count by function (a
   task's exchanges a step: the photometric term's are SelfSupModelMF's
   less SupModelMF's), the kernels' time on the card
   (NCCL's apart) and the host's and the card's largest operators by their
   own time.

Every rank prints its lines; a failure exits non-zero, and the launcher
stops the other ranks.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LAYOUTS = (4, 2)                  # spatial shards of the 4 ranks: D=1 x S=4, D=2 x S=2
GLOBAL_B = 4


def check(ok, msg):
    if not ok:
        print(f"FAILED on rank {os.environ.get('RANK')}: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def make_batch(b, h, w, device, n=cs.VIEWS, seed=8):
    """`chip_smoke.make_train_batch` at ``h`` x ``w`` on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    K = torch.tensor([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2], [0, 0, 1.0]])
    batch = {"rgb": torch.rand(b, h, w, 3, generator=gen),
             "rgb_context": torch.rand(b, n, h, w, 3, generator=gen),
             "intrinsics": K.expand(b, 3, 3).contiguous(),
             "depth": 1.0 + 59.0 * torch.rand(b, h, w, 1, generator=gen),
             "pose_context": torch.eye(4).expand(b, n, 4, 4).contiguous()}
    batch["rgb_original"], batch["rgb_context_original"] = batch["rgb"], batch["rgb_context"]
    return {k: v.to(device) for k, v in batch.items()}


def step_once(cfg, state, batch, generator, device, do_flip=None):
    """One `make_train_step` step from ``state``: (step fn, TrainState,
    (metrics, fp64 gradients on the host, the state after on the host),
    peak bytes)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    net = cfg.build_net(device=device)
    net.load_state_dict(state, strict=True)
    opt = make_optimizer(net, steps_per_epoch=1000)
    train_state = create_train_state(net, opt, device=device)
    grads, update = {}, opt.step

    def step_keeping_grads(count):
        grads.update({k: p.grad.detach().double().cpu() for k, p in net.named_parameters()})
        update(count)

    opt.step = step_keeping_grads
    step = make_train_step(cfg, net, opt, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    train_state, metrics = step(train_state, batch, generator, do_flip=do_flip)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    opt.step = update
    after = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    return step, train_state, ({k: v.item() for k, v in metrics.items()}, grads, after), peak


def timed(step, state, batch, device, reps=3):
    flips, times = torch.Generator().manual_seed(5), []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, flips)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return state, times


def host_syncs(fn):
    """The host synchronisations with the card during ``fn()`` (torch's
    sync debug mode): their count and the lines that made them, most first."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message).lower())
    return sum(where.values()), where.most_common(6)


def top_ops(events, time_of, n=8):
    return ", ".join(f"{e.key[:48]} {e.count}x {time_of(e) / 1e3:.2f} ms"
                     for e in sorted(events, key=time_of, reverse=True)[:n])


def worker(args):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dro_sfm_torch.parallel import spatial
    from dro_sfm_torch.parallel.collectives import SPAN
    from dro_sfm_torch.parallel.mesh import local_device, make_layout, maybe_init_distributed
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = local_device(args.device)
    on_card = device.type == "cuda"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counters = cs.counter_map()
    where = cs.nvidia_smi_line() if on_card else "the CPU (gloo; no times are the card's)"
    configs = {prec: cs.train_config(name=args.task, version=args.version,
                                     mixed_precision=prec == "bf16")
               for prec in ("bf16", "fp32")}
    start = configs["bf16"].build_net(device=device,
                                      generator=torch.Generator().manual_seed(0)).state_dict()
    start = cs.tame_weights(start)
    batch = make_batch(GLOBAL_B, args.height, args.width, device)
    refs = {}
    if rank == 0:                     # one process on the whole batch, no group yet
        for prec, cfg in configs.items():
            step, state, result, peak = step_once(cfg, start, batch, None, device, False)
            state, ms = timed(step, state, batch, device)
            refs[prec] = (result, peak, ms)
            del step, state
        own = cs.leaf_errors(refs["bf16"][0][1], refs["fp32"][0][1])
        reach = None
        if configs["fp32"].uses_photometric:
            order = [i ^ 1 for i in range(GLOBAL_B)]
            swapped = step_once(configs["fp32"], start, {k: v[order] for k, v in batch.items()},
                                None, device, False)[2]
            reach = cs.leaf_errors(swapped[1], refs["fp32"][0][1])
    check(maybe_init_distributed(device), "no process group from the environment")
    layout = make_layout(args.spatial)
    check(GLOBAL_B % layout.data == 0, f"B={GLOBAL_B} does not split over {layout.data}")
    per = GLOBAL_B // layout.data
    lo = layout.data_index * per
    band = spatial.split_rows({k: v[lo:lo + per] for k, v in batch.items()}, layout)

    results = {}
    for prec, cfg in configs.items():
        for c in counters.values():   # the split step's path starts here
            c.reset()
        step, state, results[prec], peak = step_once(cfg, start, band,
                                                     cs.flip_generator_for(rank != 0), device)
        launches = {k: c.launches for k, c in counters.items()}   # and ends here
        if on_card:
            check(launches == {k: cs.TRAIN_LAUNCHES.get(k, 0) for k in counters},
                  f"{prec} launches a step {launches}")
        for part in (1, 2):
            flat = torch.cat([v.reshape(-1).double() for v in results[prec][part].values()
                              if v.is_floating_point()]).to(device)
            mine = flat.clone()
            dist.broadcast(flat, src=0)
            check(torch.equal(flat, mine), f"{prec} {('gradients', 'state')[part - 1]} "
                                           "differ from rank 0's")
        if prec == "bf16":
            state, ms = timed(step, state, band, device)
            syncs = (host_syncs(lambda: step(state, band, torch.Generator().manual_seed(6)))
                     if on_card else (0, []))
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                step(state, band, torch.Generator().manual_seed(6))
                if on_card:
                    torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            spans = {e.key[len(SPAN):]: (e.count, e.cpu_time_total / 1e3)
                     for e in prof.key_averages() if e.key.startswith(SPAN)
                     and e.device_type == torch.autograd.DeviceType.CPU}
            in_spans = sum(t for _, t in spans.values())
            events = prof.key_averages()
            host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
            # A host span (``nccl:all_reduce``, ``collective:...``, the optimizer's)
            # also shows as a range on the card: no kernel, left out of the sums.
            ranges = {e.key for e in host}
            card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key not in ranges and not e.key.startswith("nccl:")]
            busy = sum(cs.device_us(e) for e in card) / 1e3
            nccl = sum(cs.device_us(e) for e in card if e.key.startswith("nccl")) / 1e3
            print(f"spatial_nccl D={layout.data} x S={layout.spatial} rank {rank} {args.task} "
                  f"({band['rgb'].shape[1]} rows of {per} samples): bf16 ms a step "
                  f"{' / '.join(f'{v:.2f}' for v in ms)}, peak {peak / 2**20:.1f} MiB; "
                  f"collectives' share of the profiled step (host time in the spans) "
                  f"{in_spans:.2f} of {wall:.2f} ms ({100 * in_spans / wall:.1f}%): "
                  + ", ".join(f"{k} {n}x {t:.2f} ms" for k, (n, t) in sorted(spans.items()))
                  + f"; launches a step {launches}; on {where}", flush=True)
            print(f"spatial_nccl D={layout.data} x S={layout.spatial} rank {rank} {args.task}: host "
                  f"syncs of a bf16 step {syncs[0]} "
                  f"({', '.join(f'{k} {n}x' for k, n in syncs[1]) or 'none'}); the "
                  f"profiled step: kernels on the card {busy:.2f} of {wall:.2f} ms "
                  f"({100 * busy / wall:.1f}%; NCCL's {nccl:.2f}, their waits for the peers "
                  f"included), {sum(e.count for e in card)} kernels; host's "
                  f"largest own times: {top_ops(host, lambda e: e.self_cpu_time_total)}; "
                  f"card's: {top_ops(card, cs.device_us)}; on {where}", flush=True)
        del step, state
        if on_card:
            torch.cuda.empty_cache()
    if rank == 0:
        failures, worst, rel = cs.dist_verdict(results["bf16"], refs["bf16"][0], own)
        if not cs.spatial_leaves_held((args.task, "split", True, False)):
            # bf16 leaves under the photometric ``min`` are printed, not held
            failures = [f for f in failures if f.startswith("loss ") or "beyond" in f]
        failures32, worst32, rel32 = cs.dist_verdict(results["fp32"], refs["fp32"][0],
                                                     reach=reach)
        check(not failures and not failures32,
              f"against one process: {failures[:4]} {failures32[:4]}")
        (_, peak1, ms1) = refs["bf16"]
        print(f"spatial_nccl D={layout.data} x S={layout.spatial}, {args.task} {args.version} "
              f"{args.height}x{args.width} B={GLOBAL_B}, against one process: bf16 loss "
              f"relative {rel:.2e}, worst leaf {worst[0]:.3e} ({worst[1]}); fp32 loss relative "
              f"{rel32:.2e} (bar 1e-5), worst leaf {worst32[0]:.3e} "
              f"({worst32[1]}, bar "
              f"{max(1e-2, 2 * (reach or {}).get(worst32[1], 0.0)):.2e}); gradients and "
              f"state equal on every rank; one "
              f"process bf16 ms a step {' / '.join(f'{v:.2f}' for v in ms1)}, peak "
              f"{peak1 / 2**20:.1f} MiB; on {where}", flush=True)
    dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--spatial", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--device", default=None,
                        help="cpu for a rehearsal on 4 gloo ranks (default: the cards)")
    parser.add_argument("--task", default="SupModelMF",
                        choices=("SupModelMF", "SelfSupModelMF", "SemiSupModelMFPose"),
                        help="the multi-frame task whose step runs")
    parser.add_argument("--version", default="it12-h-out")
    parser.add_argument("--height", type=int, default=cs.SERVE_H)
    parser.add_argument("--width", type=int, default=cs.SERVE_W)
    args = parser.parse_args()
    if args.worker:
        return worker(args)
    cpu = args.device == "cpu"
    if not cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < 4):
        cs.fail("this check needs a host with four NVIDIA GPUs (or --device cpu)")
    t0 = time.perf_counter()
    if not cpu:
        from dro_sfm_torch import kernels
        kernels.build_all()
        print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    code = 0
    for shards in LAYOUTS:
        cmd = [sys.executable, "-m", "dro_sfm_torch.scripts.launch_multihost", "--nprocs", "4",
               *(["--backend", "gloo"] if cpu else []), "--", __file__, "--worker",
               "--spatial", str(shards), "--task", args.task, "--version", args.version,
               "--height", str(args.height), "--width", str(args.width),
               *(["--device", "cpu"] if cpu else [])]
        res = subprocess.run(cmd, cwd=ROOT, timeout=900)
        print(f"spatial_nccl S={shards}: exit code {res.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        code = code or res.returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
