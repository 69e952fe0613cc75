#!/usr/bin/env python3
"""Dense-BA benchmark of the port: ATE before and after refinement, and the
time of a Gauss-Newton iteration.

The port's counterpart of `tools/bench_ba.py`, on the same problem: a
trajectory of keyframes drifting over an exactly rendered smooth surface,
odometry and loop-closure covisibility edges, noisy poses with bounded
outlier keyframes and mis-scaled depths. It carries its own numpy copy of
that problem (`tests/test_ba.py:_trajectory_problem`, whose module imports
JAX). It runs on the card unless ``--device cpu``, times with the card
synchronised before and after each run, and prints one JSON line: ATE
before and after, ``gn_iter_ms``, ``edges_per_sec``, peak memory, and the
card's name and power limit.

    python tools/torch_bench_ba.py [--keyframes 128] [--height 64] [--width 96]
                                   [--schedule plain|gnc|c2f|robust]
    python -m dro_sfm_torch.scripts.launch_multihost --nprocs 2 --backend gloo -- \\
        tools/torch_bench_ba.py --sharded          # or torchrun --nproc-per-node 2

``--sharded`` splits the edges over the ranks of the process group that
the launcher (or ``torchrun``) describes, padded with (0, 0) edges to a
multiple of the world size, as `tools/bench_ba.py` pads them; rank 0
prints.

One difference from `tools/bench_ba.py`: with ``--schedule robust`` the
divisor of the time an iteration counts the 15 pose-graph iterations
besides the two-frame alignment and dense iterations (the JAX script leaves
them out).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PGO_ITERS = 15                     # optimize_dense_ba_robust's default
REPEATS = 5                        # timed runs after the first, as tools/bench_ba.py


def wavy_depth(h, w, K, T_c2w):
    """Exact depth of the smooth surface z = 5 + 1.2 sin(0.8 x) + 0.8 cos(1.1 y)
    seen from camera T_c2w, by Newton ray casting at every pixel."""
    def Z(x, y):
        return 5.0 + 1.2 * np.sin(0.8 * x) + 0.8 * np.cos(1.1 * y)

    def Zx(x, y):
        return 0.96 * np.cos(0.8 * x)

    def Zy(x, y):
        return -0.88 * np.sin(1.1 * y)

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    rays = (pix @ np.linalg.inv(K).T) @ T_c2w[:3, :3].T
    t = T_c2w[:3, 3]
    s = np.full(rays.shape[0], 5.0)
    for _ in range(30):
        px = t[0] + s * rays[:, 0]
        py = t[1] + s * rays[:, 1]
        f = t[2] + s * rays[:, 2] - Z(px, py)
        fp = rays[:, 2] - Zx(px, py) * rays[:, 0] - Zy(px, py) * rays[:, 1]
        s = s - f / fp
    return s.reshape(h, w).astype(np.float32)


def trajectory_problem(k, h, w):
    """Ground-truth poses [k,4,4], depths [k,h,w], intrinsics [3,3] (float32)
    and the edges (odometry at +-1, +-2 and loops every 4 keyframes)."""
    K = np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2],
                  [0, 0, 1.0]], dtype=np.float32)
    gt_poses = [np.eye(4)]
    for i in range(1, k):
        T = np.eye(4)
        # a slow lateral drift keeps the surface in view of every frame
        T[:3, 3] = [0.08 * i, 0.04 * np.sin(0.4 * i), 0.05 * np.sin(0.25 * i)]
        gt_poses.append(T)
    gt_poses = np.stack(gt_poses).astype(np.float32)
    depths = np.stack([wavy_depth(h, w, K, T) for T in gt_poses])
    ei, ej = [], []
    for a in range(k):
        for d in (1, 2):
            if a + d < k:
                ei += [a, a + d]
                ej += [a + d, a]
    for a in range(0, k - 4, 4):
        ei += [a, a + 4]
        ej += [a + 4, a]
    return gt_poses, depths, K, np.asarray(ei, np.int64), np.asarray(ej, np.int64)


def build_problem(k, h, w, seed=0, twist_sigma=0.06, outlier=0.14, device="cpu"):
    """The benchmark's problem on ``device``: (BAProblem, ground-truth poses
    [k,4,4], the depth scale noise [k]). Keyframe 0 is exact; one keyframe
    in 16 (5, 21, ...) is an outlier with a twist of norm ``outlier``."""
    import torch

    from dro_sfm_torch.ba import BAProblem
    from dro_sfm_torch.ba.lie import se3_exp
    rng = np.random.default_rng(seed)
    gt_poses, depths, K, ei, ej = trajectory_problem(k, h, w)
    noise = rng.normal(size=(k, 6)) * twist_sigma
    for o in range(5, k, 16):
        noise[o] *= outlier / np.linalg.norm(noise[o])
    noise[0] = 0.0
    init_poses = torch.from_numpy(gt_poses) @ se3_exp(torch.as_tensor(noise, dtype=torch.float32))
    scale_noise = 1.0 + rng.normal(size=(k,)) * 0.03
    scale_noise[0] = 1.0
    depths = depths * scale_noise.astype(np.float32)[:, None, None]
    problem = BAProblem(init_poses, torch.from_numpy(depths), torch.from_numpy(K),
                        torch.from_numpy(ei), torch.from_numpy(ej))
    return BAProblem(*(t.to(device) for t in problem)), gt_poses, scale_noise


def pad_edges(problem, world):
    """The problem with (0, 0) edges appended up to a multiple of ``world``."""
    import torch
    pad = (-problem.edges_i.shape[0]) % world
    zeros = problem.edges_i.new_zeros(pad)
    return problem._replace(edges_i=torch.cat([problem.edges_i, zeros]),
                            edges_j=torch.cat([problem.edges_j, zeros]))


def card_line():
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dense BA benchmark of dro_sfm_torch")
    p.add_argument("--keyframes", type=int, default=32)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--twist-sigma", type=float, default=0.06)
    p.add_argument("--outlier", type=float, default=0.14)
    p.add_argument("--schedule", choices=("plain", "gnc", "c2f", "robust"), default="plain")
    p.add_argument("--sharded", action="store_true",
                   help="split the edges over the ranks of the launcher's process group")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def make_optimizer(args, group):
    """(the optimizer: problem -> (poses, log-scales), its iteration count)."""
    from dro_sfm_torch.ba.dense_ba import (
        C2F_STAGES, EDGE_STAGES, GNC_STAGES, make_sharded_optimizer, optimize_dense_ba,
        optimize_dense_ba_robust, optimize_dense_ba_scheduled)
    stages = {"gnc": GNC_STAGES, "c2f": C2F_STAGES}.get(args.schedule)
    if args.schedule == "robust":
        total = sum(s[1] for s in EDGE_STAGES) + PGO_ITERS + sum(s[2] for s in GNC_STAGES)
        return (lambda prob: optimize_dense_ba_robust(prob, stride=args.stride, group=group,
                                                      pgo_iters=PGO_ITERS)), total
    if stages is not None:
        return (lambda prob: optimize_dense_ba_scheduled(prob, stages=stages,
                                                         stride=args.stride, group=group),
                sum(s[2] for s in stages))
    if group is not None:
        return make_sharded_optimizer(group, stride=args.stride, iters=args.iters,
                                      max_step=0.1), args.iters
    return (lambda prob: optimize_dense_ba(prob, stride=args.stride, iters=args.iters,
                                           max_step=0.1)), args.iters


def run(args) -> dict:
    """Build the problem, run the optimizer once, time REPEATS more runs
    (depths moved by 1e-6 (i + 1) each); returns the JSON record."""
    import torch
    import torch.distributed as dist

    from dro_sfm_torch.parallel.mesh import local_device, maybe_init_distributed
    from dro_sfm_torch.visualization.trajectory import absolute_trajectory_error
    device = local_device(args.device)
    made_group = maybe_init_distributed(device) if args.sharded else False
    group = None
    world = 1
    if args.sharded:
        if not dist.is_initialized():
            raise RuntimeError("--sharded needs a process group: run under "
                               "dro_sfm_torch.scripts.launch_multihost or torchrun")
        group, world = dist.group.WORLD, dist.get_world_size()
    try:
        problem, gt_poses, _ = build_problem(args.keyframes, args.height, args.width,
                                             twist_sigma=args.twist_sigma,
                                             outlier=args.outlier, device=device)
        if group is not None:
            problem = pad_edges(problem, world)
        opt, total_iters = make_optimizer(args, group)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        poses, sigmas = opt(problem)
        sync()
        first_s = time.perf_counter() - t0
        times = []
        for i in range(REPEATS):
            pert = problem._replace(depths=problem.depths + 1e-6 * (i + 1))
            sync()
            t0 = time.perf_counter()
            opt(pert)
            sync()
            times.append(time.perf_counter() - t0)
        best = min(times)
        n_edges = int(problem.edges_i.shape[0])
        ate0 = absolute_trajectory_error(list(problem.poses.cpu().numpy()), list(gt_poses))
        ate1 = absolute_trajectory_error(list(poses.cpu().numpy()), list(gt_poses))
        return {
            "metric": "dense_ba",
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu"),
            "card": card_line() if device.type == "cuda" else "not measured",
            "ranks": world,
            "sharded": bool(args.sharded),
            "schedule": args.schedule,
            "keyframes": args.keyframes,
            "edges": n_edges,
            "depth_res": [args.height, args.width],
            "stride": args.stride,
            "twist_sigma": args.twist_sigma,
            "outlier": args.outlier,
            "iters": total_iters,
            "ate_init": ate0,
            "ate_refined": ate1,
            "ate_reduction": ate0 / max(ate1, 1e-12),
            "first_run_s": first_s,
            "run_ms": [1e3 * t for t in times],
            "gn_iter_ms": 1e3 * best / total_iters,
            "edges_per_sec": n_edges * total_iters / best,
            "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                         if device.type == "cuda" else "not measured"),
            "scales": torch.exp(sigmas).cpu().tolist(),
        }
    finally:
        if made_group:
            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    record = run(args)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
