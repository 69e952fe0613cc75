"""Training CLI of the port: train from a .yaml config, or resume a .ckpt.

    python -m dro_sfm_torch.scripts.train configs/overfit_synthetic.yaml
    python -m dro_sfm_torch.scripts.train results/x/epoch=01_abs_rel_pp_gt=0.123.ckpt
    python -m dro_sfm_torch.scripts.train configs/overfit_synthetic.yaml --device cpu

Runs on the card unless ``--device cpu``. ``--profile LOGDIR`` writes a
``torch.profiler`` trace of the first training steps to
``LOGDIR/trace.json``. The final metrics are printed as JSON.

Under `dro_sfm_torch.scripts.launch_multihost` or ``torchrun`` each process
trains on its own card (``LOCAL_RANK``), NCCL between them, or on the CPU
with ``--device cpu`` (gloo); process 0 prints the metrics, and each
process's trace is ``LOGDIR/trace_rank<R>.json``:

    python -m dro_sfm_torch.scripts.launch_multihost --nprocs 2 -- \
        -m dro_sfm_torch.scripts.train configs/train_synthetic_192x640.yaml
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from dro_sfm_torch.parallel.mesh import (
    is_rank0,
    local_device,
    maybe_init_distributed,
    process_count,
    process_index,
)

PROFILE_WARMUP, PROFILE_STEPS = 1, 3


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="dro_sfm_torch training")
    parser.add_argument("file", help="a .yaml config, or a .ckpt to resume")
    parser.add_argument("--seed", type=int, default=None, help="override arch.seed")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--profile", default=None, metavar="LOGDIR",
                        help="write a torch.profiler trace of the first "
                             "training steps to LOGDIR/trace.json")
    return parser.parse_args(argv)


def config_of(path: str):
    """The config of a .yaml file, or the one saved beside a .ckpt."""
    from dro_sfm_torch.utils.config import ConfigNode, load_config, prepare_config
    if path.endswith(".ckpt"):
        with open(path + ".json") as f:
            return prepare_config(ConfigNode(json.load(f)["config"]))
    return load_config(path)


@contextlib.contextmanager
def profile_first_steps(trainer, logdir: str):
    """Trace ``PROFILE_STEPS`` training steps after ``PROFILE_WARMUP``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = torch.profiler.schedule(wait=0, warmup=PROFILE_WARMUP,
                                       active=PROFILE_STEPS, repeat=1)
    step = trainer.train_step

    name = "trace.json" if process_count() == 1 else f"trace_rank{process_index()}.json"

    def export(prof):
        prof.export_chrome_trace(os.path.join(logdir, name))

    with torch.profiler.profile(activities=activities, schedule=schedule,
                                on_trace_ready=export) as prof:
        def profiled_step(*args, **kwargs):
            out = step(*args, **kwargs)
            prof.step()
            return out

        trainer.train_step = profiled_step
        try:
            yield prof
        finally:
            trainer.train_step = step


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dro_sfm_torch.training.trainer import Trainer
    cfg = config_of(args.file)
    if args.seed is not None:
        cfg.arch.seed = args.seed
    device = local_device(args.device)
    joined = maybe_init_distributed(device)
    rank0 = is_rank0()
    try:
        trainer = Trainer(cfg, resume=args.file if args.file.endswith(".ckpt") else None,
                          device=device)
        if args.profile:
            with profile_first_steps(trainer, args.profile):
                metrics = trainer.fit()
        else:
            metrics = trainer.fit()
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    metrics = {k: float(v) for k, v in metrics.items()}
    if rank0:
        print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
