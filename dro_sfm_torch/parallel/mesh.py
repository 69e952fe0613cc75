"""The processes of a run, and the device each one trains on.

PyTorch counterpart of `dro_sfm_tpu/parallel/mesh.py`. The JAX package runs
one process per host over a mesh of every device, and its training step is
one program over the globally sharded batch, so XLA makes the cross-device
sums. The port runs one process per device, torch's idiom: each process holds
its part of the global batch (``datasets.*.batch_size`` per process, as in
JAX) and the step makes the sums itself (`parallel/collectives.py`, the
train-mode `models/layers.py:BatchNorm2d`). So `make_mesh`, `batch_sharding`,
`replicated` and `shard_batch` have no counterpart, and neither has the
spatial split of ``arch.spatial_shards`` > 1 (GSPMD's halo-exchanged height
sharding).

A process joins the group that `torch.distributed.run` or
`dro_sfm_torch.scripts.launch_multihost` describe in its environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
A caller may also make its own group first; then nothing here makes one.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dro_sfm_torch.utils.device import resolve_device

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# The launcher's --backend: "gloo" puts two processes on one card (NCCL
# refuses two ranks on one device).
BACKEND_ENV = "DRO_SFM_DIST_BACKEND"


def is_distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of processes of the run (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


def is_rank0() -> bool:
    """Whether this process logs and writes checkpoints."""
    return process_index() == 0


def local_device(device=None) -> torch.device:
    """The device this process runs on: `resolve_device`'s (the card unless
    the caller names another, raising without CUDA); a card named without an
    index becomes ``cuda:{LOCAL_RANK % device_count}`` and the current one."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def maybe_init_distributed(device: torch.device) -> bool:
    """Join the process group that the environment describes, with NCCL
    when ``device`` is a card and gloo for the CPU (``DRO_SFM_DIST_BACKEND``
    overrides). A no-op, returning False, when the variables are absent or
    a process group exists already; True when it made the group."""
    if is_distributed() or not all(k in os.environ for k in ENV):
        return False
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            device_id=device if backend == "nccl" else None)
    return True
