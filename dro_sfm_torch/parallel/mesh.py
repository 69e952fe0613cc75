"""The processes of a run, the device each one trains on, and their
(data, spatial) layout.

PyTorch counterpart of `dro_sfm_tpu/parallel/mesh.py`. The JAX package runs
one process per host over a mesh of every device, and its training step is
one program over the globally sharded batch, so XLA makes the cross-device
sums. The port runs one process per device, torch's idiom: each process holds
its part of the global batch (``datasets.*.batch_size`` per process, as in
JAX) and the step makes the sums itself (`parallel/collectives.py`, the
train-mode `models/layers.py:BatchNorm2d`). So `make_mesh`, `batch_sharding`,
`replicated` and `shard_batch` have no counterpart.

The mesh's two axes become a `Layout` of the world (``arch.spatial_shards``
= S > 1): world size D·S, row-major as `make_mesh` lays out its devices, so
rank r has data index ``r // S`` and spatial index ``r % S``. Every rank
makes every spatial group (D of them, S ranks each: one sample's row bands)
and every data group (S of them, D ranks each: the same band of other
samples) with `torch.distributed.new_group`, in the same order. The
exchanges of the row bands (GSPMD's halo-exchanged height split) live in
`parallel/spatial.py`.

A process joins the group that `torch.distributed.run` or
`dro_sfm_torch.scripts.launch_multihost` describe in its environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
A caller may also make its own group first; then nothing here makes one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """The (data, spatial) layout of the world: D data shards of S row bands.
    ``spatial_group`` holds this rank's S bands of one sample, ``data_group``
    the D ranks of its band index; ``data_host_group`` is the gloo twin of
    ``data_group`` for host values (the same group under gloo)."""
    data: int
    spatial: int
    data_index: int
    spatial_index: int
    spatial_group: Any
    data_group: Any
    data_host_group: Any


# The layout made for the current default group: (that group, layout).
_LAYOUT: dict = {}


def make_layout(spatial_shards: int) -> Optional[Layout]:
    """Split the world into D = world / ``spatial_shards`` data shards of S
    spatial ranks and make the groups (a collective: every rank calls it at
    the same point). Returns None, making nothing, for S = 1; raises
    ValueError when S does not divide the world size."""
    s = int(spatial_shards)
    world = process_count()
    if s < 1 or world % s:
        raise ValueError(f"arch.spatial_shards={s} must divide the world size {world} "
                         "(one process a device)")
    _LAYOUT.clear()
    if s == 1:
        return None
    d, rank = world // s, process_index()
    gloo = dist.get_backend() == "gloo"

    def groups(rank_lists, backend=None):
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(ranks=ranks, backend=backend)
            if rank in ranks:
                mine = g
        return mine

    spatial_ranks = [[di * s + si for si in range(s)] for di in range(d)]
    data_ranks = [[di * s + si for di in range(d)] for si in range(s)]
    spatial_group = groups(spatial_ranks)
    data_group = groups(data_ranks)
    host = data_group if gloo else groups(data_ranks, "gloo")
    layout = Layout(d, s, rank // s, rank % s, spatial_group, data_group, host)
    _LAYOUT["world"] = (dist.group.WORLD, layout)
    return layout


def current_layout() -> Optional[Layout]:
    """The layout `make_layout` made for the current default group, or None
    (no split: S = 1, one process, or another group since)."""
    held = _LAYOUT.get("world")
    if held is None or not is_distributed() or held[0] is not dist.group.WORLD:
        return None
    return held[1]
