"""Sums across the processes of a run.

PyTorch counterpart of `dro_sfm_tpu/parallel/collectives.py`
(`reduce_dict`, `all_reduce_metric_sums` with its all-samples check,
`average_loss_and_metrics`, `any_process_flag`), and the sums that the JAX
package's training step, one program over the global batch, gets from XLA
and the port's step makes itself: `all_reduce_sum` (differentiable: the batch
statistics of BatchNorm and of the photometric clamp), `average_gradients`
and `average_metrics` (the step), `broadcast_flag` (the flip) and
`broadcast_tensors` (the initial weights).

Host values (metric sums, counts, flags) are reduced on a gloo group made
once beside the default group, because NCCL reduces CUDA tensors only.
Tensors on the device go through the default group: NCCL between cards,
gloo on the CPU or for two processes on one card. gloo reduces CUDA tensors
with ``all_reduce`` and ``broadcast`` only, so every reduction here is an
``all_reduce`` of sums.

Under a height split (`mesh.Layout`, ``arch.spatial_shards`` = S > 1) the
world is D data shards of S spatial ranks, and each rank's gradient is its
band's share: `average_gradients` sums over the world and divides by D
(the sum over the spatial ranks, the mean over the data shards), and
`average_metrics` and `all_reduce_metric_sums` reduce over the data group
only, since the S ranks of a sample hold its whole metrics each.

Every function returns at once when there is one process. All processes
must call each one at the same point: each is a collective. Each collective
runs inside a `torch.profiler.record_function` span named
``collective:<function>``, which a profile of the step sums.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dro_sfm_torch.parallel.mesh import current_layout, process_count

SPAN = "collective:"
# The default group of this process and its gloo twin for host values.
_HOST_GROUP: Dict[str, tuple] = {}


def _span(name: str):
    return torch.profiler.record_function(SPAN + name)


def host_group():
    """The group that reduces host tensors: the default group when it is
    gloo's, else a gloo group over the same processes, made at the first
    call (a collective itself) and kept while the default group lives."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    cached = _HOST_GROUP.get("gloo")
    if cached is None or cached[0] is not world:
        _HOST_GROUP["gloo"] = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP["gloo"][1]


def _host_sum(values, group=None) -> np.ndarray:
    """The float64 sums of ``values`` over the processes (of ``group``, a
    gloo group, when given)."""
    t = torch.from_numpy(np.array(values, dtype=np.float64))
    dist.all_reduce(t, group=host_group() if group is None else group)
    return t.numpy()


# -- host values -------------------------------------------------------------

def reduce_dict(data: Dict[str, float]) -> Dict[str, float]:
    """The mean of a scalar dict over the processes."""
    if process_count() == 1:
        return {k: float(v) for k, v in data.items()}
    keys = sorted(data)
    with _span("reduce_dict"):
        total = _host_sum([float(data[k]) for k in keys])
    return dict(zip(keys, (total / process_count()).tolist()))


def all_reduce_metric_sums(sums: np.ndarray, count: int,
                           expected_total: int | None = None):
    """The sums of per-sample metric accumulators ``sums`` [K] and of the
    sample counts over the processes: (global sums [K], global count). With
    ``expected_total``, raises unless every sample of the dataset was seen
    once (the padding duplicates of the shards carry ``valid=False``).
    Under a height split the sums run over the data group."""
    if process_count() > 1:
        layout = current_layout()
        with _span("all_reduce_metric_sums"):
            total = _host_sum(np.concatenate([np.asarray(sums, np.float64),
                                              [float(count)]]),
                              None if layout is None else layout.data_host_group)
        sums, count = total[:-1], int(round(total[-1]))
    if expected_total is not None and count != expected_total:
        raise RuntimeError(f"distributed eval saw {count} samples, expected "
                           f"{expected_total}")
    return np.asarray(sums), count


def average_loss_and_metrics(outputs: Sequence[Dict[str, float]],
                             prefix: str = "avg") -> Dict[str, float]:
    """The mean of each key over a list of per-batch metric dicts."""
    if not outputs:
        return {}
    return {f"{prefix}-{k}": float(np.mean([float(o[k]) for o in outputs if k in o]))
            for k in outputs[0]}


def any_process_flag(local_flag: bool) -> bool:
    """Whether any process raised its flag: the preemption consensus, since
    a process that left the training loop alone would leave the others
    waiting in the next sum."""
    if process_count() == 1:
        return bool(local_flag)
    with _span("any_process_flag"):
        return bool(_host_sum([float(bool(local_flag))])[0] > 0)


def broadcast_flag(flag: bool) -> bool:
    """Process 0's ``flag`` on every process."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    with _span("broadcast_flag"):
        dist.broadcast(t, src=0, group=host_group())
    return bool(t.item())


# -- tensors on the device ---------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """The sum over the processes; its gradient is the sum of the processes'
    gradients, since every process's output depends on every input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        with _span("all_reduce_sum"):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        with _span("all_reduce_sum_backward"):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the processes of ``group`` (None: the default
    group), differentiable."""
    if process_count() == 1 or dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def _flat_by_dtype(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` on one flat buffer per dtype of ``tensors``
    and copy the result back into them."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the processes (under a height
    split, its sum over the spatial ranks and mean over the data shards):
    one ``all_reduce`` a dtype. Every process holds the same parameters
    with a gradient (the same net and task)."""
    world = process_count()
    grads = [p.grad for p in params if p.grad is not None]
    if world == 1 or not grads:
        return
    layout = current_layout()
    shards = world if layout is None else layout.data

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(shards)

    with _span("average_gradients"), torch.no_grad():
        _flat_by_dtype(grads, mean)


def average_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the processes of each 0-d metric (fp32, detached): the
    global batch's, where the shards are equal. Under a height split, the
    mean over the data group (each sample counted once)."""
    world = process_count()
    if world == 1:
        return metrics
    layout = current_layout()
    group, shards = (None, world) if layout is None else (layout.data_group, layout.data)
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    with _span("average_metrics"):
        dist.all_reduce(flat, group=group)
    flat.div_(shards)
    return {k: flat[i] for i, k in enumerate(keys)}


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` (parameters, buffers) in place with process
    ``src``'s: one ``broadcast`` a dtype."""
    if process_count() == 1:
        return
    with _span("broadcast_tensors"), torch.no_grad():
        _flat_by_dtype(list(tensors), lambda flat: dist.broadcast(flat, src=src))
