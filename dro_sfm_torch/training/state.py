"""Train state, optimizer construction and learning-rate schedules.

PyTorch counterpart of `dro_sfm_tpu/training/state.py`: Adam (AdamW with a
weight decay, or SGD) over depth/pose parameter groups, each with an
epoch-stepped schedule (StepLR, MultiStepLR, CosineAnnealingLR, optional
linear warmup) written as a function of the optimizer step, and optional
clipping by the global gradient norm.

The schedules follow optax: a group's rate for an update is its schedule at
the number of updates made before it (0 for the first), and it is set on the
group just before ``optimizer.step()``. Clipping is optax's
``clip_by_global_norm``: each gradient becomes ``g / ||g|| * max_norm`` when
``||g|| >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm, so it is not used).

Config objects are duck-typed with the field names of the JAX package's
``model.optimizer`` and ``model.scheduler`` sections; a missing field takes
its default from `OPTIMIZER_DEFAULTS` / `SCHEDULER_DEFAULTS`, this
package's copy of those sections' defaults.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Callable, Dict, List

import torch

from dro_sfm_torch.utils.device import resolve_device

OPTIMIZER_DEFAULTS = {
    "name": "Adam",
    "depth": {"lr": 0.0002, "weight_decay": 0.0},
    "pose": {"lr": 0.0002, "weight_decay": 0.0},
    "momentum": 0.9,
    "clip_grad_norm": 0.0,
}
SCHEDULER_DEFAULTS = {
    "name": "StepLR", "step_size": 10, "gamma": 0.5,
    "T_max": 20, "eta_min": 1e-7,
    "milestones": [10, 15, 20, 25, 30, 35, 40, 45],
    "warmup_steps": 0,
}
GROUPS = ("depth", "pose")


def _field(cfg, name: str, defaults: Dict):
    value = getattr(cfg, name, None) if cfg is not None else None
    return defaults[name] if value is None else value


def lr_schedule(name: str, base_lr: float, steps_per_epoch: int,
                step_size: int = 10, gamma: float = 0.5,
                milestones=(10, 15, 20, 25, 30, 35, 40, 45),
                t_max: int = 20, eta_min: float = 1e-7,
                warmup_steps: int = 0) -> Callable[[int], float]:
    """An epoch-granular schedule as a function of the optimizer step
    (epoch = step // steps_per_epoch). ``warmup_steps`` > 0 ramps the rate
    linearly, ``min(1, (step + 1) / warmup_steps)``, over the first steps."""
    spe = max(1, steps_per_epoch)

    if name == "StepLR":
        def fn(step):
            return base_lr * gamma ** ((step // spe) // step_size)
    elif name == "MultiStepLR":
        def fn(step):
            return base_lr * gamma ** sum(step // spe >= m for m in milestones)
    elif name == "CosineAnnealingLR":
        def fn(step):
            e = min(step // spe, t_max)
            return eta_min + 0.5 * (base_lr - eta_min) * (
                1 + math.cos(math.pi * e / t_max))
    else:
        raise ValueError(f"Unknown scheduler {name}")
    if warmup_steps and warmup_steps > 0:
        base_fn = fn

        def fn(step):
            return min(1.0, (step + 1) / warmup_steps) * base_fn(step)
    return fn


def group_schedule(group_cfg, scheduler_cfg, steps_per_epoch: int,
                   group: str = "depth") -> Callable[[int], float]:
    """The schedule of one parameter group (``group`` names the defaults
    used for missing fields)."""
    s = SCHEDULER_DEFAULTS
    lr = _field(group_cfg, "lr", OPTIMIZER_DEFAULTS[group])
    return lr_schedule(
        _field(scheduler_cfg, "name", s), lr, steps_per_epoch,
        step_size=_field(scheduler_cfg, "step_size", s),
        gamma=_field(scheduler_cfg, "gamma", s),
        milestones=tuple(_field(scheduler_cfg, "milestones", s)),
        t_max=_field(scheduler_cfg, "T_max", s),
        eta_min=_field(scheduler_cfg, "eta_min", s),
        warmup_steps=_field(scheduler_cfg, "warmup_steps", s))


@dataclasses.dataclass
class Optimizer:
    """A torch optimizer with one param group per non-empty schedule group,
    the schedules, and the global-norm clip (0 = off). ``groups`` names the
    torch param groups ("depth", "pose") in order; ``decays`` holds the
    weight decay of both groups of the JAX package's optimizer, the empty one
    too, which its optax state's layout depends on."""
    torch_optimizer: torch.optim.Optimizer
    schedules: List[Callable[[int], float]]
    clip_grad_norm: float = 0.0
    groups: List[str] = dataclasses.field(default_factory=lambda: ["depth"])
    decays: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {g: 0.0 for g in GROUPS})

    def step(self, update_count: int) -> None:
        """Clip, set each group's rate for update ``update_count`` (the
        number of updates made before), and apply the update."""
        params = [p for g in self.torch_optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        if self.clip_grad_norm > 0 and params:
            clip_by_global_norm([p.grad for p in params], self.clip_grad_norm)
        for group, schedule in zip(self.torch_optimizer.param_groups,
                                   self.schedules):
            group["lr"] = schedule(update_count)
        self.torch_optimizer.step()

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: when the global norm is at
    or above ``max_norm`` every gradient becomes ``g / norm * max_norm``.
    Returns the norm before clipping."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(net: torch.nn.Module, optimizer_cfg=None, scheduler_cfg=None,
                   steps_per_epoch: int = 1000) -> Optimizer:
    """Adam / AdamW / SGD with the depth and pose groups of the JAX package:
    parameters under a top-level ``pose_net`` module (the single-frame pose
    network) take ``optimizer.pose``, everything else ``optimizer.depth`` —
    a multi-frame DepthPoseNet is all "depth"."""
    o = OPTIMIZER_DEFAULTS
    name = _field(optimizer_cfg, "name", o)
    by_group: Dict[str, list] = {g: [] for g in GROUPS}
    for pname, p in net.named_parameters():
        by_group["pose" if pname.split(".")[0] == "pose_net" else "depth"].append(p)
    groups, schedules, decays, names = [], [], {}, []
    for g in GROUPS:
        gcfg = _field(optimizer_cfg, g, o)
        if isinstance(gcfg, dict):
            gcfg = SimpleNamespace(**gcfg)
        wd = decays[g] = _field(gcfg, "weight_decay", o[g])
        if not by_group[g]:
            continue
        names.append(g)
        schedule = group_schedule(gcfg, scheduler_cfg, steps_per_epoch, g)
        groups.append({"params": by_group[g], "lr": schedule(0),
                       "weight_decay": wd})
        schedules.append(schedule)
    if name == "Adam":
        # optax.adam / adamw defaults: b1 0.9, b2 0.999, eps 1e-8. AdamW on
        # a group without decay is Adam.
        cls = (torch.optim.AdamW if any(g["weight_decay"] > 0 for g in groups)
               else torch.optim.Adam)
        opt = cls(groups, betas=(0.9, 0.999), eps=1e-8)
    elif name == "SGD":
        for grp in groups:
            grp["weight_decay"] = 0.0        # optax.sgd takes no weight decay
        opt = torch.optim.SGD(groups, lr=groups[0]["lr"],
                              momentum=_field(optimizer_cfg, "momentum", o))
    else:
        raise ValueError(f"Unknown optimizer {name}")
    clip = _field(optimizer_cfg, "clip_grad_norm", o) or 0.0
    return Optimizer(opt, schedules, float(clip), names,
                     decays if name == "Adam" else {g: 0.0 for g in GROUPS})


@dataclasses.dataclass
class TrainState:
    """The net (its parameters and BatchNorm statistics), the optimizer
    (its moments) and the number of updates made."""
    net: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(net: torch.nn.Module, optimizer: Optimizer,
                       device=None) -> TrainState:
    """Wrap ``net`` (moved to ``device``: the card unless the caller asks
    for the CPU) and ``optimizer`` in a state at step 0."""
    net.to(resolve_device(device))
    return TrainState(net=net, optimizer=optimizer, step=0)
