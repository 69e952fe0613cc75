"""The port's optimizer and schedules against the JAX package's optax chain.

`make_optimizer` on both sides from the same duck-typed config, over a
two-group parameter set (a top-level ``pose_net`` module takes the pose
group), five updates with the same gradients. The port sets each group's
rate from its schedule at the update count before the step and clips by the
global norm as optax does. Tolerance 1e-6 absolute on parameters of order 1
after five updates of at most ~1e-2 each (fp32 arithmetic in another order).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dro_sfm_tpu.training.state import lr_schedule as j_lr_schedule
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_torch.training.state import Optimizer, lr_schedule, make_optimizer

STEPS_PER_EPOCH = 2


def configs(name, scheduler, wd=(0.0, 0.0), clip=0.0, warmup=0):
    opt = SimpleNamespace(name=name, momentum=0.9, clip_grad_norm=clip,
                          depth=SimpleNamespace(lr=0.01, weight_decay=wd[0]),
                          pose=SimpleNamespace(lr=0.02, weight_decay=wd[1]))
    sched = SimpleNamespace(name=scheduler, step_size=1, gamma=0.5, T_max=3,
                            eta_min=1e-4, milestones=[1, 2], warmup_steps=warmup)
    return opt, sched


class Net(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.body = torch.nn.Module()
        self.body.w = torch.nn.Parameter(torch.from_numpy(params["body"]["w"].copy()))
        self.pose_net = torch.nn.Module()
        self.pose_net.w = torch.nn.Parameter(torch.from_numpy(params["pose_net"]["w"].copy()))


CASES = {
    "adam_steplr": dict(name="Adam", scheduler="StepLR"),
    "adamw_multistep": dict(name="Adam", scheduler="MultiStepLR", wd=(0.05, 0.0)),
    "sgd_cosine_warmup": dict(name="SGD", scheduler="CosineAnnealingLR", warmup=3),
    "adam_clipped": dict(name="Adam", scheduler="StepLR", clip=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(rng, case):
    opt_cfg, sched_cfg = configs(**CASES[case])
    params = {"body": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "pose_net": {"w": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{k: {"w": rng.normal(size=v["w"].shape).astype(np.float32)}
              for k, v in params.items()} for _ in range(5)]

    tx = j_make_optimizer(opt_cfg, sched_cfg, STEPS_PER_EPOCH)
    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: {"w": jnp.asarray(v["w"])} for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)

    net = Net(params)
    opt = make_optimizer(net, opt_cfg, sched_cfg, STEPS_PER_EPOCH)
    assert isinstance(opt, Optimizer) and len(opt.torch_optimizer.param_groups) == 2
    for step, g in enumerate(grads):
        opt.zero_grad()
        net.body.w.grad = torch.from_numpy(g["body"]["w"].copy())
        net.pose_net.w.grad = torch.from_numpy(g["pose_net"]["w"].copy())
        opt.step(step)
    np.testing.assert_allclose(net.body.w.detach().numpy(), np.asarray(jp["body"]["w"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(net.pose_net.w.detach().numpy(),
                               np.asarray(jp["pose_net"]["w"]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["StepLR", "MultiStepLR", "CosineAnnealingLR"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_jax(name, warmup):
    kw = dict(step_size=2, gamma=0.5, milestones=(1, 3, 4), t_max=5, eta_min=1e-5,
              warmup_steps=warmup)
    ours = lr_schedule(name, 0.1, 3, **kw)
    ref = j_lr_schedule(name, 0.1, 3, **kw)
    for step in range(25):
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step))), rtol=1e-6)
    with pytest.raises(ValueError):
        lr_schedule("nope", 0.1, 3)


def test_defaults_are_the_config_defaults():
    """With no config the optimizer is the JAX package's default: Adam at
    2e-4, StepLR halving every 10 epochs, no clipping."""
    net = Net({"body": {"w": np.zeros((2,), np.float32)},
               "pose_net": {"w": np.zeros((2,), np.float32)}})
    opt = make_optimizer(net, steps_per_epoch=100)
    assert type(opt.torch_optimizer) is torch.optim.Adam
    assert opt.clip_grad_norm == 0.0
    assert [s(0) for s in opt.schedules] == [2e-4, 2e-4]
    assert opt.schedules[0](1000) == 1e-4 and opt.schedules[0](999) == 2e-4
