"""The optax state's layout, read from optax itself (CPU).

`convert.optimizer_state_to_jax` must describe, leaf for leaf and shape for
shape, the serialized state that the JAX package's ``make_optimizer``
holds for the same net and optimizer config: Adam with and without the
global-norm clip, AdamW (a weight decay on one group), SGD with momentum,
and a net with a ``pose_net`` (as the single-frame tasks have), which takes
the pose group. The net is small (a conv, a BatchNorm, a pose conv): the
layout depends on the groups and the chain, not on the depth of the net.
After a
few updates with seeded gradients in JAX, the port reads the moments
(`optimizer_state_from_jax`) and writes them back bit for bit; a state of
another layout raises `LayoutMismatch` and leaves the torch optimizer as it
was.
"""
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_torch.convert import (
    LayoutMismatch,
    optimizer_state_from_jax,
    optimizer_state_to_jax,
    to_jax_variables,
)
from dro_sfm_torch.models.layers import BatchNorm2d, Conv2d
from dro_sfm_torch.training.state import make_optimizer

torch.set_num_threads(2)
SCHED = NS(name="StepLR", step_size=10, gamma=0.5, milestones=[10], T_max=20,
           eta_min=1e-7, warmup_steps=0)


def opt_cfg(name="Adam", clip=0.0, depth_wd=0.0, pose_wd=0.0):
    return NS(name=name, momentum=0.9, clip_grad_norm=clip,
              depth=NS(lr=1e-3, weight_decay=depth_wd), pose=NS(lr=2e-3, weight_decay=pose_wd))


CASES = {
    "adam": (False, opt_cfg()),
    "adam_clip": (False, opt_cfg(clip=1.0)),
    "adamw_clip": (False, opt_cfg(clip=0.5, depth_wd=0.01)),
    "adamw_empty_group": (False, opt_cfg(pose_wd=0.01)),
    "sgd": (False, opt_cfg("SGD")),
    "pose_net_adamw": (True, opt_cfg(pose_wd=0.01)),
    "pose_net_sgd_clip": (True, opt_cfg("SGD", clip=1.0)),
}


def small_net(pose_net: bool, seed=0):
    g = torch.Generator().manual_seed(seed)
    net = torch.nn.Module()
    net.enc = torch.nn.Module()
    net.enc.conv1 = Conv2d(3, 4, 3, generator=g)
    net.enc.bn1 = BatchNorm2d(4)
    net.head = Conv2d(4, 2, (1, 3), generator=g)
    if pose_net:
        net.pose_net = torch.nn.Module()
        net.pose_net.conv = Conv2d(4, 6, 1, generator=g)
    return net


def flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, (*path, k)))
        else:
            out[(*path, k)] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_and_moments_round_trip(case):
    pose_net, cfg = CASES[case]
    net = small_net(pose_net)
    params = jax.tree.map(jnp.asarray, to_jax_variables(net.state_dict())["params"])
    tx = j_make_optimizer(cfg, SCHED, steps_per_epoch=5)
    state = tx.init(params)
    rng = np.random.default_rng(len(case))
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
        _, state = tx.update(grads, state, params)
    jax_tree = jax.tree.map(np.asarray, serialization.to_state_dict(state))

    opt = make_optimizer(net, cfg, SCHED, steps_per_epoch=5)
    want = {p: a.shape for p, a in flat(jax_tree).items()}
    assert {p: a.shape for p, a in flat(optimizer_state_to_jax(net, opt, 3)).items()} == want

    optimizer_state_from_jax(jax_tree, net, opt)
    assert len(opt.torch_optimizer.state) == len(list(net.parameters()))
    back = flat(optimizer_state_to_jax(net, opt, 3))
    for path, a in flat(jax_tree).items():
        assert back[path].dtype == a.dtype and np.array_equal(back[path], a), path


def test_another_layout_changes_nothing():
    net = small_net(False)
    params = jax.tree.map(jnp.asarray, to_jax_variables(net.state_dict())["params"])
    tx = j_make_optimizer(opt_cfg(clip=1.0), SCHED, steps_per_epoch=5)
    jax_tree = jax.tree.map(np.asarray, serialization.to_state_dict(tx.init(params)))
    for cfg in (opt_cfg(), opt_cfg("SGD", clip=1.0), opt_cfg(clip=1.0, depth_wd=0.1)):
        opt = make_optimizer(net, cfg, SCHED, steps_per_epoch=5)
        with pytest.raises(LayoutMismatch):
            optimizer_state_from_jax(jax_tree, net, opt)
        assert not opt.torch_optimizer.state
    # moments of another shape (another net): nothing is loaded
    mu = jax_tree["1"]["inner_states"]["depth"]["inner_state"]["0"]["mu"]
    mu["enc"]["conv1"]["kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    opt = make_optimizer(net, opt_cfg(clip=1.0), SCHED, steps_per_epoch=5)
    with pytest.raises(LayoutMismatch, match="enc/conv1/kernel"):
        optimizer_state_from_jax(jax_tree, net, opt)
    assert not opt.torch_optimizer.state
