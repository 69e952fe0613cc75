"""The port's single-frame networks against the JAX package's (fp32, CPU).

`DepthResNet`, `PoseResNet` and `SingleFrameNet` with variables shaped by
``jax.eval_shape`` and filled from a seeded numpy generator
(`fill_variables`), carried into the port by `from_jax_variables` with a
strict load; 64x96 images, B=2, N=2. Train mode (batch statistics) compares
the outputs and the updated running statistics; eval mode the outputs, with
``last_only`` for `SingleFrameNet`. Tolerance 1e-4 absolute and relative:
a ResNet-18 and a U-Net decoder of fp32 convolutions and batch reductions,
summed in another order by XLA and by PyTorch's CPU kernels.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import single_frame as jsf
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models import single_frame as tsf
from tests.test_torch_modules import fill_variables

torch.set_num_threads(2)
B, N, H, W = 2, 2, 64, 96
TOL = {"atol": 1e-4, "rtol": 1e-4}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, H, W, 3)).astype(np.float32),
            rng.uniform(size=(B, N, H, W, 3)).astype(np.float32))


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def stats(tree):
    sd = from_jax_variables({"params": {}, "batch_stats": tree})
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("_mean", "_var"))}


def assert_stats_close(tmodule, want, old, prefix=""):
    got = {k[len(prefix):]: v.numpy() for k, v in tmodule.state_dict().items()
           if k.startswith(prefix)}
    assert want and set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
        assert not np.allclose(v, old[k]), k          # the train step moved it


# name -> (flax module, port module, flax call args, port call)
def _depth(target, refs):
    return (jsf.DepthResNet(min_depth=0.5, max_depth=50.0), (target,),
            tsf.DepthResNet(0.5, 50.0), lambda m: m(nchw(target)))


def _pose(target, refs):
    return (jsf.PoseResNet(), (target, refs), tsf.PoseResNet(),
            lambda m: m(torch.from_numpy(target), torch.from_numpy(refs)))


@pytest.mark.parametrize("build", [_depth, _pose], ids=["DepthResNet", "PoseResNet"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_nets_match_flax(build, train):
    target, refs = inputs()
    jm, args, tm, call = build(target, refs)
    variables = fill_variables(lambda k: jm.init(k, *args, train=False))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tm.train(train)
    if train:
        want, updates = jax.jit(functools.partial(jm.apply, train=True,
                                                  mutable=["batch_stats"]))(variables, *args)
    else:
        want = jax.jit(functools.partial(jm.apply, train=False))(variables, *args)
    got = call(tm)
    if isinstance(got, list):                            # DepthResNet: S scales
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), **TOL)
    else:
        assert got.shape == (B, N, 6)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if train:
        assert_stats_close(tm, stats(updates["batch_stats"]),
                           stats(variables["batch_stats"]))


@pytest.mark.parametrize("mode", ["train", "eval_last_only"])
def test_single_frame_net_matches_flax(mode):
    target, refs = inputs(1)
    K = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    jm = jsf.SingleFrameNet(min_depth=0.2, max_depth=20.0)
    variables = fill_variables(lambda k: jm.init(k, target, refs, K, train=False))
    tm = tsf.SingleFrameNet(0.2, 20.0, device="cpu")
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    assert {k.split(".")[0] for k, _ in tm.named_parameters()} == {"depth_net", "pose_net"}
    train = mode == "train"
    tm.train(train)
    if train:
        want, updates = jax.jit(functools.partial(jm.apply, train=True, mutable=[
            "batch_stats"]))(variables, target, refs, K)
    else:
        want = jax.jit(functools.partial(jm.apply, train=False, last_only=True))(
            variables, target, refs, K)
    got = tm(torch.from_numpy(target), torch.from_numpy(refs), torch.from_numpy(K),
             last_only=not train)
    s = 4 if train else 1
    assert got["inv_depths"].shape == (s, B, H, W, 1)
    assert got["pose_vecs"].shape == (B, N, s, 6)
    for k in ("inv_depths", "pose_vecs"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    if train:
        assert_stats_close(tm, stats(updates["batch_stats"]),
                           stats(variables["batch_stats"]))


@pytest.mark.parametrize("which", ["SingleFrameNet", "PercepNet"])
def test_from_jax_variables_maps_every_leaf(which):
    """Every leaf of the flax tree lands on the port's tensor of the same
    path (HWIO kernels as OIHW), and the load is strict."""
    from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
    from dro_sfm_torch.models.percep import PercepNet
    target, refs = inputs(2)
    if which == "SingleFrameNet":
        jm, tm = jsf.SingleFrameNet(), tsf.SingleFrameNet(device="cpu")
        args = (target, refs, np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)))
    else:
        jm, tm, args = JaxPercepNet(), PercepNet(device="cpu"), (target, target)
    variables = fill_variables(lambda k: jm.init(k, *args), seed=3)
    state = from_jax_variables(variables)
    tm.load_state_dict(state, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len([k for k in state if not k.endswith("num_batches_tracked")]) == len(flat)
    got = tm.state_dict()
    for path, leaf in flat:
        keys = [p.key for p in path]
        name = ".".join(keys[1:-1])
        leaf = np.asarray(leaf)
        rule = {"kernel": ("weight", lambda v: v.transpose(3, 2, 0, 1)),
                "scale": ("weight", None), "bias": ("bias", None),
                "mean": ("running_mean", None), "var": ("running_var", None)}
        suffix, fn = rule[keys[-1]]
        np.testing.assert_array_equal(got[f"{name}.{suffix}"].numpy(),
                                      fn(leaf) if fn else leaf)


def test_single_frame_net_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the net would be built there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsf.SingleFrameNet()
