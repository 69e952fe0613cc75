"""dro_sfm_torch modules against their flax counterparts (fp32, CPU).

Each flax module's variable tree is shaped with ``jax.eval_shape`` and filled
from a seeded numpy generator (`fill_variables`), carried into the port by
`from_jax_variables` with a strict load, and both sides run on the same
numpy inputs. Tolerance 1e-4 absolute and relative: a few fp32 convolutions
in a row, summed in another order by XLA and by PyTorch's CPU kernels.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import encoder as jenc
from dro_sfm_tpu.models import update as jupd
from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models import encoder as tenc
from dro_sfm_torch.models import update as tupd
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet

torch.set_num_threads(2)
TOL = {"atol": 1e-4, "rtol": 1e-4}


def fill_variables(init_fn, seed=0, head_gain=0.3):
    """Shape the variables of ``init_fn(key)`` without running it and fill
    them from numpy: conv kernels N(0, 1/fan_in) (the final convs of the
    depth/pose heads scaled by ``head_gain``, so the untrained refinement
    neither saturates nor amplifies rounding), small biases, and BatchNorm
    scales, shifts and statistics away from the identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def fill(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        shape = leaf.shape
        name = keys[-1]
        if name == "kernel":
            gain = head_gain if ("head" in keys and "conv2" in keys) else 1.0
            v = rng.normal(size=shape) * gain / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, size=shape)
        elif name == "mean" or (name == "bias" and "batch_stats" not in keys
                                and _is_bn(keys)):
            v = rng.normal(size=shape) * 0.1
        else:
            v = rng.normal(size=shape) * 0.01
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, fnn.meta.unbox(shapes))


def _is_bn(keys):
    return any(k is not None and ("bn" in k) for k in keys)


def to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("num_images", [1, 2])
def test_resnet_encoder(rng, num_images):
    x = rng.uniform(size=(2, 32, 48, 3 * num_images)).astype(np.float32)
    jm = jenc.ResNetEncoder(out_chs=40, num_input_images=num_images)
    v = fill_variables(lambda k: jm.init(k, x, train=False))
    expected = jm.apply(v, x, train=False)
    tm = load(tenc.ResNetEncoder(40, num_input_images=num_images), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 40, 4, 6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expected), **TOL)


def _cells(rng, hdim=32, cdim=8, feat=16, b=2, h=6, w=10):
    """Inputs shared by the update-cell tests (NHWC numpy)."""
    return {
        "net": np.tanh(rng.normal(size=(b, h, w, hdim))).astype(np.float32),
        "ctx": np.maximum(rng.normal(size=(b, h, w, cdim)), 0).astype(np.float32),
        "cost": rng.uniform(0, 2, size=(b, h, w, feat)).astype(np.float32),
        "inv": rng.uniform(0.1, 1.0, size=(b, h, w, 1)).astype(np.float32),
        "pose": (rng.normal(size=(b, 6)) * 0.05).astype(np.float32),
        "dims": (hdim, cdim, feat),
    }


def test_depth_update_cell(rng):
    d = _cells(rng)
    hdim, cdim, feat = d["dims"]
    jm = jupd.DepthUpdateCell(hidden_dim=hdim, context_dim=cdim,
                              conv_impl="split")
    args = (d["net"], d["inv"], d["cost"], d["ctx"])
    v = fill_variables(lambda k: jm.init(k, *args))
    jnet, jdelta = jm.apply(v, *args)
    tm = load(tupd.DepthUpdateCell(hdim, cdim, feat), v)
    with torch.no_grad():
        tnet, tdelta = tm(*[nchw(a) for a in args])
    np.testing.assert_allclose(tnet.permute(0, 2, 3, 1).numpy(), jnet, **TOL)
    np.testing.assert_allclose(tdelta.permute(0, 2, 3, 1).numpy(), jdelta, **TOL)


def test_pose_update_cell(rng):
    d = _cells(rng)
    hdim, cdim, feat = d["dims"]
    jm = jupd.PoseUpdateCell(hidden_dim=hdim, context_dim=cdim,
                             conv_impl="split")
    args = (d["net"], d["pose"], d["cost"], d["ctx"])
    v = fill_variables(lambda k: jm.init(k, *args))
    jnet, jdelta = jm.apply(v, *args)
    tm = load(tupd.PoseUpdateCell(hdim, cdim, feat), v)
    with torch.no_grad():
        tnet, tdelta = tm(nchw(d["net"]), torch.from_numpy(d["pose"]),
                          nchw(d["cost"]), nchw(d["ctx"]))
    np.testing.assert_allclose(tnet.permute(0, 2, 3, 1).numpy(), jnet, **TOL)
    np.testing.assert_allclose(tdelta.numpy(), jdelta, **TOL)


@pytest.mark.parametrize("impl", ["conv", "split"])
def test_sep_conv_gru(rng, impl):
    """Both JAX paths are the one PyTorch path (fused convzr, z then r)."""
    d = _cells(rng)
    hdim = d["dims"][0]
    x = np.concatenate([d["ctx"], d["cost"]], -1)
    jm = jupd.SepConvGRU(hidden_dim=hdim, conv_impl=impl)
    v = fill_variables(lambda k: jm.init(k, d["net"], x))
    expected = jm.apply(v, d["net"], x)
    tm = load(tupd.SepConvGRU(hdim, x.shape[-1]), v)
    with torch.no_grad():
        got = tm(nchw(d["net"]), nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), expected, **TOL)


@pytest.mark.parametrize("head", ["depth_sigmoid", "depth_tanh", "pose",
                                  "upmask", "mask"])
def test_heads(rng, head):
    x = rng.normal(size=(2, 6, 10, 16)).astype(np.float32)
    if head.startswith("depth"):
        act = jax.nn.sigmoid if head == "depth_sigmoid" else jnp.tanh
        tact = torch.sigmoid if head == "depth_sigmoid" else torch.tanh
        jm, tm = jupd.DepthHead(hidden_dim=24), tupd.DepthHead(16, 24)
        run_j = lambda v: jm.apply(v, x, act_fn=act)          # noqa: E731
        run_t = lambda: tm(nchw(x), act_fn=tact)             # noqa: E731
    elif head == "pose":
        jm, tm = jupd.PoseHead(hidden_dim=24), tupd.PoseHead(16, 24)
        run_j, run_t = (lambda v: jm.apply(v, x)), (lambda: tm(nchw(x)))
    elif head == "upmask":
        jm, tm = (jupd.UpMaskNet(hidden_dim=12, ratio=4),
                  tupd.UpMaskNet(16, 12, ratio=4))
        run_j, run_t = (lambda v: jm.apply(v, x)), (lambda: tm(nchw(x)))
    else:
        jm, tm = (jupd.UpdateMaskHead(hidden_dim=16, ratio=4),
                  tupd.UpdateMaskHead(16, ratio=4))
        run_j, run_t = (lambda v: jm.apply(v, x)), (lambda: tm(nchw(x)))
    v = fill_variables(lambda k: jm.init(k, x) if head != "depth_tanh"
                       else jm.init(k, x, act_fn=act))
    expected = np.asarray(run_j(v))
    load(tm, v)
    with torch.no_grad():
        got = run_t()
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("version", ["it12-h-out", "it8-out", "it4-seq2-inter",
                                     "it0-h"])
def test_every_leaf_loads_strictly(version):
    """Every leaf of the JAX DepthPoseNet tree has exactly one place in the
    port's state_dict, with the same number of elements, and nothing is left
    over (``load_state_dict(strict=True)``)."""
    b, n, h, w = 1, 2, 32, 48
    jn = JaxNet(version=version, sep_conv="split")
    v = fill_variables(lambda k: jn.init(
        k, jnp.zeros((b, h, w, 3)), jnp.zeros((b, n, h, w, 3)),
        jnp.broadcast_to(jnp.eye(3), (b, 3, 3)), train=False))
    sd = from_jax_variables(v)
    net = DepthPoseNet(version=version, device="cpu")
    ours = net.state_dict()
    assert set(sd) == set(ours)
    for k, t in sd.items():
        assert t.shape == ours[k].shape, k
    net.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) == n_leaves + n_bn


def test_sep_conv_pallas_builds_and_unknown_raises():
    """``sep_conv="pallas"`` builds (the fused pass, `gru_sep1d_pass`; its
    parity is in `tests/test_torch_gru_pass.py`); an unknown value raises."""
    gru = tupd.SepConvGRU(16, 16, conv_impl="pallas")
    h, x = torch.zeros(1, 16, 3, 4), torch.zeros(1, 16, 3, 4)
    with torch.no_grad():
        assert gru(h, x).shape == (1, 16, 3, 4)
    DepthPoseNet(version="it4-h-out", sep_conv="pallas", device="cpu")
    with pytest.raises(ValueError, match="sep_conv"):
        tupd.SepConvGRU(16, 16, conv_impl="fused")
    with pytest.raises(ValueError, match="sep_conv"):
        DepthPoseNet(version="it4-h-out", sep_conv="fused", device="cpu")


def test_train_mode_batchnorm_raises():
    """Train-mode BatchNorm no longer raises: it normalises with the batch
    mean and *biased* variance over N, H, W and moves the running statistics
    10% toward them, as flax's ``BatchNorm(momentum=0.9)`` does (the encoder
    against flax is in `tests/test_torch_train_step.py`)."""
    from dro_sfm_torch.models.layers import BatchNorm2d

    x = torch.from_numpy(np.random.default_rng(0).normal(
        2.0, 3.0, size=(2, 4, 5, 6)).astype(np.float32))
    bn = BatchNorm2d(4).train()
    y = bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    expected = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), expected.numpy(), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var.numpy(), **TOL)
