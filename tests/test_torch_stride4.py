"""The stride-4 feature net (``feat_ratio=4``) of the port against the JAX
package (fp32, CPU).

``DepthPoseNet(feat_ratio=4)``: the three `ResNetEncoder` trunks take one
more half-pixel x2 resize and fuse the stride-4 skip (``upconv2``,
``upconv2_fusion``), the refinement runs on maps of H/4 x W/4, the masks
hold 9 * 16 channels and the convex upsampling is x4. The sizes are those
of the stride-8 tests (``it8-h-out``, 64x96, N=2; B=1 for the forward as in
`tests/test_torch_depth_pose_net.py`, B=2 for the step as in
`tests/test_torch_train_step.py`), so the maps are 16x24 and stride 16
keeps 4 rows. Weights come from `fill_variables` through
`from_jax_variables` with a strict load. JAX runs ``warp_impl="gather"``
(and ``sep_conv="conv"`` against the port's ``"pallas"``), for the reasons
those files state.

Bars: the forward, in eval and in train mode, those of
`tests/test_torch_depth_pose_net.py` (1e-4 relative L2 and 1e-4 absolute
on inverse depth and pose); the train step's gradients, Adam step and
statistics those of `tests/test_torch_train_step.py` (5e-2 on the
train-mode encoders, 1e-2 elsewhere, cosine >= 0.999); the encoder alone
1e-4 absolute and relative, as the stride-8 encoder's test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import encoder as jenc
from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_tpu.utils.config import load_config
from dro_sfm_torch.convert import from_jax_variables, to_jax_variables
from dro_sfm_torch.inference import load_model, make_infer_fn, save_model
from dro_sfm_torch.models import encoder as tenc
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.ops.gru_pass import K5_COUNTER, K6I_COUNTER, K6W_COUNTER
from dro_sfm_torch.parallel import spatial
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_depth_pose_net import assert_close, make_inputs
from tests.test_torch_modules import fill_variables, nchw
from tests.test_torch_train_step import (
    CFG,
    LR,
    assert_grads_close,
    jax_grads_as_port,
    key_with_flip,
    make_batch,
    stats_as_port,
    tbatch,
)

torch.set_num_threads(4)
VERSION = "it8-h-out"
B, N, H, W = 1, 2, 64, 96
RATIO = 4


def jax_net(**kw):
    return JaxNet(version=VERSION, feat_ratio=RATIO, warp_impl="gather",
                  **{"sep_conv": "split", **kw})


@pytest.fixture(scope="module")
def nets():
    """The JAX net, its variables and the port's net on them (eval mode)."""
    inputs = make_inputs(np.random.default_rng(0))
    jnet = jax_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *map(jnp.asarray, inputs), train=False))
    tnet = DepthPoseNet(version=VERSION, feat_ratio=RATIO, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    return jnet, variables, tnet, inputs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("num_images", [1, 2])
def test_encoder_stride4_matches_flax(rng, num_images, train):
    """`ResNetEncoder(stride=4)` alone, eval and train mode; in train mode
    the updated running statistics too."""
    x = rng.uniform(size=(3, 32, 48, 3 * num_images)).astype(np.float32)
    jm = jenc.ResNetEncoder(out_chs=40, stride=4, num_input_images=num_images)
    v = fill_variables(lambda k: jm.init(k, x, train=False))
    tm = tenc.ResNetEncoder(40, stride=4, num_input_images=num_images)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    assert {"upconv2.weight", "upconv2_fusion.weight"} <= set(tm.state_dict())
    assert tuple(tm.out_conv.weight.shape) == (40, 64, 3, 3)
    if train:
        expected, updates = jm.apply(v, x, train=True, mutable=["batch_stats"])
        got = tm.train()(nchw(x))
    else:
        expected = jm.apply(v, x, train=False)
        with torch.inference_mode():
            got = tm.eval()(nchw(x))
    assert got.shape == (3, 40, 8, 12)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(expected), atol=1e-4, rtol=1e-4)
    if train:
        want = stats_as_port(updates["batch_stats"])
        for k, value in tm.state_dict().items():
            if k in want:
                np.testing.assert_allclose(value.numpy(), want[k], atol=1e-4, rtol=1e-4,
                                           err_msg=k)


def test_weights_round_trip_without_renames(nets):
    """The stride-4 tree maps leaf by leaf both ways (no table of renames)."""
    _, variables, tnet, _ = nets
    back = to_jax_variables(tnet.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    mask = tnet.state_dict()["upmask_net.conv2.weight"]
    assert mask.shape[0] == 9 * RATIO * RATIO


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(nets, last_only):
    jnet, variables, tnet, inputs = nets
    expected = jnet.apply(variables, *map(jnp.asarray, inputs), train=False,
                          last_only=last_only)
    with torch.inference_mode():
        got = tnet(*map(torch.from_numpy, inputs), last_only=last_only)
    p = 1 if last_only else tnet.spec.num_predictions
    assert got["inv_depths"].shape == (p, B, H, W, 1)
    assert_close(got["inv_depths"], expected["inv_depths"])
    assert_close(got["pose_vecs"], expected["pose_vecs"])
    if not last_only:
        inv = np.asarray(expected["inv_depths"])
        assert np.abs(inv[-1] - inv[0]).max() > 1e-2


def test_train_mode_forward_matches_jax(nets):
    """Train-mode BatchNorm in all three encoders: the outputs and the
    moved running statistics."""
    jnet, variables, _, inputs = nets
    expected, updates = jnet.apply(variables, *map(jnp.asarray, inputs), train=True,
                                   mutable=["batch_stats"])
    tnet = DepthPoseNet(version=VERSION, feat_ratio=RATIO, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tnet.train()(*map(torch.from_numpy, inputs))
    assert_close(got["inv_depths"], expected["inv_depths"])
    assert_close(got["pose_vecs"], expected["pose_vecs"])
    want = stats_as_port(updates["batch_stats"])
    for k, value in tnet.state_dict().items():
        if k in want:
            np.testing.assert_allclose(value.numpy(), want[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_serving_function_on_cpu(nets):
    """`make_infer_fn` serves the stride-4 net: metric depth at full size."""
    _, _, tnet, inputs = nets
    depth, mats = make_infer_fn(tnet, device="cpu")(*inputs)
    with torch.inference_mode():
        inv = tnet(*map(torch.from_numpy, inputs), last_only=True)["inv_depths"][-1]
    assert depth.shape == (B, H, W) and mats.shape == (B, N, 4, 4)
    torch.testing.assert_close(depth, 1.0 / inv[..., 0], rtol=1e-6, atol=0)


def test_save_and_load_model_keep_the_stride(nets, tmp_path):
    """`save_model` records ``feat_ratio``; `load_model` rebuilds the
    stride-4 net and loads it strictly. A file without the key (written
    before it was saved) takes stride 8."""
    _, _, tnet, inputs = nets
    path = str(tmp_path / "net.pt")
    save_model(tnet, path)
    back = load_model(path, device="cpu")
    assert back.feat_ratio == RATIO
    with torch.inference_mode():
        a = tnet(*map(torch.from_numpy, inputs), last_only=True)
        b = back(*map(torch.from_numpy, inputs), last_only=True)
    for k in a:
        assert torch.equal(a[k], b[k])
    old = torch.load(path, weights_only=True)
    del old["feat_ratio"]
    old["state_dict"] = DepthPoseNet(version=VERSION, device="cpu").state_dict()
    torch.save(old, path)
    assert load_model(path, device="cpu").feat_ratio == 8


def test_height_split_refuses_stride4(rng):
    """No entry point splits a stride-4 net (no config sets ``feat_ratio``):
    under a band the encoder raises and names ROADMAP C, before any
    exchange."""
    enc = tenc.ResNetEncoder(40, stride=4).eval()
    x = nchw(rng.uniform(size=(1, 32, 48, 3)).astype(np.float32))
    with spatial.active(spatial.Band(64, 2, 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            enc(x)
    with pytest.raises(NotImplementedError, match="stride 2"):
        tenc.ResNetEncoder(40, stride=2)


# -- the training step ---------------------------------------------------------

STEP_CFG = {**CFG, "warp_impl": "pallas"}


def step_jax_net(sep_conv="split"):
    return jax_net(min_depth=CFG["min_depth"], max_depth=CFG["max_depth"], remat=False,
                   sep_conv=sep_conv)


@pytest.fixture(scope="module")
def step_setup():
    batch = make_batch()
    jnet = step_jax_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    return batch, variables


def port_net(variables, sep_conv):
    cfg = tsfm.SfmModelConfig(**{**STEP_CFG, "sep_conv": sep_conv})
    net = DepthPoseNet(version=VERSION, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
                       feat_ratio=RATIO, warp_impl="pallas", sep_conv=sep_conv,
                       remat=False, device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return cfg, net


@pytest.mark.parametrize("sep_conv", ["split", "pallas"])
def test_train_gradients_match_jax(step_setup, sep_conv):
    """The supervised loss's gradients, flip on, against JAX's; with
    ``"pallas"`` through the plain K5/K6 (no kernel launched on the CPU)."""
    batch, variables = step_setup
    jcfg = jsfm.SfmModelConfig(**{**CFG, "sep_conv": "conv" if sep_conv == "pallas"
                                  else "split"})
    jnet = step_jax_net(jcfg.sep_conv)
    key = key_with_flip(True)

    def loss_fn(params):
        loss, (_, metrics, _) = jsfm.forward_and_loss(
            jcfg, jnet, {"params": params, "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return loss, metrics

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    for c in (K5_COUNTER, K6I_COUNTER, K6W_COUNTER):
        c.reset()
    tcfg, tnet = port_net(variables, sep_conv)
    loss, (_, metrics) = tsfm.forward_and_loss(tcfg, tnet, tbatch(batch), None, do_flip=True)
    loss.backward()
    for name in ("depth_loss", "pose_loss"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(jmetrics[name]),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert_grads_close(got, jax_grads_as_port(jgrads, variables["batch_stats"]))
    assert (K5_COUNTER.launches, K6I_COUNTER.launches, K6W_COUNTER.launches) == (0, 0, 0)


def test_one_adam_step_matches_jax(step_setup):
    """`make_train_step` on the stride-4 net against JAX's step: parameters
    and statistics after one step of the config-default Adam."""
    batch, variables = step_setup
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = step_jax_net()
    cfg = load_config()
    key = key_with_flip(True, fold=0)
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    jstate = j_create_state(jnet, key, None, tx, init_variables=variables)
    jstate, jmetrics = j_make_train_step(jcfg, jnet)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tcfg, tnet = port_net(variables, "split")
    opt = make_optimizer(tnet, cfg.model.optimizer, cfg.model.scheduler,
                         steps_per_epoch=1000)
    state = create_train_state(tnet, opt, device="cpu")
    before = {k: p.detach().clone().numpy() for k, p in tnet.named_parameters()}
    state, metrics = make_train_step(tcfg, tnet, opt, device="cpu")(
        state, batch, None, do_flip=True)
    grads = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    want = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for k, v in tnet.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got, exp = v.numpy(), want[k].numpy()
        if k in before:
            assert np.abs(got - before[k]).max() > 0.5 * LR, k
            err = np.abs(got - exp)
            assert err.max() <= 2.0 * LR + 1e-6, k
            flipped = err > 0.05 * LR
            assert np.all(np.abs(grads[k][flipped]) <= 5e-2 * np.linalg.norm(grads[k])), k
        else:
            np.testing.assert_allclose(got, exp, atol=1e-4, rtol=1e-4, err_msg=k)
