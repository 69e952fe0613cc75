"""The port's supervised training step against the JAX package (fp32, CPU).

``SupModelMF`` at ``it8-h-out`` (2 outer iterations of 4 depth and 4 pose
steps), 64x96, B=2, N=2, weights from `fill_variables` carried over by
`from_jax_variables`. JAX runs ``warp_impl="gather"`` with ``remat=False``
(off the TPU its ``"pallas"`` is a bf16-weight matmul sampler, not an fp32
reference); the port runs ``"pallas"``, which on CPU tensors is the plain
version of K1 forward and K2/K3 backward. JAX gradients map onto the port's
parameter names through `from_jax_variables`, a per-tensor transpose.

Bars:
- train-mode encoder: output and updated running statistics 1e-4 absolute
  and relative (a few fp32 convolutions and batch reductions in another
  order);
- gradients, per leaf (ROADMAP queue A item 8): cosine >= 0.999, and
  relative L2 <= 5e-2 on the three train-mode encoders, <= 1e-2 elsewhere; a
  leaf whose norm is below 1e-6 of the largest leaf's is compared
  absolutely, its difference below 1e-6 of that largest norm. The encoder
  bar is set by the reference, not the port: on this CPU, JAX's own fp32
  gradient of a train-mode `ResNetEncoder` is 1.8e-2 (relative L2) away
  from its fp64 gradient on the deepest BatchNorm leaves, while the port's
  fp32 gradient stays within 1e-6 of fp64; the 16 recurrent steps carry
  such differences into the refinement's leaves at up to 3e-3. The loss and
  its two terms agree to 1e-5 relative;
- one Adam step: an update is ``lr * m / (sqrt(v) + eps)`` with ``m = g`` and
  ``v = g^2`` scaled alike, so it is ``lr * g / (|g| + eps)`` — about
  ``lr * sign(g)`` whatever the gradient's relative error, but where ``|g|``
  is below the gradient's own error the sign itself may flip. The
  parameters after the step agree to 0.05 lr, except to 2 lr (a flipped
  sign) at elements whose gradient is within the gradient bar of zero
  (``|g| <= 5e-2 ||g_leaf||``); BatchNorm statistics to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import encoder as jenc
from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_tpu.utils.config import load_config
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.geometry.pose import pose_vec_to_mat
from dro_sfm_torch.models import encoder as tenc
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_modules import fill_variables, nchw

torch.set_num_threads(4)
VERSION = "it8-h-out"
B, N, H, W = 2, 2, 64, 96
CFG = dict(name="SupModelMF", version=VERSION, min_depth=0.2, max_depth=80.0,
           flip_lr_prob=0.5, mixed_precision=False, warp_impl="gather",
           sep_conv="split", remat=False)
LR = 2e-4                                 # the config default, both groups


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[W * 0.8, 0, (W - 1) / 2], [0, W * 0.8, (H - 1) / 2],
                  [0, 0, 1.0]], np.float32)
    gt_vecs = torch.from_numpy(rng.normal(0, 0.05, size=(B, N, 6)).astype(np.float32))
    return {
        "rgb": rng.uniform(size=(B, H, W, 3)).astype(np.float32),
        "rgb_context": rng.uniform(size=(B, N, H, W, 3)).astype(np.float32),
        "intrinsics": np.broadcast_to(K, (B, 3, 3)).copy(),
        # straddles the (min, max) depth band and the max_depth/4 pose mask
        "depth": rng.uniform(0.1, 40.0, size=(B, H, W, 1)).astype(np.float32),
        "pose_context": pose_vec_to_mat(gt_vecs).numpy(),
    }


def key_with_flip(flip, fold=None):
    """A PRNG key whose flip draw (after ``fold_in(key, fold)`` when
    given, as `make_train_step` folds in the step) is ``flip``."""
    for i in range(100):
        key = jax.random.PRNGKey(i)
        k = key if fold is None else jax.random.fold_in(key, fold)
        if bool(jax.random.bernoulli(k, 0.5)) == flip:
            return key
    raise AssertionError("no key")


@pytest.fixture(scope="module")
def setup():
    batch = make_batch()
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    tcfg = tsfm.SfmModelConfig(**{**CFG, "warp_impl": "pallas"})
    return batch, jcfg, jnet, variables, tcfg


def port_net(tcfg, variables, **overrides):
    net = dataclasses.replace(tcfg, **overrides).build_net(device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_grads_as_port(grads, batch_stats):
    sd = from_jax_variables({"params": grads, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def stats_as_port(batch_stats):
    sd = from_jax_variables({"params": {}, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("_mean", "_var"))}


def assert_grads_close(got, expected, encoders=("fnet.", "cnet_"), bar_elsewhere=1e-2):
    """Per-leaf gradient bars (module docstring); ``encoders`` prefixes the
    train-mode encoders' leaves, which take the 5e-2 bar, the others
    ``bar_elsewhere``."""
    assert set(got) == set(expected)
    top = max(np.linalg.norm(e) for e in expected.values())
    for name, e in expected.items():
        g = got[name]
        assert g.shape == e.shape and np.all(np.isfinite(g)), name
        ne = np.linalg.norm(e)
        if ne < 1e-6 * top:
            assert np.linalg.norm(g - e) <= 1e-6 * top, name
            continue
        cos = float(np.dot(g.ravel(), e.ravel()) / (np.linalg.norm(g) * ne))
        rel = float(np.linalg.norm(g - e) / ne)
        bar = 5e-2 if name.startswith(encoders) else bar_elsewhere
        assert cos >= 0.999 and rel <= bar, (name, cos, rel)


@pytest.mark.parametrize("num_images", [1, 2])
def test_train_mode_encoder_matches_flax(rng, num_images):
    """Train-mode BatchNorm: batch statistics (biased variance) normalise
    the output and move the running statistics, as flax's
    ``mutable=["batch_stats"]`` does."""
    x = rng.uniform(size=(3, 32, 48, 3 * num_images)).astype(np.float32)
    jm = jenc.ResNetEncoder(out_chs=40, num_input_images=num_images)
    v = fill_variables(lambda k: jm.init(k, x, train=False))
    expected, updates = jm.apply(v, x, train=True, mutable=["batch_stats"])
    tm = tenc.ResNetEncoder(40, num_input_images=num_images)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    got = tm.train()(nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(expected), atol=1e-4, rtol=1e-4)
    want = stats_as_port(updates["batch_stats"])
    ours = {k: v.numpy() for k, v in tm.state_dict().items() if k in want}
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_allclose(ours[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)
        assert not np.allclose(want[k], stats_as_port(v["batch_stats"])[k])


@pytest.mark.parametrize("flip", [False, True], ids=["flip_off", "flip_on"])
def test_train_gradients_match_jax(setup, flip):
    batch, jcfg, jnet, variables, tcfg = setup
    key = key_with_flip(flip)

    def loss_fn(params):
        loss, (_, metrics, updates) = jsfm.forward_and_loss(
            jcfg, jnet, {"params": params,
                         "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return loss, (metrics, updates)

    (jloss, (jmetrics, jupdates)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    tnet = port_net(tcfg, variables)
    loss, (_, metrics) = tsfm.forward_and_loss(tcfg, tnet, tbatch(batch), None,
                                               do_flip=flip)
    loss.backward()
    for name, value in (("loss", loss), ("depth_loss", metrics["depth_loss"]),
                        ("pose_loss", metrics["pose_loss"])):
        want = jloss if name == "loss" else jmetrics[name]
        np.testing.assert_allclose(float(value.detach()), float(want), rtol=1e-5,
                                   err_msg=name)
    got = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert_grads_close(got, jax_grads_as_port(jgrads, variables["batch_stats"]))
    want = stats_as_port(jupdates["batch_stats"])
    for k, v in tnet.state_dict().items():
        if k in want:
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_one_adam_step_matches_jax(setup):
    """`make_train_step` against JAX's: the parameters and BatchNorm
    statistics after one step of the config-default Adam and StepLR. The
    flip is JAX's draw from its step key, passed to the port."""
    batch, jcfg, jnet, variables, tcfg = setup
    cfg = load_config()
    key = key_with_flip(True, fold=0)
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler,
                          steps_per_epoch=1000)
    jstate = j_create_state(jnet, key, None, tx, init_variables=variables)
    jstate, jmetrics = j_make_train_step(jcfg, jnet)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tnet = port_net(tcfg, variables)
    opt = make_optimizer(tnet, cfg.model.optimizer, cfg.model.scheduler,
                         steps_per_epoch=1000)
    state = create_train_state(tnet, opt, device="cpu")
    before = {k: p.detach().clone().numpy() for k, p in tnet.named_parameters()}
    step = make_train_step(tcfg, tnet, opt, device="cpu")
    state, metrics = step(state, batch, None, do_flip=True)
    grads = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert state.step == 1
    assert set(metrics) == {"loss", "depth_loss", "pose_loss", "all_loss"}
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)

    want = from_jax_variables({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    for k, v in tnet.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got, exp = v.numpy(), want[k].numpy()
        if k in before:
            moved = np.abs(got - before[k])
            assert moved.max() > 0.5 * LR, k              # the step moved it
            err = np.abs(got - exp)
            assert err.max() <= 2.0 * LR + 1e-6, k
            # off by more than 0.05 lr only where the sign may flip: |g|
            # inside the gradient bar of this leaf
            g = grads[k]
            flipped = err > 0.05 * LR
            assert np.all(np.abs(g[flipped]) <= 5e-2 * np.linalg.norm(g)), k
        else:
            np.testing.assert_allclose(got, exp, atol=1e-4, rtol=1e-4, err_msg=k)


def test_remat_gives_the_same_gradients(setup):
    """``remat=True`` recomputes each inner step in the backward
    (`torch.utils.checkpoint`); the gradients equal those kept without it
    to fp32 rounding (1e-6 relative per leaf: the recomputation repeats the
    same operations, only the accumulation order of shared weights may
    change)."""
    batch, _, _, variables, tcfg = setup
    grads = []
    for remat in (False, True):
        net = port_net(tcfg, variables, remat=remat)
        loss, _ = tsfm.forward_and_loss(tcfg, net, tbatch(batch), None, do_flip=False)
        loss.backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6,
                                   atol=1e-6 * float(g.abs().max()))


def test_entry_points_refuse_missing_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the entry points would run there")
    _, _, _, variables, tcfg = setup
    net = port_net(tcfg, variables)
    opt = make_optimizer(net)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(net, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tcfg, net, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcfg.build_net()
