"""The port's self-supervised training step against the JAX package (fp32,
CPU).

``SelfSupModelMF`` at ``it8-h-out``, 64x96, B=2, N=2, the flip on, weights
from `fill_variables` carried over by `from_jax_variables`, the photometric
loss on the un-jittered originals with SSIM 0.85, smoothness 0.001 and
gamma 0.85, reduced by the ``mean`` over views without the automask.

Why not the ``min`` reduction with the automask here: its gradient jumps
where a pixel's minimum switches between two nearly equal residuals, and
the port's and the JAX package's forwards (1e-5 apart, fp32 rounding
through 16 recurrent steps) reach such switches at a few pixels. Fed the
JAX net's outputs and then the port net's, the port's own loss gives
gradients 1e-2 apart (relative L2), 95% of it at 5 pixels; the JAX
package's fp32 gradient itself lies 1.4e-2 (up to 1.8x on noise images)
from its fp64 gradient. The ``min`` and automask path is held on identical
inputs by `tests/test_torch_photometric.py`, where no switch can happen.
For the same reason the images are smooth (bilinear upsamplings of 5x7
noise, `task_batch`): a bilinear tap switch then moves a gradient little.
The initial depth and pose heads' last kernels are scaled by 0.1, as
`chip_smoke.py` scales the heads of its training phases.

Bars, those of `tests/test_torch_train_step.py`: the loss and its terms
1e-5 relative; per-leaf gradients cosine >= 0.999 and relative L2 <= 5e-2
on the train-mode encoders, <= 1e-2 elsewhere; BatchNorm statistics 1e-4.
`task_gradients_match_jax` serves the other task tests too.

The training step itself (`make_train_step`) runs the config-default loss
on a batch that holds no ground truth: a self-supervised task moves only
the keys it reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.losses.photometric import PhotometricLossConfig as JaxLossConfig
from dro_sfm_torch.losses.photometric import PhotometricLossConfig
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_modules import fill_variables
from tests.test_torch_train_step import (
    CFG,
    assert_grads_close,
    jax_grads_as_port,
    key_with_flip,
    make_batch,
    port_net,
    stats_as_port,
    tbatch,
)

torch.set_num_threads(4)
SMOOTH_LOSS = {"photometric_reduce_op": "mean", "automask_loss": False}


def smooth_images(rng, shape):
    """Images [..., H, W, 3]: 5x7 uniform noise upsampled bilinearly."""
    h, w = shape[-3], shape[-2]
    low = rng.uniform(size=(*shape[:-3], 5, 7, 3))
    ys, xs = np.linspace(0, 4, h), np.linspace(0, 6, w)
    y0, x0 = np.minimum(ys.astype(int), 3), np.minimum(xs.astype(int), 5)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    rows = low[..., y0, :, :]
    top = (1 - wx) * rows[..., :, x0, :] + wx * rows[..., :, x0 + 1, :]
    rows = low[..., y0 + 1, :, :]
    bottom = (1 - wx) * rows[..., :, x0, :] + wx * rows[..., :, x0 + 1, :]
    return ((1 - wy) * top + wy * bottom).astype(np.float32)


def task_batch(seed=0):
    """`make_batch` with smooth images, and the un-jittered originals the
    photometric term reads (the images with a little noise, as a colour
    jitter leaves them)."""
    batch = make_batch(seed)
    rng = np.random.default_rng(seed + 100)
    for k in ("rgb", "rgb_context"):
        batch[k] = smooth_images(rng, batch[k].shape)
        noisy = batch[k] + rng.normal(0, 0.02, size=batch[k].shape)
        batch[f"{k}_original"] = np.clip(noisy, 0, 1).astype(np.float32)
    return batch


def task_setup(name, loss=None, **overrides):
    """Batch, JAX config and net, variables (the initial heads' last
    kernels scaled by 0.1) and the port's config of task ``name``, with
    the photometric settings ``loss`` (the defaults when None)."""
    batch = task_batch()
    kw = {**CFG, "name": name, **overrides}
    jcfg = jsfm.SfmModelConfig(**kw, photometric=JaxLossConfig(**(loss or {})))
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    for head in ("depth_head", "pose_head"):
        if head in variables["params"]:
            conv = variables["params"][head]["conv2"]
            conv["kernel"] = conv["kernel"] * 0.1
    tcfg = tsfm.SfmModelConfig(**{**kw, "warp_impl": "pallas"},
                               photometric=PhotometricLossConfig(**(loss or {})))
    return batch, jcfg, jnet, variables, tcfg


def task_gradients_match_jax(name, flip, encoders=("fnet.", "cnet_"),
                             loss=SMOOTH_LOSS, **overrides):
    """One forward + backward of task ``name`` in both packages: the loss
    and its terms, every leaf's gradient and the BatchNorm statistics.
    Returns the port's metrics and gradients."""
    batch, jcfg, jnet, variables, tcfg = task_setup(name, loss, **overrides)
    key = key_with_flip(flip)

    def loss_fn(params):
        loss, (_, metrics, updates) = jsfm.forward_and_loss(
            jcfg, jnet, {"params": params, "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return loss, (metrics, updates)

    (jloss, (jmetrics, jupdates)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    tnet = port_net(tcfg, variables)
    loss, (_, metrics) = tsfm.forward_and_loss(tcfg, tnet, tbatch(batch), None,
                                               do_flip=flip)
    loss.backward()
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    got = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert_grads_close(got, jax_grads_as_port(jgrads, variables["batch_stats"]),
                       encoders)
    want = stats_as_port(jupdates["batch_stats"])
    for k, v in tnet.state_dict().items():
        if k in want:
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    return metrics, got


def test_selfsup_gradients_match_jax():
    metrics, _ = task_gradients_match_jax("SelfSupModelMF", flip=True)
    assert set(metrics) == {"photometric_loss", "smoothness_loss"}


def test_selfsup_step_moves_only_the_keys_it_reads():
    """A batch without ground truth trains: the step reads the images, the
    intrinsics and the originals, and every parameter with a gradient moves
    (the initial pose head may have none: where the automask keeps the
    unwarped residual at every pixel, the first prediction's warp does not
    reach the loss)."""
    batch, _, _, _, tcfg = task_setup("SelfSupModelMF", version="it4-h-out")
    assert tcfg.batch_keys == ("rgb", "rgb_context", "intrinsics", "rgb_original",
                               "rgb_context_original")
    for k in ("depth", "pose_context"):
        del batch[k]
    net = tcfg.build_net(device="cpu")
    opt = make_optimizer(net, steps_per_epoch=10)
    state = create_train_state(net, opt, device="cpu")
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    state, metrics = make_train_step(tcfg, net, opt, device="cpu")(
        state, batch, torch.Generator().manual_seed(0), progress=0.5)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert set(metrics) == {"loss", "photometric_loss", "smoothness_loss"}
    stale = [k for k, p in net.named_parameters()
             if torch.equal(p, before[k]) and p.grad.abs().sum() > 0]
    assert not stale and len([p for p in net.parameters() if p.grad.abs().sum() > 0]) > 100
