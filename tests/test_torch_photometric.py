"""The port's photometric loss, SSIM and SSIM pool against the JAX package
(fp32, CPU).

The same numpy inputs (a seed) go through `dro_sfm_tpu.losses.photometric`
and `dro_sfm_torch.losses.photometric`: SSIM on and off, the ``min`` and
``mean`` reductions, the automask on and off, ``clip_loss``, progressive
scaling past a threshold, ``smooth_finest_last`` with normalised weights,
and the perceptual term (a `PercepNet` without the 224x224 resize, its
weights carried by `from_jax_variables`).

Tolerances: the SSIM pool and the SSIM distance 1e-6 absolute (values in
[0, 1]; the pool sums the nine taps in the JAX package's order, and was
bit-exact here, but SSIM's quotient may round otherwise); the loss and each
of its terms 1e-5 relative; its gradients with respect to ``inv_depths`` and
``pose_vecs`` 1e-4 relative L2 (a projection, a bilinear warp and the SSIM
chain, each rounded in fp32 in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.losses import photometric as jphoto
from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
from dro_sfm_tpu.ops import image as jimage
from dro_sfm_tpu.ops.ssim import ssim_loss as j_ssim_loss
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.losses import photometric as tphoto
from dro_sfm_torch.models.percep import PercepNet
from dro_sfm_torch.ops import image as timage
from dro_sfm_torch.ops import ssim as tssim
from tests.test_torch_modules import fill_variables

torch.set_num_threads(2)
P, B, N, H, W = 3, 2, 2, 24, 32


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[W * 0.8, 0, (W - 1) / 2], [0, W * 0.8, (H - 1) / 2],
                  [0, 0, 1.0]], np.float32)
    return {
        "image": rng.uniform(size=(B, H, W, 3)).astype(np.float32),
        "context": rng.uniform(size=(B, N, H, W, 3)).astype(np.float32),
        "inv_depths": rng.uniform(0.1, 1.0, size=(P, B, H, W, 1)).astype(np.float32),
        "K": np.broadcast_to(K, (B, 3, 3)).copy(),
        "pose_vecs": rng.normal(0, 0.03, size=(B, N, P, 6)).astype(np.float32),
    }


@pytest.mark.parametrize("shape", [(P, B, N, H, W, 3), (2, 5, 7, 1)],
                         ids=["6d", "4d"])
def test_avg_pool_and_ssim_loss_match_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=shape).astype(np.float32)
    y = rng.uniform(size=shape).astype(np.float32)
    np.testing.assert_allclose(
        timage.avg_pool_3x3_reflect(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.avg_pool_3x3_reflect(jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tssim.ssim_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(j_ssim_loss(jnp.asarray(x), jnp.asarray(y))), atol=1e-6, rtol=0)


def test_ssim_pools_a_broadcast_reference_once():
    """A target broadcast over predictions and views gives the SSIM of its
    expanded copy, bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(size=(P, B, N, H, W, 3)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(size=(1, B, 1, H, W, 3)).astype(np.float32))
    assert torch.equal(tssim.ssim_loss(x, y), tssim.ssim_loss(x, y.expand_as(x)))


@pytest.mark.parametrize("shape", [(2, 9, 12, 3), (3, 2, 5, 6, 1)])
def test_resize_nearest_and_gradients_match_jax(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    h, w = shape[-3], shape[-2]
    for out in ((2 * h, 2 * w), (h // 2, w // 3 + 1), (h, w)):
        np.testing.assert_array_equal(
            timage.resize_nearest(torch.from_numpy(x), out).numpy(),
            np.asarray(jimage.resize_nearest(jnp.asarray(x), out)))
    for name in ("gradient_x", "gradient_y"):
        np.testing.assert_array_equal(
            getattr(timage, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jimage, name)(jnp.asarray(x))))


def percep_pair():
    """A JAX `PercepNet` without the resize and the port's with its
    weights."""
    jnet = JaxPercepNet(resize=False)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = fill_variables(lambda k: jnet.init(k, dummy, dummy), seed=4)
    tnet = PercepNet(resize=False, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    return (lambda a, b: jnet.apply(variables, a, b)), tnet


CASES = {
    "default": {},
    "ssim_off_min": {"ssim_loss_weight": 0.0},
    "mean": {"photometric_reduce_op": "mean"},
    "ssim_off_mean_no_automask": {"ssim_loss_weight": 0.0, "photometric_reduce_op": "mean",
                                  "automask_loss": False},
    "no_automask": {"automask_loss": False},
    "clip": {"clip_loss": 0.5},
    "ssim_off_clip": {"ssim_loss_weight": 0.0, "clip_loss": 0.5},
    "progressive": {"progressive_scaling": 0.3},
    "single_frame": {"gamma": 1.0, "normalize_weights": True, "smooth_finest_last": True},
    "percep": {"percep_loss_weight": 0.2},
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case):
    inp = make_inputs()
    cfg_kw = CASES[case]
    jcfg = jphoto.PhotometricLossConfig(**cfg_kw)
    tcfg = tphoto.PhotometricLossConfig(**cfg_kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    progress = 0.5 if case == "progressive" else 0.0
    jpercep, tpercep = percep_pair() if case == "percep" else (None, None)

    def jloss(inv_depths, pose_vecs):
        return jphoto.multiview_photometric_loss(
            jnp.asarray(inp["image"]), jnp.asarray(inp["context"]), inv_depths,
            jnp.asarray(inp["K"]), pose_vecs, jcfg, percep_fn=jpercep,
            progress=progress)

    grad_fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    (jl, jmetrics), (jg_d, jg_p) = grad_fn(jnp.asarray(inp["inv_depths"]),
                                           jnp.asarray(inp["pose_vecs"]))

    inv_depths = torch.from_numpy(inp["inv_depths"]).requires_grad_()
    pose_vecs = torch.from_numpy(inp["pose_vecs"]).requires_grad_()
    tl, tmetrics = tphoto.multiview_photometric_loss(
        torch.from_numpy(inp["image"]), torch.from_numpy(inp["context"]), inv_depths,
        torch.from_numpy(inp["K"]), pose_vecs, tcfg, percep_fn=tpercep, progress=progress)
    tl.backward()

    assert set(tmetrics) == set(jmetrics)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    for name, got, want in (("inv_depths", inv_depths.grad, jg_d),
                            ("pose_vecs", pose_vecs.grad, jg_p)):
        want = np.asarray(want)
        assert np.linalg.norm(want) > 0, name
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-4, (name, rel)
    if case == "progressive":           # the first prediction has dropped out
        assert float(jnp.abs(jg_d[0]).max()) == 0.0
        assert float(inv_depths.grad[0].abs().max()) == 0.0


def test_warp_gives_the_context_no_gradient():
    """The context images carry no gradient, so the warp's backward is the
    tap weights' alone: no gradient reaches ``context``."""
    inp = make_inputs()
    context = torch.from_numpy(inp["context"])
    inv_depths = torch.from_numpy(inp["inv_depths"]).requires_grad_()
    warped = tphoto.warp_context(context, inv_depths,
                                 torch.from_numpy(inp["pose_vecs"]),
                                 torch.from_numpy(inp["K"]))
    assert warped.shape == (P, B, N, H, W, 3) and not context.requires_grad
    warped.sum().backward()
    assert inv_depths.grad.abs().sum() > 0
