"""The fused separable-GRU pass (kernels K5, K6 in their plain versions)
against the JAX package (CPU).

On the CPU `gru_sep1d_pass` runs `gru_pass_plain` and `gru_pass_bwd_plain`;
the CUDA kernels are held against those on the card by ``chip_smoke.py``.
Here the forward and all six gradients are held against ``jax.vjp`` of the
Pallas `gru_sep1d_pass` in interpret mode, on the same numpy inputs, at the
shapes of `tests/test_gru_pallas.py` (B=2, 8x16, D=32, Cx=24), both axes.

Bars: fp32 2e-4 absolute and relative, the bar of `tests/test_gru_pallas.py`
(sums of up to 5 * 56 products, and of every pixel in the weight
gradients, in another order). bf16: one bf16 rounding step (2^-8) of the
largest element of each result, absolute: both sides round at the same
points, so they differ only where a reordered fp32 sum rounds a gate, q,
daq or dazr to the neighbouring bf16 value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import update as jupd
from dro_sfm_tpu.ops.pallas.gru_pass import gru_sep1d_pass as jax_pass
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models import update as tupd
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.ops.gru_pass import (
    K5_COUNTER,
    K6I_COUNTER,
    K6W_COUNTER,
    gru_pass_bwd_plain,
    gru_pass_plain,
    gru_sep1d_pass,
)

torch.set_num_threads(2)
B, H, W, D, CX = 2, 8, 16, 32, 24
NAMES = ("h", "x", "wzr", "bzr", "wq", "bq")
GRADS = ("dh", "dx", "dwzr", "dbzr", "dwq", "dbq")


def make_case(rng, b=B, h=H, w=W, d=D, cx=CX):
    c1 = d + cx
    return {"h": np.tanh(rng.normal(size=(b, h, w, d))).astype(np.float32),
            "x": rng.normal(size=(b, h, w, cx)).astype(np.float32),
            "wzr": (rng.normal(size=(5, c1, 2 * d)) / np.sqrt(5 * c1)).astype(np.float32),
            "bzr": (0.1 * rng.normal(size=2 * d)).astype(np.float32),
            "wq": (rng.normal(size=(5, c1, d)) / np.sqrt(5 * c1)).astype(np.float32),
            "bq": (0.1 * rng.normal(size=d)).astype(np.float32),
            "g": rng.normal(size=(b, h, w, d)).astype(np.float32)}


def jax_result(case, axis, dtype):
    """(h', the six gradients) of the Pallas pass in interpret mode; h and x
    in ``dtype``, weights fp32 (cast inside, as the module passes them)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(case[k], jdt if k in ("h", "x") else jnp.float32) for k in NAMES]
    out, vjp = jax.vjp(lambda *a: jax_pass(*a, axis, True), *args)
    grads = vjp(jnp.asarray(case["g"], jdt))
    return np.asarray(out, np.float32), [np.asarray(t, np.float32) for t in grads]


def port_result(case, axis, dtype):
    args = [torch.from_numpy(case[k]).to(dtype if k in ("h", "x") else torch.float32)
            .requires_grad_() for k in NAMES]
    out = gru_sep1d_pass(*args, axis)
    grads = torch.autograd.grad(out, args, torch.from_numpy(case["g"]).to(dtype))
    return out, grads


def assert_close(got, want, dtype, name):
    got = got.detach().float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -8 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("axis", [2, 1])
def test_pass_matches_pallas_interpret(rng, axis, dtype):
    case = make_case(rng)
    want_out, want_grads = jax_result(case, axis, dtype)
    out, grads = port_result(case, axis, dtype)
    assert out.dtype == dtype and out.shape == (B, H, W, D) and out.is_contiguous()
    assert_close(out, want_out, dtype, "h'")
    for name, got, want in zip(GRADS, grads, want_grads):
        assert got.shape == want.shape, name
        assert got.dtype == (dtype if name in ("dh", "dx") else torch.float32), name
        assert_close(got, want, dtype, name)


@pytest.mark.parametrize("axis", [2, 1])
def test_three_pixel_line(rng, axis):
    """A line shorter than the 5 taps: the zero padding reaches both ends."""
    case = make_case(rng, b=1, h=3, w=3, d=16, cx=8)
    want_out, want_grads = jax_result(case, axis, torch.float32)
    out, grads = port_result(case, axis, torch.float32)
    assert_close(out, want_out, torch.float32, "h'")
    for name, got, want in zip(GRADS, grads, want_grads):
        assert_close(got, want, torch.float32, name)


def test_plain_versions_called_directly(rng):
    """Without autograd the entry point is `gru_pass_plain` itself, and the
    Function's backward `gru_pass_bwd_plain`."""
    case = make_case(rng)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    args = [t[k] for k in NAMES]
    with torch.no_grad():
        out = gru_sep1d_pass(*args, 1)
    assert torch.equal(out, gru_pass_plain(*args, 1))
    _, grads = port_result(case, 1, torch.float32)
    for got, want in zip(grads, gru_pass_bwd_plain(*args, t["g"], 1)):
        assert torch.equal(got, want)


def test_bad_arguments_raise(rng):
    t = {k: torch.from_numpy(v) for k, v in make_case(rng).items()}
    args = [t[k] for k in NAMES]
    with pytest.raises(ValueError, match="axis"):
        gru_sep1d_pass(*args, 3)
    with pytest.raises(ValueError, match="wq"):
        gru_sep1d_pass(*args[:4], args[4][:, :-1], args[5], 2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_sep_conv_gru_pallas_matches_jax(rng):
    """`SepConvGRU(conv_impl="pallas")` loaded through `from_jax_variables`
    against the JAX module forced through its Pallas passes in interpret
    mode: the output and the gradients of every parameter and of both
    inputs (fp32, the bar 2e-4 of `tests/test_gru_pallas.py`)."""
    h = np.tanh(rng.normal(size=(B, H, W, D))).astype(np.float32)
    x = rng.normal(size=(B, H, W, CX)).astype(np.float32)
    jm = jupd.SepConvGRU(hidden_dim=D, conv_impl="pallas", pallas_interpret=True)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(h), jnp.asarray(x))

    def loss(p, hh, xx):
        out = jm.apply(p, hh, xx)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), (g_params, g_h, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(h), jnp.asarray(x))

    tm = tupd.SepConvGRU(D, CX, conv_impl="pallas")
    tm.load_state_dict(from_jax_variables(params), strict=True)
    th, tx = nchw(h).requires_grad_(), nchw(x).requires_grad_()
    out = tm(th, tx)
    (out * torch.cos(out)).sum().backward()
    tol = {"atol": 2e-4, "rtol": 2e-4}
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **tol)
    np.testing.assert_allclose(th.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_h), **tol)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x), **tol)
    want_grads = from_jax_variables(g_params)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), **tol, err_msg=k)


@pytest.mark.parametrize("module", ["gru", "net"])
def test_state_dict_keys_same_for_every_conv_impl(module):
    """``pallas`` declares the same parameters as the other paths, so
    `from_jax_variables` and strict loading are unchanged."""
    def build(impl):
        if module == "gru":
            return tupd.SepConvGRU(16, 24, conv_impl=impl)
        return DepthPoseNet(version="it4-h-out", sep_conv=impl, device="cpu")

    ref = {k: v.shape for k, v in build("split").state_dict().items()}
    for impl in ("conv", "matmul", "pallas"):
        assert {k: v.shape for k, v in build(impl).state_dict().items()} == ref, impl


def test_counters_stay_zero_on_cpu(rng):
    for c in (K5_COUNTER, K6I_COUNTER, K6W_COUNTER):
        c.reset()
    port_result(make_case(rng, b=1, h=4, w=6, d=16, cx=8), 2, torch.float32)
    assert (K5_COUNTER.launches, K6I_COUNTER.launches, K6W_COUNTER.launches) == (0, 0, 0)


def test_depth_pose_net_pallas_matches_jax(rng):
    """`DepthPoseNet(sep_conv="pallas")` (it8-h-out, 64x96, fp32) against the
    JAX net, to the bars of `tests/test_torch_depth_pose_net.py`. The JAX net
    runs ``sep_conv="conv"``: off the TPU its ``"pallas"`` is the conv path
    (`dro_sfm_tpu/models/update.py:150-152`) and `DepthPoseNet` has no
    ``pallas_interpret``; in fp32 the two are the same math."""
    from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
    from tests.test_torch_depth_pose_net import VERSION, assert_close, make_inputs
    from tests.test_torch_modules import fill_variables

    inputs = make_inputs(rng)
    jnet = JaxNet(version=VERSION, warp_impl="gather", sep_conv="conv")
    variables = fill_variables(lambda k: jnet.init(k, *map(jnp.asarray, inputs),
                                                   train=False))
    expected = jnet.apply(variables, *map(jnp.asarray, inputs), train=False)
    tnet = DepthPoseNet(version=VERSION, sep_conv="pallas", device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.inference_mode():
        got = tnet(*map(torch.from_numpy, inputs))
    assert_close(got["inv_depths"], expected["inv_depths"])
    assert_close(got["pose_vecs"], expected["pose_vecs"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d, cx", [(32, 32), (32, 24)])
def test_kernel_operands_are_contiguous(dtype, d, cx):
    """The kernels read their weights as contiguous [5, Dp+Cxp, out]: the
    wrapper makes them so from the module's permuted views of the OIHW
    parameters, in either dtype, padded or not, and keeps the values."""
    from dro_sfm_torch.ops.gru_pass import _Prepared, _unpad_weight

    gru = tupd.SepConvGRU(d, cx, conv_impl="pallas")
    wzr = gru.convzr1.weight[:, :, 0, :].permute(2, 1, 0)
    wq = gru.convq1.weight[:, :, 0, :].permute(2, 1, 0)
    assert not wzr.is_contiguous()
    h, x = torch.zeros(1, 2, 3, d, dtype=dtype), torch.zeros(1, 2, 3, cx, dtype=dtype)
    p = _Prepared(h, x, wzr, gru.convzr1.bias, wq, gru.convq1.bias)
    for t in (p.wzr, p.wq, p.bzr, p.bq, p.h, p.x):
        assert t.is_contiguous()
    assert p.wzr.dtype == p.wq.dtype == dtype
    assert torch.equal(_unpad_weight(p.wzr.float(), d, cx, 2), wzr.to(dtype).float())
    assert torch.equal(_unpad_weight(p.wq.float(), d, cx, 1), wq.to(dtype).float())
