"""The warp-cost backward (kernels K2, K3 in their plain versions) against
the JAX package.

On the CPU `warp_diff`'s backward runs `warp_diff_bwd_feat_plain` and
`warp_diff_bwd_coords_plain`; the CUDA kernels are held against those on the
card by ``chip_smoke.py``. Here, in fp32, the gradients of all three inputs
are held against ``jax.vjp`` of the Pallas `tent_warp_diff` in interpret mode
(its `_tent_warp_diff_bwd`, contracting at HIGHEST precision) and against
autograd through `warp_diff_plain`. Tolerance 1e-5 absolute and relative:
each side sums a handful of fp32 products per feature element and C = 16
per coordinate, in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.ops.pallas.tent_warp import tent_warp_diff
from dro_sfm_torch.ops import tent_warp
from dro_sfm_torch.ops.tent_warp import (
    K1_COUNTER,
    K2_COUNTER,
    K3_COUNTER,
    warp_diff,
    warp_diff_bwd_coords_plain,
    warp_diff_bwd_feat_plain,
    warp_diff_plain,
)
from tests.test_torch_tent_warp import SHAPES, make_coords

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-5}
KINDS = ["random", "integer", "out_of_view", "far"]


def make_case(rng, kind, hw, b=2, n=2, c=16):
    h, w = hw
    return (rng.normal(size=(b, h * w, c)).astype(np.float32),
            rng.normal(size=(b * n, h, w, c)).astype(np.float32),
            make_coords(rng, kind, b * n, h, w),
            rng.normal(size=(b * n, h * w, c)).astype(np.float32), n)


def jax_vjp(f1, feat, coords, g, n):
    """(d_f1, d_features, d_coords) of the Pallas kernel in interpret mode,
    with P padded to its 128-row tile as its wrapper pads it (zero f1 and
    cotangent, coordinates at -10)."""
    p = f1.shape[1]
    pad = -(-p // 128) * 128 - p
    f1p = np.pad(f1, ((0, 0), (0, pad), (0, 0)))
    cop = np.pad(coords, ((0, 0), (0, pad), (0, 0)), constant_values=-10.0)
    gp = np.pad(g, ((0, 0), (0, pad), (0, 0)))
    _, vjp = jax.vjp(lambda a, f, c: tent_warp_diff(a, f, c, n, True),
                     jnp.asarray(f1p), jnp.asarray(feat), jnp.asarray(cop))
    d_f1, d_feat, d_co = vjp(jnp.asarray(gp))
    return np.asarray(d_f1)[:, :p], np.asarray(d_feat), np.asarray(d_co)[:, :p]


def torch_grads(fn, f1, feat, coords, g, n):
    """Gradients of ``<fn(f1, feat, coords, n), g>`` by autograd."""
    args = [torch.from_numpy(a).requires_grad_() for a in (f1, feat, coords)]
    out = fn(*args, n)
    return [t.numpy() for t in torch.autograd.grad(out, args, torch.from_numpy(g))]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_backward_matches_pallas_vjp(rng, hw, kind):
    f1, feat, coords, g, n = make_case(rng, kind, hw)
    expected = jax_vjp(f1, feat, coords, g, n)
    got = torch_grads(warp_diff, f1, feat, coords, g, n)
    for name, a, e in zip(("d_f1", "d_features", "d_coords"), got, expected):
        assert a.shape == e.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, e, **TOL, err_msg=name)
    # the plain versions called directly give the same
    h, w = hw
    t = [torch.from_numpy(a) for a in (feat, coords, g)]
    np.testing.assert_array_equal(
        warp_diff_bwd_feat_plain(t[1], t[2], h, w, torch.float32).numpy(), got[1])
    np.testing.assert_array_equal(warp_diff_bwd_coords_plain(*t).numpy(), got[2])
    if kind in ("out_of_view", "far"):
        outside = (np.abs(coords) > 1e3).any(-1) | (coords < -3).any(-1)
        assert np.all(got[2][outside] == 0.0)


def test_integer_coordinates_take_the_right_sided_subgradient(rng):
    """At exactly-integer coordinates the coordinate gradient is
    ``F[k+1] - F[k]`` (taps k and k+1), not zero: the case of
    `tests/test_pallas_warp.py::test_tent_warp_gradients_at_integer_coords`,
    12x16 (two 128-row strips), here through the fused warp-subtract."""
    b, n, h, w, c = 1, 2, 12, 16, 8
    f1 = rng.normal(size=(b, h * w, c)).astype(np.float32)
    feat = rng.normal(size=(b * n, h, w, c)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.broadcast_to(np.stack([gx, gy], -1).reshape(1, h * w, 2),
                             (b * n, h * w, 2)).astype(np.float32)
    g = rng.normal(size=(b * n, h * w, c)).astype(np.float32)
    expected = jax_vjp(f1, feat, coords, g, n)[2]
    got = torch_grads(warp_diff, f1, feat, coords, g, n)[2]
    assert np.abs(got).max() > 1.0          # the subgradient is non-trivial
    np.testing.assert_allclose(got, expected, **TOL)
    # interior pixels: exactly -<g, F[y, x+1] - F[y, x]> in x
    fd = feat[:, :, 1:, :] - feat[:, :, :-1, :]            # [bn, h, w-1, c]
    inner = -(g.reshape(b * n, h, w, c)[:, :, :-1] * fd).sum(-1)
    np.testing.assert_allclose(got.reshape(b * n, h, w, 2)[:, :, :-1, 0], inner,
                               **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_backward_matches_autograd_of_plain(rng, kind):
    """The hand-written backward against autograd through the plain forward
    (`bilinear_sample`'s index_select and weight formula)."""
    f1, feat, coords, g, n = make_case(rng, kind, (6, 10))
    got = torch_grads(warp_diff, f1, feat, coords, g, n)
    expected = torch_grads(warp_diff_plain, f1, feat, coords, g, n)
    for a, e in zip(got, expected):
        np.testing.assert_allclose(a, e, **TOL)


def test_d_f1_is_the_view_sum(rng):
    f1, feat, coords, g, n = make_case(rng, "random", (6, 10))
    d_f1 = torch_grads(warp_diff, f1, feat, coords, g, n)[0]
    b, p, c = f1.shape
    np.testing.assert_array_equal(d_f1, g.reshape(b, n, p, c).sum(1))


def test_bf16_dtypes_and_single_rounding(rng):
    """bf16 inputs: d_f1 and d_features come out in bf16, d_coords in fp32,
    each computed in fp32 from the bf16 values and rounded once."""
    f1, feat, coords, g, n = make_case(rng, "random", (6, 10))
    bf = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (f1, feat)]
    co = torch.from_numpy(coords).requires_grad_()
    g16 = torch.from_numpy(g).bfloat16()
    out = warp_diff(bf[0], bf[1], co, n)
    d_f1, d_feat, d_co = torch.autograd.grad(out, (*bf, co), g16)
    assert (d_f1.dtype, d_feat.dtype, d_co.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    b, p, c = f1.shape
    assert torch.equal(d_f1, g16.float().reshape(b, n, p, c).sum(1).bfloat16())
    h, w = feat.shape[1:3]
    assert torch.equal(d_feat, warp_diff_bwd_feat_plain(
        co.detach(), g16.float(), h, w, torch.float32).bfloat16())
    assert torch.equal(d_co, warp_diff_bwd_coords_plain(
        bf[1].detach().float(), co.detach(), g16.float()))


def test_only_requested_gradients_are_computed(rng, monkeypatch):
    """``ctx.needs_input_grad`` is respected: with the coordinates fixed the
    coordinate half (K3 on the card) is never called."""
    f1, feat, coords, g, n = make_case(rng, "random", (6, 10))

    def refuse(*args):
        raise AssertionError("coordinate gradient computed without need")

    monkeypatch.setattr(tent_warp, "warp_diff_bwd_coords", refuse)
    ft = torch.from_numpy(feat).requires_grad_()
    out = warp_diff(torch.from_numpy(f1), ft, torch.from_numpy(coords), n)
    (d_feat,) = torch.autograd.grad(out, (ft,), torch.from_numpy(g))
    expected = torch_grads(warp_diff_plain, f1, feat, coords, g, n)[1]
    np.testing.assert_allclose(d_feat.numpy(), expected, **TOL)


def test_non_contiguous_cotangent(rng):
    """The cotangent of the squared, view-averaged cost reaches the backward
    strided; the result is the same as for a contiguous one."""
    f1, feat, coords, g, n = make_case(rng, "random", (6, 10))
    args = [torch.from_numpy(a).requires_grad_() for a in (f1, feat, coords)]
    g_t = torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))).transpose(0, 1)
    assert not g_t.is_contiguous()
    got = torch.autograd.grad(warp_diff(*args, n), args, g_t)
    expected = torch_grads(warp_diff, f1, feat, coords, g, n)
    for a, e in zip(got, expected):
        np.testing.assert_array_equal(a.numpy(), e)


def test_cpu_backward_launches_nothing(rng):
    f1, feat, coords, g, n = make_case(rng, "random", (6, 10))
    before = [k.launches for k in (K1_COUNTER, K2_COUNTER, K3_COUNTER)]
    torch_grads(warp_diff, f1, feat, coords, g, n)
    assert [k.launches for k in (K1_COUNTER, K2_COUNTER, K3_COUNTER)] == before
