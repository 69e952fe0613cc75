"""The bare warp `tent_warp` (kernel K4 forward, K2 and K3 with sign +1
backward, in their plain versions) against the JAX package (CPU).

On the CPU `tent_warp` runs `tent_warp_plain` and the K2/K3 plain versions;
the CUDA kernels are held against those on the card by ``chip_smoke.py``.
Here the output and both gradients are held against ``jax.vjp`` of the
Pallas `tent_warp` in interpret mode (P padded to its 128-row tile with
coordinates at -10, as its callers pad).

Bars: fp32 features 1e-5 absolute and relative (a handful of fp32 products
per element, C = 16 per coordinate gradient, summed in another order).
bf16 features: the TPU kernel rounds its tent weights (and, for the feature
gradient, the fp32 cotangent) to bf16 before its product, the port keeps
them in fp32 (ROADMAP queue C): each weight or cotangent moves by at most
2^-9 of itself, so the results differ by at most about 2^-8 of the sum of
the magnitudes of their terms, plus one bf16 rounding of the feature
gradient; the bar is 2^-7 of the largest such sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.ops.pallas.tent_warp import tent_warp as jax_tent_warp
from dro_sfm_torch.ops.tent_warp import (
    K2_COUNTER,
    K3_COUNTER,
    K4_COUNTER,
    tent_warp,
    tent_warp_plain,
)
from tests.test_torch_tent_warp import SHAPES, make_coords

torch.set_num_threads(2)
KINDS = ["random", "integer", "out_of_view", "far"]


def jax_result(feat, coords, g, dtype):
    """(out, d_features, d_coords) of the Pallas kernel in interpret mode."""
    p = coords.shape[1]
    pad = -(-p // 128) * 128 - p
    cop = np.pad(coords, ((0, 0), (0, pad), (0, 0)), constant_values=-10.0)
    gp = np.pad(g, ((0, 0), (0, pad), (0, 0)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out, vjp = jax.vjp(lambda f, c: jax_tent_warp(f, c, True),
                       jnp.asarray(feat, jdt), jnp.asarray(cop))
    d_feat, d_co = vjp(jnp.asarray(gp))
    return (np.asarray(out)[:, :p], np.asarray(d_feat, np.float32),
            np.asarray(d_co)[:, :p])


def port_result(feat, coords, g, dtype):
    f = torch.from_numpy(feat).to(dtype).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    out = tent_warp(f, c)
    d_feat, d_co = torch.autograd.grad(out, (f, c), torch.from_numpy(g))
    return out, d_feat, d_co


def magnitudes(feat, coords, g):
    """Per-result sums of the magnitudes of the terms: |W| |F| for the
    output, |W|^T |g| for d_features, |g| |W'| |F| for d_coords (plain
    versions on absolute values)."""
    f = torch.from_numpy(np.abs(feat)).requires_grad_()
    c = torch.from_numpy(coords)
    out = tent_warp_plain(f, c)
    (d_feat,) = torch.autograd.grad(out, f, torch.from_numpy(np.abs(g)))
    scale_co = (np.abs(g)[..., None] * 2 * np.abs(feat).max()).sum(-2).max()
    return out.abs().max().item(), d_feat.abs().max().item(), float(scale_co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tent_warp_matches_pallas_interpret(rng, hw, kind, dtype):
    h, w = hw
    b, c = 2, 16
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    if dtype == torch.bfloat16:
        feat = torch.from_numpy(feat).bfloat16().float().numpy()
    coords = make_coords(rng, kind, b, h, w)
    g = rng.normal(size=(b, h * w, c)).astype(np.float32)
    want = jax_result(feat, coords, g, dtype)
    got = port_result(feat, coords, g, dtype)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    assert got[2].dtype == torch.float32
    if dtype == torch.float32:
        tols = [{"atol": 1e-5, "rtol": 1e-5}] * 3
    else:
        tols = [{"atol": 2.0 ** -7 * m, "rtol": 0} for m in magnitudes(feat, coords, g)]
    for name, a, e, tol in zip(("out", "d_features", "d_coords"), got, want, tols):
        assert a.shape == e.shape, name
        np.testing.assert_allclose(a.detach().float().numpy(), e, **tol, err_msg=name)


def test_any_p_and_no_grad_path(rng):
    """P needs no padding (the TPU's 128-row tile is not the port's rule),
    and without autograd the entry is the plain version itself."""
    feat = torch.from_numpy(rng.normal(size=(2, 5, 7, 8)).astype(np.float32))
    coords = torch.from_numpy(make_coords(rng, "random", 2, 5, 7)[:, :33])
    with torch.no_grad():
        out = tent_warp(feat, coords)
    assert out.shape == (2, 33, 8)
    assert torch.equal(out, tent_warp_plain(feat, coords))


def test_bad_arguments_raise(rng):
    feat = torch.zeros(2, 5, 7, 8)
    with pytest.raises(ValueError, match="tent_warp"):
        tent_warp(feat, torch.zeros(3, 10, 2))
    with pytest.raises(TypeError, match="fp32"):
        tent_warp(feat, torch.zeros(2, 10, 2, dtype=torch.float64))


def test_counters_stay_zero_on_cpu(rng):
    for cnt in (K2_COUNTER, K3_COUNTER, K4_COUNTER):
        cnt.reset()
    feat = rng.normal(size=(1, 6, 10, 8)).astype(np.float32)
    port_result(feat, make_coords(rng, "random", 1, 6, 10),
                rng.normal(size=(1, 60, 8)).astype(np.float32), torch.float32)
    assert (K2_COUNTER.launches, K3_COUNTER.launches, K4_COUNTER.launches) == (0, 0, 0)
