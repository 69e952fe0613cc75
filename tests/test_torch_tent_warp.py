"""The warp-cost op (kernel K1's plain version) against the JAX package.

On the CPU `warp_diff` runs its plain PyTorch version; the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``. Here the
plain version is held in fp32 against the Pallas kernel in interpret mode
(`tent_warp_diff`, `pallas_warp_cost`, which contract at HIGHEST precision)
and against the JAX gather path. Tolerance 1e-5: both sides sum four fp32
products, the Pallas side as a matmul over the tent-weight strip.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import depth_pose_net as jdpn
from dro_sfm_tpu.ops.pallas.tent_warp import pallas_warp_cost, tent_warp_diff
from dro_sfm_torch.models import depth_pose_net as tdpn
from dro_sfm_torch.ops.tent_warp import (
    K1_COUNTER,
    warp_cost,
    warp_diff,
    warp_diff_plain,
)

torch.set_num_threads(2)
TOL = {"atol": 1e-5, "rtol": 1e-5}
SHAPES = [(8, 16), (6, 10), (12, 16)]     # one tile, padded, two strips


def make_coords(rng, kind, bn, h, w):
    """[bn, h*w, 2] fp32 coordinates of one kind."""
    p = h * w
    if kind == "random":
        c = rng.uniform([-2.0, -2.0], [w + 1.0, h + 1.0], size=(bn, p, 2))
    elif kind == "integer":
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([gx, gy], -1).reshape(p, 2)
        shift = rng.integers(-2, 3, size=(bn, 1, 2))
        c = grid[None] + shift
    elif kind == "out_of_view":
        c = rng.uniform(-1.0, 1.0, size=(bn, p, 2)) + np.where(
            rng.uniform(size=(bn, p, 1)) < 0.5, -10.0, [w + 5.0, h + 5.0])
    elif kind == "far":
        c = rng.choice([-1e8, -1e4, 1e4, 1e8, 0.5 * w], size=(bn, p, 2))
    else:
        raise ValueError(kind)
    return c.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "integer", "out_of_view", "far"])
@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_warp_diff_matches_pallas_interpret(rng, hw, kind):
    b, n, c = 2, 2, 16
    h, w = hw
    f1 = rng.normal(size=(b, h * w, c)).astype(np.float32)
    feat = rng.normal(size=(b * n, h, w, c)).astype(np.float32)
    coords = make_coords(rng, kind, b * n, h, w)
    out = warp_diff(torch.from_numpy(f1), torch.from_numpy(feat),
                    torch.from_numpy(coords), n)
    # The Pallas kernel wants P padded to its 128-row tile, with zero f1 and
    # coordinates at -10 (out of view), as its wrapper pads them.
    p = h * w
    p_pad = -(-p // 128) * 128
    f1_pad = np.pad(f1, ((0, 0), (0, p_pad - p), (0, 0)))
    co_pad = np.pad(coords, ((0, 0), (0, p_pad - p), (0, 0)),
                    constant_values=-10.0)
    ref = tent_warp_diff(jnp.asarray(f1_pad), jnp.asarray(feat),
                         jnp.asarray(co_pad), n, True)[:, :p]
    assert out.shape == (b * n, p, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if kind in ("out_of_view", "far"):
        # wholly outside the map: the cost is f1 - 0
        outside = (np.abs(coords) > 1e3).any(-1) | (coords < -3).any(-1)
        np.testing.assert_array_equal(
            out.numpy()[outside], np.repeat(f1, n, axis=0)[outside])


@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_warp_cost_matches_pallas_and_gather(rng, hw):
    """`warp_cost` (squared) against `pallas_warp_cost` in interpret mode,
    and the port's geometric `warp_cost` against the JAX gather path."""
    b, n, c = 1, 2, 8
    h, w = hw
    fmap1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    fref = rng.normal(size=(b, n, h, w, c)).astype(np.float32)
    coords = make_coords(rng, "random", b * n, h, w).reshape(b, n, h, w, 2)
    ours = warp_cost(torch.from_numpy(fmap1), torch.from_numpy(fref),
                     torch.from_numpy(coords))
    ref = pallas_warp_cost(jnp.asarray(fmap1), jnp.asarray(fref),
                           jnp.asarray(coords), interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    for impl in ("gather", "matmul"):
        np.testing.assert_array_equal(
            warp_cost(torch.from_numpy(fmap1), torch.from_numpy(fref),
                      torch.from_numpy(coords), impl=impl).numpy(), ours.numpy())

    depth = rng.uniform(2, 5, size=(b, h, w, 1)).astype(np.float32)
    poses = (rng.normal(size=(b, n, 6)) * 0.02).astype(np.float32)
    K = np.array([[[8.0, 0, 4.5], [0, 8.0, 2.5], [0, 0, 1.0]]], np.float32)
    args = (fmap1, fref, depth, poses, K)
    expected = jdpn.warp_cost(*map(jnp.asarray, args), impl="gather")
    got = tdpn.warp_cost(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               atol=1e-4, rtol=1e-4)   # squares of O(3) values


def test_plain_bf16_rounds_once(rng):
    """In bf16 the plain version samples and subtracts in fp32 and rounds
    once, which is what the kernel does: it equals the fp32 result rounded."""
    b, n, h, w, c = 1, 2, 6, 10, 16
    f1 = torch.from_numpy(rng.normal(size=(b, h * w, c)).astype(np.float32))
    feat = torch.from_numpy(rng.normal(size=(b * n, h, w, c)).astype(np.float32))
    coords = torch.from_numpy(make_coords(rng, "random", b * n, h, w))
    f1, feat = f1.bfloat16(), feat.bfloat16()
    out = warp_diff(f1, feat, coords, n)
    assert out.dtype == torch.bfloat16
    expected = warp_diff_plain(f1.float(), feat.float(), coords, n).bfloat16()
    assert torch.equal(out, expected)


def test_cpu_path_counts_no_launch(rng):
    before = K1_COUNTER.launches
    f1 = torch.zeros(1, 60, 8)
    warp_diff(f1, torch.zeros(2, 6, 10, 8), torch.zeros(2, 60, 2), 2)
    assert K1_COUNTER.launches == before


@pytest.mark.parametrize("case", ["shape", "dtype", "coords_dtype", "views"])
def test_warp_diff_rejects_bad_inputs(case):
    f1, feat, co, n = (torch.zeros(1, 60, 8), torch.zeros(2, 6, 10, 8),
                       torch.zeros(2, 60, 2), 2)
    if case == "shape":
        feat = torch.zeros(2, 6, 10, 4)
    elif case == "dtype":
        feat = feat.bfloat16()
    elif case == "coords_dtype":
        co = co.double()
    else:
        n = 3
    with pytest.raises((ValueError, TypeError)):
        warp_diff(f1, feat, co, n)


def test_import_builds_nothing(tmp_path):
    """Importing the port (every module) neither runs nor needs nvcc."""
    code = (
        "import os, sys, pkgutil, importlib\n"
        "import dro_sfm_torch\n"
        "for m in pkgutil.walk_packages(dro_sfm_torch.__path__, 'dro_sfm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from dro_sfm_torch import kernels\n"
        "assert not kernels._loaded\n"
        "assert not os.listdir(os.environ['DRO_SFM_TORCH_BUILD_DIR'])\n"
    )
    env = {"PATH": str(tmp_path), "DRO_SFM_TORCH_BUILD_DIR": str(tmp_path),
           "PYTHONPATH": str(__import__("pathlib").Path(__file__).parents[1])}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
