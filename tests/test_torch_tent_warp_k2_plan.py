"""K2's gather order, checked without a GPU.

Kernel K2 gathers each feature gradient from its contributors in a fixed
order: the pixels bucketed by the cell of their top-left tap, ascending p in
a bucket, an output pixel taking the buckets in which it is tap 0, 1, 2, 3.
`k2_gather_order` mirrors that plan in plain PyTorch, and `k2_sum_ranges`
the split of a long list into ranges summed apart. Every in-view (pixel,
tap) must appear once, at the output it samples, in that order; summed in
that order in fp32 the gradient must match `warp_diff_bwd_feat_plain`
within `chip_smoke.k2_tolerance` (the bar the card holds K2 to), and where
no list is split, on the CPU, whose `index_add_` adds tap by tap in
ascending p, bit for bit.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import k2_tolerance
from dro_sfm_torch import kernels
from dro_sfm_torch.ops.resample import bilinear_taps
from dro_sfm_torch.ops.tent_warp import (K2_GROUPS, K2_LONG, k2_gather_order, k2_sum_ranges,
                                         warp_diff_bwd_feat_plain)

CSRC = Path(kernels.__file__).resolve().parent / "csrc"

KINDS = ["noisy grid", "integer", "outside -10", "far", "one cell"]


def make_coords(rng, kind, bn, h, w):
    """[bn, h*w, 2] fp32 coordinates of one kind."""
    p = h * w
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([gx, gy], -1).reshape(1, p, 2).astype(np.float64)
    if kind == "noisy grid":
        c = grid + 1.5 * rng.normal(size=(bn, p, 2))
    elif kind == "integer":
        c = grid + rng.integers(-2, 3, size=(bn, 1, 2))
    elif kind == "outside -10":
        c = np.full((bn, p, 2), -10.0)
    elif kind == "far":
        c = np.where(rng.uniform(size=(bn, p, 2)) < 0.5,
                     rng.choice([-1e8, 1e8], size=(bn, p, 2)), grid)
    elif kind == "one cell":
        c = np.array([w // 2, h // 2]) + rng.uniform(0.25, 0.75, size=(bn, p, 2))
    else:
        raise ValueError(kind)
    return torch.from_numpy(c.astype(np.float32))


def gather(coords, g, h, w, dtype, sign):
    """sign * W^T g summed as K2 sums it, in fp32: each range of
    `k2_sum_ranges` in `k2_gather_order`'s order, then the ranges' sums in
    order."""
    bn, _, c = g.shape
    _, _, weight, _, _ = bilinear_taps(coords, h, w)
    gf = g.float()
    out = torch.zeros(bn, h * w, c)
    for v, view in enumerate(k2_gather_order(coords, h, w)):
        for q, contributors in enumerate(view):
            sums = []
            for lo, hi in k2_sum_ranges(len(contributors)):
                acc = torch.zeros(c)
                for p, tap in contributors[lo:hi]:
                    acc = acc + sign * (weight[tap, v, p] * gf[v, p])
                sums.append(acc)
            out[v, q] = sums[0]
            for acc in sums[1:]:
                out[v, q] = out[v, q] + acc
    return out.reshape(bn, h, w, c).to(dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bn, h, w", [(2, 6, 10), (1, 5, 7)])
def test_every_in_view_tap_once_in_bucket_order(rng, kind, bn, h, w):
    coords = make_coords(rng, kind, bn, h, w)
    index, valid, _, _, _ = bilinear_taps(coords, h, w)
    order = k2_gather_order(coords, h, w)
    assert len(order) == bn
    for v, view in enumerate(order):
        assert len(view) == h * w
        seen = []
        for q, contributors in enumerate(view):
            for p, tap in contributors:
                assert valid[tap, v, p] and index[tap, v, p] == v * h * w + q
            taps = [t for _, t in contributors]
            assert taps == sorted(taps)                  # buckets in tap order
            for t in range(4):
                ps = [p for p, tap in contributors if tap == t]
                assert ps == sorted(ps)                  # ascending p in a bucket
            seen += [(p, t) for p, t in contributors]
        want = {(p, t) for t in range(4) for p in valid[t, v].nonzero().flatten().tolist()}
        assert len(seen) == len(set(seen)) and set(seen) == want
    if kind == "outside -10":
        assert not any(c for view in order for c in view)
    if kind == "one cell":
        assert sum(bool(c) for c in order[0]) == 4       # one cell: its four taps


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("c, g_dtype, dtype", [(16, torch.float32, torch.float32),
                                               (6, torch.float32, torch.float32),
                                               (16, torch.float32, torch.bfloat16),
                                               (16, torch.bfloat16, torch.bfloat16)])
def test_gather_in_order_matches_plain(rng, kind, sign, c, g_dtype, dtype):
    bn, h, w = 2, 6, 10
    coords = make_coords(rng, kind, bn, h, w)
    g = torch.from_numpy(rng.normal(size=(bn, h * w, c)).astype(np.float32)).to(g_dtype)
    got = gather(coords, g, h, w, dtype, sign)
    ref = warp_diff_bwd_feat_plain(coords, g, h, w, dtype, sign)
    assert got.dtype == ref.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= k2_tolerance(coords, g, h, w, dtype, ref)
    assert torch.equal(got, ref)


def test_one_view_one_cell_all_pixels_in_one_bucket(rng):
    h, w = 5, 7
    coords = make_coords(rng, "one cell", 1, h, w)
    order = k2_gather_order(coords, h, w)[0]
    full = [c for c in order if c]
    assert len(full) == 4 and all(len(c) == h * w for c in full)
    assert all([p for p, _ in c] == list(range(h * w)) for c in full)


def test_sum_ranges_match_the_kernel():
    bwd = (CSRC / "tent_warp_bwd.cu").read_text()
    common = (CSRC / "tent_warp_common.cuh").read_text()
    const = lambda text, name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const(bwd, "kLong") == K2_LONG
    assert "constexpr int kGroups = kBlock / kGroup;" in bwd
    assert const(common, "kBlock") // const(common, "kGroup") == K2_GROUPS


@pytest.mark.parametrize("n", [0, 1, K2_LONG, K2_LONG + 1, 90, 1920, 4 * 1920])
def test_sum_ranges_cover_a_list_once_in_order(n):
    ranges = k2_sum_ranges(n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert len(ranges) == (1 if n <= K2_LONG else K2_GROUPS)
    assert all(hi > lo for lo, hi in ranges) or n == 0


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("g_dtype, dtype", [(torch.float32, torch.float32),
                                            (torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.bfloat16)])
def test_split_long_lists_match_plain(rng, sign, g_dtype, dtype):
    bn, h, w, c = 2, 9, 10, 16
    coords = make_coords(rng, "one cell", bn, h, w)
    assert max(len(q) for q in k2_gather_order(coords, h, w)[0]) == h * w > K2_LONG
    g = torch.from_numpy(rng.normal(size=(bn, h * w, c)).astype(np.float32)).to(g_dtype)
    got = gather(coords, g, h, w, dtype, sign)
    ref = warp_diff_bwd_feat_plain(coords, g, h, w, dtype, sign)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.dtype == dtype and err <= k2_tolerance(coords, g, h, w, dtype, ref)
