"""K4's launch plan (`ops/tent_warp.py:k4_plan`), checked without a GPU.

K4 cuts the output pixels into tiles of consecutive pixels and gives each
block a run of tiles; the tiles must cover every pixel once, the last one
ragged where the pixels do not fill it. The variant follows the shape and
the alignment: "direct" (16-byte stores) where C and the pointers allow
16-byte rows, "unaligned" otherwise. The plan's constants must be the
kernel's.
"""
import re
from pathlib import Path

import pytest
import torch

from dro_sfm_torch import kernels
from dro_sfm_torch.ops.tent_warp import (
    K4_BLOCKS_PER_SM,
    K4_THREADS,
    K4Plan,
    k4_plan,
    k4_quad_aligned,
)

SOURCE = Path(kernels.__file__).resolve().parent / "csrc" / "tent_warp_fwd.cu"
H100_SMS = 132
BF16, FP32 = 2, 4
ALIGNED = 1 << 20                  # a 256-byte aligned address, as torch allocates

# (what, maps, P, C): chip_smoke.py's K4 shapes and the ragged ones
SHAPES = [("B=8 warp", 16, 1920, 128), ("B=1 warp", 2, 1920, 128),
          ("P=60", 1, 60, 128), ("P=1927", 16, 1927, 128), ("C=6", 2, 60, 6),
          ("one pixel", 1, 1, 128), ("C=256", 4, 333, 256)]
# (element size, features' offset in elements from an aligned address)
LAYOUTS = [(BF16, 0), (BF16, 1), (FP32, 0)]


def k4_tiles(plan: K4Plan, n_pix: int):
    """The pixel ranges [start, stop) each block of ``plan`` gathers, in the
    order it walks them: the loop of `tent_warp_fwd_kernel`."""
    out = []
    for blk in range(plan.grid):
        tiles = range(blk * plan.tiles_per_block,
                      min((blk + 1) * plan.tiles_per_block, plan.n_tiles))
        out.append([(t * plan.tile_pix, min((t + 1) * plan.tile_pix, n_pix)) for t in tiles])
    return out


@pytest.mark.parametrize("what, bn, p, c", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("sms", [H100_SMS, 1, 1000])
@pytest.mark.parametrize("element, off", LAYOUTS, ids=["bf16", "bf16 off by one", "fp32"])
def test_tiles_cover_every_pixel_once(what, bn, p, c, sms, element, off):
    n_pix = bn * p
    plan = k4_plan(n_pix, c, element, ALIGNED + off * element, ALIGNED, sms)
    assert 1 <= plan.tile_pix <= K4_THREADS
    assert plan.n_tiles == -(-n_pix // plan.tile_pix)
    assert plan.grid <= max(1, -(-plan.n_tiles // plan.tiles_per_block))
    tiles = k4_tiles(plan, n_pix)
    assert len(tiles) == plan.grid and all(tiles)
    ranges = [r for blk in tiles for r in blk]
    assert [q for a, b in ranges for q in range(a, b)] == list(range(n_pix))
    assert all(b - a == plan.tile_pix for a, b in ranges[:-1])
    assert ranges[-1][1] - ranges[-1][0] == n_pix - (plan.n_tiles - 1) * plan.tile_pix


@pytest.mark.parametrize("bn, p", [(1, 60), (16, 1927)])
def test_ragged_last_tile(bn, p):
    plan = k4_plan(bn * p, 128, BF16, ALIGNED, ALIGNED, H100_SMS)
    last = k4_tiles(plan, bn * p)[-1][-1]
    assert 0 < last[1] - last[0] < plan.tile_pix


@pytest.mark.parametrize("sms", [H100_SMS, 1, 7])
def test_grid_is_a_few_blocks_an_sm(sms):
    plan = k4_plan(16 * 1920, 128, BF16, ALIGNED, ALIGNED, sms)
    assert plan.grid <= K4_BLOCKS_PER_SM * sms
    assert plan.grid * plan.tiles_per_block >= plan.n_tiles
    assert (plan.grid - 1) * plan.tiles_per_block < plan.n_tiles


@pytest.mark.parametrize("element, off", [(BF16, 0), (FP32, 0), (BF16, 8), (FP32, 16)])
def test_aligned_rows_take_direct(element, off):
    assert k4_plan(16 * 1920, 128, element, ALIGNED + off, ALIGNED, H100_SMS).variant == "direct"


@pytest.mark.parametrize("n_pix, want", [(16 * 1920, 64), (16 * 1927, 64), (2 * 1920, 8),
                                         (60, 8), (528 * 64, 64), (528 * 64 + 1, 72),
                                         (64 * 1920, 240), (10 ** 7, 256)])
def test_tile_fills_one_wave_of_blocks(n_pix, want):
    plan = k4_plan(n_pix, 128, BF16, ALIGNED, ALIGNED, H100_SMS)
    assert plan.tile_pix == want and want % 8 == 0
    if want < K4_THREADS:
        assert plan.tiles_per_block == 1 and plan.grid <= K4_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("element", [BF16, FP32])
@pytest.mark.parametrize("c, feat_off, out_off", [(6, 0, 0), (130, 0, 0), (128, 1, 0),
                                                  (128, 0, 4)],
                         ids=["C=6", "C=130", "features off by one", "out off by 4 bytes"])
def test_unaligned_shapes_take_unaligned(element, c, feat_off, out_off):
    feat = ALIGNED + feat_off * element
    assert not k4_quad_aligned(c, element, feat, ALIGNED + out_off)
    assert k4_plan(2 * 60, c, element, feat, ALIGNED + out_off, H100_SMS).variant == "unaligned"


def test_misaligned_view_picks_unaligned():
    """A bf16 features tensor one element past an aligned address, as
    chip_smoke.py's "odd offset" case builds it, plans the unaligned variant;
    a contiguous copy of it the direct one."""
    buf = torch.zeros(2 * 6 * 10 * 128 + 1, dtype=torch.bfloat16)
    feat = buf[1:].view(2, 6, 10, 128)
    assert feat.data_ptr() % 16 == 2
    plan = k4_plan(2 * 60, 128, feat.element_size(), feat.data_ptr(), ALIGNED, H100_SMS)
    assert plan.variant == "unaligned"
    copy = feat.clone()
    assert k4_plan(2 * 60, 128, copy.element_size(), copy.data_ptr(), ALIGNED,
                   H100_SMS).variant == "direct"


def test_plan_constants_are_the_kernels():
    text = SOURCE.read_text()
    assert re.search(rf"constexpr int kThreads = {K4_THREADS};", text)
    assert re.search(r"__shared__ PixTaps taps\[kThreads\];", text)
    assert re.search(r"struct __align__\(16\) PixTaps \{\s*int row\[4\];\s*float wt\[4\];", text)
