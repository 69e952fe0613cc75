"""K5's launch plan and the GRU sources, checked without a GPU.

K5 runs as two launches on the tile engine of K6-input (`csrc/gru_conv.cuh`):
grids of row tiles of whole line segments. The plan must reach every pixel
exactly once, the shared header must replace the old one, K5's kernels must
carry their own name prefix (the profile sums kernels by prefix), and no GRU
source, nor K2's, may add floats with atomics.
"""
import re
from pathlib import Path

import pytest
import torch

from dro_sfm_torch import kernels
from dro_sfm_torch.ops.gru_pass import GRU_BM, _Prepared, gru_row_tiles, gru_segment
from tests.test_torch_gru_k6_plan import SHAPES

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
# K6's sources (gru_pass_bwd.cu, gru_gemm.cuh) are checked in test_torch_gru_k6_plan.py
K5_SOURCES = [CSRC / "gru_pass_fwd.cu", CSRC / "gru_conv.cuh"]


def kernel_names(path):
    return re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                      path.read_text())


def tile_pixels(b, h, w, axis, tiles):
    """The pixel of every row of every row tile, as `Geo::tile_pixel` maps
    them (b H W + i W + j; None for a row past a line's end or the last
    segment)."""
    s, ss = (w, 1) if axis == 2 else (h, w)
    seg = gru_segment(s)
    spl = -(-s // seg)
    n_segs = b * h * w // s * spl
    out = []
    for tile in range(tiles):
        for row in range(GRU_BM):
            g, u = tile * (GRU_BM // seg) + row // seg, row % seg
            line, pos = g // spl, g % spl * seg + u
            out.append(None if g >= n_segs or pos >= s
                       else line // ss * s * ss + line % ss + pos * ss)
    return out


@pytest.mark.parametrize("what, b, h, w, d, cx", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("axis", [2, 1])
def test_k5_row_tiles_reach_every_pixel_once(what, b, h, w, d, cx, axis):
    pixels = [p for p in tile_pixels(b, h, w, axis, gru_row_tiles(b, h, w, axis))
              if p is not None]
    assert sorted(pixels) == list(range(b * h * w))


def test_old_header_is_gone_and_not_included():
    assert not (CSRC / "gru_pass_common.cuh").exists()
    for path in CSRC.iterdir():
        assert "gru_pass_common" not in path.read_text(), path.name


def test_k5_kernels_carry_their_own_prefix():
    names = kernel_names(CSRC / "gru_pass_fwd.cu")
    assert sorted(names) == ["gru_pass_fwd_q", "gru_pass_fwd_zr"]
    assert not any(n.startswith("gru_pass_bwd") for n in names)


def test_k5_holds_no_window_or_wmma_code():
    text = (CSRC / "gru_pass_fwd.cu").read_text() + (CSRC / "gru_conv.cuh").read_text()
    for word in ("wmma", "<mma.h>", "Windows", "copy_row", "conv_block", "kSmemBudget"):
        assert word not in text, word


@pytest.mark.parametrize("path", K5_SOURCES, ids=lambda p: p.name)
def test_k5_sources_hold_no_atomics(path):
    assert not re.search(r"\batomic\w*\s*\(", path.read_text())


def test_k2_adds_no_floats_with_atomics():
    text = (CSRC / "tent_warp_bwd.cu").read_text()
    calls = re.findall(r"\batomic\w*\s*\(([^;]*)\);", text)
    assert calls, "K2 counts its cells with integer atomics"
    for args in calls:
        assert re.fullmatch(r".*,\s*-?\d+\s*", args) and "float" not in args, args
    assert "scatter_add" not in text


@pytest.mark.parametrize("d, cx, dtype, padded", [
    (32, 20, torch.bfloat16, True), (32, 24, torch.bfloat16, False),
    (32, 20, torch.float32, False), (30, 24, torch.float32, True)])
def test_chunked_operands_pad_to_whole_16_byte_chunks(d, cx, dtype, padded):
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(2, 3, 5, d, generator=gen).to(dtype)
    x = torch.randn(2, 3, 5, cx, generator=gen).to(dtype)
    g = torch.randn(2, 3, 5, d, generator=gen).to(dtype)
    c1 = d + cx
    p = _Prepared(h, x, torch.zeros(5, c1, 2 * d), torch.zeros(2 * d), torch.zeros(5, c1, d),
                  torch.zeros(d))
    hk, xk, gk, dk, cxk = p.chunked(g)
    assert (dk != d or cxk != cx) == padded
    assert (dk * h.element_size()) % 16 == 0 and (cxk * h.element_size()) % 16 == 0
    for got, want in ((hk, h), (xk, x), (gk, g)):
        assert torch.equal(got[..., :want.shape[-1]], want)
        assert not got[..., want.shape[-1]:].any()
