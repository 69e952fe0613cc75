"""K6's launch plan and sources, checked without a GPU.

K6-weight walks the pixels line by line in segments and splits them into
ranges (split-K) whose fp32 partials a second launch sums in split order;
the ranges must cover every pixel once, in order. The sources must hold no
atomics (the gradients are the same bits from run to run), every CUDA source
must be built, and every K6 kernel must carry the prefix by which the
profile adds them up.
"""
import re
from pathlib import Path

import pytest

from dro_sfm_torch import kernels
from dro_sfm_torch.ops.gru_pass import (GRU_BM, K6W_CH, K6W_OUT, K6W_PIX, _round16,
                                        gru_row_tiles, gru_segment, k6_split_pixels,
                                        k6_weight_plan)

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
H100_SMS = 132

# (what, B, H, W, D, Cx): the shapes chip_smoke.py's GRU phase drives, and
# the stride-4 net's (48x160 maps: 32-position segments along W, 4x the
# stages of K6-weight), which its phase stride4 drives
SHAPES = [("depth", 8, 24, 80, 128, 160), ("pose", 16, 24, 80, 128, 160),
          ("B=1", 1, 24, 80, 128, 160), ("3-px line", 2, 3, 7, 32, 24),
          ("D32 Cx24", 2, 8, 16, 32, 24), ("D32 Cx20", 2, 8, 16, 32, 20),
          ("6x10", 2, 6, 10, 128, 160), ("depth stride 4", 8, 48, 160, 128, 160),
          ("pose stride 4", 16, 48, 160, 128, 160)]


def line_order(b, h, w, axis):
    """Every pixel (b H W + i W + j) once, line by line along the shift
    axis."""
    if axis == 2:
        return list(range(b * h * w))
    return [(bb * h + i) * w + j for bb in range(b) for j in range(w) for i in range(h)]


@pytest.mark.parametrize("what, b, h, w, d, cx", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("sms", [H100_SMS, 1, 1000])
def test_split_ranges_cover_every_pixel_once_in_order(what, b, h, w, d, cx, axis, sms):
    seg, n_split, per = k6_weight_plan(b, h, w, axis, _round16(d), _round16(cx), sms)
    assert seg in (8, 16, 32) and n_split >= 1 and per >= 1
    splits = k6_split_pixels(b, h, w, axis, seg, n_split, per)
    assert len(splits) == n_split and all(splits)
    assert [p for pix in splits for p in pix] == line_order(b, h, w, axis)


@pytest.mark.parametrize("s, want", [(80, 16), (24, 8), (3, 8), (10, 16), (7, 8), (64, 32),
                                     (96, 32), (16, 16), (160, 32), (48, 16)])
def test_segment_leaves_fewest_positions_empty(s, want):
    assert gru_segment(s) == want


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("what, b", [("depth", 8), ("pose", 16)])
def test_weight_grid_fills_one_wave_of_two_blocks_an_sm(what, b, axis):
    dp, cxp = 128, 160
    _, n_split, _ = k6_weight_plan(b, 24, 80, axis, dp, cxp, H100_SMS)
    tiles = -(-(dp + cxp) // K6W_CH) * (-(-2 * dp // K6W_OUT) + -(-dp // K6W_OUT))
    assert 2 * H100_SMS - tiles < tiles * n_split <= 2 * H100_SMS


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("what, b", [("depth", 8), ("pose", 16)])
def test_weight_grid_at_stride4_fills_one_wave(what, b, axis):
    """At the stride-4 maps (48x160) each split walks 4x the stages of
    24x80's, and the grid still fills one wave of two blocks an SM."""
    dp, cxp = 128, 160
    _, n_split, per = k6_weight_plan(b, 48, 160, axis, dp, cxp, H100_SMS)
    _, n_split8, per8 = k6_weight_plan(b, 24, 80, axis, dp, cxp, H100_SMS)
    tiles = -(-(dp + cxp) // K6W_CH) * (-(-2 * dp // K6W_OUT) + -(-dp // K6W_OUT))
    assert 2 * H100_SMS - tiles < tiles * n_split <= 2 * H100_SMS
    assert n_split == n_split8 and 3 * per8 <= per <= 5 * per8


@pytest.mark.parametrize("what, b, h, w, d, cx", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("axis", [2, 1])
def test_input_row_tiles_hold_every_segment(what, b, h, w, d, cx, axis):
    s = w if axis == 2 else h
    seg = gru_segment(s)
    n_segs = b * h * w // s * -(-s // seg)
    tiles = gru_row_tiles(b, h, w, axis)
    assert (tiles - 1) * (GRU_BM // seg) < n_segs <= tiles * (GRU_BM // seg)


def test_stage_holds_whole_segments():
    assert all(K6W_PIX % seg == 0 for seg in (8, 16, 32))


K6_SOURCES = [CSRC / "gru_pass_bwd.cu", CSRC / "gru_gemm.cuh"]


@pytest.mark.parametrize("path", K6_SOURCES, ids=lambda p: p.name)
def test_k6_sources_hold_no_atomics(path):
    assert not re.search(r"\batomic\w*\s*\(", path.read_text())


def test_every_cuda_source_is_built():
    assert set(CSRC.glob("*.cu")) == set(kernels.SOURCES.values())


def test_k6_kernels_carry_the_profile_prefix():
    text = (CSRC / "gru_pass_bwd.cu").read_text()
    names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", text)
    assert len(names) == 6, names
    assert all(n.startswith(("gru_pass_bwd_input", "gru_pass_bwd_weight")) for n in names)
