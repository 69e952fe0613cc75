"""The port's drawing primitives against OpenCV on the same canvas (CPU).

Text (`put_text`, `get_text_size`) at the styles the JAX package uses
(0.45/1 and 0.5/1 with ``LINE_AA``, 0.7/2 with ``LINE_8``): every pixel
equal to ``cv2.putText`` on random strings, colours and backgrounds, and
``cv2.getTextSize``'s box and baseline; outside printable ASCII a ``?``.
Filled circles equal ``cv2.circle(..., -1)`` bit for bit, clipped too.
Antialiased polylines (thickness 1 and 2) are drawn by distance, not by
OpenCV's filter: every pixel more than 2 px outside the line's band (the
pixels either library touches) is bit-equal, and inside it the drawn masks
reach IoU >= 0.8 and a mean absolute difference <= 32 levels (measured on
these random walks and an axis-aligned path, white on black: IoU 0.844 /
0.848 at the worst, MAD 26.4 / 15.8 at the worst, thickness 1 / 2; printed).
"""
import cv2
import numpy as np
import pytest

from dro_sfm_torch.visualization import draw

FONT = cv2.FONT_HERSHEY_SIMPLEX
STYLES = [(0.45, 1, cv2.LINE_AA, "aa"), (0.5, 1, cv2.LINE_AA, "aa"), (0.7, 2, cv2.LINE_8, 8)]
CHARS = [chr(c) for c in range(32, 127)]


@pytest.mark.parametrize("scale, thickness, cv_type, line_type", STYLES)
def test_text_equals_opencv(scale, thickness, cv_type, line_type):
    rng = np.random.default_rng(int(scale * 100))
    for _ in range(25):
        text = "".join(rng.choice(CHARS, rng.integers(1, 40)))
        bg, color = rng.integers(0, 256, 3).tolist(), rng.integers(0, 256, 3).tolist()
        org = (int(rng.integers(-20, 40)), int(rng.integers(0, 50)))
        want = np.full((48, 420, 3), bg, np.uint8)
        cv2.putText(want, text, org, FONT, scale, color, thickness, cv_type)
        got = np.full((48, 420, 3), bg, np.uint8)
        draw.put_text(got, text, org, scale, color, thickness, line_type)
        assert np.array_equal(got, want), text
        assert draw.get_text_size(text, scale, thickness) == cv2.getTextSize(
            text, FONT, scale, thickness)


def test_text_outside_ascii_and_unknown_style():
    a = np.zeros((30, 200, 3), np.uint8)
    b = a.copy()
    draw.put_text(a, "café µm", (4, 20), 0.5, (255, 255, 255))
    draw.put_text(b, "caf? ?m", (4, 20), 0.5, (255, 255, 255))
    assert np.array_equal(a, b)
    with pytest.raises(NotImplementedError, match="0.6_1_aa"):
        draw.put_text(a, "x", (0, 10), 0.6, (255, 0, 0))


def test_circle_equals_opencv():
    rng = np.random.default_rng(0)
    for _ in range(200):
        c, r = rng.integers(-10, 50, 2), int(rng.integers(0, 12))
        want = np.full((40, 40, 3), 7, np.uint8)
        cv2.circle(want, (int(c[0]), int(c[1])), r, (10, 200, 30), -1)
        got = np.full((40, 40, 3), 7, np.uint8)
        draw.circle_filled(got, c, r, (10, 200, 30))
        assert np.array_equal(got, want)


def line_bars(thickness, polys, color=(255, 255, 255), bg=0):
    ious, mads = [], []
    for p in polys:
        want = np.full((240, 320, 3), bg, np.uint8)
        cv2.polylines(want, [p], False, color[::-1], thickness, cv2.LINE_AA)
        got = np.full((240, 320, 3), bg, np.uint8)
        draw.polylines(got, p, color[::-1], thickness)
        mw, mg = (want != bg).any(-1), (got != bg).any(-1)
        band = cv2.dilate((mw | mg).astype(np.uint8), np.ones((5, 5), np.uint8)) > 0
        assert np.array_equal(got[~band], want[~band])
        ious.append((mw & mg).sum() / (mw | mg).sum())
        mads.append(np.abs(got.astype(int) - want)[mw | mg].mean())
    return min(ious), max(mads)


@pytest.mark.parametrize("thickness", [1, 2])
def test_polylines_within_bars(thickness):
    rng = np.random.default_rng(thickness)
    polys = []
    for _ in range(20):
        walk = np.cumsum(rng.normal(0, 6, (int(rng.integers(2, 40)), 2)), 0) + [160, 120]
        polys.append(np.clip(walk, 5, [314, 234]).astype(np.int32))
    polys.append(np.array([[3, 5], [300, 5], [300, 200]], np.int32))     # axis-aligned
    iou, mad = line_bars(thickness, polys)
    print(f"polylines thickness {thickness}: worst IoU {iou:.3f}, worst MAD {mad:.1f}")
    assert iou >= 0.8 and mad <= 32
    iou, mad = line_bars(thickness, polys[:5], color=(90, 160, 255), bg=24)
    assert iou >= 0.8 and mad <= 32
    with pytest.raises(NotImplementedError):
        draw.polylines(np.zeros((9, 9, 3), np.uint8), polys[0], (1, 2, 3), 3)
