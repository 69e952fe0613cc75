"""Drawing on uint8 RGB images without OpenCV: text, polylines, filled circles.

The port's counterparts of the OpenCV calls the JAX package draws with:

* `put_text` / `get_text_size`: ``cv2.putText`` and ``cv2.getTextSize`` with
  ``FONT_HERSHEY_SIMPLEX`` at the styles the package uses (scale 0.45 and
  0.5 at thickness 1 with ``LINE_AA``, 0.7 at thickness 2 with ``LINE_8``).
  OpenCV 5 draws that font from built-in outlines: each glyph an
  antialiased bitmap at a whole pixel, the pen moving a whole number of
  pixels a character. ``assets/font_simplex.npz`` holds each style's
  bitmaps, offsets, advances and text height, taken from OpenCV by
  ``tools/torch_make_font.py``; a glyph is blended as ``bg + (colour - bg)
  * alpha / 255``, rounded. The tool holds random strings on random colours
  to ``cv2.putText`` pixel for pixel. Characters outside printable ASCII
  draw as ``?``, as in OpenCV.
* `polylines`: ``cv2.polylines(..., LINE_AA)`` at thickness 1 and 2, drawn
  by the distance of each pixel centre to the nearest segment: coverage
  ``clip((HALF[t] - d) / RAMP[t], 0, 1) * PEAK[t]``, the constants fitted to
  OpenCV's lines. OpenCV's Wu-style filter is not copied: inside the line's
  band the pixels differ (the bars are in ROADMAP C), outside it none is
  touched.
* `circle_filled`: ``cv2.circle(..., thickness=-1)`` with ``LINE_8``, bit for
  bit (OpenCV's midpoint circle, filled by horizontal spans).

Colours are RGB triples; the image is drawn on in place.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

ASSETS = Path(__file__).resolve().parents[1] / "assets"
FIRST_CHAR, LAST_CHAR = 32, 126
# polylines' coverage profile by thickness: half width, ramp, peak
HALF = {1: 1.3, 2: 2.3}
RAMP = {1: 1.0, 2: 1.3}
PEAK = {1: 0.92, 2: 1.0}


def style_key(scale: float, thickness: int, line_type="aa") -> str:
    return f"{scale:g}_{thickness}_{line_type}"


@functools.lru_cache(maxsize=None)
def font_atlas(key: str) -> Dict[str, np.ndarray]:
    """One style's glyphs: ``offset`` [95,2] (x, y from the origin),
    ``shape`` [95,2], ``advance`` [95], ``height`` and the bitmaps, cut from
    ``alpha`` at ``start`` [95]."""
    with np.load(ASSETS / "font_simplex.npz") as data:
        styles = sorted({k.split("/")[0] for k in data.files})
        if key not in styles:
            raise NotImplementedError(f"text style {key}: the port draws {styles} "
                                      "(tools/torch_make_font.py)")
        atlas = {name: data[f"{key}/{name}"] for name in
                 ("offset", "shape", "advance", "height", "alpha")}
    sizes = atlas["shape"][:, 0].astype(np.int64) * atlas["shape"][:, 1]
    atlas["start"] = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return atlas


def _codes(text: str) -> np.ndarray:
    codes = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int64)
    codes[(codes < FIRST_CHAR) | (codes > LAST_CHAR)] = ord("?")
    return codes - FIRST_CHAR


def get_text_size(text: str, scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) as ``cv2.getTextSize`` gives them: the
    advances plus one pixel, the style's height, and the rows of ink below
    the origin."""
    try:
        atlas = font_atlas(style_key(scale, thickness, "aa"))
    except NotImplementedError:              # the size does not depend on the line type
        atlas = font_atlas(style_key(scale, thickness, 8))
    codes = _codes(text)
    width = int(atlas["advance"][codes].sum()) + 1
    below = atlas["offset"][codes, 1].astype(np.int64) + atlas["shape"][codes, 0]
    inked = atlas["shape"][codes, 0] > 0
    baseline = int(max(0, below[inked].max(initial=0)))
    return (width, int(atlas["height"])), baseline


def _blend(region: np.ndarray, alpha: np.ndarray, color) -> None:
    bg = region.astype(np.float64)
    col = np.asarray(color, np.float64)
    region[...] = np.floor(bg + (col - bg) * (alpha[..., None] / 255.0) + 0.5).astype(np.uint8)


def put_text(img: np.ndarray, text: str, org: Sequence[int], scale: float, color,
             thickness: int = 1, line_type="aa") -> None:
    """Draw ``text`` with its baseline's left end at ``org`` (x, y), as
    ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, line_type)`` draws it (``line_type`` "aa" or 8)."""
    atlas = font_atlas(style_key(scale, thickness, line_type))
    h, w = img.shape[:2]
    x = int(org[0])
    for code in _codes(text):
        gh, gw = (int(v) for v in atlas["shape"][code])
        if gh and gw:
            start = int(atlas["start"][code])
            alpha = atlas["alpha"][start:start + gh * gw].reshape(gh, gw)
            x0 = x + int(atlas["offset"][code, 0])
            y0 = int(org[1]) + int(atlas["offset"][code, 1])
            cx0, cy0 = max(x0, 0), max(y0, 0)
            cx1, cy1 = min(x0 + gw, w), min(y0 + gh, h)
            if cx0 < cx1 and cy0 < cy1:
                _blend(img[cy0:cy1, cx0:cx1],
                       alpha[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0], color)
        x += int(atlas["advance"][code])


def polylines(img: np.ndarray, points: np.ndarray, color, thickness: int = 1,
              closed: bool = False) -> None:
    """An antialiased polyline through ``points`` [N,2] (x, y pixel centres,
    integers), as ``cv2.polylines(img, [points], closed, color, thickness,
    LINE_AA)``; thickness 1 or 2."""
    if thickness not in HALF:
        raise NotImplementedError(f"polylines of thickness {thickness}: the port draws "
                                  f"{sorted(HALF)}")
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return
    if closed and len(pts) > 2:
        pts = np.concatenate([pts, pts[:1]])
    if len(pts) == 1:
        pts = np.concatenate([pts, pts])
    h, w = img.shape[:2]
    reach = HALF[thickness]
    x0 = int(max(np.floor(pts[:, 0].min() - reach), 0))
    x1 = int(min(np.ceil(pts[:, 0].max() + reach) + 1, w))
    y0 = int(max(np.floor(pts[:, 1].min() - reach), 0))
    y1 = int(min(np.ceil(pts[:, 1].max() + reach) + 1, h))
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    dist = np.full(xs.shape, np.inf)
    for a, b in zip(pts[:-1], pts[1:]):
        d = b - a
        n2 = float(d @ d)
        t = 0.0 if n2 == 0 else np.clip(((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / n2, 0, 1)
        dist = np.minimum(dist, np.hypot(xs - (a[0] + t * d[0]), ys - (a[1] + t * d[1])))
    alpha = np.clip((reach - dist) / RAMP[thickness], 0.0, 1.0) * PEAK[thickness] * 255.0
    touched = alpha > 0
    region = img[y0:y1, x0:x1]
    blended = region.copy()
    _blend(blended, alpha, color)
    region[touched] = blended[touched]


def circle_filled(img: np.ndarray, center: Sequence[int], radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (``LINE_8``), bit for
    bit: OpenCV's midpoint circle, each octant step filling two spans."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    col = np.asarray(color, np.uint8)

    def span(y, xa, xb):
        if 0 <= y < h:
            xa, xb = max(xa, 0), min(xb, w - 1)
            if xa <= xb:
                img[y, xa:xb + 1] = col

    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
