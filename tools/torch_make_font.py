#!/usr/bin/env python3
"""Write the glyph atlas of the port's text drawing from OpenCV.

    python3 tools/torch_make_font.py      # needs OpenCV

OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` with a built-in outline font: each
glyph is an antialiased bitmap pasted at a whole pixel, the pen moving by a
whole number of pixels a character. For each text style the JAX package
uses (scale 0.45 and 0.5 at thickness 1 with ``LINE_AA``, 0.7 at thickness 2
with ``LINE_8``) this renders every printable ASCII character alone, white
on black, and keeps its bitmap (the alpha), its offset from the text origin
and its advance (``cv2.getTextSize`` of the character less one pixel), and
the style's text height; it then draws random strings with the atlas and
checks them against ``cv2.putText`` (every pixel within one level). The
atlas goes to ``dro_sfm_torch/assets/font_simplex.npz``
(`dro_sfm_torch.visualization.draw`).
"""
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "dro_sfm_torch" / "assets" / "font_simplex.npz"
FONT = cv2.FONT_HERSHEY_SIMPLEX
STYLES = ((0.45, 1, cv2.LINE_AA), (0.5, 1, cv2.LINE_AA), (0.7, 2, cv2.LINE_8))
CHARS = [chr(c) for c in range(32, 127)]
OX, OY, CANVAS = 30, 60, (100, 120)


def style_key(scale, thickness, line_type):
    return f"{scale:g}_{thickness}_{'aa' if line_type == cv2.LINE_AA else 8}"


def atlas(scale, thickness, line_type):
    offsets, shapes, advances, alphas = [], [], [], []
    for c in CHARS:
        img = np.zeros(CANVAS, np.uint8)
        cv2.putText(img, c, (OX, OY), FONT, scale, 255, thickness, line_type)
        ys, xs = np.nonzero(img)
        if len(xs):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            assert 0 < y0 and y1 < CANVAS[0] and 0 < x0 and x1 < CANVAS[1], c
        else:
            y0 = y1 = OY
            x0 = x1 = OX
        offsets.append((x0 - OX, y0 - OY))
        shapes.append((y1 - y0, x1 - x0))
        alphas.append(img[y0:y1, x0:x1].reshape(-1))
        advances.append(cv2.getTextSize(c, FONT, scale, thickness)[0][0] - 1)
    (_, height), _ = cv2.getTextSize("H", FONT, scale, thickness)
    return {"offset": np.asarray(offsets, np.int16), "shape": np.asarray(shapes, np.int16),
            "advance": np.asarray(advances, np.int16), "height": np.int16(height),
            "alpha": np.concatenate(alphas)}


def main() -> None:
    data = {}
    for style in STYLES:
        key = style_key(*style)
        for name, arr in atlas(*style).items():
            data[f"{key}/{name}"] = arr
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **data)

    from dro_sfm_torch.visualization import draw
    draw.font_atlas.cache_clear()
    rng = np.random.default_rng(0)
    worst = 0
    for scale, thickness, line_type in STYLES:
        for _ in range(40):
            text = "".join(rng.choice(CHARS, rng.integers(1, 30)))
            bg = rng.integers(0, 256, 3).tolist()
            color = rng.integers(0, 256, 3).tolist()
            want = np.full((40, 500, 3), bg, np.uint8)
            cv2.putText(want, text, (7, 25), FONT, scale, color, thickness, line_type)
            got = np.full((40, 500, 3), bg, np.uint8)
            draw.put_text(got, text, (7, 25), scale, color, thickness,
                          "aa" if line_type == cv2.LINE_AA else 8)
            worst = max(worst, int(np.abs(got.astype(int) - want).max()))
            size = cv2.getTextSize(text, FONT, scale, thickness)
            assert draw.get_text_size(text, scale, thickness) == size, (text, size)
    assert worst <= 1, worst
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes); random strings within {worst} level "
          f"of cv2.putText, getTextSize equal")


if __name__ == "__main__":
    main()
