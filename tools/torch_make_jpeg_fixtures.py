#!/usr/bin/env python3
"""Write the image fixtures of the port's codec and dataset checks.

    python3 tools/torch_make_jpeg_fixtures.py      # needs OpenCV, Pillow, cc and libjpeg

Renders the four views of scene 0 of the port's synthetic renderer at
480x640 (``SyntheticConfig(height=480, width=640, num_planes=3,
num_context=3)``) and writes under ``dro_sfm_torch/testdata/jpeg/``:

* with OpenCV: ``view{i}.jpg`` at quality 95 and 4:2:0, ``view0_444.jpg``
  at 4:4:4, ``view1_gray.jpg`` in grayscale, and ``view1_progressive.jpg``,
  progressive with a restart marker every 4 MCUs (so that restarts fall
  inside progressive scans);
* with the system's libjpeg (``tools/torch_jpeg_arith_writer.c``, built into
  ``build/`` by `tools.torch_image_kinds.libjpeg_writer`):
  ``view2_arith.jpg``, sequential arithmetic coding with a restart marker
  every 8 MCUs, and ``view2_arith_progressive.jpg``;
* with Pillow: ``view3_cmyk.jpg`` (inverted CMYK under an Adobe marker);
* view 0 reduced to 48x64 (``cv2.INTER_AREA``) as one BMP of each kind the
  port reads beyond uncompressed 8/24/32-bit: OS/2 8-bit, 1- and 4-bit
  palettes, 16-bit 5-5-5, 5-6-5 bit fields, 32-bit ten-bit fields under a
  V5 header, 24-bit under a V4 header, RLE8 and RLE4 (palettes from
  Pillow's quantizer).

Beside them goes ``fixtures.json``: for each file the sha256 of
``cv2.imread(path, IMREAD_COLOR)[..., ::-1]`` (RGB, C order), its shape and
its view, the renderer's settings, and the versions of OpenCV, its libjpeg,
the writer's libjpeg and Pillow, so that a machine without OpenCV
(``chip_smoke.py`` phase ``datasets``) can hold the port's decoder to
OpenCV's bytes and re-render each view's depth and pose.
"""
import hashlib
import io
import json
import re
import sys
from pathlib import Path

import cv2
import numpy as np
import PIL
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402
from tools.torch_image_kinds import (  # noqa: E402
    bmp_file,
    bottom_up,
    libjpeg_version,
    libjpeg_write,
    packed_rows,
    palette_of,
    rle_encode,
)

OUT = ROOT / "dro_sfm_torch" / "testdata" / "jpeg"
RENDER = {"height": 480, "width": 640, "num_planes": 3, "num_context": 3, "seed": 0}
SCENE = 0
BMP_SHAPE = (48, 64)


def bmp_files(rgb: np.ndarray) -> dict:
    """name -> BMP bytes of ``rgb`` [48, 64, 3], one of each kind."""
    h, w = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    p555 = ((r >> 3) << 10 | (g >> 3) << 5 | b >> 3).astype("<u2")
    p565 = ((r >> 3) << 11 | (g >> 2) << 5 | b >> 3).astype("<u2")
    p1010 = (r << 22 | g << 12 | b << 2 | 3).astype("<u4")
    (i8, pal8), (i4, pal4), (i1, pal1) = (palette_of(Image.fromarray(rgb).quantize(n), n)
                                          for n in (256, 16, 2))
    as_bytes = lambda a, n: a.view(np.uint8).reshape(h, w, n)  # noqa: E731
    return {
        "view0_os2.bmp": bmp_file(w, h, 8, packed_rows(i8, 8), palette=pal8, header=12),
        "view0_pal1.bmp": bmp_file(w, h, 1, packed_rows(i1, 1), palette=pal1),
        "view0_pal4.bmp": bmp_file(w, h, 4, packed_rows(i4, 4), palette=pal4),
        "view0_rgb16.bmp": bmp_file(w, h, 16, bottom_up(as_bytes(p555, 2), 2)),
        "view0_565.bmp": bmp_file(w, h, 16, bottom_up(as_bytes(p565, 2), 2), compression=3,
                                  masks=(0xF800, 0x7E0, 0x1F)),
        "view0_bitfields32_v5.bmp": bmp_file(w, h, 32, bottom_up(as_bytes(p1010, 4), 4),
                                             compression=3, header=124,
                                             masks=(0x3FF00000, 0xFFC00, 0x3FF)),
        "view0_v4.bmp": bmp_file(w, h, 24, bottom_up(rgb[..., ::-1], 3), header=108),
        "view0_rle8.bmp": bmp_file(w, h, 8, rle_encode(i8, 8), compression=1, palette=pal8),
        "view0_rle4.bmp": bmp_file(w, h, 4, rle_encode(i4, 4), compression=2, palette=pal4),
    }


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    data = SyntheticDataset(SyntheticConfig(**RENDER))
    planes, poses = data._scene(SCENE)
    views = [(data._render(planes, pose)[0] * 255).astype(np.uint8) for pose in poses]
    q95 = [cv2.IMWRITE_JPEG_QUALITY, 95]
    s420 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]

    def opencv(img, params):
        ok, enc = cv2.imencode(".jpg", img, params)
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return enc.tobytes()

    files = {f"view{i}.jpg": (i, opencv(views[i][..., ::-1], q95 + s420))
             for i in range(len(views))}
    files["view0_444.jpg"] = (0, opencv(views[0][..., ::-1], q95 + [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]))
    files["view1_gray.jpg"] = (1, opencv(cv2.cvtColor(views[1], cv2.COLOR_RGB2GRAY), q95))
    files["view1_progressive.jpg"] = (1, opencv(views[1][..., ::-1], q95 + s420 + [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 4]))
    files["view2_arith.jpg"] = (2, libjpeg_write(views[2], "-arith", "-quality", "95",
                                                 "-restart", "8"))
    files["view2_arith_progressive.jpg"] = (2, libjpeg_write(views[2], "-arith", "-progressive",
                                                             "-quality", "95"))
    buf = io.BytesIO()
    Image.fromarray(views[3]).convert("CMYK").save(buf, "JPEG", quality=95)
    files["view3_cmyk.jpg"] = (3, buf.getvalue())
    small = cv2.resize(views[0], BMP_SHAPE[::-1], interpolation=cv2.INTER_AREA)
    files.update({name: (0, blob) for name, blob in bmp_files(small).items()})

    table = {}
    for name, (view, blob) in files.items():
        path = OUT / name
        path.write_bytes(blob)
        rgb = np.ascontiguousarray(cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
        table[name] = {"view": view, "shape": list(rgb.shape),
                       "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    build = cv2.getBuildInformation()
    found = re.search(r"JPEG:\s*(.*)", build)
    meta = {"render": RENDER, "scene": SCENE, "opencv": cv2.__version__,
            "opencv_libjpeg": found.group(1).strip() if found else "unknown",
            "writer_libjpeg": libjpeg_version(), "pillow": PIL.__version__, "files": table}
    (OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum((OUT / n).stat().st_size for n in table)
    print(f"wrote {len(table)} image files ({size / 1024:.0f} KiB) and fixtures.json to {OUT}")


if __name__ == "__main__":
    main()
