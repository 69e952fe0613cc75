"""The rest of the port's PNG decoder against OpenCV (CPU), bit for bit.

Palette files (1, 2, 4 and 8 bits, with and without ``tRNS``), 1-bit gray,
16-bit RGB and RGBA as Pillow and OpenCV write them, and Adam7-interlaced
files (gray, RGB, RGBA, 16-bit RGB, palette; written here, since neither
package writes them, with every row filter) at sizes that leave passes
empty. ``read_png`` must equal ``cv2.imread(path, IMREAD_UNCHANGED)`` (its
channels in RGB order) and ``read_image_rgb`` ``cv2.imread(path,
IMREAD_COLOR)[..., ::-1]``. Tolerance: none.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_torch.utils.image_io import read_image_rgb, read_png

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def filtered_row(row, prev, bpp, kind):
    x = row.astype(np.int16)
    a = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    b = prev.astype(np.int16)
    c = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [0 * x, a, b, (a + b) >> 1, paeth][kind]
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def write_adam7(path, samples, ctype, depth=8, palette=None):
    """An interlaced PNG of ``samples`` [H,W,C] (uint8 or uint16), each
    pass's rows filtered with the five filters in turn."""
    h, w = samples.shape[:2]
    raw, kind = b"", 0
    for y0, x0, dy, dx in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = (sub.astype(">u2").view(np.uint8) if depth == 16 else sub).reshape(len(sub), -1)
        bpp = max(1, sub.shape[2] * depth // 8)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            raw += filtered_row(r, prev, bpp, kind % 5)
            prev, kind = r, kind + 1
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    open(path, "wb").write(data)


def opencv(path):
    u = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if u.ndim == 2:
        u = u[..., None]
    if u.shape[-1] >= 3:
        u = np.concatenate([u[..., 2::-1], u[..., 3:]], axis=-1)
    return u, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]


def check(path):
    unchanged, color = opencv(path)
    got = read_png(path)
    assert got.dtype == unchanged.dtype and np.array_equal(got, unchanged)
    assert np.array_equal(read_image_rgb(path), color)
    return got


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).integers(0, 256, (23, 37, 3), np.uint8)


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
@pytest.mark.parametrize("transparency", [None, 1])
def test_palette(tmp_path, image, colors, transparency):
    path = str(tmp_path / "p.png")
    im = Image.fromarray(image).quantize(colors)
    if transparency is None:
        im.save(path)
    else:
        im.save(path, transparency=transparency)
    got = check(path)
    assert got.shape[-1] == (3 if transparency is None else 4)


def test_one_bit_gray(tmp_path, image):
    path = str(tmp_path / "g1.png")
    Image.fromarray(image[..., 0] > 128).save(path)
    assert set(np.unique(check(path))) <= {0, 255}


@pytest.mark.parametrize("channels", [3, 4])
def test_sixteen_bit_colour(tmp_path, channels):
    path = str(tmp_path / "c16.png")
    x = np.random.default_rng(channels).integers(0, 65536, (19, 27, channels)).astype(np.uint16)
    cv2.imwrite(path, x)
    assert check(path).dtype == np.uint16


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (9, 9), (23, 37)])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "rgb16", "palette"])
def test_adam7(tmp_path, size, kind):
    rng = np.random.default_rng(sum(size))
    path = str(tmp_path / "i.png")
    if kind == "rgb16":
        samples = rng.integers(0, 65536, (*size, 3)).astype(np.uint16)
        write_adam7(path, samples, 2, 16)
    elif kind == "palette":
        palette = rng.integers(0, 256, (7, 3), np.uint8)
        samples = rng.integers(0, 7, (*size, 1), np.uint8)
        write_adam7(path, samples, 3, 8, palette)
        samples = palette[samples[..., 0]]
    else:
        ch = {"gray": 1, "rgb": 3, "rgba": 4}[kind]
        samples = rng.integers(0, 256, (*size, ch), np.uint8)
        write_adam7(path, samples, {1: 0, 3: 2, 4: 6}[ch])
    got = check(path)
    assert np.array_equal(got, samples)
