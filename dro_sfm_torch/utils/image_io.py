"""PNG files and the bilinear resize of the inference CLIs, on zlib and numpy.

The card's machine has neither OpenCV nor Pillow, so the port reads and
writes PNG itself:

* `read_png`: non-interlaced 8-bit gray, gray+alpha, RGB and RGBA, and
  16-bit gray (big-endian in the file), with all five row filters. The rows
  are reconstructed along anti-diagonals: a pixel depends on its left,
  upper and upper-left neighbours, which all lie on the two diagonals
  before its own, so each diagonal is one numpy step over every row at
  once (``H + W - 1`` steps) whatever mix of filters the rows use.
* `write_png`: the same colour types, each row filtered with the filter
  whose output has the least sum of absolute values (libpng's heuristic).
* `read_image_rgb`: a frame as uint8 RGB [H,W,3], as ``cv2.imread(...,
  IMREAD_COLOR)[..., ::-1]`` gives it for those PNGs.
* `resize_bilinear_u8`: ``cv2.resize(..., INTER_LINEAR)`` on uint8
  (half-pixel centres, clamped borders, no antialiasing), in float and
  rounded; OpenCV's fixed-point weights put its result within one level of
  this one.

Interlaced and palette PNGs, 16-bit colour, JPEG, BMP and video need a
decoder that the port does not have yet (ROADMAP A9) and raise.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_NOT_PORTED = "ROADMAP A9: the port decodes non-interlaced 8-bit and 16-bit gray PNG only"


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the row filters of ``raw`` [H, W, bpp] (uint8) along the
    anti-diagonals of a zero-padded copy."""
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} does not exist")
    h, w, bpp = raw.shape
    out = np.zeros(((h + 1) * (w + 1), bpp), np.int16)   # row 0, column 0: zeros
    src = np.zeros_like(out)
    src.reshape(h + 1, w + 1, bpp)[1:, 1:] = raw
    kinds = filters.astype(np.intp)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        n = r1 - r0 + 1
        first = (r0 + 1) * (w + 1) + (d - r0 + 1)
        # the diagonal steps one row down and one column left: w elements
        a = out[first - 1:first - 1 + (n - 1) * w + 1:w]
        b = out[first - w - 1:first - w - 1 + (n - 1) * w + 1:w]
        c = out[first - w - 2:first - w - 2 + (n - 1) * w + 1:w]
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where(pa <= np.minimum(pb, pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[r0:r1 + 1], (zero[:n], a, b, (a + b) >> 1, paeth))
        cur = slice(first, first + (n - 1) * w + 1, w)
        out[cur] = (src[cur] + pred) & 0xFF
    return out.reshape(h + 1, w + 1, bpp)[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file: uint8 [H,W,C] (C = 1, 2, 3 or 4 for gray,
    gray+alpha, RGB, RGBA) or, for 16-bit gray, uint16 [H,W,1]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise NotImplementedError(f"{path} is not a PNG file; other image and video "
                                  f"formats are {_NOT_PORTED}")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace or ctype not in _CHANNELS or depth not in (8, 16) \
            or (depth == 16 and ctype != 0):
        raise NotImplementedError(
            f"{path}: PNG of colour type {ctype}, bit depth {depth}, interlace "
            f"{interlace}; {_NOT_PORTED}, gray+alpha, RGB and RGBA")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {rows.size} bytes of image data, want {h * (w * bpp + 1)}")
    rows = rows.reshape(h, w * bpp + 1)
    pixels = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16)
    return pixels


def _filtered(pixels: np.ndarray) -> np.ndarray:
    """Each row with the filter of least absolute sum: [H, 1 + W*bpp]."""
    h, w, bpp = pixels.shape
    x = pixels.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    cands = cands.reshape(5, h, w * bpp).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)      # [5, H]
    best = cost.argmin(axis=0)
    out = np.empty((h, 1 + w * bpp), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cands[best, np.arange(h)]
    return out


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 [H,W] or [H,W,C] (C = 1-4) or uint16 [H,W] / [H,W,1]."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    h, w, ch = image.shape
    if image.dtype == np.uint16 and ch == 1:
        depth, pixels = 16, image.astype(">u2").view(np.uint8).reshape(h, w, 2)
    elif image.dtype == np.uint8 and ch in (1, 2, 3, 4):
        depth, pixels = 8, image
    else:
        raise ValueError(f"write_png takes uint8 with 1-4 channels or uint16 gray, "
                         f"not {image.dtype} with {ch}")
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(_filtered(np.ascontiguousarray(pixels))
                                           .tobytes()))
            + chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_image_rgb(path: str) -> np.ndarray:
    """A frame as uint8 RGB [H,W,3]: gray repeated, alpha dropped, as
    ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]`` reads an 8-bit PNG."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise NotImplementedError(f"{path}: a 16-bit PNG is not a colour frame")
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _axis_taps(n_in: int, n_out: int):
    """Source index pairs and weights of one axis, half-pixel centres,
    clamped at the borders."""
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, frac.astype(np.float32)


def resize_bilinear_u8(image: np.ndarray, shape) -> np.ndarray:
    """uint8 [H,W,C] -> uint8 [h,w,C] (``shape`` = (h, w)) by bilinear
    interpolation with half-pixel centres, rounded half up."""
    h, w = int(shape[0]), int(shape[1])
    if image.shape[:2] == (h, w):
        return image
    y0, y1, fy = _axis_taps(image.shape[0], h)
    x0, x1, fx = _axis_taps(image.shape[1], w)
    img = image.astype(np.float32)
    top = img[y0] * (1 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    out = top[:, x0] * (1 - fx)[None, :, None] + top[:, x1] * fx[None, :, None]
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
