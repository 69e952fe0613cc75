"""Image files and the uint8 resizes, on zlib, numpy and the host codec.

The card's machine has no OpenCV, Pillow or imageio, so the port reads and
writes images itself:

* `read_png` (`decode_png` of the bytes): gray, gray+alpha, RGB and RGBA at
  8 and 16 bits (big-endian in the file), gray at 1, 2 and 4 bits (scaled to
  0-255, as libpng's ``expand_gray_1_2_4_to_8``), and palette files at 1-8
  bits (expanded to RGB, or RGBA when a ``tRNS`` chunk gives the entries
  alpha), non-interlaced or Adam7-interlaced (each of the seven passes
  unfiltered on its own and scattered to its pixels). zlib inflates; the
  five row filters are undone by ``png_unfilter`` of the host codec
  (``csrc/image_codec.cpp``, `dro_sfm_torch.hostlib`). `_unfilter` is its
  plain numpy version: it reconstructs the rows along anti-diagonals (a
  pixel depends on its left, upper and upper-left neighbours, which all lie
  on the two diagonals before its own), one numpy step a diagonal.
* `write_png`: the same colour types, each row filtered with the filter
  whose output has the least sum of absolute values (libpng's heuristic).
* `decode_jpeg`: JPEG through the host codec, bit-equal to
  ``cv2.imread(..., IMREAD_COLOR)`` (libjpeg-turbo's islow IDCT, fancy
  upsampling and colour tables): baseline, extended sequential and
  progressive, Huffman- or arithmetic-coded, 1, 3 or 4 components (CMYK
  and YCCK through OpenCV's CMYK -> BGR), with the EXIF orientation applied
  as OpenCV applies it. Lossless, 12-bit and hierarchical files, which
  OpenCV's IMREAD_COLOR does not decode either, and a progressive file that
  libjpeg would decode with block smoothing, raise `NotImplementedError`;
  truncated or corrupt ones raise `ValueError` (libjpeg would warn and
  fill in).
* `decode_bmp`: BMP as OpenCV 5.0.0 reads it: OS/2 and Windows headers
  (40 bytes to V5), bottom-up and top-down, 1-, 4- and 8-bit palettes,
  16-bit 5-5-5 and 5-6-5, 24- and 32-bit (bit fields of a V3-V5 header
  applied), in numpy; RLE8 and RLE4 unpacked by ``bmp_rle`` of the host
  codec. What OpenCV refuses raises `NotImplementedError`.
* `read_image_rgb`: a frame as uint8 RGB [H,W,3], as ``cv2.imread(path,
  IMREAD_COLOR)[..., ::-1]`` gives it (16-bit samples keep their high
  byte); the format is chosen by the file's first bytes, as OpenCV chooses
  it, not by its name.
* `resize_bilinear_u8`: ``cv2.resize(..., INTER_LINEAR)`` on uint8, bit for
  bit: 11-bit fixed-point weights from float32 source coordinates (half-pixel
  centres), an exact integer horizontal pass, and OpenCV's vector vertical
  pass (each row's value shifted right by 4, multiplied by its weight,
  shifted right by 16, the two summed and rounded by 2 bits); a row above
  or below the image takes the edge row with its own weight. An exact 2x
  reduction, which OpenCV sends to ``INTER_AREA``, gives the same numbers
  on this path.
* `resize_nearest`: ``cv2.resize(..., INTER_NEAREST)``: source index
  ``min(floor(dst * (1 / (out / in))), in - 1)`` in double.

* `encode_jpeg`: baseline JPEG as ``cv2.imencode(".jpg", bgr,
  [IMWRITE_JPEG_QUALITY, q])`` writes it, through the host codec.

Video files are written (MJPEG AVI) and read (MPEG-4 Part 2 and H.264
Constrained Baseline in MP4, MOV or AVI, and MJPEG AVI) by
`dro_sfm_torch.utils.video_io`; the other codecs are not decoded (ROADMAP C).
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ERR_LEN = 512


@functools.lru_cache(maxsize=None)
def _codec() -> ctypes.CDLL:
    """The host codec, built at first use, its entry points typed."""
    from dro_sfm_torch import hostlib
    lib = ctypes.CDLL(str(hostlib.build("image_codec")))
    buf, size, err = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
    out, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.jpeg_info.argtypes = [buf, size, i32p, i32p, i32p, err, size]
    lib.jpeg_decode.argtypes = [buf, size, out, size, err, size]
    lib.png_unfilter.argtypes = [out, ctypes.c_int, ctypes.c_int, ctypes.c_int, out, err, size]
    lib.jpeg_encode.argtypes = [out, ctypes.c_int, ctypes.c_int, ctypes.c_int, out, size,
                                ctypes.POINTER(ctypes.c_size_t), err, size]
    lib.gif_lzw.argtypes = [out, size, ctypes.c_int, out, size, ctypes.POINTER(ctypes.c_size_t),
                            err, size]
    lib.bmp_rle.argtypes = [buf, size, ctypes.c_int, ctypes.c_int, ctypes.c_int, out, err, size]
    for fn in (lib.jpeg_info, lib.jpeg_decode, lib.png_unfilter, lib.jpeg_encode, lib.gif_lzw,
               lib.bmp_rle):
        fn.restype = ctypes.c_int
    return lib


def _check(code: int, err, what: str) -> None:
    if code == 0:
        return
    msg = f"{what}: {err.value.decode(errors='replace')}"
    raise NotImplementedError(msg) if code == -2 else ValueError(msg)


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


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of ``rows`` [H, 1 + W*bpp] (uint8, each row's
    filter byte first) in the host codec: [H, W*bpp]."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h, n = rows.shape
    if not 1 <= bpp <= 8:
        raise ValueError(f"PNG pixels of {bpp} bytes")
    out = np.empty((h, n - 1), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_codec().png_unfilter(rows.ctypes.data, h, n - 1, bpp, out.ctypes.data, err,
                                 _ERR_LEN), err, "PNG")
    return out


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Plain version of `png_unfilter`: undo the row filters of ``raw``
    [H, W, bpp] (uint8) along the anti-diagonals of a zero-padded copy."""
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
    """The samples of a PNG file, [H,W,C] (C = 1, 2, 3 or 4 for gray,
    gray+alpha, RGB, RGBA; a palette file gives RGB, or RGBA with
    ``tRNS``): uint8, or uint16 for 16-bit files."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG") -> np.ndarray:
    """`read_png` of the file's bytes."""
    if not data.startswith(PNG_SIGNATURE):
        raise NotImplementedError(f"{path} is not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1:
        raise ValueError(f"{path}: PNG of colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} does not exist")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = 1 if ctype == 3 else _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        rowbytes = -(-pw * ch * depth // 8)
        n = ph * (rowbytes + 1)
        if pos + n > raw.size:
            raise ValueError(f"{path}: {raw.size} bytes of image data, too few for its size")
        rows = png_unfilter(raw[pos:pos + n].reshape(ph, rowbytes + 1), max(1, ch * depth // 8))
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth, ctype)
        pos += n
    if pos != raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, want {pos}")
    if ctype != 3:
        return out
    index = out[..., 0]
    if index.max(initial=0) >= len(palette):
        raise ValueError(f"{path}: palette index {int(index.max())} past its "
                         f"{len(palette)} entries")
    if trns is None:
        return palette[index]
    alpha = np.full(len(palette), 255, np.uint8)
    alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
    return np.concatenate([palette, alpha[:, None]], axis=1)[index]


def _samples(rows: np.ndarray, w: int, ch: int, depth: int, ctype: int) -> np.ndarray:
    """The samples [h, w, ch] of unfiltered rows [h, rowbytes]: 16-bit ones
    from big-endian pairs, sub-byte ones unpacked (most significant bits
    first) and, for gray, scaled to 0-255."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(len(rows), w, ch)
    if depth == 8:
        return rows.reshape(len(rows), w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(len(rows), -1, depth)
    vals = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    vals = vals[:, :w, None]
    return vals * np.uint8(255 // (2 ** depth - 1)) if ctype == 0 else vals


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


# cv2's EXIF orientations: 2-4 flip, 5-8 transpose and then flip
# (horizontally 1, both -1, vertically 0).
_FLIP = {2: 1, 3: -1, 4: 0, 6: 1, 7: -1, 8: 0}


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip = _FLIP.get(orientation)
    if flip is not None:
        img = img[::-1] if flip == 0 else img[:, ::-1] if flip == 1 else img[::-1, ::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, what: str = "JPEG") -> np.ndarray:
    """uint8 RGB [H,W,3] of a JPEG stream, its EXIF orientation applied."""
    lib = _codec()
    h, w, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(orientation), err, _ERR_LEN), err, what)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err, _ERR_LEN),
           err, what)
    return _orient(out, orientation.value)


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG of uint8 RGB [H,W,3] at ``quality`` (1-100), the bytes
    of ``cv2.imencode(".jpg", image[..., ::-1], [IMWRITE_JPEG_QUALITY,
    quality])``."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes uint8 RGB [H,W,3], not {image.dtype} "
                         f"{image.shape}")
    h, w, _ = image.shape
    lib = _codec()
    err = ctypes.create_string_buffer(_ERR_LEN)
    written = ctypes.c_size_t()
    cap = h * w * 3 // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        code = lib.jpeg_encode(image.ctypes.data, h, w, int(quality), out.ctypes.data, cap,
                               ctypes.byref(written), err, _ERR_LEN)
        if code != -3:
            break
        cap = written.value
    _check(code, err, "JPEG encode")
    return out[:written.value].tobytes()


# BI_BITFIELDS masks (red, green, blue) that OpenCV takes for 16-bit pixels
_MASKS_16 = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}
# (bits, compression) of a Windows header that OpenCV reads: BI_RGB 0,
# BI_RLE8 1, BI_RLE4 2, BI_BITFIELDS 3
_BMP_KINDS = {(1, 0), (4, 0), (8, 0), (24, 0), (32, 0), (16, 0), (16, 3), (32, 3), (4, 2),
              (8, 1)}


def bmp_rle(pixels: bytes, bits: int, width: int, height: int, what: str = "BMP") -> np.ndarray:
    """Palette indices [height, width] (uint8, rows in the stream's order) of
    RLE8 (``bits`` 8) or RLE4 (4) pixel data, unpacked in the host codec as
    OpenCV unpacks it: the pixels an escape skips take index 0."""
    out = np.empty((height, width), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_codec().bmp_rle(pixels, len(pixels), bits, width, height, out.ctypes.data, err,
                            _ERR_LEN), err, what)
    return out


def decode_bmp(data: bytes, what: str = "BMP") -> np.ndarray:
    """uint8 RGB [H,W,3] of a BMP file, as OpenCV's ``grfmt_bmp.cpp`` reads
    it with ``IMREAD_COLOR``:

    * a Windows info header of 36 bytes or more (40, V4's 108, V5's 124),
      bottom-up or top-down: 1-, 4- and 8-bit palettes (``biClrUsed``
      entries, or all; indices past them read black), 16-bit 5-5-5, 24-bit,
      32-bit (the fourth byte dropped); ``BI_BITFIELDS`` at 16 bits with the
      5-5-5 or 5-6-5 masks, which are read after the header, as OpenCV reads
      them whatever the header's size; at 32 bits with the masks of a header
      of 56 bytes or more (V3, V4, V5) applied where none is zero
      (`_bit_fields`), and otherwise ignored; RLE8 and RLE4 (`bmp_rle`);
    * the OS/2 core header (12 bytes: 16-bit sizes, 3-byte palette
      entries, all ``1 << bits`` of them): 1-, 4-, 8-, 24- and 32-bit.

    A 5-bit channel is shifted to the top of its byte (its low bits zero),
    as OpenCV converts it. What OpenCV refuses raises `NotImplementedError`;
    a truncated or broken file `ValueError`."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ValueError(f"{what}: not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if len(data) < 14 + hsize:
        raise ValueError(f"{what}: truncated BMP header")
    if hsize >= 36:
        w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        ncolors = struct.unpack_from("<I", data, 46)[0]
        if (bits, compression) not in _BMP_KINDS:
            raise NotImplementedError(f"{what}: {bits}-bit BMP with compression {compression} "
                                      f"(OpenCV does not read it either)")
        entry, top_down, h = 4, h < 0, abs(h)
    elif hsize == 12:                                         # OS/2 core header
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, ncolors, entry, top_down = 0, 1 << bits, 3, False
        if bits not in (1, 4, 8, 24, 32):
            raise NotImplementedError(f"{what}: {bits}-bit OS/2 BMP "
                                      f"(OpenCV does not read it either)")
    else:
        raise NotImplementedError(f"{what}: BMP with a {hsize}-byte header "
                                  f"(OpenCV does not read it either)")
    if w <= 0 or h == 0:
        raise ValueError(f"{what}: BMP of size {w}x{h}")
    palette = None
    if bits <= 8:
        n = ncolors or 1 << bits
        if n > 256:
            raise ValueError(f"{what}: BMP palette of {n} colours")
        if 14 + hsize + entry * n > len(data):
            raise ValueError(f"{what}: truncated BMP palette")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(data, np.uint8, entry * n, 14 + hsize).reshape(n, entry)
        palette[:n] = entries[:, 2::-1]
    elif bits == 16:
        if compression == 3:
            if 14 + hsize + 12 > len(data):
                raise ValueError(f"{what}: truncated BMP bit-field masks")
            masks = struct.unpack_from("<III", data, 14 + hsize)
            if masks not in _MASKS_16:
                raise NotImplementedError(f"{what}: 16-bit BMP with bit-field masks "
                                          f"{tuple(hex(m) for m in masks)} (OpenCV reads only "
                                          f"5-5-5 and 5-6-5)")
            bits = _MASKS_16[masks]
        else:
            bits = 15
    if compression in (1, 2):
        index = bmp_rle(data[offset:], bits, w, h, what)
        return palette[index if top_down else index[::-1]]
    stride = (w * (16 if bits == 15 else bits) + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{what}: truncated BMP")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        return palette[rows[:, :w]]
    if bits < 8:
        index = np.unpackbits(rows, axis=1).reshape(h, -1, bits)[:, :w]
        return palette[(index << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)]
    if bits in (15, 16):
        t = rows[:, :2 * w].copy().view("<u2").astype(np.uint16)
        green = (t >> 2) & 0xF8 if bits == 15 else (t >> 3) & 0xFC
        red = (t >> 7) & 0xF8 if bits == 15 else (t >> 8) & 0xF8
        return np.stack([red, green, (t << 3) & 0xF8], -1).astype(np.uint8)
    ch = bits // 8
    pixels = rows[:, :w * ch].reshape(h, w, ch)
    if bits == 32 and compression == 3 and hsize >= 56:
        masks = struct.unpack_from("<III", data, 54)          # red, green, blue
        if all(masks):
            return _bit_fields(pixels.copy().view("<u4")[..., 0], masks)
    return np.ascontiguousarray(pixels[..., 2::-1])


def _bit_fields(pixels: np.ndarray, masks) -> np.ndarray:
    """RGB of 32-bit pixels [H, W] under the masks of a V3-or-later header,
    as OpenCV 5 scales them: each field shifted down to bit 0 and multiplied
    by 255 / (its mask shifted down) in float32, truncated."""
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1
        field = ((pixels & np.uint32(m)) >> np.uint32(shift)).astype(np.float32)
        out.append(field * (np.float32(255) / np.float32(m >> shift)))
    return np.stack(out, -1).astype(np.uint8)


def read_image_rgb(path: str) -> np.ndarray:
    """A frame as uint8 RGB [H,W,3], as ``cv2.imread(path, IMREAD_COLOR)
    [..., ::-1]`` reads it: PNG (gray repeated, alpha dropped), JPEG or BMP,
    told apart by the file's first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data, path)
        if img.dtype != np.uint8:
            img = (img >> 8).astype(np.uint8)
        if img.shape[-1] in (1, 2):
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data, path)
    if data.startswith(b"BM"):
        return decode_bmp(data, path)
    raise NotImplementedError(f"{path}: not a PNG, JPEG or BMP file (first bytes "
                              f"{data[:8]!r})")


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps of one axis: the two source indices
    (clipped to the image) and their 11-bit weights."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_bilinear_u8(image: np.ndarray, shape) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] -> uint8 [h,w(,C)] (``shape`` = (h, w)), as
    ``cv2.resize(image, (w, h), interpolation=INTER_LINEAR)``."""
    h, w = int(shape[0]), int(shape[1])
    if image.shape[:2] == (h, w):
        return image
    if image.dtype != np.uint8:
        raise ValueError(f"resize_bilinear_u8 takes uint8, not {image.dtype}")
    y0, y1, b0, b1 = _linear_taps(image.shape[0], h)
    x0, x1, a0, a1 = _linear_taps(image.shape[1], w)
    img = image.astype(np.int32)
    if image.ndim == 3:
        a0, a1 = a0[:, None], a1[:, None]
    rows = (img[:, x0] * a0 + img[:, x1] * a1) >> 4          # [H, w(, C)]
    b0 = b0.reshape(-1, *([1] * (image.ndim - 1)))
    b1 = b1.reshape(-1, *([1] * (image.ndim - 1)))
    out = (((rows[y0] * b0) >> 16) + ((rows[y1] * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(image: np.ndarray, shape) -> np.ndarray:
    """[H,W(,C)] of any dtype -> [h,w(,C)], as ``cv2.resize(...,
    INTER_NEAREST)``."""
    h, w = int(shape[0]), int(shape[1])
    if image.shape[:2] == (h, w):
        return image

    def index(n_in, n_out):
        step = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * step).astype(np.int64), n_in - 1)

    return image[index(image.shape[0], h)[:, None], index(image.shape[1], w)]
