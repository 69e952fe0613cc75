"""Writers of the JPEG and BMP kinds that the port's codec reads or refuses,
for `tools/torch_make_jpeg_fixtures.py` and the CPU tests
(`tests/test_torch_image_formats.py`). OpenCV and Pillow write most JPEG
kinds; the system's libjpeg, through `tools/torch_jpeg_arith_writer.c`
(`libjpeg_write`), writes arithmetic-coded, YCCK and partially progressive
files; the rest (lossless, 12-bit and hierarchical JPEG, every BMP header
and pixel format, RLE8 and RLE4 streams) is written here byte by byte.
Needs numpy, a C compiler and the system's libjpeg headers; not the port."""
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WRITER = ROOT / "tools" / "torch_jpeg_arith_writer.c"


def image(h, w, seed=0):
    """Smooth colour ramps with noise on top, uint8 [h, w, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (3 * xx + 5 * yy) % 256], -1)
    return np.clip(base + rng.integers(-60, 61, (h, w, 3)), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def libjpeg_writer() -> str:
    """`tools/torch_jpeg_arith_writer.c` built against the system's libjpeg
    into ``build/``, named by the source's hash; built in a temporary file
    and moved into place, so that processes building at once do not
    collide."""
    digest = hashlib.sha256(WRITER.read_bytes()).hexdigest()[:12]
    out = ROOT / "build" / f"torch_jpeg_arith_writer_{digest}"
    if not out.is_file():
        out.parent.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out.parent)
        os.close(fd)
        subprocess.run(["cc", "-O2", "-o", tmp, str(WRITER), "-ljpeg"], check=True)
        os.replace(tmp, out)
    return str(out)


def libjpeg_version() -> str:
    """LIBJPEG_TURBO_VERSION of the headers the writer is built against."""
    out = subprocess.run(["cc", "-E", "-dM", "-include", "stdio.h", "-include", "jpeglib.h",
                          "-x", "c", "/dev/null"], capture_output=True, text=True, check=True)
    for line in out.stdout.splitlines():
        if line.startswith("#define LIBJPEG_TURBO_VERSION "):
            return line.split()[-1]
    return "unknown"


def libjpeg_write(pixels: np.ndarray, *options: str) -> bytes:
    """JPEG bytes of uint8 pixels [H, W] (gray), [H, W, 3] (RGB) or
    [H, W, 4] (CMYK) from the libjpeg writer with ``options``."""
    h, w = pixels.shape[:2]
    c = 1 if pixels.ndim == 2 else pixels.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        raw, jpg = Path(tmp) / "in.raw", Path(tmp) / "out.jpg"
        raw.write_bytes(np.ascontiguousarray(pixels, np.uint8).tobytes())
        subprocess.run([libjpeg_writer(), str(raw), str(jpg), str(w), str(h), str(c),
                        *options], check=True)
        return jpg.read_bytes()


def segments(data: bytes):
    """(offset, marker, length) of each marker segment before the first scan."""
    pos = 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        yield pos, marker, length
        if marker == 0xDA:
            return
        pos += 2 + length


def without_segment(data: bytes, marker: int) -> bytes:
    """``data`` with every segment of ``marker`` before the first scan cut out."""
    cut = [(p, p + 2 + n) for p, m, n in segments(data) if m == marker]
    for start, end in reversed(cut):
        data = data[:start] + data[end:]
    return data


def with_adobe(data: bytes, transform: int) -> bytes:
    """``data`` with its Adobe APP14 segment replaced by one of ``transform``."""
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return (data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
            + without_segment(data, 0xEE)[2:])


def with_sof(data: bytes, marker: int) -> bytes:
    """``data`` with its frame header's marker code replaced."""
    pos = next(p for p, m, _ in segments(data) if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC))
    return data[:pos + 1] + bytes([marker]) + data[pos + 2:]


def exif_segment(orientation, little_endian=True):
    e = "<" if little_endian else ">"
    tiff = ((b"II*\x00" if little_endian else b"MM\x00*") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(data: bytes, orientation: int) -> bytes:
    return data[:2] + exif_segment(orientation) + data[2:]


class BitWriter:
    """Entropy-coded bits, MSB first, 0xFF bytes stuffed, padded with ones."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, bits):
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def huffman_codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def put_value(bw, codes, value):
    """A DC-style difference: its category's code, then its bits."""
    cat = int(abs(value)).bit_length()
    bw.put(*codes[cat])
    if cat:
        bw.put(value if value >= 0 else value + (1 << cat) - 1, cat)


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def dht(cls_id: int, counts, symbols) -> bytes:
    return segment(0xC4, bytes([cls_id]) + bytes(counts) + bytes(symbols))


# Annex K's luminance DC table: categories 0-11.
DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_SYMBOLS = list(range(12))


def lossless_gray(gray: np.ndarray) -> bytes:
    """An 8-bit grayscale lossless JPEG (SOF3, predictor 1, no point
    transform) of ``gray`` [H, W] uint8."""
    h, w = gray.shape
    codes = huffman_codes(DC_COUNTS, DC_SYMBOLS)
    bw = BitWriter()
    x = gray.astype(np.int32)
    for r in range(h):
        for c in range(w):
            pred = (128 if r == 0 else x[r - 1, c]) if c == 0 else x[r, c - 1]
            put_value(bw, codes, int(x[r, c] - pred))
    return (b"\xff\xd8" + segment(0xC3, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00")
            + dht(0x00, DC_COUNTS, DC_SYMBOLS)
            + segment(0xDA, b"\x01\x01\x00\x01\x00\x00") + bw.flush() + b"\xff\xd9")


def jpeg_12bit(means: np.ndarray) -> bytes:
    """A 12-bit grayscale extended sequential JPEG (SOF1, P=12) of flat
    8x8 blocks: block (i, j) has the sample value ``means[i, j]`` (0-4095),
    all quantizers 1, so that the DC coefficient is 8 * (mean - 2048)."""
    bh, bw_ = means.shape
    dc_counts = [0, 0, 0, 0, 16] + [0] * 11                   # categories 0-15, 5 bits each
    dc_codes = huffman_codes(dc_counts, list(range(16)))
    ac_counts, ac_symbols = [1] + [0] * 15, [0x00]            # end of block only
    bw = BitWriter()
    pred = 0
    for v in means.reshape(-1):
        dc = 8 * (int(v) - 2048)
        put_value(bw, dc_codes, dc - pred)
        pred = dc
        bw.put(0, 1)                                           # EOB
    dqt = segment(0xDB, b"\x10" + struct.pack(">64H", *([1] * 64)))
    return (b"\xff\xd8" + dqt
            + segment(0xC1, struct.pack(">BHHB", 12, 8 * bh, 8 * bw_, 1) + b"\x01\x11\x00")
            + dht(0x00, dc_counts, range(16)) + dht(0x10, ac_counts, ac_symbols)
            + segment(0xDA, b"\x01\x01\x00\x00\x3f\x00") + bw.flush() + b"\xff\xd9")


# --- BMP --------------------------------------------------------------------------

def bmp_file(width, height, bits, pixels: bytes, *, compression=0, palette=None, header=40,
             masks=None, masks_after_header=None, colors_used=0) -> bytes:
    """A BMP file: the 14-byte file header, an info header of ``header``
    bytes (12: OS/2 core; 40; 108: V4; 124: V5; V4 and V5 carry ``masks``
    in the header), the bit-field ``masks`` after a 40-byte header or
    ``masks_after_header`` after any, the ``palette`` (RGB [n, 3]; 3-byte
    entries under OS/2) and ``pixels``. A negative ``height`` is top-down."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pal = b"" if palette is None else np.asarray(palette, np.uint8)[:, ::-1].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits, compression,
                           len(pixels), 2835, 2835, colors_used, 0)
        if header > 40:
            red, green, blue = masks or (0, 0, 0)
            extra = struct.pack("<IIII", red, green, blue, 0) + b"BGRs" + bytes(header - 60)
            info += extra
        pal = b""
        if palette is not None:
            p = np.zeros((len(palette), 4), np.uint8)
            p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
            pal = p.tobytes()
    tail = b""
    if masks is not None and header == 40:
        tail = struct.pack("<III", *masks)
    if masks_after_header is not None:
        tail = struct.pack("<III", *masks_after_header)
    offset = 14 + len(info) + len(tail) + len(pal)
    body = info + tail + pal + pixels
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, offset) + body


def bottom_up(pixels: np.ndarray, bytes_per_pixel: int) -> bytes:
    """Rows of uint8 pixels [h, w, bytes_per_pixel], bottom row first, each
    padded to 4 bytes."""
    h, w = pixels.shape[:2]
    pad = bytes(-(w * bytes_per_pixel) % 4)
    return b"".join(r.tobytes() + pad for r in pixels[::-1])


def palette_of(img, colours: int):
    """Palette indices [h, w] and the RGB palette [colours, 3] (zero past its
    own entries) of a Pillow palette image (``Image.quantize(colours)``)."""
    pal = np.array(img.getpalette()[:3 * colours], np.uint8).reshape(-1, 3)
    return np.array(img), np.concatenate([pal, np.zeros((colours - len(pal), 3), np.uint8)])


def packed_rows(index: np.ndarray, bits: int) -> bytes:
    """Palette indices [h, w] packed at ``bits`` per pixel, MSB first, rows
    padded to 4 bytes, bottom row first."""
    h, w = index.shape
    stride = (w * bits + 31) // 32 * 4
    out = bytearray()
    for row in index[::-1]:
        bits_row = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:]
        packed = np.packbits(bits_row.reshape(-1))
        out += packed.tobytes() + bytes(stride - len(packed))
    return bytes(out)


def rle_encode(index: np.ndarray, bits: int) -> bytes:
    """RLE8 (``bits`` 8) or RLE4 (4) of palette indices [h, w], bottom row
    first: encoded runs of 3 or more (RLE4's repeat one colour), absolute
    runs of 3 or more literals (RLE4's two pixels a byte), padded to 16
    bits, short runs encoded, an end of line after each row and an end of
    bitmap after the last."""
    out = bytearray()
    for row in index[::-1].tolist():
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            k = i
            while k < n and k - i < 255 and not (k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            if j - i >= 3 or k - i < 3:
                out += bytes([j - i, row[i] if bits == 8 else row[i] << 4 | row[i]])
                i = j
                continue
            lit = row[i:k]
            if bits == 4:
                lit += [0] * (len(lit) % 2)
                lit = [a << 4 | b for a, b in zip(lit[::2], lit[1::2])]
            out += bytes([0, k - i]) + bytes(lit) + bytes(len(lit) % 2)
            i = k
        out += b"\x00\x00"
    return bytes(out) + b"\x00\x01"
