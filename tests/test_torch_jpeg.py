"""The port's host image codec against OpenCV (CPU).

`dro_sfm_torch.utils.image_io.decode_jpeg` must equal ``cv2.imdecode(...,
IMREAD_COLOR)[..., ::-1]`` bit for bit (tolerance 0) on the JPEG files that
OpenCV writes from seeded images: qualities 50, 75 and 95, every
``IMWRITE_JPEG_SAMPLING_FACTOR`` (4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4), with
and without restart intervals, grayscale, and sizes from 1x1 to 480x640
(sizes that are not whole MCUs among them). The EXIF orientation tag is
applied as OpenCV applies it (all eight values, both byte orders).
Lossless and 12-bit files, which OpenCV's IMREAD_COLOR does not decode
either, raise `NotImplementedError`; truncated, garbage and corrupt ones
(Huffman tables with too many short codes among them) raise `ValueError`.
``png_unfilter`` equals the numpy `_unfilter` on all five row filters, and
`decode_bmp` equals OpenCV on 8-, 24- and 32-bit files, bottom-up and
top-down, and Pillow's palette files. The other kinds (progressive,
arithmetic-coded, CMYK JPEG; OS/2, 1-, 4-, 16-bit, bit-field and RLE BMP)
are in `test_torch_image_formats.py`.
"""
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_torch.utils.image_io import (
    _unfilter,
    decode_jpeg,
    png_unfilter,
    decode_bmp,
    read_image_rgb,
)
from tools.torch_image_kinds import exif_segment, image, jpeg_12bit, lossless_gray

SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(1, 1), (7, 13), (17, 33), (48, 64), (480, 640)]


def encode(img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_equals_opencv(size, sampling, quality):
    img = image(*size, seed=quality)
    for rst in (0, 2):
        data = encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                      cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
        assert np.array_equal(decode_jpeg(data), opencv(data)), rst


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grayscale_and_restarts(size, tmp_path):
    gray = image(*size)[..., 1]
    for rst in (0, 1, 5):
        data = encode(gray, cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
        got = decode_jpeg(data)
        assert got.shape == (*size, 3) and np.array_equal(got, opencv(data))
    path = tmp_path / "gray.jpeg"
    path.write_bytes(data)
    assert np.array_equal(read_image_rgb(str(path)), cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv(tmp_path, orientation):
    data = encode(image(20, 30), cv2.IMWRITE_JPEG_QUALITY, 90)
    for le in (True, False):
        path = tmp_path / f"o{orientation}{le}.jpg"
        path.write_bytes(data[:2] + exif_segment(orientation, le) + data[2:])
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        got = read_image_rgb(str(path))
        assert got.shape == want.shape == ((30, 20, 3) if orientation >= 5 else (20, 30, 3))
        assert np.array_equal(got, want)


def test_what_is_refused_raises(tmp_path):
    img = image(48, 64)
    data = encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    for refused, kind in ((lossless_gray(img[..., 1]), "lossless"),
                          (jpeg_12bit(np.full((6, 8), 1000)), "12-bit")):
        assert cv2.imdecode(np.frombuffer(refused, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(NotImplementedError, match=kind):
            decode_jpeg(refused)
    for cut in (len(data) // 2, len(data) - 2, 200):
        with pytest.raises(ValueError, match="truncated|corrupt"):
            decode_jpeg(data[:cut])
    garbage = np.random.default_rng(0).integers(0, 256, 4000, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(garbage)
    sof = data.index(b"\xff\xc0")
    bad = bytearray(data)
    bad[sof + 5:sof + 9] = b"\x00\x00\x00\x00"              # height and width 0
    with pytest.raises(ValueError, match="corrupt"):
        decode_jpeg(bytes(bad))
    dht = data.index(b"\xff\xc4")
    bad = bytearray(data)
    bad[dht + 5:dht + 21] = b"\xff" * 16                       # code counts past 256
    with pytest.raises(ValueError, match="Huffman"):
        decode_jpeg(bytes(bad))
    sos = data.index(b"\xff\xda")
    bad = data[:sos + 14] + garbage[:200].replace(b"\xff", b"\x00")   # no end of image
    with pytest.raises(ValueError):
        decode_jpeg(bad)
    path = tmp_path / "x.gif"
    path.write_bytes(b"GIF89a" + garbage[:100])
    with pytest.raises(NotImplementedError, match="not a PNG, JPEG or BMP"):
        read_image_rgb(str(path))


# Huffman code counts by length (1..16) that sum to 256 or fewer symbols but
# whose codes do not fit in their lengths: three 1-bit codes, 200 1-bit codes,
# both 1-bit codes (the all-ones code), five 2-bit codes after one 1-bit code.
BAD_COUNTS = {"three_1bit": [3], "200_1bit": [200], "all_ones": [2], "five_2bit": [1, 5]}


@pytest.mark.parametrize("counts", list(BAD_COUNTS.values()), ids=list(BAD_COUNTS))
def test_overfull_huffman_table_raises(counts):
    """A Huffman table with too many short codes is refused before its lookup
    table is filled, as libjpeg refuses it."""
    data = encode(image(48, 64), cv2.IMWRITE_JPEG_QUALITY, 90)
    dht = data.index(b"\xff\xc4")
    end = dht + 2 + struct.unpack(">H", data[dht + 2:dht + 4])[0]
    counts = counts + [0] * (16 - len(counts))
    symbols = bytes(i % 12 for i in range(sum(counts)))       # valid DC categories
    body = bytes([data[dht + 4]]) + bytes(counts) + symbols
    bad = data[:dht] + b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body + data[end:]
    assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="Huffman"):
        decode_jpeg(bad)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_png_unfilter_equals_numpy(bpp):
    rng = np.random.default_rng(bpp)
    h, w = 23, 31
    raw = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
    kinds = np.arange(h) % 5
    rows = np.concatenate([kinds[:, None].astype(np.uint8), raw], axis=1)
    got = png_unfilter(rows, bpp)
    want = _unfilter(raw.reshape(h, w, bpp), kinds.astype(np.uint8)).reshape(h, w * bpp)
    assert np.array_equal(got, want)
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="filter 5"):
        png_unfilter(rows, bpp)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_equals_opencv(tmp_path, channels):
    img = image(13, 17)[..., :channels] if channels < 4 else np.concatenate(
        [image(13, 17), image(13, 17, 1)[..., :1]], -1)
    path = tmp_path / "x.bmp"
    cv2.imwrite(str(path), img)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    assert np.array_equal(read_image_rgb(str(path)), want)
    data = bytearray(path.read_bytes())                       # the same rows top-down
    h = struct.unpack_from("<i", data, 22)[0]
    offset = struct.unpack_from("<I", data, 10)[0]
    stride = (len(data) - offset) // h
    rows = [bytes(data[offset + i * stride:offset + (i + 1) * stride]) for i in range(h)]
    data[22:26] = struct.pack("<i", -h)
    data[offset:] = b"".join(rows[::-1])
    assert np.array_equal(decode_bmp(bytes(data)), want)


def test_bmp_palette_from_pillow(tmp_path):
    img = Image.fromarray(image(19, 23)).convert("P", palette=Image.ADAPTIVE, colors=40)
    path = tmp_path / "p.bmp"
    img.save(path)
    assert np.array_equal(read_image_rgb(str(path)), cv2.imread(str(path))[..., ::-1])
    data = bytearray(path.read_bytes())
    data[30:34] = struct.pack("<I", 4)                       # BI_JPEG, which OpenCV refuses
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(NotImplementedError, match="compression 4"):
        decode_bmp(bytes(data))


def test_committed_fixtures_decode_to_opencvs_bytes():
    """The fixtures of ``chip_smoke.py`` phase ``datasets``
    (`tools/torch_make_jpeg_fixtures.py`): the port's decoder and OpenCV
    give the recorded sha256 of every file."""
    import hashlib
    import json
    from pathlib import Path
    folder = Path(__file__).resolve().parents[1] / "dro_sfm_torch" / "testdata" / "jpeg"
    table = json.loads((folder / "fixtures.json").read_text())["files"]
    assert len(table) == 19
    for name, entry in table.items():
        path = str(folder / name)
        for img in (read_image_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]):
            assert list(img.shape) == entry["shape"]
            assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == \
                entry["sha256"], name


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No C++ compiler: building the codec raises (there is no Python
    decoder to fall back on)."""
    from dro_sfm_torch import hostlib
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        hostlib.find_cxx()
    monkeypatch.setattr(hostlib, "library_path", lambda name: tmp_path / "host" / "lib.so")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        hostlib.build("image_codec")
    assert not (tmp_path / "host").exists()
