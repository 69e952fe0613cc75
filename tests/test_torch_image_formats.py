"""The port's host codec on the JPEG and BMP kinds beyond baseline (CPU).

Every file below is held to ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]``
(OpenCV 5.0.0, its bundled libjpeg-turbo 3.1.2) bit for bit, tolerance 0:

* progressive Huffman JPEG from OpenCV (every sampling factor, with and
  without restart intervals, sizes from 1x1 to 97x131) and from Pillow
  (4:2:0, 4:2:2, 4:4:4, grayscale);
* arithmetic-coded JPEG, sequential and progressive, written by the system's
  libjpeg (`tools/torch_jpeg_arith_writer.c`): sampling factors, grayscale,
  restart intervals, and DAC conditioning values other than the defaults;
* four-component JPEG: CMYK without an Adobe marker and under Adobe
  transform 0, YCCK under transform 2 (and 1, which libjpeg takes as YCCK
  with a warning), Huffman, progressive and arithmetic, and Pillow's CMYK;
* BMP: the OS/2 core header, 1-, 4- and 8-bit palettes, 16-bit 5-5-5 and
  5-6-5 (``BI_BITFIELDS``), 32-bit bit fields (applied under a V3-V5
  header, ignored under a 40-byte one), V4 and V5 headers, top-down rows,
  RLE8 and RLE4 with every escape.

What OpenCV refuses the port refuses with `NotImplementedError`, and the
test shows that ``cv2.imread`` returns ``None`` for the same bytes (so the
JAX readers raise too): lossless, 12-bit and hierarchical JPEG, BMP masks
or compressions OpenCV does not take. A progressive file that libjpeg
decodes with block smoothing raises `NotImplementedError` where OpenCV
decodes it. Truncated and corrupt streams of each new kind raise
`ValueError`. One case of each kind, and the committed fixtures, are also
held to the JAX package's reader, `dro_sfm_tpu.data.kitti.load_image_rgb`.
"""
import hashlib
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_torch.utils.image_io import decode_bmp, decode_jpeg, read_image_rgb
from tools.torch_image_kinds import (
    bmp_file,
    bottom_up,
    image,
    jpeg_12bit,
    libjpeg_write,
    lossless_gray,
    packed_rows,
    palette_of,
    rle_encode,
    segments,
    with_adobe,
    with_exif,
    with_sof,
    without_segment,
)

SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(1, 1), (7, 13), (17, 33), (97, 131)]
FIXTURES = Path(__file__).resolve().parents[1] / "dro_sfm_torch" / "testdata" / "jpeg"


def opencv(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else img[..., ::-1]


def held(data, tmp_path, name="x.jpg"):
    """``read_image_rgb`` of ``data`` as a file equals ``cv2.imread``'s."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None, name
    got = read_image_rgb(str(path))
    assert got.shape == want.shape and np.array_equal(got, want[..., ::-1]), name


def cv2_jpeg(img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


def pillow_jpeg(img, **kw):
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cmyk_of(size, seed=0):
    h, w = size
    return np.concatenate([image(h, w, seed), image(h, w, seed + 1)[..., :1]], -1)


# --- progressive Huffman ----------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_progressive_from_opencv(size, sampling, tmp_path):
    img = image(*size, seed=3)
    for rst in (0, 1, 5):
        held(cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                      cv2.IMWRITE_JPEG_RST_INTERVAL, rst), tmp_path, f"p{rst}.jpg")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["420", "422", "444", "gray"])
def test_progressive_from_pillow(size, kind, tmp_path):
    img = image(*size, seed=4)
    if kind == "gray":
        data = pillow_jpeg(img[..., 1], progressive=True, quality=90)
    else:
        data = pillow_jpeg(img, progressive=True, quality=90,
                           subsampling={"444": 0, "422": 1, "420": 2}[kind])
    held(data, tmp_path)


# --- arithmetic coding ------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sample", ["1x1", "2x1", "1x2", "2x2", "gray"])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic(size, sample, mode, tmp_path):
    img = image(*size, seed=5)
    prog = ["-progressive"] if mode == "progressive" else []
    for rst in ("0", "1", "4"):
        data = (libjpeg_write(img[..., 1], "-arith", *prog, "-restart", rst) if sample == "gray"
                else libjpeg_write(img, "-arith", *prog, "-sample", sample, "-restart", rst))
        marker = 0xCA if prog else 0xC9
        assert any(m == marker for _, m, _ in segments(data))
        held(data, tmp_path, f"a{rst}.jpg")


@pytest.mark.parametrize("dac", [(0, 1, 5), (2, 4, 10), (0, 0, 1), (1, 3, 63), (3, 8, 2),
                                 (0, 15, 0)], ids=lambda d: "L{}U{}K{}".format(*d))
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_conditioning(dac, mode, tmp_path):
    """DC statistics conditioned by DAC's L and U, AC by Kx."""
    prog = ["-progressive"] if mode == "progressive" else []
    data = libjpeg_write(image(40, 56, seed=6), "-arith", *prog, "-dac", *map(str, dac))
    assert any(m == 0xCC for _, m, _ in segments(data))       # a DAC segment
    held(data, tmp_path)


# --- four components --------------------------------------------------------------

CODINGS = {"huffman": [], "progressive": ["-progressive"], "arith": ["-arith"],
           "arith_progressive": ["-arith", "-progressive"]}


@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("colour", ["cmyk_no_adobe", "cmyk_adobe0", "ycck_adobe2",
                                    "ycck_adobe1", "ycck_no_adobe"])
def test_four_components(coding, colour, tmp_path):
    """libjpeg's choice: transform 0 CMYK, 2 YCCK, another YCCK (with a
    warning), no Adobe marker CMYK; then OpenCV's CMYK -> BGR."""
    for size, sample in (((33, 47), "2x2"), ((16, 24), "1x1"), ((9, 70), "2x1")):
        data = libjpeg_write(cmyk_of(size), *CODINGS[coding], "-sample", sample,
                             *(["-ycck"] if colour.startswith("ycck") else []))
        if colour.endswith("no_adobe"):
            data = without_segment(data, 0xEE)
        else:
            data = with_adobe(data, int(colour[-1]))
        held(data, tmp_path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_from_pillow(size, tmp_path):
    """Pillow writes inverted CMYK under an Adobe marker (transform 0)."""
    held(pillow_jpeg(Image.fromarray(cmyk_of(size, 7), "CMYK"), quality=90), tmp_path)
    held(pillow_jpeg(Image.fromarray(image(*size, 8)).convert("CMYK"), quality=95,
                     progressive=True), tmp_path)


# --- BMP --------------------------------------------------------------------------

def quantized(rgb, colours):
    return palette_of(Image.fromarray(rgb).quantize(colours), colours)


def bmp_kinds():
    """name -> BMP bytes, one of each kind OpenCV reads."""
    h, w = 19, 23
    rng = np.random.default_rng(0)
    out = {}
    for bits in (1, 4, 8):
        idx, pal = quantized(image(h, w, bits), 1 << bits)
        for header in (12, 40, 108, 124):
            out[f"pal{bits}_h{header}"] = bmp_file(w, h, bits, packed_rows(idx, bits),
                                                   palette=pal, header=header)
        half = max(1, (1 << bits) // 2)
        out[f"pal{bits}_fewer_colours"] = bmp_file(w, h, bits, packed_rows(idx, bits),
                                                   palette=pal[:half], colors_used=half)
    px16 = rng.integers(0, 65536, (h, w)).astype("<u2")
    rows16 = bottom_up(px16.view(np.uint8).reshape(h, w, 2), 2)
    out["rgb16"] = bmp_file(w, h, 16, rows16)
    out["rgb16_h108"] = bmp_file(w, h, 16, rows16, header=108)
    out["bitfields16_555"] = bmp_file(w, h, 16, rows16, compression=3,
                                      masks=(0x7C00, 0x3E0, 0x1F))
    out["bitfields16_565"] = bmp_file(w, h, 16, rows16, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F))
    out["bitfields16_565_h124"] = bmp_file(w, h, 16, rows16, compression=3, header=124,
                                           masks=(0xF800, 0x7E0, 0x1F),
                                           masks_after_header=(0xF800, 0x7E0, 0x1F))
    px24 = image(h, w, 9)[..., ::-1]
    for header in (12, 40, 108, 124):
        out[f"rgb24_h{header}"] = bmp_file(w, h, 24, bottom_up(px24, 3), header=header)
    out["rgb24_top_down_h108"] = bmp_file(w, -h, 24, bottom_up(px24[::-1], 3), header=108)
    px32 = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    out["rgb32_os2"] = bmp_file(w, h, 32, bottom_up(px32, 4), header=12)
    out["rgb32_h124"] = bmp_file(w, h, 32, bottom_up(px32, 4), header=124,
                                 masks=(0xFF, 0xFF00, 0xFF0000))
    for name, masks in {"standard": (0xFF0000, 0xFF00, 0xFF), "swapped": (0xFF, 0xFF00, 0xFF0000),
                        "high": (0xFF000000, 0xFF0000, 0xFF00),
                        "ten_bit": (0x3FF00000, 0xFFC00, 0x3FF),
                        "narrow": (0xF800, 0x7E0, 0x1F), "scattered": (0xF0F, 0xF0F0, 0xF0000),
                        "zero_blue": (0xFF0000, 0xFF00, 0)}.items():
        for header in (40, 108, 124):
            out[f"bitfields32_{name}_h{header}"] = bmp_file(w, h, 32, bottom_up(px32, 4),
                                                            compression=3, masks=masks,
                                                            header=header)
    idx8, pal8 = quantized(image(h, w, 10), 256)
    idx8[4:9, 2:20] = idx8[4, 2]                               # long runs
    out["rle8"] = bmp_file(w, h, 8, rle_encode(idx8, 8), compression=1, palette=pal8)
    out["rle8_h124"] = bmp_file(w, h, 8, rle_encode(idx8, 8), compression=1, palette=pal8,
                                header=124)
    out["rle8_top_down"] = bmp_file(w, -h, 8, rle_encode(idx8[::-1], 8), compression=1,
                                    palette=pal8)
    idx4, pal4 = quantized(image(h, w, 11), 16)
    idx4[3:7, 5:21] = idx4[3, 5]
    out["rle4"] = bmp_file(w, h, 4, rle_encode(idx4, 4), compression=2, palette=pal4)
    out["rle4_h108"] = bmp_file(w, h, 4, rle_encode(idx4, 4), compression=2, palette=pal4,
                                header=108)
    return out


BMP_KINDS = bmp_kinds()


@pytest.mark.parametrize("kind", sorted(BMP_KINDS))
def test_bmp_kind(kind, tmp_path):
    held(BMP_KINDS[kind], tmp_path, "x.bmp")


def test_bmp_from_pillow(tmp_path):
    """Pillow's 1-bit, 8-bit gray and 32-bit RGBA BMP files."""
    img = image(21, 29, 12)
    for i, pic in enumerate((Image.fromarray(img).convert("1"), Image.fromarray(img[..., 0]),
                             Image.fromarray(np.concatenate([img, img[..., :1]], -1), "RGBA"))):
        path = tmp_path / f"{i}.bmp"
        pic.save(path)
        held(path.read_bytes(), tmp_path, f"{i}.bmp")


W8, H8 = 8, 6
RLE_STREAMS = {   # name -> (bits, stream) on an 8x6 image
    "rle8_delta_eol_wrap_eob": (8, bytes([3, 5, 0, 2, 2, 1, 0, 3, 1, 2, 3, 0, 0, 0, 8, 7, 0, 0,
                                          2, 4, 0, 0, 4, 9, 0, 1])),
    "rle8_delta_past_the_end": (8, bytes([2, 6, 0, 2, 1, 20])),
    "rle8_end_of_bitmap_first": (8, bytes([0, 1])),
    "rle8_no_end_marker": (8, bytes([8, 1]) * 6),
    "rle8_end_of_line_mid_row": (8, bytes([1, 1, 0, 0]) * 6),
    "rle8_two_end_of_lines": (8, bytes([8, 3, 0, 0, 0, 0, 8, 4, 0, 1])),
    "rle8_delta_zero": (8, bytes([2, 3, 0, 2, 0, 0, 6, 4, 0, 1])),
    "rle8_absolute_to_row_end": (8, bytes([0, 8, 1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 0, 1])),
    "rle4_delta_wraps_row": (4, bytes([5, 0x12, 0, 2, 6, 9, 2, 0x44, 0, 0]) +
                             bytes([8, 0x33, 0, 0]) * 4),
    "rle4_delta_dy_ignored": (4, bytes([3, 0x22, 0, 2, 2, 1, 3, 0x44, 0, 0]) +
                              bytes([8, 0x33, 0, 0]) * 5),
    "rle4_end_of_bitmap_ends_the_line": (4, bytes([3, 0x22, 0, 1]) + bytes([8, 0x33, 0, 0]) * 5),
    "rle4_end_of_bitmap_last": (4, bytes([8, 0x11, 0, 0]) * 5 + bytes([3, 0x22, 0, 1])),
    "rle4_odd_absolute": (4, bytes([0, 5, 0x12, 0x34, 0x50, 0, 0, 0]) +
                          bytes([8, 0x1F, 0, 0]) * 5),
}
RLE_BROKEN = {   # OpenCV returns None
    "rle8_run_past_row": (8, bytes([9, 1, 0, 1])),
    "rle8_absolute_past_row": (8, bytes([5, 1, 0, 4, 1, 2, 3, 4, 0, 1])),
    "rle8_truncated": (8, bytes([8, 1, 8, 1])),
    "rle8_truncated_absolute": (8, bytes([0, 6, 1, 2, 3])),
    "rle4_run_after_a_full_row": (4, bytes([8, 0x12, 8, 0x34, 0, 1])),
    "rle4_stops_short": (4, bytes([0, 1])),
    "rle4_truncated": (4, bytes([8, 0x11, 0, 0])),
}


@pytest.mark.parametrize("name", sorted(RLE_STREAMS) + sorted(RLE_BROKEN))
def test_rle_escapes(name, tmp_path):
    """Each escape as OpenCV 5.0.0 reads it: the pixels an escape skips take
    palette entry 0; RLE8's delta skips dy rows and dx pixels in reading
    order; RLE4's end of bitmap ends only the line and its delta skips dx
    pixels only; a run past its row, or a stream that stops short, makes
    OpenCV return None and the port raise `ValueError`."""
    bits, stream = {**RLE_STREAMS, **RLE_BROKEN}[name]
    pal = (np.arange(3 * (1 << bits)).reshape(-1, 3) * 37 % 251).astype(np.uint8)
    for height in (H8, -H8):
        data = bmp_file(W8, height, bits, stream, compression=1 if bits == 8 else 2,
                        palette=pal)
        if name in RLE_STREAMS:
            held(data, tmp_path, "x.bmp")
        else:
            assert opencv(data) is None
            with pytest.raises(ValueError, match="RLE"):
                decode_bmp(data)


# --- what stays refused -----------------------------------------------------------

def refused_kinds():
    base = cv2_jpeg(image(32, 48, 13), cv2.IMWRITE_JPEG_QUALITY, 90)
    means = np.array([[100, 3000, 2048], [4095, 0, 1234]])
    out = {"lossless_sof3": (lossless_gray(image(24, 40)[..., 1]), "lossless"),
           "lossless_sof11": (with_sof(base, 0xCB), "lossless"),
           "12bit_sof1": (jpeg_12bit(means), "12-bit"),
           "12bit_progressive": (with_sof(jpeg_12bit(means), 0xC2), "12-bit")}
    for sof in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        out[f"hierarchical_sof{sof - 0xC0}"] = (with_sof(base, sof), "hierarchical")
    px = np.random.default_rng(1).integers(0, 256, (5, 6, 2)).astype(np.uint8)
    rows16 = bottom_up(px, 2)
    out["bmp_bitfields16_444"] = (bmp_file(6, 5, 16, rows16, compression=3,
                                           masks=(0xF00, 0xF0, 0xF)), "bit-field masks")
    out["bmp_bitfields16_masks_in_v5_header_only"] = (
        bmp_file(6, 5, 16, rows16, compression=3, header=124, masks=(0xF800, 0x7E0, 0x1F)),
        "bit-field masks")
    out["bmp_jpeg_compression"] = (bmp_file(6, 5, 24, bottom_up(px[..., :1].repeat(3, -1), 3),
                                            compression=4), "compression 4")
    out["bmp_rle8_on_24_bits"] = (bmp_file(6, 5, 24, b"\x00\x01", compression=1),
                                  "compression 1")
    out["bmp_os2_16_bits"] = (bmp_file(6, 5, 16, rows16, header=12), "OS/2")
    core = bmp_file(6, 5, 24, bottom_up(px[..., :1].repeat(3, -1), 3))
    out["bmp_16_byte_header"] = (core[:14] + struct.pack("<I", 16) + core[18:], "header")
    return out


REFUSED = refused_kinds()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_as_opencv_refuses(kind, tmp_path):
    """Kinds OpenCV does not decode with IMREAD_COLOR: ``cv2.imread`` gives
    None (the JAX readers raise FileNotFoundError) and the port raises
    `NotImplementedError` naming the kind."""
    data, match = REFUSED[kind]
    path = tmp_path / ("x.bmp" if kind.startswith("bmp") else "x.jpg")
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(NotImplementedError, match=match):
        read_image_rgb(str(path))


def test_lossless_and_12bit_files_are_what_they_claim():
    """The lossless file is valid: OpenCV's IMREAD_UNCHANGED decodes it to
    its source exactly, while IMREAD_COLOR returns None. No second decoder
    confirms the 12-bit file (OpenCV returns None under every flag; the
    libjpeg-turbo 2.1 writer's library and Pillow's are 8-bit builds), so
    its refusal rests on OpenCV alone."""
    gray = image(24, 40)[..., 1]
    data = np.frombuffer(lossless_gray(gray), np.uint8)
    assert np.array_equal(cv2.imdecode(data, cv2.IMREAD_UNCHANGED), gray)
    assert cv2.imdecode(data, cv2.IMREAD_COLOR) is None
    twelve = np.frombuffer(jpeg_12bit(np.array([[100, 3000]])), np.uint8)
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED, cv2.IMREAD_ANYDEPTH,
                 cv2.IMREAD_GRAYSCALE):
        assert cv2.imdecode(twelve, flag) is None


@pytest.mark.parametrize("coding", [[], ["-arith"]], ids=["huffman", "arith"])
def test_block_smoothing_is_refused(coding, tmp_path):
    """Scans that never refine the first AC coefficients: libjpeg-turbo
    smooths the blocks and OpenCV decodes; the port refuses."""
    for img in (image(48, 64, 14), image(17, 23, 15)[..., 0]):
        data = libjpeg_write(img, "-partial", *coding)
        path = tmp_path / "s.jpg"
        path.write_bytes(data)
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
        with pytest.raises(NotImplementedError, match="block smoothing"):
            read_image_rgb(str(path))


# --- progression order, truncation and corruption ---------------------------------

def scans(data):
    """The file cut into its head, one chunk per scan (the segments after
    the scan before, then its header and entropy-coded data) and the end."""
    def data_end(p):
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        while not (data[p] == 0xFF and data[p + 1] != 0 and not 0xD0 <= data[p + 1] <= 0xD7):
            p += 1
        return p

    pos, starts, ends = 2, [], []
    while data[pos + 1] != 0xD9:
        if data[pos + 1] == 0xDA:
            starts.append(pos)
            pos = data_end(pos)
            ends.append(pos)
        else:
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    cuts = [starts[0]] + ends
    return data[:starts[0]], [data[a:b] for a, b in zip(cuts, cuts[1:])], data[ends[-1]:]


def scan_params(chunk):
    p = chunk.index(b"\xff\xda")
    ns = chunk[p + 4]
    ss, se, a = chunk[p + 5 + 2 * ns:p + 8 + 2 * ns]
    return p + 5 + 2 * ns, ss, se, a >> 4, a & 15


@pytest.mark.parametrize("coding", [[], ["-arith"]], ids=["huffman", "arith"])
def test_bad_progression_raises(coding):
    """Scan parameters libjpeg stops at (JERR_BAD_PROGRESSION): OpenCV
    returns None, the port raises `ValueError`."""
    data = libjpeg_write(image(24, 32, 16), "-progressive", *coding)
    head, chunks, tail = scans(data)
    ac = next(i for i, c in enumerate(chunks) if scan_params(c)[1] > 0)
    at, ss, se, ah, al = scan_params(chunks[ac])
    for bad in ((ss, ss - 1, ah, al), (ss, 64, ah, al), (ss, se, ah, 14), (ss, se, 2, 0),
                (0, 5, ah, al)):
        c = bytearray(chunks[ac])
        c[at:at + 3] = bytes([bad[0], bad[1], bad[2] << 4 | bad[3]])
        broken = head + b"".join(chunks[:ac] + [bytes(c)] + chunks[ac + 1:]) + tail
        assert opencv(broken) is None, bad
        with pytest.raises(ValueError, match="progression"):
            decode_jpeg(broken)


@pytest.mark.parametrize("coding", [[], ["-arith"]], ids=["huffman", "arith"])
def test_out_of_order_progression_is_decoded(coding, tmp_path):
    """Scans out of the progression's order (an AC scan before the DC scan,
    a scan repeated): libjpeg warns (JWRN_BOGUS_PROGRESSION) and decodes,
    and so does the port, to the same bytes."""
    data = libjpeg_write(image(40, 56, 17), "-progressive", *coding)
    head, chunks, tail = scans(data)
    assert scan_params(chunks[0])[1] == 0 and scan_params(chunks[1])[1] > 0
    swapped = head + b"".join([chunks[1], chunks[0]] + chunks[2:]) + tail
    repeated = head + b"".join(chunks[:2] + [chunks[1]] + chunks[2:]) + tail
    for i, variant in enumerate((swapped, repeated)):
        held(variant, tmp_path, f"{i}.jpg")


def new_jpeg_kinds():
    """name -> JPEG bytes, one of each new kind, 37x53."""
    img = image(37, 53, 18)
    cmyk = cmyk_of((37, 53), 19)
    return {
        "progressive_opencv": cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "progressive_pillow": pillow_jpeg(img, progressive=True, quality=92),
        "arith_sequential": libjpeg_write(img, "-arith", "-restart", "3"),
        "arith_progressive": libjpeg_write(img, "-arith", "-progressive", "-restart", "2"),
        "cmyk_pillow": pillow_jpeg(Image.fromarray(cmyk, "CMYK")),
        "ycck_arith": libjpeg_write(cmyk, "-ycck", "-arith"),
        "cmyk_no_adobe": without_segment(libjpeg_write(cmyk, "-progressive"), 0xEE),
    }


NEW_JPEG = new_jpeg_kinds()


@pytest.mark.parametrize("kind", sorted(NEW_JPEG))
def test_truncated_or_corrupt_raises(kind):
    """Cut anywhere, the stream raises `ValueError` (libjpeg would warn and
    fill in gray); so does a restart marker out of sequence."""
    data = NEW_JPEG[kind]
    for cut in (len(data) // 3, len(data) // 2, len(data) - 30, len(data) - 2):
        with pytest.raises(ValueError, match="truncated|corrupt"):
            decode_jpeg(data[:cut])
    rst = data.find(b"\xff\xd0", next(p for p, m, _ in segments(data) if m == 0xDA))
    if rst > 0:
        bad = data[:rst + 1] + b"\xd5" + data[rst + 2:]
        with pytest.raises(ValueError, match="restart"):
            decode_jpeg(bad)


def test_corrupt_arithmetic_headers_raise():
    """A DAC value with L > U and a DAC table index past 31 stop libjpeg
    (OpenCV returns None); the port raises `ValueError`."""
    data = libjpeg_write(image(24, 32, 21), "-arith", "-dac", "1", "3", "5")
    pos = next(p for p, m, _ in segments(data) if m == 0xCC)
    for index, value in ((0, 0x12), (40, 5)):
        bad = bytearray(data)
        bad[pos + 4:pos + 6] = bytes([index, value])
        assert opencv(bytes(bad)) is None
        with pytest.raises(ValueError, match="DAC"):
            decode_jpeg(bytes(bad))


@pytest.mark.parametrize("kind", sorted(NEW_JPEG))
@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation_on_new_kinds(kind, orientation, tmp_path):
    held(with_exif(NEW_JPEG[kind], orientation), tmp_path)


def test_libjpeg_defaults_for_tables_and_colour(tmp_path):
    """libjpeg-turbo installs the standard Huffman tables where a file has
    none (Motion JPEG frames), and a JFIF marker means YCbCr even beside an
    Adobe transform 0."""
    base = cv2_jpeg(image(30, 44, 22), cv2.IMWRITE_JPEG_QUALITY, 80)
    held(without_segment(base, 0xC4), tmp_path, "no_dht.jpg")
    held(with_adobe(base, 0), tmp_path, "jfif_adobe0.jpg")
    held(with_adobe(without_segment(base, 0xE0), 0), tmp_path, "adobe0.jpg")


# --- the JAX package's reader -----------------------------------------------------

@pytest.mark.parametrize("kind", sorted(NEW_JPEG) + ["bmp_" + k for k in (
    "pal1_h12", "pal4_h40", "pal8_h124", "rgb16", "bitfields16_565", "bitfields32_ten_bit_h124",
    "rgb24_h108", "rle8", "rle4")])
def test_matches_the_jax_reader(kind, tmp_path):
    """`dro_sfm_tpu.data.kitti.load_image_rgb` (``cv2.imread``) on the same
    file as `read_image_rgb`."""
    from dro_sfm_tpu.data import kitti
    data = BMP_KINDS[kind[4:]] if kind.startswith("bmp_") else NEW_JPEG[kind]
    path = tmp_path / (kind + (".bmp" if kind.startswith("bmp_") else ".jpg"))
    path.write_bytes(data)
    assert np.array_equal(read_image_rgb(str(path)), kitti.load_image_rgb(str(path)))


def test_committed_fixtures_match_the_jax_reader():
    from dro_sfm_tpu.data import kitti
    table = json.loads((FIXTURES / "fixtures.json").read_text())["files"]
    for name, entry in table.items():
        path = str(FIXTURES / name)
        img = read_image_rgb(path)
        assert np.array_equal(img, kitti.load_image_rgb(path)), name
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"], name
