"""The port's PNG reader, writer and resize against OpenCV and Pillow (CPU).

`dro_sfm_torch.utils.image_io` decodes what ``cv2.imwrite`` writes at every
compression level and what Pillow writes (RGB, RGBA, gray, gray+alpha; all
five row filters occur), bit-equal to ``cv2.imread``; OpenCV reads the
port's files back bit-equal; 16-bit depth files round-trip through both
packages' ``load_depth``/``write_depth``. The bilinear resize equals
``cv2.resize(INTER_LINEAR)`` (its fixed-point weights and rounding); a frame
already at the shape is returned as it is. A file that is not a PNG, or one
whose image data does not fit its header, raises; palette and 16-bit colour
files decode (`test_torch_png_decode.py` holds them and Adam7 to OpenCV).
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_tpu.utils import depth as jdepth
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.utils import depth as tdepth
from dro_sfm_torch.utils.image_io import (
    read_image_rgb,
    read_png,
    resize_bilinear_u8,
    write_png,
)


@pytest.fixture(scope="module")
def images():
    ds = SyntheticDataset(SyntheticConfig(height=48, width=80, num_planes=3))
    planes, poses = ds._scene(1)
    rgb, depth = ds._render(planes, poses[0])
    rng = np.random.default_rng(0)
    return {"scene": (rgb * 255).astype(np.uint8),
            "noise": rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
            "depth": (depth[..., 0] * 256).astype(np.uint16)}


def png_filters(path):
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, bits, ctype = header[:4]
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * bits // 8
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("name", ["scene", "noise"])
@pytest.mark.parametrize("level", [0, 1, 3, 6, 9])
def test_reads_opencv_pngs(tmp_path, images, name, level):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, images[name][..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert np.array_equal(read_image_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_reads_pillow_pngs(tmp_path, images, mode):
    path = str(tmp_path / "x.png")
    Image.fromarray(images["scene"]).convert(mode).save(path)
    assert np.array_equal(read_image_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    assert np.array_equal(read_png(path).squeeze(-1) if mode == "L" else read_png(path),
                          np.asarray(Image.open(path)))


def test_every_row_filter_is_decoded(tmp_path, images):
    seen = set()
    for level in (0, 1, 3, 6, 9):
        for name in ("scene", "noise"):
            path = str(tmp_path / f"{name}{level}.png")
            cv2.imwrite(path, images[name], [cv2.IMWRITE_PNG_COMPRESSION, level])
            seen |= png_filters(path)
    path = str(tmp_path / "port.png")
    write_png(path, images["scene"])
    seen |= png_filters(path)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_opencv_reads_port_pngs(tmp_path, images, channels):
    img = images["scene"]
    img = {1: img[..., :1], 2: np.concatenate([img[..., :1], img[..., 1:2]], -1),
           3: img, 4: np.concatenate([img, img[..., :1]], -1)}[channels]
    path = str(tmp_path / "x.png")
    write_png(path, img)
    assert np.array_equal(read_png(path), img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = {1: img[..., 0], 2: None, 3: img[..., ::-1],
            4: np.concatenate([img[..., 2::-1], img[..., 3:]], -1)}[channels]
    if want is not None:
        assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(Image.open(path)), img.squeeze(-1) if channels == 1 else img)


def test_depth_pngs_round_trip_between_the_packages(tmp_path, images):
    depth = images["depth"].astype(np.float32) / 256.0
    tdepth.write_depth(str(tmp_path / "t.png"), depth)
    jdepth.write_depth(str(tmp_path / "j.png"), depth)
    assert np.array_equal(cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_ANYDEPTH),
                          images["depth"])
    for name in ("t.png", "j.png"):
        assert np.array_equal(tdepth.load_depth(str(tmp_path / name)),
                              jdepth.load_depth(str(tmp_path / name)))
    K = np.eye(3, dtype=np.float32)
    tdepth.write_depth(str(tmp_path / "t.npz"), depth, intrinsics=K)
    assert np.array_equal(jdepth.load_depth(str(tmp_path / "t.npz")), depth)
    assert np.array_equal(np.load(tmp_path / "t.npz")["intrinsics"], K)


@pytest.mark.parametrize("src, dst", [((48, 80), (24, 32)), ((17, 23), (48, 80)),
                                      ((30, 41), (20, 64)), ((48, 80), (48, 80))])
def test_resize_within_one_level_of_opencv(images, src, dst):
    rng = np.random.default_rng(1)
    img = images["scene"] if src == (48, 80) else rng.integers(0, 256, (*src, 3), np.uint8)
    got = resize_bilinear_u8(img, dst)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)
    if src == dst:
        assert got is img


def test_what_is_not_decoded_raises(tmp_path, images):
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, images["scene"])
    pal = str(tmp_path / "p.png")
    Image.fromarray(images["scene"]).convert("P").save(pal)
    rgb16 = str(tmp_path / "c16.png")
    cv2.imwrite(rgb16, images["scene"].astype(np.uint16) * 256)
    interlaced = str(tmp_path / "i.png")
    write_png(interlaced, images["noise"])
    data = bytearray(open(interlaced, "rb").read())
    data[28] = 1                   # IHDR says Adam7; the data is not interlaced
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(interlaced, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="not a PNG"):
        read_png(jpg)
    assert np.array_equal(read_png(pal), cv2.imread(pal, cv2.IMREAD_COLOR)[..., ::-1])
    assert np.array_equal(read_png(rgb16), cv2.imread(rgb16, cv2.IMREAD_UNCHANGED)[..., ::-1])
    with pytest.raises(ValueError, match="row filter|bytes of image data"):
        read_png(interlaced)
    with pytest.raises(ValueError, match="CRC"):
        data[20] ^= 1
        open(interlaced, "wb").write(bytes(data))
        read_png(interlaced)
