"""The port's baseline JPEG encoder against ``cv2.imencode`` (CPU), byte
for byte.

``encode_jpeg`` (the host codec, ``csrc/image_codec.cpp``) must write the
bytes of ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, q])`` at the
default quality 95 and at 75 (and at 100, 50 and 1, where the tables
saturate), on rendered frames, noise, flat and smooth images, and sizes that are not multiples of 16 (dummy blocks at the right and
bottom edges, an odd last row). Tolerance: none. The port's decoder reads
the stream back as OpenCV reads it.
"""
import cv2
import numpy as np
import pytest

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.utils.image_io import decode_jpeg, encode_jpeg


def images():
    rng = np.random.default_rng(0)
    data = SyntheticDataset(SyntheticConfig(height=96, width=160, num_planes=3))
    planes, _ = data._scene(0)
    rgb, _ = data._render(planes, np.eye(4))
    out = {"scene": (rgb * 255).astype(np.uint8)}
    for h, w in [(1, 1), (8, 8), (16, 16), (17, 23), (31, 33), (9, 100), (37, 45)]:
        out[f"noise{h}x{w}"] = rng.integers(0, 256, (h, w, 3), np.uint8)
    out["smooth"] = np.linspace(0, 255, 40 * 50 * 3).reshape(40, 50, 3).astype(np.uint8)
    out["black"] = np.zeros((20, 30, 3), np.uint8)
    out["white"] = np.full((20, 30, 3), 255, np.uint8)
    return out


IMAGES = images()


@pytest.mark.parametrize("quality", [95, 75, 100, 50, 1])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_bytes_equal_opencv(name, quality):
    img = IMAGES[name]
    want = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    got = encode_jpeg(img, quality)
    assert got == want
    assert np.array_equal(decode_jpeg(got), cv2.imdecode(np.frombuffer(want, np.uint8),
                                                         cv2.IMREAD_COLOR)[..., ::-1])


def test_default_quality_and_refusals():
    img = IMAGES["scene"]
    assert encode_jpeg(img) == encode_jpeg(img, 95)
    for bad in (img.astype(np.float32), img[..., :2], img[..., 0], np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises((ValueError, NotImplementedError)):
            encode_jpeg(bad)
