"""The port's uint8 resizes and jitter against OpenCV and the JAX package (CPU).

`resize_bilinear_u8` equals ``cv2.resize(INTER_LINEAR)`` bit for bit
(tolerance 0) at the shapes of the configs (480x640 -> 240x320, an exact 2x
reduction that OpenCV sends to ``INTER_AREA``, and -> 384x512; KITTI's
375x1242 -> 320x960 and -> 192x640), on upscales and on odd sizes, with one,
three and four channels; `resize_nearest` equals ``INTER_NEAREST`` on float
depth. `_jitter_once_u8` equals the JAX package's (OpenCV's LUT, mean,
RGB2GRAY, addWeighted, RGB2HSV, HSV2RGB) for the same factors, on widths
inside and outside OpenCV's 32-pixel vector blocks; `train_transform` and
`eval_transform` on uint8 samples equal JAX's for the same generator seed.
The float path of the synthetic scenes is unchanged: no resize, no uint8
step, the float jitter of `_jitter_once`; a float image of another shape
(NYU's frames at another ``image_shape``) resizes as the JAX package's
``cv2.resize`` does (`resize_linear_f32`, OpenCV 5.0.0's float path), on the
configs' shapes, downscales and upscales, one, three and four channels. The
bar: bit for bit, except the output columns of a horizontal enlargement
that lie left of the first source column or right of the last, where
OpenCV's library blends with other roundings: there within 2^-24 (measured
up to 2^-24 on these frames).
"""
import cv2
import numpy as np
import pytest

from dro_sfm_tpu.data import transforms as jt
from dro_sfm_torch.data import transforms as tt
from dro_sfm_torch.utils.image_io import resize_bilinear_u8, resize_nearest

RESIZES = [((480, 640), (240, 320)), ((480, 640), (384, 512)), ((375, 1242), (320, 960)),
           ((375, 1242), (192, 640)), ((48, 64), (96, 128)), ((17, 23), (48, 80)),
           ((5, 3), (40, 31)), ((1, 1), (4, 4)), ((101, 99), (33, 34)), ((64, 64), (16, 16)),
           ((30, 41), (20, 64)), ((7, 9), (5, 3))]


def scene(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (7 * xx + 3 * yy) % 256], -1)
    return np.clip(base + rng.integers(-50, 51, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src, dst", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_bilinear_equals_opencv(src, dst):
    img = scene(*src)
    for x in (img, img[..., 1], np.concatenate([img, img[..., :1]], -1)):
        got = resize_bilinear_u8(np.ascontiguousarray(x), dst)
        want = cv2.resize(np.ascontiguousarray(x), (dst[1], dst[0]),
                          interpolation=cv2.INTER_LINEAR)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_bilinear_random_shapes_equal_opencv():
    rng = np.random.default_rng(3)
    for _ in range(60):
        src, dst = rng.integers(1, 90, 2), rng.integers(1, 90, 2)
        img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
        assert np.array_equal(resize_bilinear_u8(img, dst),
                              cv2.resize(img, (int(dst[1]), int(dst[0])),
                                         interpolation=cv2.INTER_LINEAR)), (src, dst)


@pytest.mark.parametrize("src, dst", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_nearest_equals_opencv(src, dst):
    depth = np.random.default_rng(1).uniform(0, 80, src).astype(np.float32)
    assert np.array_equal(resize_nearest(depth, dst),
                          cv2.resize(depth, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))
    assert np.array_equal(tt._resize_depth(depth[..., None], dst),
                          jt._resize_depth(depth[..., None], dst))


@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (5, 100), (24, 31)])
def test_jitter_u8_equals_jax(shape):
    rng = np.random.default_rng(shape[1])
    img = scene(*shape, seed=shape[0])
    for k in range(40):
        b, c, s = rng.uniform(0.5, 1.5, 3)
        h = 0.0 if k % 4 == 0 else rng.uniform(-0.2, 0.2)
        assert np.array_equal(tt._jitter_once_u8(img, b, c, s, h),
                              jt._jitter_once_u8(img, b, c, s, h)), (b, c, s, h)


def test_color_conversions_equal_opencv():
    # Rows of 3999 pixels: 124 of OpenCV's 32-pixel vector blocks and a tail of 31.
    img = np.random.default_rng(9).integers(0, 256, (256, 3999, 3), dtype=np.uint8)
    build = (f"the port copies OpenCV {tt.OPENCV_COPIED}'s uint8 arithmetic; this is "
             f"OpenCV {cv2.__version__}")
    assert np.array_equal(tt.rgb_to_gray_u8(img),
                          cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)), build
    assert np.array_equal(tt.rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV)), build
    hsv = img.copy()
    hsv[..., 0] %= 180
    assert np.array_equal(tt.hsv_to_rgb_u8(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)), build


def u8_sample(h, w, n=2, depth=True):
    rng = np.random.default_rng(h * w)
    sample = {"idx": 0, "filename": "x", "rgb": scene(h, w, 1),
              "rgb_context": np.stack([scene(h, w, 2 + i) for i in range(n)]),
              "intrinsics": np.array([[50, 0, w / 2], [0, 50, h / 2], [0, 0, 1]], np.float32),
              "pose_context": rng.normal(size=(n, 4, 4)).astype(np.float32)}
    if depth:
        sample["depth"] = rng.uniform(0, 10, (h, w, 1)).astype(np.float32)
    return sample


def same(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("src, dst", [((48, 64), (24, 32)), ((75, 124), (64, 96)),
                                      ((48, 64), (48, 64))])
def test_train_and_eval_transform_equal_jax(src, dst):
    for seed in range(4):
        got = tt.train_transform(u8_sample(*src), dst, (0.2, 0.2, 0.2, 0.05),
                                 np.random.default_rng(seed))
        want = jt.train_transform(u8_sample(*src), dst, (0.2, 0.2, 0.2, 0.05),
                                  np.random.default_rng(seed))
        same(got, want)
        assert got["rgb"].shape == (*dst, 3) and got["depth"].shape == (*dst, 1)
    got, want = tt.eval_transform(u8_sample(*src), dst), jt.eval_transform(u8_sample(*src), dst)
    same(got, want)
    assert got["depth"].shape == (*src, 1)


def test_float_path_of_the_synthetic_scenes_is_unchanged():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    ctx = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    K = np.eye(3, dtype=np.float32)
    out = tt.train_transform({"rgb": rgb.copy(), "rgb_context": ctx.copy(), "intrinsics": K},
                             (24, 32), (0.2, 0.2, 0.2, 0.05), np.random.default_rng(5))
    draw = np.random.default_rng(5)
    b, c, s = (draw.uniform(0.8, 1.2) for _ in range(3))
    h = draw.uniform(-0.05, 0.05)
    assert np.array_equal(out["rgb_original"], rgb) and np.array_equal(out["intrinsics"], K)
    assert np.array_equal(out["rgb"], tt._jitter_once(rgb, b, c, s, h).astype(np.float32))
    assert np.array_equal(out["rgb_context"],
                          np.stack([tt._jitter_once(x, b, c, s, h) for x in ctx]))
    ev = tt.eval_transform({"rgb": rgb.copy(), "rgb_context": ctx.copy(), "intrinsics": K},
                           (24, 32))
    assert np.array_equal(ev["rgb"], rgb) and ev["rgb"].dtype == np.float32
    got = tt.eval_transform({"rgb": rgb, "rgb_context": ctx, "intrinsics": K}, (12, 16))
    want = jt.eval_transform({"rgb": rgb.copy(), "rgb_context": ctx.copy(), "intrinsics": K},
                             (12, 16))
    for key in ("rgb", "rgb_context", "intrinsics"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


FLOAT_RESIZES = [((480, 640), (240, 320)), ((480, 640), (192, 256)), ((480, 640), (228, 304)),
                 ((480, 640), (256, 320)), ((480, 640), (481, 641)), ((480, 640), (960, 1280)),
                 ((48, 64), (100, 700)), ((17, 23), (48, 80)), ((101, 99), (33, 34)),
                 ((5, 3), (40, 31)), ((30, 41), (20, 64))]


@pytest.mark.parametrize("src, dst", FLOAT_RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_float_resize_equals_opencv(src, dst):
    """NYU-like float frames (uint8 / 255) and uniform noise."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    nyu = (scene(*src).astype(np.float32) / np.float32(255)).astype(np.float32)
    noise = rng.uniform(0, 1, (*src, 4)).astype(np.float32)
    edge = np.zeros(dst[1], bool)                       # columns outside the source's span
    x = (np.arange(dst[1]) + 0.5) * (src[1] / dst[1]) - 0.5
    edge[(x < 0) | (np.floor(x) >= src[1] - 1)] = dst[1] > src[1]
    for img in (nyu, nyu[..., 0], noise, noise[..., :3]):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = tt.resize_linear_f32(img, dst)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got[:, ~edge], want[:, ~edge])
        assert np.abs(got[:, edge] - want[:, edge]).max(initial=0) <= 2.0 ** -24
    sample = {"rgb": nyu, "rgb_context": np.stack([nyu, nyu[::-1].copy()]),
              "intrinsics": np.eye(3, dtype=np.float32)}
    got = tt.eval_transform({k: v.copy() for k, v in sample.items()}, dst)
    want = jt.eval_transform({k: v.copy() for k, v in sample.items()}, dst)
    assert np.array_equal(got["intrinsics"], want["intrinsics"])
    assert np.array_equal(got["rgb"][:, ~edge], want["rgb"][:, ~edge])
    assert np.abs(got["rgb_context"] - want["rgb_context"]).max() <= 2.0 ** -24
