"""Sample transforms: resize, originals kept, colour jitter, float images (numpy).

The port's copy of `dro_sfm_tpu/data/transforms.py`:

* train: resize (images, depth and intrinsics) -> keep pre-jitter originals
  -> colour jitter -> float arrays;
* validation/test: resize (images and intrinsics; ground-truth depth stays
  at full resolution) -> float arrays.

The intrinsics rescale is the plain ``K[0] *= out_w / w; K[1] *= out_h / h``.
Images resize bilinearly and depth by nearest neighbour, as ``cv2.resize``
with ``INTER_LINEAR`` and ``INTER_NEAREST``: uint8 bit for bit
(`dro_sfm_torch.utils.image_io`); float32 (NYU's HDF5 frames at another
``image_shape``) by `resize_linear_f32`, OpenCV 5.0.0's path for float
images of 1, 3 or 4 channels (its IPP library): weights from the double
source coordinate rounded to float32, then a horizontal and a vertical pass
of ``fma(f, b - a, a)``. That is bit for bit, but where a horizontal
enlargement puts output columns left of the first source column or right
of the last, whose rows IPP blends with other roundings (by at most 2^-24 on
images in [0, 1]). The file readers decode uint8 and convert to float after
the resize; the synthetic scenes render float images at the configured
shape.

The colour jitter follows torchvision's ColorJitter (factors uniform in
[max(0, 1-x), 1+x], hue in [-h, h]) in fixed brightness, contrast,
saturation, hue order. The JAX package computes it with OpenCV; here it is
numpy with OpenCV's arithmetic:

* float images: grey = 0.299 R + 0.587 G + 0.114 B; H in degrees [0, 360),
  S and V in [0, 1]; each with the fused multiply-adds of OpenCV's float
  vector loop (16 pixels a pass), so bit for bit where a row is a multiple
  of 16 pixels wide (every recipe's width); its scalar and IPP paths, which
  take the other pixels, round elsewhere, by an ulp;
* uint8 images (`_jitter_once_u8`): look-up tables for brightness and
  contrast, ``cv2.mean``, grey ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``,
  ``cv2.addWeighted`` (``fma(a, alpha, b * beta)`` in float32, rounded half to
  even and saturated), RGB -> HSV with H in [0, 180) and OpenCV's 12-bit
  division tables, the hue table, and HSV -> RGB in float32 with OpenCV's
  fused multiply-adds, truncated to uint8 in OpenCV's vector loop (whole
  blocks of 32 pixels of a row) and rounded in the rest of the row.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dro_sfm_torch.data.base import Sample
from dro_sfm_torch.utils.image_io import resize_bilinear_u8, resize_nearest

FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# cv2's HSV2RGB: for each hue sector, which of (v, v(1-s), v(1-sf), v(1-s(1-f)))
# is blue, green and red.
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                        [2, 1, 0]])
# The OpenCV build whose uint8 arithmetic `rgb_to_gray_u8` and
# `hsv_to_rgb_u8` copy: 5.0.0 on x86-64 (baseline SSE3, dispatch up to
# AVX512_SKX). Its RGB2GRAY has 15-bit weights, where OpenCV 4 has
# ``(4899 R + 9617 G + 1868 B + 2^13) >> 14``, and its vector uint8 HSV2RGB
# takes `_HSV2RGB_BLOCK` pixels of a row a pass. Another build may round
# other pixels.
OPENCV_COPIED = "5.0.0"
# Pixels of a row in one pass of that build's vector uint8 HSV2RGB.
_HSV2RGB_BLOCK = 32
# cv2's uint8 RGB2HSV division tables (hsv_shift = 12).
_HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I)]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I))]).astype(np.int32)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 is exact in float64, and the sum rounds to
    float32."""
    return (np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
            + np.asarray(c, np.float32)).astype(np.float32)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[..., 3] float32 RGB -> [...] grey as cv2's float RGB2GRAY's vector
    loop: ``fma(B, 0.114, fma(R, 0.299, G * 0.587))``."""
    f = np.float32
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return _fma32(b, f(0.114), _fma32(r, f(0.299), g * f(0.587)))


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """[..., 3] float32 RGB -> HSV as cv2's float RGB2HSV's vector loop: H
    in degrees [0, 360) as one fused ``(x - y) * (60 / (diff + eps)) +
    offset`` (offset 360 where H would be negative), S = (V - min) / (V +
    eps), V = max."""
    f = np.float32
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + FLT_EPSILON)
    r_max, g_max = v == r, v == g
    x = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    offset = np.where(r_max, np.where(g < b, f(360.0), f(0.0)),
                      np.where(g_max, f(120.0), f(240.0)))
    h = _fma32(x, f(60.0) / (diff + FLT_EPSILON), offset)
    return np.stack([h, s, v], axis=-1).astype(f, copy=False)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of `rgb_to_hsv`, as cv2's float HSV2RGB's vector loop: the
    sector from the truncated ``H * 6/360`` and the table ``v, v(1-s),
    v fma(-s, f, 1), v fma(-s, 1-f, 1)``."""
    f, one = np.float32, np.float32(1.0)
    h = hsv[..., 0] * f(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    pre = np.trunc(h)
    sector = (pre - np.trunc(pre * f(1.0 / 6.0)) * f(6.0)).astype(np.int64) % 6
    frac = (h - pre).astype(f)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, frac, one),
                    v * _fma32(-s, (one - frac).astype(f), one)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)
    return bgr[..., ::-1].astype(f)


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] RGB -> uint8 [...] grey, as cv2's uint8 RGB2GRAY."""
    x = img.astype(np.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + (1 << 14))
            >> 15).astype(np.uint8)


def add_weighted_u8(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, 0.0)`` on uint8."""
    prod = b.astype(np.float32) * np.float32(beta)
    t = _fma32(a.astype(np.float32), np.float32(alpha), prod)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 HSV as cv2's RGB2HSV: H in [0, 180)."""
    x = img.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV [H,W,3] (H in [0, 180)) -> uint8 RGB as cv2's HSV2RGB: the
    float result is truncated in whole blocks of `_HSV2RGB_BLOCK` pixels of
    a row (OpenCV's vector loop) and rounded in the rest of the row."""
    f32, one = np.float32, np.float32(1.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.trunc(h)
    h = (h - sector).astype(f32)
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one),
                    v * _fma32(-s, (one - h).astype(f32), one)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)
    out = (bgr[..., ::-1] * f32(255.0)).astype(f32)
    tail = np.arange(out.shape[-2]) >= out.shape[-2] // _HSV2RGB_BLOCK * _HSV2RGB_BLOCK
    out = np.where(tail[:, None], np.rint(out), np.trunc(out))
    return np.clip(out, 0, 255).astype(np.uint8)


def _linear_taps_f32(n_in: int, n_out: int):
    """The INTER_LINEAR taps of one axis of a float image: the two source
    indices (clipped to the image) and the second's float32 weight, the
    fraction of the double coordinate ``(i + 0.5) * n_in / n_out - 0.5``
    (0 where it lies before the first sample or from the last on)."""
    d = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(d)
    f = (d - s).astype(np.float32)
    s = s.astype(np.int64)
    f[(s < 0) | (s >= n_in - 1)] = 0
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def resize_linear_f32(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """float32 [H,W] or [H,W,C] -> [h,w(,C)] (``shape`` = (h, w)) as
    ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` (module
    docstring): each row interpolated along x, then the rows along y, each
    step ``fma(f, b - a, a)``."""
    h, w = int(shape[0]), int(shape[1])
    x0, x1, fx = _linear_taps_f32(img.shape[1], w)
    y0, y1, fy = _linear_taps_f32(img.shape[0], h)
    tail = [1] * (img.ndim - 2)
    fx, fy = fx.reshape(1, -1, *tail), fy.reshape(-1, 1, *tail)
    rows = _fma32(fx, img[:, x1] - img[:, x0], img[:, x0])
    return _fma32(fy, rows[y1] - rows[y0], rows[y0])


def _resize_rgb(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    if img.shape[:2] == tuple(shape):
        return img
    if img.dtype == np.float32:
        return resize_linear_f32(img, shape)
    return resize_bilinear_u8(img, shape)


def _resize_depth(depth: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    if depth.shape[:2] == tuple(shape):
        return depth
    return resize_nearest(depth[..., 0], shape)[..., None]


def resize_sample(sample: Sample, shape: Tuple[int, int],
                  with_depth: bool = True) -> Sample:
    """Resize the images (and depth for training) and rescale the
    intrinsics."""
    h, w = sample["rgb"].shape[:2]
    out_h, out_w = shape
    if (h, w) != (out_h, out_w):
        K = sample["intrinsics"].copy()
        K[0] *= out_w / w
        K[1] *= out_h / h
        sample["intrinsics"] = K
        sample["rgb"] = _resize_rgb(sample["rgb"], shape)
        sample["rgb_context"] = np.stack(
            [_resize_rgb(im, shape) for im in sample["rgb_context"]])
        if with_depth and "depth" in sample:
            sample["depth"] = _resize_depth(sample["depth"], shape)
    return sample


def _to_float_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1]; float input passes through."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.asarray(img, np.float32)


def duplicate_sample(sample: Sample) -> Sample:
    """Keep pre-jitter copies of the images, as float."""
    for key in ("rgb", "rgb_context"):
        img = sample[key]
        sample[key + "_original"] = (_to_float_rgb(img) if img.dtype == np.uint8
                                     else img.copy())
    return sample


def float_sample(sample: Sample) -> Sample:
    for key in ("rgb", "rgb_context"):
        sample[key] = _to_float_rgb(sample[key])
    return sample


def _jitter_once(img: np.ndarray, b: float, c: float, s: float,
                 h: float) -> np.ndarray:
    """Brightness, contrast, saturation and hue factors on [H,W,3] in [0,1]."""
    out = np.clip(img * b, 0.0, 1.0)
    mean = float(out.mean())
    out = np.clip(out * c + mean * (1.0 - c), 0.0, 1.0)
    gray = rgb_to_gray(out.astype(np.float32, copy=False))[..., None]
    out = np.clip(out * s + gray * (1.0 - s), 0.0, 1.0)
    if h != 0.0:
        hsv = rgb_to_hsv(out.astype(np.float32))
        hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
        out = hsv_to_rgb(hsv)
    return np.clip(out, 0.0, 1.0)


def _jitter_once_u8(img: np.ndarray, b: float, c: float, s: float,
                    h: float) -> np.ndarray:
    """The same factors on uint8 [H,W,3], in uint8 steps."""
    lut = np.arange(256, dtype=np.float32)
    out = np.clip(lut * b, 0, 255).astype(np.uint8)[img]
    sums = out.reshape(-1, 3).sum(axis=0, dtype=np.int64)
    scale = 1.0 / (out.shape[0] * out.shape[1])             # cv2.mean
    mean = float(sum(float(v) * scale for v in sums) / 3.0)
    out = np.clip(lut * c + mean * (1.0 - c), 0, 255).astype(np.uint8)[out]
    gray = rgb_to_gray_u8(out)
    out = add_weighted_u8(out, s, np.repeat(gray[..., None], 3, axis=-1), 1.0 - s)
    if h != 0.0:
        hsv = rgb_to_hsv_u8(out)
        shift = int(round(h * 180.0)) % 180
        hsv[..., 0] = ((np.arange(256) + shift) % 180).astype(np.uint8)[hsv[..., 0]]
        out = hsv_to_rgb_u8(hsv)
    return out


def colorjitter_sample(sample: Sample, jitter: Sequence[float],
                       rng: np.random.Generator) -> Sample:
    """One random colour jitter shared by target and context (not the
    originals)."""
    brightness, contrast, saturation, hue = jitter
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    fn = _jitter_once_u8 if sample["rgb"].dtype == np.uint8 else _jitter_once
    sample["rgb"] = fn(sample["rgb"], b, c, s, h)
    sample["rgb_context"] = np.stack(
        [fn(im, b, c, s, h) for im in sample["rgb_context"]])
    return sample


def train_transform(sample: Sample, image_shape: Tuple[int, int],
                    jittering: Sequence[float],
                    rng: Optional[np.random.Generator] = None) -> Sample:
    """The training pipeline."""
    if image_shape:
        sample = resize_sample(sample, image_shape, with_depth=True)
    sample = duplicate_sample(sample)
    if jittering and rng is not None:
        sample = colorjitter_sample(sample, jittering, rng)
    return float_sample(sample)


def eval_transform(sample: Sample, image_shape: Tuple[int, int]) -> Sample:
    """The validation and test pipeline: ground-truth depth stays at full
    resolution for the metrics."""
    if image_shape:
        sample = resize_sample(sample, image_shape, with_depth=False)
    return float_sample(sample)
