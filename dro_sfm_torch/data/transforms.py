"""Sample transforms: originals kept, colour jitter, float images (numpy).

The port's copy of the float path of `dro_sfm_tpu/data/transforms.py`:

* train: keep pre-jitter originals -> colour jitter -> float arrays;
* validation/test: float arrays.

The colour jitter follows torchvision's ColorJitter (factors uniform in
[max(0, 1-x), 1+x], hue in [-h, h]) in fixed brightness, contrast,
saturation, hue order. The JAX package computes the grey image and the
RGB <-> HSV round trip of the hue step with OpenCV; here they are numpy with
OpenCV's float conventions: grey = 0.299 R + 0.587 G + 0.114 B; H in degrees
[0, 360), S and V in [0, 1].

Resizing and uint8 images are not ported (ROADMAP A5, with the dataset file
readers): the synthetic scenes render at the configured image shape, and a
sample of another shape or a uint8 image raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dro_sfm_torch.data.base import Sample

FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
_NOT_PORTED = ("are not ported yet: they come with the dataset file readers "
               "(ROADMAP A5)")
# cv2's HSV2RGB: for each hue sector, which of (v, v(1-s), v(1-sf), v(1-s(1-f)))
# is blue, green and red.
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                        [2, 1, 0]])


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[..., 3] float32 RGB -> [...] grey, cv2's RGB2GRAY weights."""
    f = np.float32
    return (img[..., 0] * f(0.299) + img[..., 1] * f(0.587)
            + img[..., 2] * f(0.114))


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """[..., 3] float32 RGB -> HSV as cv2's float RGB2HSV: H in degrees
    [0, 360), S = (V - min) / (V + eps), V = max."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + FLT_EPSILON)
    diff = np.float32(60.0) / (diff + FLT_EPSILON)
    h = np.where(v == r, (g - b) * diff,
                 np.where(v == g, (b - r) * diff + np.float32(120.0),
                          (r - g) * diff + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32, copy=False)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of `rgb_to_hsv`, as cv2's float HSV2RGB."""
    h = hsv[..., 0] * np.float32(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))],
                   axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)
    return bgr[..., ::-1].astype(np.float32)


def _check_float(img: np.ndarray) -> None:
    if img.dtype == np.uint8:
        raise NotImplementedError(f"uint8 images and their jitter {_NOT_PORTED}")


def check_shape(sample: Sample, shape: Tuple[int, int]) -> Sample:
    """``sample`` unchanged when its images have ``shape``; else raise."""
    if shape and sample["rgb"].shape[:2] != tuple(shape):
        raise NotImplementedError(
            f"a {sample['rgb'].shape[:2]} sample for image_shape {tuple(shape)}: "
            f"resizes {_NOT_PORTED}")
    return sample


def duplicate_sample(sample: Sample) -> Sample:
    """Keep pre-jitter copies of the images."""
    sample["rgb_original"] = sample["rgb"].copy()
    sample["rgb_context_original"] = sample["rgb_context"].copy()
    return sample


def float_sample(sample: Sample) -> Sample:
    for key in ("rgb", "rgb_context"):
        _check_float(sample[key])
        sample[key] = np.asarray(sample[key], np.float32)
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


def colorjitter_sample(sample: Sample, jitter: Sequence[float],
                       rng: np.random.Generator) -> Sample:
    """One random colour jitter shared by target and context (not the
    originals)."""
    brightness, contrast, saturation, hue = jitter
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    _check_float(sample["rgb"])
    sample["rgb"] = _jitter_once(sample["rgb"], b, c, s, h)
    sample["rgb_context"] = np.stack(
        [_jitter_once(im, b, c, s, h) for im in sample["rgb_context"]])
    return sample


def train_transform(sample: Sample, image_shape: Tuple[int, int],
                    jittering: Sequence[float],
                    rng: Optional[np.random.Generator] = None) -> Sample:
    """The training pipeline."""
    sample = duplicate_sample(check_shape(sample, image_shape))
    if jittering and rng is not None:
        sample = colorjitter_sample(sample, jittering, rng)
    return float_sample(sample)


def eval_transform(sample: Sample, image_shape: Tuple[int, int]) -> Sample:
    """The validation and test pipeline."""
    return float_sample(check_shape(sample, image_shape))
