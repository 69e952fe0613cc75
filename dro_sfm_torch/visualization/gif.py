"""Animated GIFs of image sequences, with labels.

The port's counterpart of `dro_sfm_tpu/visualization/gif.py`: frames from a
folder, a glob or a list (paths or arrays: uint8, or float in [0, 1]), each
optionally labelled in its top-left corner and scaled, written as a looping
GIF (`dro_sfm_torch.utils.video_io.write_gif`). Three things differ from
the JAX package, which draws with Pillow: the label is drawn with the port's
OpenCV font (`draw.put_text`, scale 0.45) on a black box fitted to it, not
with Pillow's default bitmap font; ``scale`` resizes bilinearly
(`resize_bilinear_u8`) where Pillow resizes bicubically; and frames of
more than 256 colours go through the port's median-cut quantizer. There is
no Pillow image input.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Union

import numpy as np

from dro_sfm_torch.utils.image_io import read_image_rgb, resize_bilinear_u8
from dro_sfm_torch.utils.video_io import write_gif
from dro_sfm_torch.visualization.draw import get_text_size, put_text

Frames = Union[str, Sequence[Union[str, np.ndarray]]]
IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp")
LABEL_SCALE = 0.45
LABEL_COLOR = (255, 255, 64)


def _to_image(frame, scale: float) -> np.ndarray:
    if isinstance(frame, str):
        img = read_image_rgb(frame)
    else:
        img = np.asarray(frame)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = np.ascontiguousarray(img[..., :3])
    if scale != 1.0:
        h, w = img.shape[:2]
        img = resize_bilinear_u8(img, (max(1, int(h * scale)), max(1, int(w * scale))))
    return img


def draw_label(img: np.ndarray, label: str) -> None:
    """``label`` in yellow on a black box at the top-left corner."""
    (tw, _), _ = get_text_size(label, LABEL_SCALE)
    img[4:min(23, img.shape[0]), 4:min(10 + tw, img.shape[1])] = 0
    put_text(img, label, (8, 18), LABEL_SCALE, LABEL_COLOR)


def images_to_gif(frames: Frames, out_path: str, fps: float = 10.0,
                  labels: Optional[Sequence[str]] = None,
                  scale: float = 1.0, loop: int = 0) -> int:
    """Write ``frames`` as an animated GIF; returns the frame count.
    ``frames`` is a folder or a glob of image files, or a list of paths and
    HxWx3 arrays; ``labels`` gives frame ``i`` the tag ``labels[i]``."""
    if isinstance(frames, str):
        pattern = os.path.join(frames, "*") if os.path.isdir(frames) else frames
        frames = sorted(p for p in glob.glob(pattern)
                        if os.path.splitext(p)[1].lower() in IMG_EXT)
    imgs: List[np.ndarray] = []
    for i, frame in enumerate(frames):
        img = _to_image(frame, scale)
        if labels is not None and i < len(labels) and labels[i]:
            img = img.copy()
            draw_label(img, labels[i])
        imgs.append(img)
    if not imgs:
        raise ValueError(f"no frames for gif: {out_path}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return write_gif(out_path, imgs, int(1000.0 / max(fps, 0.1)), loop=loop)
