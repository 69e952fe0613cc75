"""A labelled grid of image panels, and its GIF and video files.

The port's counterpart of `dro_sfm_tpu/visualization/image_grid.py`:
`ImageGrid` pastes equally sized panels (resized as ``cv2.resize`` does,
`resize_bilinear_u8`) into a canvas, each label drawn by
`dro_sfm_torch.visualization.draw`; `write_gif` and `write_video` write a
sequence of frames as an animated GIF and as ``mp4v`` video, as the JAX
package writes them (`dro_sfm_torch.utils.video_io`).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from dro_sfm_torch.utils.image_io import read_image_rgb, resize_bilinear_u8
from dro_sfm_torch.utils.video_io import VideoWriter
from dro_sfm_torch.utils.video_io import write_gif as _write_gif
from dro_sfm_torch.visualization.draw import put_text


def as_rgb_u8(image: np.ndarray) -> np.ndarray:
    """uint8 RGB [H,W,3] of a uint8 image or a float one in [0, 1], gray
    repeated to three channels."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


class ImageGrid:
    """Compose equally sized panels into a labelled grid canvas."""

    def __init__(self, rows: int, cols: int, cell_h: int, cell_w: int,
                 pad: int = 4, background: int = 32):
        self.rows, self.cols = rows, cols
        self.cell_h, self.cell_w = cell_h, cell_w
        self.pad = pad
        h = rows * cell_h + (rows + 1) * pad
        w = cols * cell_w + (cols + 1) * pad
        self.canvas = np.full((h, w, 3), background, dtype=np.uint8)

    def set_cell(self, row: int, col: int, image: np.ndarray,
                 label: Optional[str] = None) -> None:
        img = resize_bilinear_u8(as_rgb_u8(image), (self.cell_h, self.cell_w))
        if label:
            img = img.copy()
            put_text(img, label, (6, 18), 0.5, (255, 255, 255))
        y = self.pad + row * (self.cell_h + self.pad)
        x = self.pad + col * (self.cell_w + self.pad)
        self.canvas[y:y + self.cell_h, x:x + self.cell_w] = img


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int = 10) -> None:
    """Animated GIF of RGB frames (uint8, or float in [0, 1]), looping."""
    _write_gif(path, [as_rgb_u8(f) for f in frames], int(1000 / fps), loop=0)


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 10) -> None:
    """mp4v video of RGB frames (uint8, or float in [0, 1]) at ``path``, as
    OpenCV's writer gives it (`VideoWriter`: ``.mp4``, ``.m4v``, ``.mov`` or
    ``.avi``)."""
    with VideoWriter(path, fps) as writer:
        for f in frames:
            writer.write(as_rgb_u8(f))


def frames_from_folder(folder: str, ext=(".png", ".jpg")) -> List[np.ndarray]:
    """The images of ``folder`` with an extension in ``ext``, in name order,
    as uint8 RGB."""
    return [read_image_rgb(os.path.join(folder, name)) for name in sorted(os.listdir(folder))
            if name.lower().endswith(ext)]
