"""What the inference CLIs share: frame folders, a video file's frames,
frame loading and the served model.

Frames are PNG, JPEG or BMP files (`dro_sfm_torch.utils.image_io`), loaded
as the JAX CLIs load them (RGB, resized as ``cv2.resize(INTER_LINEAR)`` to
the model's shape when they are not at it, float32 in [0, 1]). A video file
(``VIDEO_EXT``) is split into such a folder by `extract_frames`, as the JAX
CLI's ``parse_video`` splits it; the port decodes MP4, MOV and AVI of
MPEG-4 Part 2 or H.264 (Constrained Baseline, Main, High) video and MJPEG AVI
(`dro_sfm_torch.utils.video_io`), and raises on the other containers of
``VIDEO_EXT`` (ROADMAP C).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp")
VIDEO_EXT = (".mp4", ".avi", ".mov", ".mpeg", ".flv", ".wmv")


def extract_frames(video: str, save_root: str, sample_rate: int = 1) -> dict:
    """Every ``sample_rate``-th frame of the video file ``video`` written
    under ``save_root`` as ``{saved:06d}.jpg`` (JPEG at quality 95, the
    bytes of ``cv2.imwrite``'s default), as the JAX CLI's ``parse_video``
    writes them. Returns the number of frames written (``frames``), the
    stream's ``fps`` and each frame's decode and encode milliseconds (host
    clock; ``decode_ms`` for every frame of the video, ``encode_ms`` for
    the written ones)."""
    from dro_sfm_torch.utils.image_io import encode_jpeg
    from dro_sfm_torch.utils.video_io import VideoReader
    os.makedirs(save_root, exist_ok=True)
    reader = VideoReader(video)
    saved, encode_ms = 0, []
    for count, frame in enumerate(reader):
        if count % sample_rate == 0:
            t0 = time.perf_counter()
            data = encode_jpeg(frame, 95)
            with open(os.path.join(save_root, f"{saved:06d}.jpg"), "wb") as f:
                f.write(data)
            encode_ms.append(1e3 * (time.perf_counter() - t0))
            saved += 1
    return {"frames": saved, "fps": reader.fps, "decode_ms": reader.decode_ms,
            "encode_ms": encode_ms}


def list_frames(folder: str, sample_rate: int = 1) -> List[str]:
    """The image files of ``folder`` in name order, every ``sample_rate``-th."""
    files = sorted(f for f in os.listdir(folder) if f.lower().endswith(IMG_EXT))
    return [os.path.join(folder, f) for f in files][::sample_rate]


class FrameLoader:
    """Frames as float32 RGB [H,W,3] in [0, 1] at ``shape``; the last three
    are kept, so that a 3-frame sliding window decodes each frame once.
    ``decode_ms`` holds the milliseconds of every decode (read, resize,
    scale)."""

    KEEP = 3

    def __init__(self, shape: Tuple[int, int]):
        self.shape = tuple(shape)
        self.cache: Dict[str, np.ndarray] = {}
        self.decode_ms: List[float] = []

    def __call__(self, path: str) -> np.ndarray:
        if path not in self.cache:
            from dro_sfm_torch.utils.image_io import read_image_rgb, resize_bilinear_u8
            t0 = time.perf_counter()
            img = resize_bilinear_u8(read_image_rgb(path), self.shape)
            self.cache[path] = img.astype(np.float32) / 255.0
            self.decode_ms.append(1e3 * (time.perf_counter() - t0))
            while len(self.cache) > self.KEEP:
                self.cache.pop(next(iter(self.cache)))
        return self.cache[path]


def open_model(checkpoint: str, device=None, image_shape=None,
               ) -> Tuple[Callable, Tuple[int, int], np.ndarray]:
    """The served model of ``checkpoint`` on ``device`` (the card unless the
    caller asks for the CPU): (infer, shape, K). ``infer(target [H,W,3],
    refs [N,H,W,3])`` returns numpy (depth [H,W], pose mats [N,4,4]);
    ``shape`` is ``image_shape`` or the config's
    ``datasets.augmentation.image_shape``; K the dummy calibration."""
    from dro_sfm_torch.data.video import dummy_calibration
    from dro_sfm_torch.inference import load_model_and_config, make_infer_fn
    net, cfg = load_model_and_config(checkpoint, device)
    if image_shape is None:
        if cfg is None:
            raise ValueError(f"{checkpoint} holds no config: pass --image-shape H W")
        image_shape = cfg.datasets.augmentation.image_shape
    shape = (int(image_shape[0]), int(image_shape[1]))
    K = dummy_calibration(shape[1], shape[0])
    fn = make_infer_fn(net, device)

    def infer(target: np.ndarray, refs: np.ndarray):
        depth, mats = fn(target[None], refs[None], K[None])
        return depth[0].cpu().numpy(), mats[0].cpu().numpy()

    return infer, shape, K
