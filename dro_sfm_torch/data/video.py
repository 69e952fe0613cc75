"""Frame folders: dummy intrinsics and file scanning.

The port's copy of the numpy helpers of `dro_sfm_tpu/data/video.py`: the
intrinsics of a video without calibration (fx = fy = 1.2 W, principal point
at the centre), the frame index of a file name, and the image files of a
directory tree. The dataset classes (video, random video, image folders)
are ROADMAP A5.
"""
from __future__ import annotations

import os
import re
from collections import defaultdict

import numpy as np

IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp")


def dummy_calibration(w: int, h: int) -> np.ndarray:
    """Intrinsics [3,3] float32 of a ``w`` x ``h`` frame without calibration."""
    return np.array([[w * 1.2, 0.0, w / 2.0],
                     [0.0, w * 1.2, h / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


def frame_index(filename: str) -> int:
    """The first number in ``filename``, or -1."""
    m = re.search(r"\d+", filename)
    return int(m.group()) if m else -1


def scan_image_tree(root_dir: str) -> dict:
    """The image files of ``root_dir`` and its subdirectories, by directory
    (files relative to it), in name order."""
    tree = defaultdict(list)
    for entry in sorted(os.scandir(root_dir), key=lambda e: e.name):
        rel = os.path.relpath(entry.path, root_dir)
        if entry.is_dir():
            sub = scan_image_tree(entry.path)
            if sub.get(entry.path):
                tree[rel] = sub[entry.path]
        elif entry.name.lower().endswith(IMG_EXT):
            tree[root_dir].append(rel)
    return tree
