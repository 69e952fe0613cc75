"""Frame folders: videos and image folders without calibration or ground truth.

The port's copy of `dro_sfm_tpu/data/video.py`: directories of sequential
frames (PNG, JPEG or BMP), each frame's context by frame order at a stride,
dummy intrinsics (fx = fy = 1.2 W, principal point at the centre), no depth
or pose: the self-supervised input path. `VideoRandomDataset` draws the
stride of each item from [1, max_stride]; `ImageDataset` reads flat image
folders the same way.
"""
from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.kitti import load_image_rgb
from dro_sfm_torch.data.transforms import eval_transform, train_transform

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


class VideoDataset:
    """Sequential frames grouped by folder; context by frame order at the
    first stride; dummy intrinsics."""

    def __init__(self, root_dir: str, split: str = "", mode: str = "train",
                 back_context: int = 1, forward_context: int = 1,
                 strides: Sequence[int] = (1,),
                 image_shape=None, jittering=(), **kwargs):
        self.root_dir = root_dir
        self.mode = mode
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.backward_context = back_context
        self.forward_context = forward_context
        self.stride = strides[0] if strides else 1

        tree = scan_image_tree(root_dir)
        self.tree = {folder: sorted(names, key=frame_index)
                     for folder, names in tree.items()}
        self.samples = []  # (folder, target name, [context names...])
        for folder, names in self.tree.items():
            b, f, s = back_context, forward_context, self.stride
            for i in range(b * s, len(names) - f * s):
                ctx = [names[i + o * s] for o in range(-b, 0)] + \
                      [names[i + o * s] for o in range(1, f + 1)]
                self.samples.append((folder, names[i], ctx))

    def __len__(self):
        return len(self.samples)

    def _context(self, idx: int):
        return self.samples[idx][2]

    def __getitem__(self, idx: int) -> Sample:
        folder, target, _ = self.samples[idx]
        ctx = self._context(idx)
        base = (self.root_dir if folder == self.root_dir
                else os.path.join(self.root_dir, folder))
        image = load_image_rgb(os.path.join(base, target))
        h, w = image.shape[:2]
        sample: Sample = {
            "idx": idx,
            "filename": f"{os.path.basename(folder)}_{os.path.splitext(target)[0]}",
            "rgb": image,
            "rgb_context": np.stack(
                [load_image_rgb(os.path.join(base, c)) for c in ctx]),
            "intrinsics": dummy_calibration(w, h),
        }
        if self.mode == "train":
            rng = sample_rng(self, folder, target)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())


class VideoRandomDataset(VideoDataset):
    """The context stride of each item drawn from [1, max_stride] (seeded by
    the index), 1 where that stride leaves the folder."""

    def __init__(self, *args, max_stride: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_stride = max_stride

    def _context(self, idx: int):
        rng = np.random.default_rng(idx)
        folder, target, _ = self.samples[idx]
        names = self.tree[folder]
        i = names.index(target)
        s = int(rng.integers(1, self.max_stride + 1))
        b, f = self.backward_context, self.forward_context
        if i - b * s < 0 or i + f * s >= len(names):
            s = 1
        return [names[i + o * s] for o in range(-b, 0)] + \
               [names[i + o * s] for o in range(1, f + 1)]


class ImageDataset(VideoDataset):
    """Flat image folders with integer-indexed file names, read as
    `VideoDataset` reads them."""


def _video_factory(cls):
    def factory(path, split, mode, image_shape, jittering, section):
        return cls(
            root_dir=path, split=split, mode=mode,
            back_context=section.back_context,
            forward_context=section.forward_context,
            strides=tuple(section.strides),
            image_shape=image_shape,
            jittering=jittering if mode == "train" else ())
    return factory


DATASETS = {"Video": _video_factory(VideoDataset),
            "Video_Random": _video_factory(VideoRandomDataset),
            "Image": _video_factory(ImageDataset)}
