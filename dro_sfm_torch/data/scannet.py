"""ScanNet readers: the train/val reader and the paired test reader.

The port's copy of `dro_sfm_tpu/data/scannet.py`: the scene/color, depth,
pose and intrinsic directory layout; millimetre PNG depth in metres with
invalid pixels at -1, resized to the image by nearest neighbour; every 5th
frame of the split; relative poses ``inv(ctx_pose) @ pose``. The split file
lies beside the data root.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.kitti import (
    invert_pose_numpy,
    load_image_rgb,
    read_depth_png,
    read_matrix_txt,
)
from dro_sfm_torch.data.transforms import eval_transform, train_transform
from dro_sfm_torch.utils.image_io import resize_nearest


def read_png_depth_mm(path: str) -> np.ndarray:
    """uint16 PNG in millimetres -> metres [H,W,1]; invalid (0) -> -1."""
    depth_png = read_depth_png(path)
    depth = depth_png.astype(np.float32) / 1000.0
    depth[depth_png == 0] = -1.0
    return depth[..., None]


def depth_at_image_size(depth: np.ndarray, image: np.ndarray) -> np.ndarray:
    """``depth`` [h,w,1] resized to the image's size by nearest neighbour."""
    if depth.shape[:2] == image.shape[:2]:
        return depth
    return resize_nearest(depth[..., 0], image.shape[:2])[..., None]


class ScannetDataset:
    """ScanNet train/val reader."""

    def __init__(self, root_dir: str, split: str, mode: str = "train",
                 depth_type: Optional[str] = "groundtruth",
                 back_context: int = 0, forward_context: int = 0,
                 strides: Sequence[int] = (1,), downsample: int = 5,
                 image_shape=None, jittering=()):
        if tuple(strides) != (1,):
            raise ValueError(f"ScannetDataset only supports stride 1, not {strides}")
        self.root_dir = root_dir
        self.mode = mode
        self.with_depth = bool(depth_type)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.backward_context = back_context
        self.forward_context = forward_context

        split_path = (split if os.path.isabs(split)
                      else os.path.join(os.path.dirname(root_dir), split))
        self.file_tree = defaultdict(list)
        with open(split_path) as f:
            for line in f:
                if line.strip():
                    scene, filename = line.split()
                    self.file_tree[scene].append(filename)
        for k in self.file_tree:
            self.file_tree[k] = self.file_tree[k][::downsample]

        self.files = []
        for scene, names in self.file_tree.items():
            for fname in names:
                if self._has_context(fname, names):
                    self.files.append((scene, fname))

    def _context_names(self, filename: str, file_list):
        fidx = file_list.index(filename)
        offsets = list(range(-self.backward_context, 0)) + \
            list(range(1, self.forward_context + 1))
        return [file_list[fidx + o] if 0 <= fidx + o < len(file_list)
                else None for o in offsets]

    def _has_context(self, filename, file_list):
        return all(c is not None and c in file_list
                   for c in self._context_names(filename, file_list))

    def _sample_context(self, idx: int, scene: str, filename: str):
        """Context frame names of sample ``idx`` (the paired readers
        override it)."""
        return self._context_names(filename, self.file_tree[scene])

    def _pose(self, scene: str, filename: str) -> np.ndarray:
        path = os.path.join(self.root_dir, scene, filename)
        path = path.replace("color", "pose")
        path = os.path.splitext(path)[0] + ".txt"
        return read_matrix_txt(path)

    def _intrinsics(self, path: str) -> np.ndarray:
        """Per-scene intrinsics, parsed once."""
        cache = getattr(self, "_intr_cache", None)
        if cache is None:
            cache = self._intr_cache = {}
        intr = cache.get(path)
        if intr is None:
            intr = read_matrix_txt(path)[:3, :3].astype(np.float32)
            cache[path] = intr
        return intr.copy()

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        scene, filename = self.files[idx]
        img_path = os.path.join(self.root_dir, scene, filename)
        image = load_image_rgb(img_path)

        intr_path = img_path.split("color")[0] + "intrinsic/intrinsic_color.txt"
        intr = self._intrinsics(intr_path)

        ctx_names = self._sample_context(idx, scene, filename)
        ctx_imgs = [load_image_rgb(os.path.join(self.root_dir, scene, c))
                    for c in ctx_names]
        pose = self._pose(scene, filename)
        rel_poses = [
            (invert_pose_numpy(self._pose(scene, c)) @ pose).astype(np.float32)
            for c in ctx_names]

        sample: Sample = {
            "idx": idx,
            "filename": "%s_%s" % (scene.split("/")[0],
                                   os.path.splitext(filename)[0]),
            "rgb": image,
            "intrinsics": intr,
            "rgb_context": np.stack(ctx_imgs),
            "pose_context": np.stack(rel_poses),
        }
        if self.with_depth:
            depth_path = img_path.replace("color", "depth")
            depth_path = os.path.splitext(depth_path)[0] + ".png"
            sample["depth"] = depth_at_image_size(read_png_depth_mm(depth_path), image)

        if self.mode == "train":
            rng = sample_rng(self, scene, filename)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())


class ScannetTestDataset(ScannetDataset):
    """The paired test split: each line lists a scene, its target frame and
    the target's context frames."""

    def __init__(self, root_dir: str, split: str, mode: str = "test",
                 depth_type: Optional[str] = "groundtruth",
                 back_context: int = 0, forward_context: int = 0,
                 image_shape=None, jittering=(), **kwargs):
        self.root_dir = root_dir
        self.mode = mode
        self.with_depth = bool(depth_type)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.backward_context = back_context
        self.forward_context = forward_context

        split_path = (split if os.path.isabs(split)
                      else os.path.join(os.path.dirname(root_dir), split))
        self.tuples = []
        with open(split_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    self.tuples.append((parts[0], parts[1], parts[2:]))
        self.file_tree = defaultdict(list)
        self.files = [(scene, target) for scene, target, _ in self.tuples]

    def _sample_context(self, idx: int, scene: str, filename: str):
        return list(self.tuples[idx][2])


def _scannet_factory(path, split, mode, image_shape, jittering, section):
    return ScannetDataset(
        root_dir=path, split=split, mode=mode,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        back_context=section.back_context,
        forward_context=section.forward_context,
        strides=tuple(section.strides),
        image_shape=image_shape,
        jittering=jittering if mode == "train" else ())


def _scannet_test_factory(path, split, mode, image_shape, jittering, section):
    return ScannetTestDataset(
        root_dir=path, split=split, mode=mode,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        back_context=section.back_context,
        forward_context=section.forward_context,
        image_shape=image_shape,
        jittering=())


# ScannetTestMF reads the same paired tuples (`dro_sfm_tpu/data/extra.py`).
DATASETS = {"Scannet": _scannet_factory, "ScannetTest": _scannet_test_factory,
            "ScannetTestMF": _scannet_test_factory}
