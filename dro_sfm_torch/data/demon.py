"""DeMoN-format datasets (sun3d, rgbd, scenes11): two- and three-view folders.

The port's copy of `dro_sfm_tpu/data/demon.py` and `demon_mf.py`. A sample
is a folder with ``0000.jpg``, ``0001.jpg`` (and ``0002.jpg``), ``.npy``
depth of the same names, ``poses.txt`` (one world->camera 3x4 row a view)
and ``cam.txt`` (3x3 intrinsics). `DemonDataset` takes view 0 as target
and view 1 as context, relative pose ``pose1 @ inv(pose0)``.
`DemonMFDataset` with one back and one forward context keeps the
three-view folders and takes the middle view as target, (0000, 0002) as
context; otherwise it reads every folder as `DemonDataset` does.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.kitti import load_image_rgb
from dro_sfm_torch.data.transforms import eval_transform, train_transform


def _load_poses(folder: str) -> np.ndarray:
    """poses.txt rows (world->camera 3x4) -> [V,4,4]."""
    rows = np.atleast_2d(np.genfromtxt(os.path.join(folder, "poses.txt")).astype(np.float64))
    out = []
    for r in rows:
        T = np.eye(4)
        T[:3, :] = r.reshape(3, 4)
        out.append(T)
    return np.stack(out)


def _depth(path: str) -> np.ndarray:
    depth = np.load(path).astype(np.float32)
    return depth[..., None] if depth.ndim == 2 else depth


class DemonDataset:
    """Two-view folders: target 0000, context 0001."""

    def __init__(self, root_dir: str, split: str, mode: str = "train",
                 depth_type: Optional[str] = "groundtruth",
                 image_shape=None, jittering=(), **kwargs):
        self.root_dir = root_dir
        self.mode = mode
        self.with_depth = bool(depth_type)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        split_path = (split if os.path.isabs(split)
                      else os.path.join(root_dir, split))
        with open(split_path) as f:
            self.paths = [os.path.join(root_dir, line.split()[0])
                          for line in f if line.strip()]

    def __len__(self):
        return len(self.paths)

    def _finish(self, idx, folder, image, ctx, rel, depth) -> Sample:
        sample: Sample = {
            "idx": idx,
            "filename": os.path.basename(folder),
            "rgb": image,
            "rgb_context": ctx,
            "intrinsics": np.genfromtxt(os.path.join(folder, "cam.txt")).astype(np.float32),
            "pose_context": rel,
        }
        if self.with_depth:
            sample["depth"] = _depth(depth)
        if self.mode == "train":
            rng = sample_rng(self, folder)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())

    def __getitem__(self, idx: int) -> Sample:
        folder = self.paths[idx]
        poses = _load_poses(folder)
        return self._finish(
            idx, folder, load_image_rgb(os.path.join(folder, "0000.jpg")),
            load_image_rgb(os.path.join(folder, "0001.jpg"))[None],
            (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)[None],
            os.path.join(folder, "0000.npy"))


class DemonMFDataset(DemonDataset):
    """Two- or three-view folders (three views: middle target)."""

    def __init__(self, root_dir: str, split: str, mode: str = "train",
                 depth_type: Optional[str] = "groundtruth",
                 back_context: int = 1, forward_context: int = 1,
                 image_shape=None, jittering=(), **kwargs):
        super().__init__(root_dir, split, mode, depth_type, image_shape, jittering)
        self.three_view = back_context == 1 and forward_context == 1
        paths = []
        for folder in self.paths:
            has3 = (os.path.exists(os.path.join(folder, "0002.jpg"))
                    and os.path.exists(os.path.join(folder, "0002.npy")))
            if has3 or not self.three_view:
                paths.append((folder, has3))
        self.paths = paths

    def __getitem__(self, idx: int) -> Sample:
        folder, has3 = self.paths[idx]
        poses = _load_poses(folder)
        if not (self.three_view and has3):
            return self._finish(
                idx, folder, load_image_rgb(os.path.join(folder, "0000.jpg")),
                load_image_rgb(os.path.join(folder, "0001.jpg"))[None],
                (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)[None],
                os.path.join(folder, "0000.npy"))
        ctx = np.stack([load_image_rgb(os.path.join(folder, "0000.jpg")),
                        load_image_rgb(os.path.join(folder, "0002.jpg"))])
        rel = np.stack([(poses[0] @ np.linalg.inv(poses[1])).astype(np.float32),
                        (poses[2] @ np.linalg.inv(poses[1])).astype(np.float32)])
        return self._finish(idx, folder, load_image_rgb(os.path.join(folder, "0001.jpg")),
                            ctx, rel, os.path.join(folder, "0001.npy"))


def _factory(cls):
    def factory(path, split, mode, image_shape, jittering, section):
        return cls(
            root_dir=path, split=split, mode=mode,
            depth_type=(section.depth_type[0] if section.depth_type else None),
            back_context=section.back_context,
            forward_context=section.forward_context,
            image_shape=image_shape,
            jittering=jittering if mode == "train" else ())
    return factory


DATASETS = {"Demon": _factory(DemonDataset), "DemonMF": _factory(DemonMFDataset)}
