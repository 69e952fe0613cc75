"""Matterport capture reader.

The port's copy of `dro_sfm_tpu/data/matterport.py`: per scene, ``cam_left/``
JPEG frames, ``depth/`` millimetre PNGs and ``pose/`` 4x4 text files; fixed
intrinsics (577.87, principal point 319.5, 239.5 at 640x480); the split file
inside the data root, downsampled by pose deltas (`Matterport`) or every
5th frame (`MatterportTest`); relative poses ``inv(ctx) @ pose``.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.kitti import invert_pose_numpy, load_image_rgb
from dro_sfm_torch.data.scannet import depth_at_image_size, read_png_depth_mm
from dro_sfm_torch.data.transforms import eval_transform, train_transform

MATTERPORT_K = np.array([[577.870605, 0.0, 319.5],
                         [0.0, 577.870605, 239.5],
                         [0.0, 0.0, 1.0]], dtype=np.float32)


def pose_delta_6d(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """Size of the relative pose: [3 x rotation angle (rad), 3 translation (m)]."""
    rel = invert_pose_numpy(pose_a) @ pose_b
    angle = np.arccos(np.clip((np.trace(rel[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    return np.array([angle, angle, angle, *rel[:3, 3]])


def _pose_ok(delta: np.ndarray, rot_thr: float, t_thr: float) -> bool:
    return abs(delta[0]) < rot_thr and np.linalg.norm(delta[3:]) < t_thr


def adaptive_downsample(root_dir, scene, names, step: int = 5,
                        rot_thr: float = 0.5, t_thr: float = 1.0):
    """Advance by ``step`` frames while each of them stays within the
    thresholds of the current frame, else to the first that does not."""
    if len(names) <= step:
        return names
    poses = []
    for n in names:
        txt = os.path.join(root_dir, scene, n).replace(
            "cam_left", "pose").replace(".jpg", ".txt")
        poses.append(np.genfromtxt(txt))
    selected = []
    cur = 0
    n_frames = len(names)
    while cur < n_frames - step:
        selected.append(names[cur])
        advanced = False
        for offset in range(step):
            nxt = cur + 1 + offset
            if not _pose_ok(pose_delta_6d(poses[cur], poses[nxt]), rot_thr, t_thr):
                cur += max(offset, 1)
                advanced = True
                break
        if not advanced:
            cur += step
    return selected


class MatterportDataset:
    def __init__(self, root_dir: str, split: str, mode: str = "train",
                 depth_type: Optional[str] = "groundtruth",
                 back_context: int = 0, forward_context: int = 0,
                 strides: Sequence[int] = (1,), downsample: int = 5,
                 adaptive: bool = True,
                 image_shape=None, jittering=()):
        self.root_dir = root_dir
        self.mode = mode
        self.with_depth = bool(depth_type)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.backward_context = back_context
        self.forward_context = forward_context

        split_path = (split if os.path.isabs(split)
                      else os.path.join(root_dir, split))
        self.file_tree = defaultdict(list)
        with open(split_path) as f:
            for line in f:
                if line.strip():
                    scene, filename = line.split()
                    self.file_tree[scene].append(filename)
        for k in self.file_tree:
            if adaptive:
                self.file_tree[k] = adaptive_downsample(
                    root_dir, k, self.file_tree[k], downsample)
            else:
                self.file_tree[k] = self.file_tree[k][::downsample]

        self.files = []
        for scene, names in self.file_tree.items():
            for fname in names:
                if all(c is not None for c in self._context_names(fname, names)):
                    self.files.append((scene, fname))

    def _context_names(self, filename, file_list):
        fidx = file_list.index(filename)
        offsets = list(range(-self.backward_context, 0)) + \
            list(range(1, self.forward_context + 1))
        return [file_list[fidx + o] if 0 <= fidx + o < len(file_list)
                else None for o in offsets]

    def _pose(self, scene, filename) -> np.ndarray:
        path = os.path.join(self.root_dir, scene, filename).replace(
            "cam_left", "pose").replace(".jpg", ".txt")
        return np.genfromtxt(path)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        scene, filename = self.files[idx]
        img_path = os.path.join(self.root_dir, scene, filename)
        image = load_image_rgb(img_path)

        ctx_names = self._context_names(filename, self.file_tree[scene])
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
            "intrinsics": MATTERPORT_K.copy(),
            "rgb_context": np.stack(ctx_imgs),
            "pose_context": np.stack(rel_poses),
        }
        if self.with_depth:
            depth_path = img_path.replace("cam_left", "depth").replace(".jpg", ".png")
            sample["depth"] = depth_at_image_size(read_png_depth_mm(depth_path), image)

        if self.mode == "train":
            rng = sample_rng(self, scene, filename)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())


def _matterport_factory(adaptive):
    def factory(path, split, mode, image_shape, jittering, section):
        return MatterportDataset(
            root_dir=path, split=split, mode=mode,
            depth_type=(section.depth_type[0] if section.depth_type else None),
            back_context=section.back_context,
            forward_context=section.forward_context,
            strides=tuple(section.strides),
            adaptive=adaptive,
            image_shape=image_shape,
            jittering=jittering if mode == "train" else ())
    return factory


DATASETS = {"Matterport": _matterport_factory(adaptive=True),
            "MatterportTest": _matterport_factory(adaptive=False)}
