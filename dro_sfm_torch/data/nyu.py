"""NYU-v2 (processed HDF5 dumps).

The port's copy of `dro_sfm_tpu/data/nyu.py`: directories of ``.h5`` files
each holding ``rgb`` [3,H,W] uint8 and ``depth`` [H,W] float; context frames
by sorted order within a session; the standard NYU calibration (518.86, cx
325.6, cy 253.7) of the processed dumps. The files are read by the port's
own HDF5 reader (`dro_sfm_torch.utils.hdf5`), not h5py.

NYU yields float images: at the recipes' ``image_shape`` (480, 640) no
resize runs; at any other shape the float resize raises
(`data/transforms.py`).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.transforms import eval_transform, train_transform
from dro_sfm_torch.utils.hdf5 import open_h5

NYU_K = np.array([[518.85790117450188, 0.0, 325.58244941119034],
                  [0.0, 519.46961112127485, 253.73616633400465],
                  [0.0, 0.0, 1.0]], dtype=np.float32)


def scan_h5_tree(root_dir: str) -> dict:
    """``.h5`` files by session folder (relative path; the root's own under
    ``root_dir``), sorted by name."""
    tree = defaultdict(list)
    for entry in sorted(os.scandir(root_dir), key=lambda e: e.name):
        rel = os.path.relpath(entry.path, root_dir)
        if entry.is_dir():
            sub = scan_h5_tree(entry.path)
            if sub.get(entry.path):
                tree[rel] = sub[entry.path]
        elif entry.name.lower().endswith(".h5"):
            tree[root_dir].append(rel)
    return tree


def read_h5_sample(path: str):
    """(image [H,W,3] float32 in [0, 1], depth [H,W,1] float32) of one file."""
    f = open_h5(path)
    rgb, depth = f["rgb"], f["depth"]                  # [3,H,W] uint8, [H,W] float
    image = np.transpose(rgb, (1, 2, 0)).astype(np.float32) / 255.0
    return image, depth.astype(np.float32)[..., None]


class NYUDataset:
    def __init__(self, root_dir: str, split: str = "", mode: str = "train",
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

        self.tree = {k: sorted(v) for k, v in scan_h5_tree(root_dir).items()}
        self.files = []
        for session, names in self.tree.items():
            b, f = back_context, forward_context
            for i in range(b, len(names) - f):
                self.files.append((session, i))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        session, i = self.files[idx]
        names = self.tree[session]
        base = (self.root_dir if session == self.root_dir
                else os.path.join(self.root_dir, session))
        image, depth = read_h5_sample(os.path.join(base, names[i]))
        b, f = self.backward_context, self.forward_context
        ctx_names = names[i - b:i] + names[i + 1:i + 1 + f]
        ctx = [read_h5_sample(os.path.join(base, c))[0] for c in ctx_names]

        sample: Sample = {
            "idx": idx,
            "filename": "%s_%s" % (os.path.basename(session),
                                   os.path.splitext(names[i])[0]),
            "rgb": image,
            "rgb_context": np.stack(ctx) if ctx else
                np.zeros((0, *image.shape), np.float32),
            "intrinsics": NYU_K.copy(),
        }
        if self.with_depth:
            sample["depth"] = depth

        if self.mode == "train":
            rng = sample_rng(self, session, i)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())


def _nyu_factory(path, split, mode, image_shape, jittering, section):
    return NYUDataset(
        root_dir=path, split=split, mode=mode,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        back_context=section.back_context,
        forward_context=section.forward_context,
        image_shape=image_shape,
        jittering=jittering if mode == "train" else ())


DATASETS = {"NYU": _nyu_factory, "NYUtest": _nyu_factory}
