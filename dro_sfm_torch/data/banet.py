"""BA-Net paired-split readers (`ScannetBA`, `MatterportBA`).

The port's copy of `dro_sfm_tpu/data/banet.py`. A ``splits/banet_train.txt``
beside the data root repeats in groups of 7 lines: line 0 of a group is the
target frame's path, line 1 its BA-Net context partner. The other context
frames lie at +/-5 and +/-10 frames, their sign set by the partner's
direction, and a target is kept only when all four contexts are in the
availability split. Frames are read as `ScannetDataset` reads them.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional

from dro_sfm_torch.data.base import sample_rng
from dro_sfm_torch.data.scannet import ScannetDataset


def parse_banet_split(path: str):
    """A BA-Net split file -> ``{scene: [target_id, ...]}`` and ``{scene:
    {target_id: (c1, c2, c3, c4)}}``, ids being ``NNNNNN.jpg`` frame names;
    the scene is path component 3 and the frame id the ``frame-<id>`` stem."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    targets = lines[::7]
    partners = lines[1::7]

    order = defaultdict(list)
    contexts = defaultdict(dict)
    for d0, d1 in zip(targets, partners):
        scene = d0.split("/")[3] + "/color"
        id0 = d0.split("/")[-1].split(".")[0].split("frame-")[-1] + ".jpg"
        id1 = d1.split("/")[-1].split(".")[0].split("frame-")[-1] + ".jpg"
        if id0 in contexts[scene]:
            continue
        n0 = int(id0.split(".")[0])
        if int(id1.split(".")[0]) > n0:
            c2, c3, c4 = (f"{n0 - 5:06d}.jpg", f"{n0 + 5:06d}.jpg",
                          f"{n0 - 10:06d}.jpg")
        else:
            c2, c3, c4 = (f"{n0 + 5:06d}.jpg", f"{n0 - 5:06d}.jpg",
                          f"{n0 + 10:06d}.jpg")
        order[scene].append(id0)
        contexts[scene][id0] = (id1, c2, c3, c4)
    return order, contexts


class BANetDataset(ScannetDataset):
    """Scene reader driven by a BA-Net paired split.

    ``split`` is the availability list (``scene filename`` lines, all
    frames); ``banet_split`` the paired file. The contexts by
    (back_context, forward_context):

    * (2, 2)  -> all four BA-Net contexts
    * (1, 1)  -> (c1, c2)
    * (0, 1)  -> (c1,)
    * (-1, 1) -> (c1, c1) or (c1, c2), a coin flip per sample
    """

    def __init__(self, root_dir: str, split: str, mode: str = "train",
                 depth_type: Optional[str] = "groundtruth",
                 back_context: int = 1, forward_context: int = 1,
                 banet_split: str = "splits/banet_train.txt",
                 image_shape=None, jittering=(), **kwargs):
        if (back_context, forward_context) not in (
                (2, 2), (1, 1), (0, 1), (-1, 1)):
            raise NotImplementedError(
                f"BA-Net context selection undefined for back="
                f"{back_context}, forward={forward_context}")
        self.root_dir = root_dir
        self.mode = mode
        self.with_depth = bool(depth_type)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.backward_context = back_context
        self.forward_context = forward_context

        base = os.path.dirname(root_dir)
        split_path = split if os.path.isabs(split) else os.path.join(base, split)
        self.file_tree = defaultdict(list)
        with open(split_path) as f:
            for line in f:
                if line.strip():
                    scene, filename = line.split()
                    self.file_tree[scene].append(filename)

        ba_path = (banet_split if os.path.isabs(banet_split)
                   else os.path.join(base, banet_split))
        order, self.ba_contexts = parse_banet_split(ba_path)

        self.files = []
        for scene, ids in order.items():
            avail = self.file_tree.get(scene, [])
            for target in ids:
                if all(c in avail for c in self.ba_contexts[scene][target]):
                    self.files.append((scene, target))

    def _sample_context(self, idx: int, scene: str, filename: str):
        c1, c2, c3, c4 = self.ba_contexts[scene][filename]
        back, fwd = self.backward_context, self.forward_context
        if (back, fwd) == (2, 2):
            return [c1, c2, c3, c4]
        if (back, fwd) == (1, 1):
            return [c1, c2]
        if (back, fwd) == (0, 1):
            return [c1]
        rng = sample_rng(self, scene, filename, "ba_repeat")
        return [c1, c1] if rng.random() < 0.5 else [c1, c2]


def _banet_factory(path, split, mode, image_shape, jittering, section):
    return BANetDataset(
        root_dir=path, split=split, mode=mode,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        back_context=section.back_context,
        forward_context=section.forward_context,
        image_shape=image_shape,
        jittering=jittering if mode == "train" else ())


DATASETS = {"ScannetBA": _banet_factory, "MatterportBA": _banet_factory}
