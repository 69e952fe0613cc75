"""The sample schema, per-sample augmentation seeds and relative poses.

The port's copy of `dro_sfm_tpu/data/base.py`. A sample is a dict of numpy
arrays, channel-last:

======================  =============================  =======================
key                     shape / type                   notes
======================  =============================  =======================
idx                     int                            dataset index
filename                str                            split-relative id
rgb                     [H,W,3] float32 in [0,1]       jittered for training
rgb_original            [H,W,3] float32                pre-jitter copy
rgb_context             [N,H,W,3] float32              N = back+forward ctx
rgb_context_original    [N,H,W,3] float32              pre-jitter copy
intrinsics              [3,3] float32                  for the image size
depth                   [H,W,1] float32, 0 = invalid   optional (supervised)
pose_context            [N,4,4] float32                T_{ctx<-target}, optional
==============================================================================
"""
from __future__ import annotations

import zlib
from typing import Dict, Protocol

import numpy as np

Sample = Dict[str, object]


class Dataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Sample: ...


def sample_rng(dataset, *key) -> np.random.Generator:
    """Per-sample augmentation RNG, the same in every process and fresh
    every epoch: crc32 of the key parts mixed with the dataset's current
    epoch (set by `DataLoader.set_epoch`)."""
    epoch = getattr(dataset, "epoch", 0)
    digest = zlib.crc32(repr(key).encode())
    return np.random.default_rng((digest * 2654435761 + epoch) % (2 ** 63))


def set_dataset_epoch(dataset, epoch: int) -> None:
    """Stamp ``epoch`` through wrapper datasets, recursively."""
    if hasattr(dataset, "datasets"):       # ConcatDataset
        for d in dataset.datasets:
            set_dataset_epoch(d, epoch)
    elif hasattr(dataset, "dataset"):      # RepeatedDataset
        set_dataset_epoch(dataset.dataset, epoch)
    try:
        dataset.epoch = epoch
    except AttributeError:
        pass


def relative_pose(pose_target: np.ndarray, pose_ctx: np.ndarray) -> np.ndarray:
    """T_{ctx<-target} from the camera-to-world poses of both frames."""
    return np.linalg.inv(pose_ctx) @ pose_target


def validate_sample(sample: Sample) -> None:
    """Schema checks of one sample."""
    rgb = sample["rgb"]
    if not (rgb.ndim == 3 and rgb.shape[-1] == 3 and rgb.dtype == np.float32):
        raise ValueError(f"rgb: want [H,W,3] float32, got {rgb.shape} {rgb.dtype}")
    ctx = sample["rgb_context"]
    if not (ctx.ndim == 4 and ctx.shape[1:] == rgb.shape):
        raise ValueError(f"rgb_context: want [N,{','.join(map(str, rgb.shape))}], "
                         f"got {ctx.shape}")
    if sample["intrinsics"].shape != (3, 3):
        raise ValueError(f"intrinsics: want [3,3], got {sample['intrinsics'].shape}")
    if "depth" in sample and sample["depth"].shape != (*rgb.shape[:2], 1):
        raise ValueError(f"depth: want [H,W,1], got {sample['depth'].shape}")
    if "pose_context" in sample and sample["pose_context"].shape != (ctx.shape[0], 4, 4):
        raise ValueError(f"pose_context: want [N,4,4], got {sample['pose_context'].shape}")
