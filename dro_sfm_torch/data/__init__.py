"""Datasets, transforms and loading.

The port's copy of `dro_sfm_tpu/data/__init__.py`: `setup_dataset` maps the
dataset names of a config section to reader classes; each (path, split) pair
of a section is one dataset, concatenated (with repeats) for training and
kept apart for evaluation. The names are the synthetic scenes and the file
readers of the JAX package (KITTI, ScanNet and its paired splits, BA-Net,
DeMoN, Matterport, video and image folders, DGP), which decode with the
port's codec, and NYU's HDF5 dumps, read by the port's own HDF5 reader.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict

from dro_sfm_torch.data import banet, demon, dgp, kitti, matterport, nyu, scannet, video
from dro_sfm_torch.data.base import Dataset, Sample, relative_pose, validate_sample
from dro_sfm_torch.data.loader import (
    ConcatDataset,
    DataLoader,
    RepeatedDataset,
    collate,
    make_loader,
)
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset

_REGISTRY: Dict[str, Callable] = {}


def _synthetic_factory(path, split, mode, image_shape, jittering, section,
                       num_planes=1):
    """'Synthetic': ``path`` is the seed and ``split`` the number of scenes.
    Scenes render at ``image_shape``. 'SyntheticMulti' composites 3 planes
    a scene."""
    n_ctx = int(section.back_context) + int(section.forward_context)
    cfg = SyntheticConfig(
        num_scenes=int(split) if str(split).isdigit() else 8,
        num_context=max(n_ctx, 1),
        seed=int(path) if str(path).isdigit() else 0,
        num_planes=num_planes)
    if image_shape:
        cfg.height, cfg.width = int(image_shape[0]), int(image_shape[1])
    return SyntheticDataset(cfg, mode=mode, image_shape=image_shape,
                            jittering=jittering if mode == "train" else ())


_REGISTRY["Synthetic"] = _synthetic_factory
_REGISTRY["SyntheticMulti"] = partial(_synthetic_factory, num_planes=3)
for _readers in (kitti, scannet, banet, demon, matterport, video, dgp, nyu):
    _REGISTRY.update(_readers.DATASETS)


def setup_dataset(section, augmentation, mode: str):
    """The dataset of one split section of the config: one dataset for
    "train", a list (one per entry) otherwise."""
    names = list(section.dataset)
    if not names:
        raise ValueError(f"No dataset configured for mode {mode}")
    image_shape = tuple(augmentation.image_shape)
    jittering = tuple(augmentation.jittering)
    datasets = []
    for i, name in enumerate(names):
        if name not in _REGISTRY:
            raise KeyError(f"Unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
        ds = _REGISTRY[name](
            path=section.path[i], split=section.split[i], mode=mode,
            image_shape=image_shape, jittering=jittering, section=section)
        repeat = section.repeat[i] if i < len(section.repeat) else 1
        if mode == "train" and repeat > 1:
            ds = RepeatedDataset(ds, repeat)
        datasets.append(ds)
    if mode == "train":
        return datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    return datasets


__all__ = [
    "ConcatDataset",
    "DataLoader",
    "Dataset",
    "RepeatedDataset",
    "Sample",
    "SyntheticConfig",
    "SyntheticDataset",
    "collate",
    "make_loader",
    "relative_pose",
    "setup_dataset",
    "validate_sample",
]
