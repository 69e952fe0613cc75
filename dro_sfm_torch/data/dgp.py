"""Reader of the DGP scene format (TRI's DDAD) from its JSON files.

The port's copy of `dro_sfm_tpu/data/dgp.py`, which parses the public DGP
layout itself (no ``dgp`` package):

* ``scene_dataset*.json`` with ``scene_splits`` (0 train, 1 val, 2 test)
  listing ``scene*.json`` files;
* a ``scene.json``: ``samples`` (``datum_keys``, ``calibration_key``) and
  ``data`` (datums by ``key`` with ``id.name``, ``id.timestamp`` and an
  ``image`` or ``point_cloud`` carrying a ``filename`` and a sensor-to-world
  ``pose``);
* ``calibration/<key>.json``: ``names`` and ``intrinsics`` (fx fy cx cy);
* ground-truth depth projected from ``point_cloud/<lidar>/*.npz`` at first
  use and cached as ``depth/<lidar>/<camera>/<timestamp>.npz``.

One camera a sample; context from the neighbouring samples of the scene;
``pose_context[i] = inv(world_from_ctx) @ world_from_target``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.kitti import load_image_rgb
from dro_sfm_torch.data.transforms import eval_transform, train_transform

_SPLIT_ENUM = {"train": "0", "val": "1", "validation": "1", "test": "2"}


def _quat_to_mat(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Rotation matrix from a unit quaternion (w, x, y, z)."""
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=np.float64)


def _pose_to_mat(pose: Dict) -> np.ndarray:
    """DGP JSON pose {translation{x,y,z}, rotation{qw,qx,qy,qz}} -> [4,4]
    sensor-to-world transform."""
    t = pose.get("translation", {})
    q = pose.get("rotation", {})
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _quat_to_mat(float(q.get("qw", 1.0)), float(q.get("qx", 0.0)),
                             float(q.get("qy", 0.0)), float(q.get("qz", 0.0)))
    T[:3, 3] = [float(t.get("x", 0.0)), float(t.get("y", 0.0)),
                float(t.get("z", 0.0))]
    return T


def _intrinsics_to_K(intr: Dict) -> np.ndarray:
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = float(intr.get("fx", 0.0))
    K[1, 1] = float(intr.get("fy", 0.0))
    K[0, 1] = float(intr.get("skew", 0.0))
    K[0, 2] = float(intr.get("cx", 0.0))
    K[1, 2] = float(intr.get("cy", 0.0))
    return K


def _load_point_cloud(path: str) -> np.ndarray:
    """[N,3] float64 points from a DGP point-cloud npz (plain or structured
    `data` array whose first three fields are X/Y/Z)."""
    with np.load(path) as f:
        pc = f["data"] if "data" in f else f[f.files[0]]
    if pc.dtype.fields:  # structured (DDAD ships X,Y,Z,INTENSITY,...)
        names = list(pc.dtype.names)[:3]
        pc = np.stack([pc[n] for n in names], axis=-1)
    return np.asarray(pc, dtype=np.float64).reshape(-1, pc.shape[-1])[:, :3]


def project_depth_map(points_world: np.ndarray, world_from_cam: np.ndarray,
                      K: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Z-buffered pinhole projection of world points into a camera.

    The nearest hit's depth at each pixel, zero elsewhere.
    """
    h, w = int(shape[0]), int(shape[1])
    cam_from_world = np.linalg.inv(world_from_cam)
    pc = points_world @ cam_from_world[:3, :3].T + cam_from_world[:3, 3]
    z = pc[:, 2]
    keep = z > 1e-3
    pc, z = pc[keep], z[keep]
    uv = pc[:, :2] / z[:, None]
    u = np.round(uv[:, 0] * K[0, 0] + K[0, 2]).astype(np.int64)
    v = np.round(uv[:, 1] * K[1, 1] + K[1, 2]).astype(np.int64)
    keep = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z = u[keep], v[keep], z[keep]
    depth = np.zeros((h, w), dtype=np.float32)
    # Nearest hit wins: write decreasing depth so the minimum lands last.
    order = np.argsort(-z)
    depth[v[order], u[order]] = z[order].astype(np.float32)
    return depth


class _Scene:
    """Parsed scene.json: per-camera ordered datum lists + calibration."""

    def __init__(self, scene_dir: str, scene_json: str):
        self.dir = scene_dir
        with open(os.path.join(scene_dir, scene_json)) as f:
            doc = json.load(f)
        self.datums: Dict[str, Dict] = {d["key"]: d for d in doc["data"]}
        self.samples: List[Dict] = doc["samples"]
        self.name = doc.get("name", os.path.basename(scene_dir))
        self._calibrations: Dict[str, Dict] = {}

    def calibration(self, key: str) -> Dict:
        if key not in self._calibrations:
            path = os.path.join(self.dir, "calibration", key + ".json")
            with open(path) as f:
                self._calibrations[key] = json.load(f)
        return self._calibrations[key]

    def intrinsics(self, calibration_key: str, sensor: str) -> np.ndarray:
        calib = self.calibration(calibration_key)
        idx = calib["names"].index(sensor)
        return _intrinsics_to_K(calib["intrinsics"][idx])

    def datum_for(self, sample: Dict, name: str,
                  kind: str = "image") -> Optional[Dict]:
        for key in sample["datum_keys"]:
            d = self.datums[key]
            if kind in d["datum"] and (name is None or d["id"]["name"] == name):
                return d
        return None


class DGPDataset:
    """DGP-format dataset over one scene-dataset JSON: one camera a sample
    (further cameras are further dataset entries of the config), temporal
    context, relative context poses, cached lidar depth."""

    def __init__(self, root_dir: str, split: str = "train",
                 mode: str = "train", cameras: Sequence[str] = (),
                 depth_type: Optional[str] = None,
                 back_context: int = 0, forward_context: int = 1,
                 image_shape=None, jittering=(), scene_dataset_json=None,
                 **_):
        self.root_dir = root_dir
        self.mode = mode
        self.camera = cameras[0] if cameras else None
        self.depth_type = depth_type or None
        self.bwd = int(back_context)
        self.fwd = int(forward_context)
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)

        # `split` may name the scene-dataset JSON directly (config style:
        # path=<root>, split=<scene_dataset file>); the temporal split then
        # defaults to train. Otherwise auto-discover the JSON at the root.
        sd_json = scene_dataset_json
        if sd_json is None and str(split).endswith(".json"):
            sd_json, split = str(split), "train"
        if sd_json is None:
            candidates = sorted(
                f for f in os.listdir(root_dir)
                if f.startswith("scene_dataset") and f.endswith(".json"))
            if not candidates:
                raise FileNotFoundError(
                    f"No scene_dataset*.json under {root_dir}")
            sd_json = candidates[0]
        with open(os.path.join(root_dir, sd_json)) as f:
            sd = json.load(f)
        split_key = _SPLIT_ENUM.get(str(split).lower(), str(split))
        splits = sd.get("scene_splits", {})
        entry = splits.get(split_key) or splits.get(str(split)) or {}
        scene_files = entry.get("filenames", [])

        self.scenes: List[_Scene] = []
        self.items: List[tuple] = []  # (scene_idx, sample_idx)
        for rel in scene_files:
            scene_dir = os.path.join(root_dir, os.path.dirname(rel))
            scene = _Scene(scene_dir, os.path.basename(rel))
            si = len(self.scenes)
            self.scenes.append(scene)
            n = len(scene.samples)
            for t in range(self.bwd, n - self.fwd):
                if self.camera is None and scene.samples[t]["datum_keys"]:
                    # Default camera: first image datum of the first sample.
                    d = scene.datum_for(scene.samples[t], None)
                    if d is not None:
                        self.camera = d["id"]["name"]
                self.items.append((si, t))

    def __len__(self) -> int:
        return len(self.items)

    # -- raw accessors ------------------------------------------------------

    def _image_record(self, scene: _Scene, t: int):
        sample = scene.samples[t]
        datum = scene.datum_for(sample, self.camera)
        if datum is None:
            raise KeyError(
                f"No image datum for camera {self.camera!r} in scene "
                f"{scene.name} sample {t}")
        img = datum["datum"]["image"]
        pose = _pose_to_mat(img.get("pose", {}))
        return img["filename"], pose, sample

    def _depth_for(self, scene: _Scene, t: int, filename: str,
                   world_from_cam: np.ndarray, K: np.ndarray,
                   shape) -> np.ndarray:
        ts = os.path.splitext(os.path.basename(filename))[0]
        cache = os.path.join(scene.dir, "depth", self.depth_type,
                             self.camera, ts + ".npz")
        if os.path.exists(cache):
            return np.load(cache)["depth"].astype(np.float32)
        sample = scene.samples[t]
        pc_datum = scene.datum_for(sample, self.depth_type, "point_cloud")
        if pc_datum is None:
            raise KeyError(f"No point_cloud datum {self.depth_type!r} in "
                           f"scene {scene.name} sample {t}")
        pc = pc_datum["datum"]["point_cloud"]
        points = _load_point_cloud(os.path.join(scene.dir, pc["filename"]))
        world_from_lidar = _pose_to_mat(pc.get("pose", {}))
        world_points = points @ world_from_lidar[:3, :3].T \
            + world_from_lidar[:3, 3]
        depth = project_depth_map(world_points, world_from_cam, K, shape)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez_compressed(cache, depth=depth)
        return depth

    # -- sample assembly ----------------------------------------------------

    def __getitem__(self, idx: int) -> Sample:
        si, t = self.items[idx]
        scene = self.scenes[si]
        filename, pose_t, sample_meta = self._image_record(scene, t)
        rgb = load_image_rgb(os.path.join(scene.dir, filename))
        K = scene.intrinsics(sample_meta["calibration_key"], self.camera)

        ctx_ts = [t - d for d in range(self.bwd, 0, -1)] \
            + [t + d for d in range(1, self.fwd + 1)]
        ctx_rgb, ctx_pose = [], []
        for tc in ctx_ts:
            fn_c, pose_c, _ = self._image_record(scene, tc)
            ctx_rgb.append(load_image_rgb(os.path.join(scene.dir, fn_c)))
            # T_{ctx<-target} (see module docstring).
            ctx_pose.append(np.linalg.inv(pose_c) @ pose_t)

        sample: Sample = {
            "idx": idx,
            "filename": f"{scene.name}/{os.path.splitext(filename)[0]}",
            "rgb": rgb,
            "rgb_context": np.stack(ctx_rgb),
            "intrinsics": K,
            "pose_context": np.stack(ctx_pose).astype(np.float32),
        }
        if self.depth_type:
            depth = self._depth_for(scene, t, filename, pose_t, K,
                                    rgb.shape[:2])
            sample["depth"] = depth[..., None]

        if self.mode == "train":
            rng = sample_rng(self, scene.name, t)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())


def _dgp_factory(path, split, mode, image_shape, jittering, section):
    cameras = section.cameras[0] if section.cameras else ()
    return DGPDataset(
        root_dir=path, split=split, mode=mode, cameras=cameras,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        back_context=section.back_context,
        forward_context=section.forward_context,
        image_shape=image_shape,
        jittering=jittering if mode == "train" else ())


DATASETS = {"DGP": _dgp_factory}
