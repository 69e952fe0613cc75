"""KITTI raw: split files, depth files, the OXTS pose chain.

The port's copy of `dro_sfm_tpu/data/kitti.py`: samples listed by a split
file; context frames found by frame index at each stride; velodyne ``.npz``
or ``groundtruth`` 16-bit PNG depth; the camera pose from the OXTS GPS/IMU
packets through the IMU -> velodyne -> camera calibration; calibration,
OXTS and poses cached. It also holds what the other readers share: the
decode cache of `load_image_rgb` and the small text and depth file readers.
Frames decode with the port's codec (`dro_sfm_torch.utils.image_io`).
"""
from __future__ import annotations

import glob
import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, sample_rng
from dro_sfm_torch.data.transforms import eval_transform, train_transform
from dro_sfm_torch.utils.image_io import read_image_rgb, read_png

IMAGE_FOLDER = {"left": "image_02", "right": "image_03"}
CALIB_FILE = {"cam2cam": "calib_cam_to_cam.txt",
              "velo2cam": "calib_velo_to_cam.txt",
              "imu2velo": "calib_imu_to_velo.txt"}
PNG_DEPTH_DATASETS = ["groundtruth"]
OXTS_POSE_DATA = "oxts"


def read_calib_file(path: str) -> dict:
    """A KITTI calibration text file: ``key: numbers`` lines as arrays."""
    data = {}
    with open(path) as f:
        for line in f.readlines():
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def transform_from_rot_trans(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """[R|t] -> 4x4 homogeneous transform."""
    T = np.eye(4)
    T[:3, :3] = R.reshape(3, 3)
    T[:3, 3] = t.reshape(3)
    return T


def pose_from_oxts_packet(raw: np.ndarray, scale: float):
    """An OXTS GPS/IMU packet -> (R, t) in the Mercator-projected world
    frame."""
    lat, lon, alt = raw[0], raw[1], raw[2]
    roll, pitch, yaw = raw[3], raw[4], raw[5]
    er = 6378137.0  # earth radius
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])

    def rotx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rotz(yaw) @ roty(pitch) @ rotx(roll)
    return R, t


def invert_pose_numpy(T: np.ndarray) -> np.ndarray:
    """Rigid inverse of a 4x4 pose."""
    Tinv = np.copy(T)
    R, t = Tinv[:3, :3], Tinv[:3, 3]
    Tinv[:3, :3], Tinv[:3, 3] = R.T, -(R.T @ t)
    return Tinv


_DECODE_CACHE_SIZE = int(os.environ.get("DRO_SFM_DECODE_CACHE", "192"))
_decode_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
_decode_lock = threading.Lock()


def load_image_rgb(path: str) -> np.ndarray:
    """A decoded frame, uint8 RGB [H,W,3] (float conversion comes after the
    resize, in the transforms).

    Frames are kept in an LRU cache of ``DRO_SFM_DECODE_CACHE`` entries
    (192 by default; 0 turns it off): with back and forward context every
    frame is decoded for about three neighbouring samples. The caller gets a
    copy, since samples are written in place."""
    if _DECODE_CACHE_SIZE > 0:
        with _decode_lock:
            img = _decode_cache.get(path)
            if img is not None:
                _decode_cache.move_to_end(path)
                return img.copy()
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    img = read_image_rgb(path)
    if _DECODE_CACHE_SIZE > 0:
        with _decode_lock:
            _decode_cache[path] = img
            while len(_decode_cache) > _DECODE_CACHE_SIZE:
                _decode_cache.popitem(last=False)
        return img.copy()
    return img


def read_matrix_txt(path: str) -> np.ndarray:
    """A whitespace-separated numeric matrix file -> float64 [R,C]."""
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    return np.array(rows, dtype=np.float64)


def read_npz_depth(path: str, depth_type: str) -> np.ndarray:
    depth = np.load(path)[depth_type + "_depth"].astype(np.float32)
    return depth[..., None]


def read_depth_png(path: str) -> np.ndarray:
    """The samples of a one-channel PNG, [H,W] (uint16 for 16-bit files)."""
    img = read_png(path)
    if img.shape[-1] != 1:
        raise NotImplementedError(f"{path}: a depth PNG has one channel, not {img.shape[-1]}")
    return img[..., 0]


def read_png_depth(path: str) -> np.ndarray:
    """uint16 PNG depth / 256 in metres; invalid (0) pixels become -1."""
    depth_png = read_depth_png(path)
    if depth_png.max() <= 255:
        raise ValueError(f"{path}: wrong .png depth file (no value above 255)")
    depth = depth_png.astype(np.float32) / 256.0
    depth[depth_png == 0] = -1.0
    return depth[..., None]


class KITTIDataset:
    """KITTI raw with context frames and optional depth and pose."""

    def __init__(self, root_dir: str, file_list: str, mode: str = "train",
                 depth_type: Optional[str] = None, with_pose: bool = True,
                 back_context: int = 0, forward_context: int = 0,
                 strides: Sequence[int] = (1,),
                 image_shape=None, jittering=()):
        self.root_dir = root_dir
        self.mode = mode
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        self.depth_type = depth_type
        self.with_depth = bool(depth_type)
        self.with_pose = with_pose
        self.backward_context = back_context
        self.forward_context = forward_context
        self.with_context = back_context > 0 or forward_context > 0
        self.split = os.path.basename(file_list).split(".")[0]

        self._folder_size_cache: dict = {}
        self._calib_cache: dict = {}
        self._oxts_cache: dict = {}
        self._pose_cache: dict = {}
        self._imu2cam_cache: dict = {}

        split_path = (file_list if os.path.isabs(file_list)
                      else os.path.join(root_dir, file_list))
        with open(split_path) as f:
            lines = f.readlines()
        paths = []
        for line in lines:
            if not line.strip():
                continue
            path = os.path.join(root_dir, line.split()[0])
            if not self.with_depth or os.path.exists(self._depth_file(path)):
                paths.append(path)

        self.paths = paths
        self.backward_context_paths = []
        self.forward_context_paths = []
        if self.with_context:
            kept = []
            for stride in strides:
                for path in paths:
                    back_idxs, fwd_idxs = self._context_idxs(
                        path, back_context, forward_context, stride)
                    if back_idxs is not None and fwd_idxs is not None:
                        kept.append(path)
                        self.backward_context_paths.append(back_idxs[::-1])
                        self.forward_context_paths.append(fwd_idxs)
            self.paths = kept

    @staticmethod
    def _file_at(idx: int, path: str) -> str:
        base, ext = os.path.splitext(os.path.basename(path))
        return os.path.join(os.path.dirname(path),
                            str(idx).zfill(len(base)) + ext)

    @staticmethod
    def _parent_folder(image_file: str) -> str:
        return os.path.abspath(os.path.join(image_file, "../../../.."))

    def _depth_file(self, image_file: str) -> str:
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                depth_file = image_file.replace(
                    IMAGE_FOLDER[cam] + "/data",
                    f"proj_depth/{self.depth_type}/{IMAGE_FOLDER[cam]}")
                if self.depth_type not in PNG_DEPTH_DATASETS:
                    depth_file = depth_file.replace("png", "npz")
                return depth_file
        raise ValueError(f"Invalid KITTI image path {image_file}")

    def _context_idxs(self, path, back, fwd, stride):
        """Context frame indices at ``stride``, each file checked to exist;
        (None, None) when the context leaves the folder."""
        base, ext = os.path.splitext(os.path.basename(path))
        folder = os.path.dirname(path)
        f_idx = int(base)
        if folder not in self._folder_size_cache:
            self._folder_size_cache[folder] = len(
                glob.glob(os.path.join(folder, "*" + ext)))
        max_files = self._folder_size_cache[folder]
        if f_idx - back * stride < 0 or f_idx + fwd * stride >= max_files:
            return None, None
        back_idxs, c = [], f_idx
        while len(back_idxs) < back and c > 0:
            c -= stride
            if os.path.exists(self._file_at(c, path)):
                back_idxs.append(c)
        if c < 0:
            return None, None
        fwd_idxs, c = [], f_idx
        while len(fwd_idxs) < fwd and c < max_files:
            c += stride
            if os.path.exists(self._file_at(c, path)):
                fwd_idxs.append(c)
        if c >= max_files:
            return None, None
        return back_idxs, fwd_idxs

    def _intrinsics(self, image_file: str) -> np.ndarray:
        parent = self._parent_folder(image_file)
        if parent not in self._calib_cache:
            self._calib_cache[parent] = read_calib_file(
                os.path.join(parent, CALIB_FILE["cam2cam"]))
        calib = self._calib_cache[parent]
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                P = calib[IMAGE_FOLDER[cam].replace("image", "P_rect")]
                return np.reshape(P, (3, 4))[:, :3].astype(np.float32)
        raise ValueError(f"Cannot find intrinsics for {image_file}")

    def _imu2cam(self, image_file: str) -> np.ndarray:
        parent = self._parent_folder(image_file)
        if parent not in self._imu2cam_cache:
            cam2cam = read_calib_file(os.path.join(parent, CALIB_FILE["cam2cam"]))
            imu2velo = read_calib_file(os.path.join(parent, CALIB_FILE["imu2velo"]))
            velo2cam = read_calib_file(os.path.join(parent, CALIB_FILE["velo2cam"]))
            velo2cam_mat = transform_from_rot_trans(velo2cam["R"], velo2cam["T"])
            imu2velo_mat = transform_from_rot_trans(imu2velo["R"], imu2velo["T"])
            cam2rect_mat = transform_from_rot_trans(cam2cam["R_rect_00"],
                                                    np.zeros(3))
            self._imu2cam_cache[parent] = (
                cam2rect_mat @ velo2cam_mat @ imu2velo_mat)
        return self._imu2cam_cache[parent]

    def _oxts(self, image_file: str) -> np.ndarray:
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                oxts_file = image_file.replace(
                    IMAGE_FOLDER[cam], OXTS_POSE_DATA).replace(".png", ".txt")
                break
        else:
            raise ValueError("Invalid KITTI path for pose supervision.")
        if oxts_file not in self._oxts_cache:
            self._oxts_cache[oxts_file] = np.loadtxt(oxts_file, delimiter=" ")
        return self._oxts_cache[oxts_file]

    def _pose(self, image_file: str) -> np.ndarray:
        """The camera pose in the frame of the sequence's first frame."""
        if image_file in self._pose_cache:
            return self._pose_cache[image_file]
        origin_frame = self._file_at(0, image_file)
        origin_oxts = self._oxts(origin_frame)
        scale = np.cos(origin_oxts[0] * np.pi / 180.0)
        origin_pose = transform_from_rot_trans(
            *pose_from_oxts_packet(origin_oxts, scale))
        pose = transform_from_rot_trans(
            *pose_from_oxts_packet(self._oxts(image_file), scale))
        imu2cam = self._imu2cam(image_file)
        odo_pose = (imu2cam @ np.linalg.inv(origin_pose)
                    @ pose @ np.linalg.inv(imu2cam)).astype(np.float32)
        self._pose_cache[image_file] = odo_pose
        return odo_pose

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Sample:
        path = self.paths[idx]
        sample: Sample = {
            "idx": idx,
            "filename": "%s_%010d" % (self.split, idx),
            "rgb": load_image_rgb(path),
            "intrinsics": self._intrinsics(path),
        }
        if self.with_depth:
            sample["depth"] = self._read_depth(self._depth_file(path))
        if self.with_context:
            ctx_idxs = (self.backward_context_paths[idx]
                        + self.forward_context_paths[idx])
            ctx_files = [self._file_at(i, path) for i in ctx_idxs]
            sample["rgb_context"] = np.stack(
                [load_image_rgb(f) for f in ctx_files])
            if self.with_pose:
                first_pose = self._pose(path)
                sample["pose_context"] = np.stack([
                    invert_pose_numpy(self._pose(f)) @ first_pose
                    for f in ctx_files]).astype(np.float32)
        if self.mode == "train":
            rng = sample_rng(self, path, idx)
            return train_transform(sample, self.image_shape or (),
                                   self.jittering, rng)
        return eval_transform(sample, self.image_shape or ())

    def _read_depth(self, depth_file: str) -> np.ndarray:
        if self.depth_type == "velodyne":
            return read_npz_depth(depth_file, self.depth_type)
        if self.depth_type == "groundtruth":
            return read_png_depth(depth_file)
        raise NotImplementedError(f"Depth type {self.depth_type}")


def _kitti_factory(path, split, mode, image_shape, jittering, section):
    return KITTIDataset(
        root_dir=path, file_list=split, mode=mode,
        depth_type=(section.depth_type[0] if section.depth_type else None),
        with_pose=True,
        back_context=section.back_context,
        forward_context=section.forward_context,
        strides=tuple(section.strides),
        image_shape=image_shape,
        jittering=jittering if mode == "train" else ())


DATASETS = {"KITTI": _kitti_factory}
