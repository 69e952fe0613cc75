"""`fuse_scene_pointcloud` of the port against the JAX package's (CPU), bit
for bit, on a ScanNet-layout scene written here: colour JPEGs (OpenCV) at
twice the depth's size, uint16 millimetre depth PNGs with holes and far
values, pose txts (one not finite, one missing) and the intrinsics file;
with the defaults, another stride, a voxel grid, an ``.obj`` output and no
intrinsics file. The files written must be equal byte for byte.
"""
import os

import cv2
import numpy as np
import pytest

from dro_sfm_tpu.visualization.pointcloud import fuse_scene_pointcloud as jax_fuse
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.visualization.pointcloud import fuse_scene_pointcloud


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene0000_00")
    for d in ("color", "depth", "pose", "intrinsic"):
        (root / d).mkdir()
    data = SyntheticDataset(SyntheticConfig(height=48, width=64, num_planes=3))
    planes, _ = data._scene(0)
    rng = np.random.default_rng(0)
    for i in range(24):
        T = np.eye(4)
        T[:3, 3] = [0.02 * i, 0.0, 0.03 * i]
        rgb, depth = data._render(planes, T)
        big = cv2.resize((rgb * 255).astype(np.uint8), (128, 96))
        cv2.imwrite(str(root / "color" / f"{i}.jpg"), big[..., ::-1])
        mm = (depth[..., 0] * 1000).astype(np.uint16)
        mm[rng.random(mm.shape) < 0.1] = 0
        mm[:2] = 15000                                        # past depth_max
        if i != 5:                                            # a missing depth
            cv2.imwrite(str(root / "depth" / f"{i}.png"), mm)
        if i == 10:
            T[0, 0] = np.nan
        np.savetxt(root / "pose" / f"{i}.txt", T)
    K = np.eye(4)
    K[:3, :3] = data.K
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", K)
    return str(root)


@pytest.mark.parametrize("kwargs", [{}, {"stride": 3, "pixel_stride": 2},
                                    {"stride": 2, "voxel": 0.05},
                                    {"intrinsics_file": "missing.txt", "stride": 4}])
@pytest.mark.parametrize("ext", [".ply", ".obj"])
def test_fuse_matches_jax(scene, tmp_path, kwargs, ext):
    got, want = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    n_t = fuse_scene_pointcloud(scene, got, **kwargs)
    n_j = jax_fuse(scene, want, **kwargs)
    assert n_t == n_j > 0
    assert open(got).read() == open(want).read()


def test_empty_scene(tmp_path):
    (tmp_path / "color").mkdir()
    assert fuse_scene_pointcloud(str(tmp_path), str(tmp_path / "x.ply")) == 0
    assert not os.path.exists(tmp_path / "x.ply")
