"""The port's offline dataset tools (`dro_sfm_torch/scripts/{generate_splits,
export_gt_pointcloud,pose_stats,preview_dataset,debug_depth}.py`) against
the JAX tools of the same names (CPU), each run in this process on the
fabricated scenes of `tests/test_tools.py` (written with OpenCV).

Split lists, statistics, point clouds and OBJ files must be equal byte for
byte; the depth previews' JPEG bytes too (the port's encoder gives
`cv2.imencode`'s bytes); the preview's PNG frames equal pixel for pixel;
its MJPEG AVI (the JAX tool writes mp4) is read back with `read_avi_mjpeg`,
one frame a sample of the canvases' size, each within 30 dB PSNR of the
PNG frame (JPEG quality 95 on text and noise).
"""
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from dro_sfm_torch.scripts import debug_depth as t_debug
from dro_sfm_torch.scripts import export_gt_pointcloud as t_export
from dro_sfm_torch.scripts import generate_splits as t_splits
from dro_sfm_torch.scripts import pose_stats as t_stats
from dro_sfm_torch.scripts import preview_dataset as t_preview
from dro_sfm_torch.utils.video_io import read_avi_mjpeg
from tests.test_tools import _make_scene
from tools import debug_depth as j_debug
from tools import export_gt_pointcloud as j_export
from tools import generate_splits as j_splits
from tools import pose_stats as j_stats
from tools import preview_dataset as j_preview

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(monkeypatch, tool, args):
    """A JAX tool's ``main`` on ``args`` as its command line."""
    monkeypatch.setattr(sys, "argv", [tool.__file__, *args])
    tool.main()


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("unit", ["", "ms"])
def test_pose_stats(tmp_path, monkeypatch, capsys, unit):
    scene = _make_scene(tmp_path)
    args = [str(scene), str(tmp_path)] + (["--timestamp-unit", unit] if unit else [])
    run_tool(monkeypatch, j_stats, args)
    want = capsys.readouterr()
    t_stats.main(args)
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    stats = [json.loads(line) for line in got.out.splitlines()]
    assert stats[0]["n_valid"] == 12 and stats[0]["n_nan"] == 1
    assert ("dt_ms" in stats[0]) == bool(unit)
    assert t_stats.rotation_defect(np.eye(3) * 2.0) == j_stats.rotation_defect(np.eye(3) * 2.0)


@pytest.mark.parametrize("out,voxel", [("cloud.ply", "0"), ("cloud.ply", "0.5"),
                                       ("cloud.obj", "0")])
def test_export_gt_pointcloud(tmp_path, monkeypatch, capsys, out, voxel):
    scene = _make_scene(tmp_path)
    common = ["--scene", str(scene), "--stride", "3", "--pixel-stride", "4", "--voxel", voxel]
    run_tool(monkeypatch, j_export, ["--out", str(tmp_path / f"jax_{out}"), *common])
    n = t_export.main(["--out", str(tmp_path / out), *common])
    assert n > 0
    assert read(tmp_path / out) == read(tmp_path / f"jax_{out}")


SPLIT_CASES = {
    "tails": (["--val-tail", "3", "--test-tail", "2", "--depth-vis", "--traj-obj"], False),
    "tuples": (["--tuple-context", "1", "--max-trans", "0.25", "--traj-obj"], True),
    "val only, excluded scene": (["--val-tail", "4", "--depth-vis", "--test-scenes",
                                  "EXCLUDE"], True),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_generate_splits(tmp_path, monkeypatch, case):
    """Each on its own copy of a two-scene tree (the tools write previews
    and OBJs into the scenes): every file of the trees and the split lists
    equal, the JPEG previews byte for byte."""
    args, with_bad = SPLIT_CASES[case]
    src = tmp_path / "src"
    scene = _make_scene(src, with_bad=with_bad)
    other = scene.parent / "scene0001_00"
    shutil.copytree(scene, other)
    # a second scene whose third pose jumps 2 m: the motion filter drops it
    pose = np.loadtxt(other / "pose" / "2.txt")
    pose[0, 3] += 2.0
    np.savetxt(other / "pose" / "2.txt", pose)
    (tmp_path / "EXCLUDE").write_text("scene0001_00/color 0.jpg\n")
    args = [str(tmp_path / a) if a == "EXCLUDE" else a for a in args]
    trees = {}
    for who, run in (("jax", lambda a: run_tool(monkeypatch, j_splits, a)),
                     ("port", t_splits.main)):
        root = tmp_path / who
        shutil.copytree(src, root)
        run(["--root", str(root / "scans"), "--out", str(root / "splits" / "list.txt"),
             *args])
        trees[who] = root
    names = files_under(trees["jax"])
    assert names == files_under(trees["port"])
    assert any(n.startswith("splits") for n in names)
    if "--depth-vis" in args:
        assert any("depth_vis" in n for n in names) and any("color_vis" in n for n in names)
    if "--traj-obj" in args:
        assert any(n.endswith("camera_trajectory_c.obj") for n in names)
    for name in names:
        assert read(trees["port"] / name) == read(trees["jax"] / name), name


@pytest.mark.parametrize("output", ["frames", "preview.avi"])
def test_preview_dataset(tmp_path, monkeypatch, output):
    """``configs/train_synthetic.yaml``'s validation scenes, 3 samples."""
    config = os.path.join(REPO, "configs", "train_synthetic.yaml")
    common = ["--config", config, "--split", "validation", "--max-samples", "3"]
    run_tool(monkeypatch, j_preview, [*common, "--output", str(tmp_path / "jax")])
    want = [cv2.imread(str(tmp_path / "jax" / f"{i:05d}.png"))[..., ::-1] for i in range(3)]
    n = t_preview.main([*common, "--output", str(tmp_path / output)])
    assert n == 3
    if output == "frames":
        assert sorted(os.listdir(tmp_path / "frames")) == sorted(os.listdir(tmp_path / "jax"))
        for i, w in enumerate(want):
            got = cv2.imread(str(tmp_path / "frames" / f"{i:05d}.png"))[..., ::-1]
            assert np.array_equal(got, w), i
        return
    frames, fps = read_avi_mjpeg(str(tmp_path / output))
    assert fps == 5 and len(frames) == 3
    for f, w in zip(frames, want):
        assert f.shape == w.shape
        mse = np.mean((f.astype(np.float64) - w) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30.0


def test_preview_dataset_refuses_mp4(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        t_preview.main(["--config", "x.yaml", "--output", str(tmp_path / "x.mp4")])


def test_debug_depth(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 30.0, size=(24, 40)).astype(np.float32)
    depth[:3] = 0
    png = str(tmp_path / "d.png")
    cv2.imwrite(png, (depth * 256).astype(np.uint16))
    npz = str(tmp_path / "d.npz")
    np.savez(npz, depth=depth)
    run_tool(monkeypatch, j_debug, [png, npz])
    want = capsys.readouterr().out
    t_debug.main([png, npz])
    got = capsys.readouterr().out
    assert got == want and got.count("==") == 2
