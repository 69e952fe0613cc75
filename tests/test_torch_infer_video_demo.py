"""The port's ``infer_video`` demo outputs against the JAX CLI run in the
same test (CPU, the tiny it4 checkpoint and five rendered frames of
`test_torch_infer_cli.py`, with their exact depths as millimetre PNGs).

Both CLIs run with ``--gt-poses`` and ``--gt-depth``. Held:

* the ``rgb`` and ``gtd`` panels under ``panels/`` equal the JAX CLI's
  (OpenCV's decode) bit for bit; the ``depth`` and ``mask`` panels equal the
  JAX package's colormap, filter and resize applied to the port's own
  ``depths.npy`` bit for bit, and the JAX CLI's panels, whose depths differ
  from the port's by rounding, at all but 2% of their pixels;
* ``depths.npy`` within 1e-4 (relative L2 a map), ``trajectory.json`` and
  the OBJ's vertices within 1e-4 of the JAX CLI's;
* ``depth_vis.mp4`` has the frame count, size, rate and fourcc (mp4v) of
  the JAX CLI's (both read by ``cv2.VideoCapture``); each of its frames,
  decoded by the port, equals OpenCV's decode and the reconstruction of
  `Mpeg4Encoder` run again on the composer's canvases bit for bit, and lies
  within 25 dB PSNR of its canvas (measured 27.5-27.7 dB: the panels are
  mostly coloured text, which 4:2:0 chroma blurs);
* ``trajectory.png`` is written, and the result holds the compose and
  encode milliseconds a frame and the video's bytes;
* ``infer_pose --plot`` writes the trajectory figure beside the json, whose
  poses map to pixels on the drawn path.
"""
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from dro_sfm_tpu.inference import filter_depth as jax_filter_depth
from dro_sfm_tpu.utils.depth import viz_inv_depth as jax_viz
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.scripts import infer_pose, infer_video
from dro_sfm_torch.utils.image_io import read_png, write_png
from dro_sfm_torch.utils.video_io import Mpeg4Encoder, VideoReader
from tests.test_torch_infer_cli import FRAMES, H, W, scene  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def obj_vertices(path):
    return np.array([[float(v) for v in line.split()[1:]] for line in open(path)
                     if line.startswith("v ")])


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("demo")
    gtd = tmp / "gt_depth"
    gtd.mkdir()
    data = SyntheticDataset(SyntheticConfig(height=H, width=W, num_planes=3))
    planes, _ = data._scene(2)
    for i in range(FRAMES):
        T = np.eye(4)
        T[:3, 3] = [0.04 * i, 0.0, 0.03 * i]
        _, depth = data._render(planes, T)
        write_png(str(gtd / f"f{i:04d}.png"), (depth[..., 0] * 1000).astype(np.uint16))
    common = ["--checkpoint", scene["ckpt"], "--input", scene["frames"], "--gt-poses",
              scene["gt"], "--gt-depth", str(gtd)]
    canvases = []
    port = infer_video.main(common + ["--output", str(tmp / "port"), "--device", "cpu"],
                            canvases=canvases)
    path = os.path.join(REPO, "scripts", "infer_video.py")
    spec = importlib.util.spec_from_file_location("jax_infer_video_cli", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = sys.argv
    sys.argv = [path, *common, "--output", str(tmp / "jax")]
    try:
        module.main()
    finally:
        sys.argv = argv
    return {"port": tmp / "port", "jax": tmp / "jax", "result": port, "canvases": canvases,
            "frames": scene["frames"]}


def test_panels(runs):
    port, jax = runs["port"], runs["jax"]
    names = sorted(os.listdir(jax / "panels"))
    assert names == sorted(os.listdir(port / "panels")) and len(names) == 4 * (FRAMES - 2)
    depths = np.load(port / "depths.npy")
    for name in names:
        got = read_png(str(port / "panels" / name))
        want = cv2.imread(str(jax / "panels" / name), cv2.IMREAD_COLOR)[..., ::-1]
        kind, idx = name[:-4].split("_")
        if kind in ("rgb", "gtd"):
            assert np.array_equal(got, want), name
            continue
        depth = depths[int(idx)]
        if kind == "depth":
            inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
            full = (jax_viz(inv) * 255).astype(np.uint8)
        else:
            rgb = read_png(str(port / "panels" / name.replace("mask", "rgb")))
            frame = cv2.imread(os.path.join(runs["frames"], f"f{int(idx) + 1:04d}.png"))
            rgb_u8 = ((frame[..., ::-1].astype(np.float32) / 255.0) * 255).astype(np.uint8)
            valid = (jax_filter_depth(depth) > 0).astype(np.float32)[..., None]
            full = (rgb_u8 * (0.35 + 0.65 * valid)).astype(np.uint8)
            assert rgb.shape == got.shape
        mine = cv2.resize(full, (W // 2, H // 2))
        assert np.array_equal(got, mine), name
        assert (got != want).any(-1).mean() <= 0.02, name


def test_numbers_and_files(runs):
    port, jax, result = runs["port"], runs["jax"], runs["result"]
    got, want = np.load(port / "depths.npy"), np.load(jax / "depths.npy")
    for a, b in zip(got, want):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4
    np.testing.assert_allclose(json.loads((port / "trajectory.json").read_text()),
                               json.loads((jax / "trajectory.json").read_text()), atol=1e-4)
    np.testing.assert_allclose(obj_vertices(port / "trajectory_pose.obj"),
                               obj_vertices(jax / "trajectory_pose.obj"), atol=1e-4)
    assert (port / "trajectory.png").stat().st_size > 0
    assert result["windows"] == FRAMES - 2 and result["ate"] is not None
    assert len(result["compose_ms"]) == len(result["encode_ms"]) == FRAMES - 2
    assert result["video_bytes"] == (port / "depth_vis.mp4").stat().st_size


def test_video(runs):
    caps = [cv2.VideoCapture(str(runs["port"] / "depth_vis.mp4")),
            cv2.VideoCapture(str(runs["jax"] / "depth_vis.mp4"))]
    props = [(c.get(cv2.CAP_PROP_FRAME_COUNT), c.get(cv2.CAP_PROP_FRAME_WIDTH),
              c.get(cv2.CAP_PROP_FRAME_HEIGHT), c.get(cv2.CAP_PROP_FPS),
              int(c.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little")) for c in caps]
    assert props[0] == props[1] and props[0][3:] == (10.0, b"FMP4")    # MPEG-4 Part 2
    reader = VideoReader(str(runs["port"] / "depth_vis.mp4"))
    frames = list(reader)
    assert reader.fps == 10.0 and len(frames) == len(runs["canvases"]) == FRAMES - 2
    assert frames[0].shape[:2] == runs["result"]["frame_size"] == (props[0][2], props[0][1])
    encoder = Mpeg4Encoder(*frames[0].shape[:2], 10.0)
    for got, canvas in zip(frames, runs["canvases"]):
        encoder.encode(canvas)
        assert np.array_equal(got, encoder.reconstruction())
        assert np.array_equal(got, caps[0].read()[1][..., ::-1])
        assert psnr(got, canvas) >= 25.0


def test_infer_pose_plot(scene, tmp_path):  # noqa: F811
    traj = infer_pose.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                            "--output", str(tmp_path / "t.json"), "--plot",
                            str(tmp_path / "t.png"), "--device", "cpu"])
    img = read_png(str(tmp_path / "t.png"))
    assert img.shape == (640, 640, 3) and len(traj) == FRAMES - 2
    assert np.allclose(json.loads((tmp_path / "t.json").read_text()), np.stack(traj))
    from dro_sfm_torch.visualization.trajectory import plot_trajectory
    fig = plot_trajectory(str(tmp_path / "again.png"), traj)
    assert np.array_equal(fig["image"], img)
    for T in traj:
        x = fig["x0"] + fig["scale"] * (T[0, 3] - fig["lo"][0])
        y = fig["y0"] - fig["scale"] * (T[2, 3] - fig["lo"][1])
        assert (img[int(round(y)), int(round(x))] != 255).any()
