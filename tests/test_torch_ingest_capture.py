"""The port's capture ingest against the JAX tool (CPU).

A capture directory is written here: ``cam_left/<timestamp>.jpg`` frames
(OpenCV), uint16 millimetre depth PNGs (one missing, one mostly out of
range), and a trajectory CSV in which one frame has no pose within
``--max-dt``, one pose is not finite and the camera jumps once. The JAX
tool (``tools/ingest_capture.py``, a subprocess) and the port
(``dro_sfm_torch.scripts.ingest_capture``) run on copies of it with
``--check --filter`` and each preset: the pose txts must be equal byte for
byte, the split files equal and the census lines equal. ``--preview-video``
(mp4v in an ``.mp4``, from OpenCV's writer in the JAX tool and the port's
encoder here) must give the same frame count, size, rate and codec, and
each port frame, decoded by the port and by OpenCV, must equal
`Mpeg4Encoder`'s reconstruction of `preview_canvas` of the frame (the name
drawn in OpenCV's font); an ``.avi`` holds the same frames.
"""
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from dro_sfm_torch.scripts import ingest_capture
from dro_sfm_torch.utils.image_io import read_image_rgb
from dro_sfm_torch.utils.video_io import Mpeg4Encoder, VideoReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cap")
    (root / "cam_left").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(14):
        stamp = 1000 + 100 * i                       # ms in the name, s in the CSV
        img = rng.integers(0, 256, (24, 32, 3), np.uint8)
        cv2.imwrite(str(root / "cam_left" / f"{stamp}.jpg"), img)
        depth = rng.integers(500, 9000, (24, 32)).astype(np.uint16)
        if i == 4:
            depth[:, :24] = 0                        # mostly untrusted
        if i != 7:
            cv2.imwrite(str(root / "depth" / f"{stamp}.png"), depth)
        if i == 11:
            continue                                 # no pose for this frame
        x = 0.02 * i + (1.0 if i >= 9 else 0.0)      # a jump at frame 9
        q = [0.0, 0.0, np.sin(0.01 * i), np.cos(0.01 * i)]
        px = "nan" if i == 2 else f"{x:.6f}"
        rows.append(f"{stamp / 1000:.3f}, {px}, 0.0, {0.01 * i:.6f}, "
                    + ", ".join(f"{v:.9f}" for v in q))
    (root / "traj.csv").write_text("# ts px py pz qx qy qz qw\n" + "\n".join(rows) + "\n")
    return root


def run_both(capture, tmp_path, extra):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(capture, jdir)
    shutil.copytree(capture, tdir)
    common = ["--trajectory", "traj.csv", "--scene", "cap", "--check", "--filter"] + extra
    jargs = [a.replace("traj.csv", str(jdir / "traj.csv")) for a in common]
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ingest_capture.py"),
                          "--capture", str(jdir), "--split-out", str(jdir / "split.txt"),
                          *jargs], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    targs = [a.replace("traj.csv", str(tdir / "traj.csv")) for a in common]
    out = ingest_capture.main(["--capture", str(tdir), "--split-out", str(tdir / "split.txt"),
                               *targs])
    return jdir, tdir, res.stdout, out


@pytest.mark.parametrize("preset", [[], ["--preset", "gazebo"],
                                    ["--preset", "gazebo", "--apply-cam2world"]])
def test_poses_split_and_census_match(capture, tmp_path, capsys, preset):
    capsys.readouterr()
    jdir, tdir, jout, out = run_both(capture, tmp_path, preset)
    tout = capsys.readouterr().out
    names = sorted(os.listdir(jdir / "pose"))
    assert names == sorted(os.listdir(tdir / "pose")) and len(names) == 13
    for n in names:
        assert (jdir / "pose" / n).read_bytes() == (tdir / "pose" / n).read_bytes()
    assert (jdir / "split.txt").read_text() == (tdir / "split.txt").read_text()
    assert out["lines"] and len(out["kept"]) == 13
    census = [line for line in jout.splitlines() if line.strip().startswith(("check", "no depth"))]
    assert census == [line for line in tout.splitlines()
                      if line.strip().startswith(("check", "no depth"))]
    assert out["census"]["missing_depth"] == 1 and out["census"]["invalid_pose"] == 1
    assert os.path.exists(jdir / "intrinsics.txt") == bool(preset)
    if preset:
        assert (jdir / "intrinsics.txt").read_bytes() == (tdir / "intrinsics.txt").read_bytes()


def test_preview_video(capture, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(capture, jdir)
    shutil.copytree(capture, tdir)
    run = [sys.executable, os.path.join(ROOT, "tools", "ingest_capture.py"), "--capture",
           str(jdir), "--trajectory", str(jdir / "traj.csv"), "--scene", "cap", "--split-out",
           str(jdir / "s.txt"), "--preview-video", str(jdir / "p.mp4")]
    assert subprocess.run(run, capture_output=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"}).returncode == 0
    out = ingest_capture.main(["--capture", str(tdir), "--trajectory", str(tdir / "traj.csv"),
                               "--scene", "cap", "--split-out", str(tdir / "s.txt"),
                               "--preview-video", str(tdir / "p.mp4")])
    caps = [cv2.VideoCapture(str(p)) for p in (jdir / "p.mp4", tdir / "p.mp4")]
    props = [(c.get(cv2.CAP_PROP_FRAME_COUNT), c.get(cv2.CAP_PROP_FRAME_WIDTH),
              c.get(cv2.CAP_PROP_FRAME_HEIGHT), c.get(cv2.CAP_PROP_FPS),
              int(c.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little")) for c in caps]
    assert props[0] == props[1] == (13, 64, 24, 10.0, b"FMP4")       # MPEG-4 Part 2
    frames = list(VideoReader(str(tdir / "p.mp4")))
    encoder = Mpeg4Encoder(24, 64, 10)
    assert len(frames) == len(out["kept"]) == 13
    for got, name in zip(frames, out["kept"]):
        dp = tdir / "depth" / name.replace(".jpg", ".png")
        depth = ingest_capture.read_depth_mm(str(dp)) if dp.exists() else None
        encoder.encode(ingest_capture.preview_canvas(
            read_image_rgb(str(tdir / "cam_left" / name)), depth, name))
        assert np.array_equal(got, encoder.reconstruction())
        assert np.array_equal(got, caps[1].read()[1][..., ::-1])
    assert ingest_capture.preview_video(str(tdir), out["kept"], str(tdir / "p.avi")) == 13
    assert all(np.array_equal(a, b) for a, b in zip(VideoReader(str(tdir / "p.avi")), frames))
