"""The port's point-cloud renderer and ``vis`` CLI (CPU).

`render_points` puts a known cloud on the pixels the view's projection
gives, and where points share a pixel the nearest wins (the lower index on
a tie); the CPU render of the same cloud is the same bits run after run
(the card's against the CPU's is held in ``chip_smoke.py`` phase ``demo``).
`read_ply` reads back `write_ply`'s files; the CLI writes a ``.png``
(points, the trajectory in red, its start in green) and an mp4v turntable
in ``.mp4`` and ``.avi``, as the JAX script's OpenCV writer writes it, that
OpenCV reads with its frame count, size and rate, and refuses a container
that its writer does not know. Tolerance: none.
"""
import json

import cv2
import numpy as np
import pytest
import torch

from dro_sfm_torch.scripts import vis
from dro_sfm_torch.visualization.pointcloud import write_ply
from dro_sfm_torch.visualization.splat import BACKGROUND, View, render_points


def test_known_cloud_lands_on_its_pixels():
    # A view down the z axis (elevation 90): columns follow y, rows follow x.
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.5, 1.0],
                    [0.5, 0.5, 0.2]])
    cols = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9], [7, 7, 7]], np.uint8)
    view = View(pts.min(0), pts.max(0), (64, 64), elev=90.0, azim=0.0)
    u, v, depth = view.project(pts)
    img = render_points(torch.tensor(pts), torch.tensor(cols), view).numpy()
    for k in (0, 1, 2):
        assert tuple(img[int(np.floor(v[k])), int(np.floor(u[k]))]) == tuple(cols[k])
    # points 3 and 4 share a pixel; 3 is higher (nearer the eye above)
    assert (np.floor(u[3]), np.floor(v[3])) == (np.floor(u[4]), np.floor(v[4]))
    assert depth[3] < depth[4]
    assert tuple(img[int(np.floor(v[3])), int(np.floor(u[3]))]) == (9, 9, 9)
    assert (img == BACKGROUND).all(-1).sum() == 64 * 64 - 4
    # the same point twice: the lower index wins
    twice = render_points(torch.tensor(pts[[4, 4]]), torch.tensor(cols[[1, 2]]), view).numpy()
    assert tuple(twice[int(np.floor(v[4])), int(np.floor(u[4]))]) == (0, 255, 0)


def test_render_is_deterministic():
    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.normal(0, 1, (20000, 3)))
    cols = torch.tensor(rng.integers(0, 256, (20000, 3)).astype(np.uint8))
    view = View(pts.min(0).values.numpy(), pts.max(0).values.numpy(), (96, 128), 20.0, 33.0)
    a, b = render_points(pts, cols, view), render_points(pts, cols, view)
    assert torch.equal(a, b)


def test_cli_png_and_turntable(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 1, (3000, 3))
    cols = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
    write_ply(str(tmp_path / "c.ply"), pts, cols)
    got, got_cols = vis.read_ply(str(tmp_path / "c.ply"))
    assert np.allclose(got, pts, atol=5e-7) and np.array_equal(got_cols, cols)
    traj = []
    for i in range(6):
        T = np.eye(4)
        T[:3, 3] = [0.3 * i, 0.1 * i, 0.0]
        traj.append(T.tolist())
    (tmp_path / "t.json").write_text(json.dumps(traj))
    out = vis.main(["--ply", str(tmp_path / "c.ply"), "--trajectory", str(tmp_path / "t.json"),
                    "--output", str(tmp_path / "r.png"), "--device", "cpu",
                    "--max-points", "2000"])
    img = cv2.imread(str(tmp_path / "r.png"))[..., ::-1]
    assert np.array_equal(img, out["frames"][0]) and out["points"] == 2000
    assert ((img[..., 0] > 200) & (img[..., 1] < 60)).any()          # the red trajectory
    assert ((img[..., 1] > 120) & (img[..., 0] < 60)).any()          # the green start
    for name in ("r.mp4", "r.avi"):
        out = vis.main(["--ply", str(tmp_path / "c.ply"), "--output", str(tmp_path / name),
                        "--frames", "5", "--device", "cpu"])
        cap = cv2.VideoCapture(str(tmp_path / name))
        assert (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
                cap.get(cv2.CAP_PROP_FPS)) == (5, vis.SIZE, 15)
        assert int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little") == b"FMP4"   # MPEG-4 Part 2
        assert not np.array_equal(out["frames"][0], out["frames"][2])   # the view turns
    with pytest.raises(ValueError, match="mp4v video goes into"):
        vis.main(["--ply", str(tmp_path / "c.ply"), "--output", str(tmp_path / "r.mkv"),
                  "--device", "cpu"])
    with pytest.raises(ValueError, match="mp4v video goes into"):    # before reading the .ply
        vis.main(["--ply", str(tmp_path / "missing.ply"), "--output", str(tmp_path / "r.jpg"),
                  "--device", "cpu"])
