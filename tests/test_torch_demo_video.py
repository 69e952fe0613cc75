"""The port's demo-video panels and composer against the JAX package (CPU).

`cloud_topdown_panel` bit for bit (with and without the ``default_rng(0)``
draw); `DemoVideoComposer.frame_size` equal, and every pixel of `compose`
equal (the text is OpenCV's, pixel for pixel), with all, some and no
panels, float and gray panels, and the caller's panels left untouched;
`draw_trajectory_panel` bit-equal outside the lines' band (2 px around the
pixels either package's lines touch), and inside it within the polyline
bars of `test_torch_draw.py` (IoU >= 0.8, mean absolute difference <= 32).
`plot_trajectory` (the port's own figure, not matplotlib's) is held by its
structure: every pose's pixel lies on the drawn blue path, the start is
green, the ground truth's path is red with gaps (dashed), and one scale
serves both axes (a square path draws as a square).
"""
import cv2
import numpy as np
import pytest

from dro_sfm_tpu.visualization import demo_video as J
from dro_sfm_torch.visualization import demo_video as T
from dro_sfm_torch.visualization.trajectory import plot_trajectory


def trajectory(n=15, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        P = np.eye(4)
        P[:3, 3] = [0.1 * i + 0.02 * np.sin(i), 0.01 * i, 0.2 * i + 0.05 * np.cos(i)]
        poses.append(P)
    gt = np.stack([p[:3, 3] + rng.normal(0, 0.02, 3) for p in poses])
    return poses, gt


@pytest.mark.parametrize("n", [0, 1, 500, 70000])
def test_cloud_panel_bit_equal(n):
    rng = np.random.default_rng(n)
    pts = rng.normal(0, 1, (n, 3))
    for cols in (rng.integers(0, 256, (n, 3)).astype(np.uint8), rng.random((n, 3))):
        assert np.array_equal(T.cloud_topdown_panel(pts, cols, size=(96, 160)),
                              J.cloud_topdown_panel(pts, cols, size=(96, 160)))


@pytest.mark.parametrize("kwargs", [dict(label="pred"),
                                    dict(overlay="gt", label="pred-sim3(b) vs gt(r)"),
                                    dict(color=(255, 90, 90), label="gt")])
@pytest.mark.parametrize("upto", [0, 6, 14])
def test_trajectory_panel_within_bars(kwargs, upto):
    poses, gt = trajectory()
    kwargs = {k: (gt if k == "overlay" else v) for k, v in kwargs.items()}
    want = J.draw_trajectory_panel(poses, upto, size=(96, 160), **kwargs)
    got = T.draw_trajectory_panel(poses, upto, size=(96, 160), **kwargs)
    assert got.shape == want.shape and got.dtype == np.uint8
    mw, mg = (want != 24).any(-1), (got != 24).any(-1)
    band = cv2.dilate((mw | mg).astype(np.uint8), np.ones((5, 5), np.uint8)) > 0
    assert np.array_equal(got[~band], want[~band])
    iou = (mw & mg).sum() / (mw | mg).sum()
    mad = np.abs(got.astype(int) - want)[mw | mg].mean()
    assert iou >= 0.8 and mad <= 32, (iou, mad)


@pytest.mark.parametrize("which", ["all", "some", "none"])
@pytest.mark.parametrize("ate", [None, 0.1234])
def test_compose_bit_equal(which, ate):
    rng = np.random.default_rng(3)
    jc = J.DemoVideoComposer((96, 160), "runs/m.ckpt", "frames/", sample_rate=2, max_frames=50,
                             fps=12.5)
    tc = T.DemoVideoComposer((96, 160), "runs/m.ckpt", "frames/", sample_rate=2, max_frames=50,
                             fps=12.5)
    tc.info = dict(jc.info)                  # the same clock and host
    assert tc.frame_size == jc.frame_size
    poses, gt = trajectory()
    panels = {"rgb": rng.integers(0, 256, (48, 80, 3), np.uint8),
              "depth": rng.random((96, 160, 3)),
              "mask": rng.integers(0, 256, (48, 80), np.uint8),
              "depth_gt": rng.integers(0, 256, (30, 50, 3), np.uint8),
              "traj": J.draw_trajectory_panel(poses, 5, size=(48, 80)),
              "traj_vs_gt": J.draw_trajectory_panel(poses, 5, size=(48, 80), overlay=gt),
              "traj_gt": J.draw_trajectory_panel(poses, 5, size=(48, 80)),
              "cloud": rng.integers(0, 256, (48, 80, 3), np.uint8)}
    panels = {"all": panels, "some": {k: panels[k] for k in ("rgb", "depth", "cloud")},
              "none": {}}[which]
    before = {k: v.copy() for k, v in panels.items()}
    got = tc.compose(panels, 7, "000008.png", ate=ate)
    want = jc.compose(panels, 7, "000008.png", ate=ate)
    assert got.shape == (*jc.frame_size, 3) and np.array_equal(got, want)
    assert all(np.array_equal(panels[k], before[k]) for k in panels)


def test_plot_trajectory_structure(tmp_path):
    poses, gt = trajectory(25, seed=1)
    gt_poses = []
    for g in gt:
        P = np.eye(4)
        P[:3, 3] = g + [0.3, 0.0, 0.0]                    # beside the prediction
        gt_poses.append(P)
    fig = plot_trajectory(str(tmp_path / "t.png"), poses, gt_poses=gt_poses, title="run")
    img = fig["image"].astype(int)

    def px(points):
        return np.stack([fig["x0"] + fig["scale"] * (points[:, 0] - fig["lo"][0]),
                         fig["y0"] - fig["scale"] * (points[:, 2] - fig["lo"][1])], 1)

    pred = np.rint(px(np.stack([p[:3, 3] for p in poses]))).astype(int)
    for x, y in pred[1:]:
        r, g, b = img[y, x]
        assert b > 150 and r < 120, (x, y, img[y, x])     # blue path
    r, g, b = img[pred[0][1], pred[0][0]]
    assert g > 130 and r < 100 and b < 100               # green start
    track = px(np.stack([p[:3, 3] for p in gt_poses]))
    samples = np.concatenate([np.linspace(a, b, 12)[:-1] for a, b in zip(track[:-1], track[1:])])
    values = img[np.rint(samples[:, 1]).astype(int), np.rint(samples[:, 0]).astype(int)]
    red = (values[:, 0] > 150) & (values[:, 1] < 120)
    light = values.sum(1) > 600
    assert red.mean() > 0.3 and light.mean() > 0.1        # dashes and gaps
    square = []
    for x, z in [(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)]:
        P = np.eye(4)
        P[0, 3], P[2, 3] = x, z
        square.append(P)
    sq = plot_trajectory(str(tmp_path / "s.png"), square)["image"]
    ys, xs = np.nonzero((sq[..., 2] > 150) & (sq[..., 0] < 120))
    assert abs((xs.max() - xs.min()) - (ys.max() - ys.min())) <= 1
