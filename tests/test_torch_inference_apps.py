"""The inference applications of the port against the JAX package's (CPU).

Mirrors `tests/test_inference.py`, each case on the same seeded inputs in
both packages:

* geometric consistency and fusion (torch, fp32, batched over the source
  views): the reprojected depth within 1e-5 relative of JAX's; the masks
  and the fused depth equal to JAX's away from the thresholds. A mask is a
  comparison (``dist < 1``, ``rel_diff < 1e-3``) and a nearest sample
  rounds, so a last-bit difference flips the pixels where the JAX value
  lies within 1e-4 of a threshold or of a half-integer; those pixels are
  left out of the comparison, and the test requires that most are not;
* ``filter_depth``, the trajectory's scale chaining, the point cloud and
  its files, voxel downsampling, Umeyama, the ATE, the trajectory OBJ, the
  ground-truth poses and the video helpers: numpy copies, held equal (the
  alignment within 1e-12).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dro_sfm_tpu.data.video as jvideo
import dro_sfm_tpu.inference as jinf
import dro_sfm_tpu.visualization.demo_video as jdemo
import dro_sfm_tpu.visualization.pointcloud as jpc
import dro_sfm_tpu.visualization.trajectory as jtraj
import dro_sfm_torch.data.video as tvideo
import dro_sfm_torch.inference as tinf
import dro_sfm_torch.visualization.demo_video as tdemo
import dro_sfm_torch.visualization.pointcloud as tpc
import dro_sfm_torch.visualization.trajectory as ttraj


def make_K(h, w):
    return np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2], [0, 0, 1.0]],
                    np.float32)


def pose(rng, scale=0.1):
    a = rng.normal(0, 0.02, 3)
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    T = np.eye(4)
    T[:3, :3] = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
                 @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    T[:3, 3] = rng.normal(0, scale, 3)
    return T.astype(np.float32)


def plane_depth(T, K, h, w, normal=(0.1, -0.05, -1.0), offset=-5.0):
    """Depth of the plane n.X = offset seen by the camera-to-world T."""
    n = np.asarray(normal) / np.linalg.norm(normal)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T @ T[:3, :3].T
    return ((offset - n @ T[:3, 3]) / (rays @ n)).astype(np.float32)


def views(seed, h=24, w=32, v=3, noise=1e-3):
    rng = np.random.default_rng(seed)
    K = make_K(h, w)
    T_ref = pose(rng)
    T_srcs = np.stack([pose(rng) for _ in range(v)])
    depth_ref = plane_depth(T_ref, K, h, w)
    depth_srcs = np.stack([plane_depth(T, K, h, w) for T in T_srcs])
    depth_srcs *= 1 + rng.normal(0, noise, depth_srcs.shape).astype(np.float32)
    return depth_ref, depth_srcs, T_ref, T_srcs, K


def jax_views(depth_ref, depth_srcs, T_ref, T_srcs, K):
    """JAX's mask, reprojection, distance and relative difference per view."""
    out = []
    h, w = depth_ref.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for d, T in zip(depth_srcs, T_srcs):
        args = [jnp.asarray(a) for a in (depth_ref, d, T_ref, T, K)]
        mask, reproj = jinf.check_geometric_consistency(*args)
        d_re, x2, y2 = map(np.asarray, jinf.reproject_with_depth(*args))
        # the sample position: where the source depth is read
        rel = np.linalg.inv(T) @ T_ref
        pts = (np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T) * depth_ref[..., None]
        proj = (pts @ rel[:3, :3].T + rel[:3, 3]) @ K.T
        xy = proj[..., :2] / np.maximum(proj[..., 2:], 1e-10)
        out.append((np.asarray(mask), np.asarray(reproj), d_re,
                    np.sqrt((x2 - xs) ** 2 + (y2 - ys) ** 2),
                    np.abs(d_re - depth_ref) / np.maximum(depth_ref, 1e-10), xy))
    return out


def far_from_thresholds(per_view, margin=1e-4):
    ok = True
    for _, _, _, dist, rel_diff, xy in per_view:
        half = np.abs(np.abs(xy - np.floor(xy)) - 0.5).min(axis=-1)
        ok = ok & (np.abs(dist - 1.0) > margin) & (np.abs(rel_diff - 1e-3) > 1e-3 * margin) \
            & (half > margin)
    return ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consistency_and_fusion_match_jax(seed):
    depth_ref, depth_srcs, T_ref, T_srcs, K = views(seed)
    per_view = jax_views(depth_ref, depth_srcs, T_ref, T_srcs, K)
    t = [torch.from_numpy(a) for a in (depth_ref, depth_srcs, T_ref, T_srcs, K)]
    masks, reprojs = tinf.check_geometric_consistency(*t)
    d_re, _, _ = tinf.reproject_with_depth(*t)
    ok = far_from_thresholds(per_view)
    assert ok.mean() > 0.5
    for v, (mask, reproj, jd_re, *_rest) in enumerate(per_view):
        np.testing.assert_allclose(d_re[v].numpy(), jd_re, rtol=1e-5, atol=1e-5)
        assert np.array_equal(masks[v].numpy()[ok], mask[ok])
        np.testing.assert_allclose(reprojs[v].numpy()[ok], reproj[ok], rtol=1e-5)
    want = np.asarray(jinf.geometric_fusion(*map(jnp.asarray, (depth_ref, depth_srcs, T_ref,
                                                               T_srcs, K)), thres_view=2))
    got = tinf.geometric_fusion(*t, thres_view=2).numpy()
    assert 0 < (want[ok] > 0).mean() < 1                     # some kept, some zeroed
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)


def test_consistency_identical_translated_and_wrong():
    h, w = 24, 32
    K = torch.from_numpy(make_K(h, w))
    depth = torch.full((h, w), 5.0)
    T = torch.eye(4)
    mask, reproj = tinf.check_geometric_consistency(depth, depth[None], T, T[None], K)
    assert bool(mask.all())
    torch.testing.assert_close(reproj, torch.full_like(reproj, 5.0), atol=1e-4, rtol=0)
    T_src = torch.eye(4)
    T_src[0, 3] = 0.2
    mask, _ = tinf.check_geometric_consistency(depth, depth[None], T, T_src[None], K)
    assert float(mask[0, :, 8:-8].float().mean()) > 0.9
    mask, _ = tinf.check_geometric_consistency(depth, torch.full((1, h, w), 2.0), T,
                                               T_src[None], K)
    assert float(mask.float().mean()) < 0.1
    fused = tinf.geometric_fusion(depth, depth.expand(3, h, w), T, T.expand(3, 4, 4), K)
    torch.testing.assert_close(fused, torch.full_like(fused, 5.0), atol=1e-4, rtol=0)


def test_filter_depth_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.0, 12.0, size=(20, 24)).astype(np.float32)
    depth[5:15, 5:15] = 3.0
    for kw in ({}, {"grad_max": 1.0, "depth_max": 8.0, "crop_h": 2, "crop_w": 3}):
        assert np.array_equal(tinf.filter_depth(depth, **kw), jinf.filter_depth(depth, **kw))


def test_trajectory_chaining_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    ours, theirs = tinf.TrajectoryAccumulator(), jinf.TrajectoryAccumulator()
    for _ in range(6):
        p21, p23 = pose(rng, 0.3), pose(rng, 0.3)
        assert np.array_equal(ours.add(p21, p23), theirs.add(p21, p23))
    ours.save_json(str(tmp_path / "a.json"))
    theirs.save_json(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    # the scale chaining case of tests/test_inference.py
    acc = tinf.TrajectoryAccumulator()
    p21, p23, q21, q23 = (np.eye(4) for _ in range(4))
    for T, z in ((p21, 1.0), (p23, -2.0), (q21, 1.0), (q23, -1.0)):
        T[2, 3] = z
    acc.add(p21, p23)
    np.testing.assert_allclose(acc.add(q21, q23)[:3, 3], [0, 0, 3.0], atol=1e-6)


def test_pointcloud_files_match_jax(tmp_path):
    h, w = 8, 10
    rng = np.random.default_rng(5)
    K = make_K(h, w)
    depth = rng.uniform(1.0, 3.0, size=(h, w)).astype(np.float32)
    depth[0, 0] = 0.0
    rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
    T = pose(rng)
    for args in ((depth, K), (depth, K, T, rgb)):
        a, b = tpc.depth_to_points(*args), jpc.depth_to_points(*args)
        assert np.array_equal(a[0], b[0])
        assert (a[1] is None and b[1] is None) or np.array_equal(a[1], b[1])
    for ext in ("ply", "obj"):
        n = tpc.export_pointcloud(str(tmp_path / f"t.{ext}"), depth, K, T, rgb)
        assert n == jpc.export_pointcloud(str(tmp_path / f"j.{ext}"), depth, K, T, rgb) == h * w - 1
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()
    pts, cols = tpc.depth_to_points(depth, K, T, rgb)
    for a, b in zip(tpc.voxel_downsample(pts, cols, 0.1), jpc.voxel_downsample(pts, cols, 0.1)):
        assert np.array_equal(a, b)


def test_umeyama_ate_and_gt_poses_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    gt = [pose(rng, 1.0).astype(np.float64) for _ in range(12)]
    pred = [p.copy() for p in gt]
    for p in pred:
        p[:3, 3] = p[:3, 3] * 0.5 + rng.normal(0, 0.01, 3) + [1.0, 2.0, 3.0]
    x, y = ttraj.positions_from_poses(pred), ttraj.positions_from_poses(gt)
    for a, b in zip(ttraj.umeyama_alignment(x, y), jtraj.umeyama_alignment(x, y)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert ttraj.absolute_trajectory_error(pred, gt) == jtraj.absolute_trajectory_error(pred, gt)
    (a_pos, a_ate), (b_pos, b_ate) = tdemo.align_to_gt(pred, gt), jdemo.align_to_gt(pred, gt)
    assert np.array_equal(a_pos, b_pos) and a_ate == b_ate
    tdemo.poses_to_obj(str(tmp_path / "t.obj"), pred)
    jdemo.poses_to_obj(str(tmp_path / "j.obj"), pred)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    frames = [f"frame{i:04d}.png" for i in range(len(gt))]
    for f, p in zip(frames, gt):
        np.savetxt(tmp_path / f.replace(".png", ".txt"), p)
    got, want = tdemo.load_gt_poses(str(tmp_path), frames), jdemo.load_gt_poses(str(tmp_path),
                                                                                  frames)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert tdemo.load_gt_poses(str(tmp_path), frames + ["missing.png"]) is None
    fig = ttraj.plot_trajectory(str(tmp_path / "t.png"), pred, gt_poses=gt)
    assert fig["image"].shape == (ttraj.PLOT_SIZE, ttraj.PLOT_SIZE, 3)
    assert (tmp_path / "t.png").stat().st_size > 0


def test_video_helpers_match_jax(tmp_path):
    assert np.array_equal(tvideo.dummy_calibration(640, 192), jvideo.dummy_calibration(640, 192))
    for name in ("frame_0042.png", "x.png", "a12b3.jpg"):
        assert tvideo.frame_index(name) == jvideo.frame_index(name)
    for d in ("seq_a", "seq_b/inner"):
        os.makedirs(tmp_path / d)
    for f in ("seq_a/2.png", "seq_a/1.jpg", "seq_b/inner/3.png", "top.bmp", "notes.txt"):
        (tmp_path / f).write_bytes(b"")
    got, want = tvideo.scan_image_tree(str(tmp_path)), jvideo.scan_image_tree(str(tmp_path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
