"""The port's inference CLIs on a checkpoint of the JAX package (CPU).

The JAX package writes a tiny ``it4-h-out-seq2`` net (48x64) with its own
``save_checkpoint``, as `tests/test_infer_video_cli.py` does; five PNG
frames of a rendered scene (the camera moving) and their ground-truth
poses lie in a folder. The port's ``infer_video``, ``infer`` and
``infer_pose`` run on them with ``--device cpu``, and their numeric outputs
are held to the JAX package's ``load_model``, ``make_infer_fn``,
``TrajectoryAccumulator`` and ``filter_depth`` run here on the same frames
(read by OpenCV): depth maps and trajectories within 1e-4 (relative L2 per
map, absolute on the poses); the point cloud's size within the pixels that
lie within 1e-4 of ``filter_depth``'s thresholds in the JAX depth. The same
frames as JPEG and BMP files go through ``infer_video`` to the same bar, and
as an ``mp4v`` video written by OpenCV: the JAX CLI's ``parse_video`` and the
port's CLI extract byte-equal JPEG frames from it, and the port's windows
over them match the JAX package's to the same bar.
``infer_video --ba`` refines the keyframes as the JAX CLI does: its keyframe
poses and ``ba_scales.npy`` against the JAX package's `optimize_dense_ba`
fed the port's own depth maps and chained poses with the CLI's ``K_ba``
and edges (1e-4). What the port does not read (an FLV file, a lossless
JPEG) raises `NotImplementedError`, a corrupt MP4 file `ValueError`.
"""
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.data.video import dummy_calibration
from dro_sfm_tpu.inference import TrajectoryAccumulator, filter_depth
from dro_sfm_tpu.inference import load_model as jax_load_model
from dro_sfm_tpu.inference import make_infer_fn as jax_make_infer_fn
from dro_sfm_tpu.models import DepthPoseNet
from dro_sfm_tpu.training.checkpoint import save_checkpoint
from dro_sfm_tpu.utils.config import load_config
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.scripts import infer, infer_pose, infer_video
from dro_sfm_torch.utils.depth import load_depth
from dro_sfm_torch.utils.image_io import write_png
from tests.test_torch_modules import fill_variables
from tools.torch_image_kinds import lossless_gray

torch.set_num_threads(4)
H, W, FRAMES = 48, 64, 5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("infer_cli")
    cfg = load_config(overrides={
        "model": {"depth_net": {"version": "it4-h-out-seq2"},
                  "params": {"min_depth": 0.2, "max_depth": 20.0}},
        "datasets": {"augmentation": {"image_shape": (H, W)}}})
    net = DepthPoseNet(version="it4-h-out-seq2", min_depth=0.2, max_depth=20.0)
    variables = fill_variables(lambda k: net.init(
        k, jnp.zeros((1, H, W, 3)), jnp.zeros((1, 2, H, W, 3)), jnp.eye(3)[None],
        train=False))

    class State:
        params = variables["params"]
        batch_stats = variables["batch_stats"]
        opt_state = ()
        step = 0

    ckpt = str(tmp / "tiny.ckpt")
    save_checkpoint(ckpt, State(), epoch=0, config=cfg.to_dict())
    frames, gt = tmp / "frames", tmp / "gt"
    frames.mkdir()
    gt.mkdir()
    data = SyntheticDataset(SyntheticConfig(height=H, width=W, num_planes=3))
    planes, _ = data._scene(2)
    for i in range(FRAMES):
        T = np.eye(4)
        T[:3, 3] = [0.04 * i, 0.0, 0.03 * i]
        rgb, _ = data._render(planes, T)
        write_png(str(frames / f"f{i:04d}.png"), (rgb * 255).astype(np.uint8))
        np.savetxt(gt / f"f{i:04d}.txt", T)
    return {"ckpt": ckpt, "frames": str(frames), "gt": str(gt), "tmp": tmp}


@pytest.fixture(scope="module")
def reference(scene):
    """The JAX package's windows over the same frames."""
    jnet, variables, cfg = jax_load_model(scene["ckpt"])
    fn = jax_make_infer_fn(jnet)
    K = dummy_calibration(W, H)
    files = sorted(os.listdir(scene["frames"]))

    def load(f):
        img = cv2.imread(os.path.join(scene["frames"], f), cv2.IMREAD_COLOR)[..., ::-1]
        return cv2.resize(img, (W, H)).astype(np.float32) / 255.0

    accum = TrajectoryAccumulator()
    depths, filtered = [], []
    for i in range(1, FRAMES - 1):
        depth, poses = fn(variables, jnp.asarray(load(files[i])[None]),
                          jnp.asarray(np.stack([load(files[i - 1]), load(files[i + 1])])[None]),
                          jnp.asarray(K[None]))
        depths.append(np.asarray(depth))
        accum.add(np.asarray(poses)[0], np.asarray(poses)[1])
        filtered.append(filter_depth(np.asarray(depth)))
    return {"depths": np.stack(depths), "trajectory": np.stack(accum.trajectory),
            "filtered": filtered, "fn": fn, "variables": variables, "load": load, "K": K,
            "files": files}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ply_count(path):
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])


def test_infer_video_matches_the_jax_package(scene, reference, capsys):
    out = str(scene["tmp"] / "video")
    result = infer_video.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                               "--output", out, "--gt-poses", scene["gt"], "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "ATE-RMSE" in printed and "depth_vis.mp4" in printed
    for name in ("trajectory.png", "depth_vis.mp4", "panels/rgb_000000.png"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    assert result["windows"] == FRAMES - 2 and result["ate"] is not None
    depths = np.load(os.path.join(out, "depths.npy"))
    assert depths.shape == (FRAMES - 2, H, W)
    for got, want in zip(depths, reference["depths"]):
        assert rel_l2(got, want) <= 1e-4
    traj = np.asarray(json.load(open(os.path.join(out, "trajectory.json"))))
    np.testing.assert_allclose(traj, reference["trajectory"], atol=1e-4, rtol=0)
    # the point cloud: filter_depth on the JAX depths, but for pixels within
    # 1e-4 of its thresholds, where a last-bit difference may flip one
    s, uncertain, want = 4, 0, 0
    for depth, filt in zip(reference["depths"], reference["filtered"]):
        pad = np.pad(depth, [(0, 1), (0, 1)])
        grad = (pad[1:, :-1] - pad[:-1, :-1]) ** 2 + (pad[:-1, 1:] - pad[:-1, :-1]) ** 2
        near = (np.abs(grad - 0.05) < 1e-4) | (np.abs(depth - 10.0) < 1e-4)
        uncertain += int(near[::s, ::s].sum())
        want += int((filt[::s, ::s] > 0).sum())
    assert abs(ply_count(os.path.join(out, "pointcloud.ply")) - want) <= uncertain
    assert result["points"] == ply_count(os.path.join(out, "pointcloud.ply"))
    obj = open(os.path.join(out, "trajectory_pose.obj")).read().splitlines()
    assert sum(line.startswith("v ") for line in obj) == FRAMES - 2


def test_infer_video_on_a_video_file_matches_the_jax_package(scene, reference, capsys):
    """The scene's frames as an mp4v .mp4 (cv2.VideoWriter): the JAX CLI's
    extraction (`scripts/infer_video.py:parse_video`) and the port's CLI
    write byte-equal JPEG frames; the port's depths and trajectory over them
    match the JAX package's windows over the JAX frames (1e-4, the bars of
    `test_infer_video_matches_the_jax_package`)."""
    tmp = scene["tmp"] / "from_video"
    tmp.mkdir()
    video = str(tmp / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for f in sorted(os.listdir(scene["frames"])):
        writer.write(cv2.imread(os.path.join(scene["frames"], f), cv2.IMREAD_COLOR))
    writer.release()
    video_file_matches_the_jax_package(scene, reference, capsys, tmp, video)


def test_infer_video_on_an_h264_file_matches_the_jax_package(scene, reference, capsys):
    """The same with the scene's frames as an H.264 Constrained Baseline
    .mp4 from libx264 (`tools/torch_make_video_fixtures.py:write_libav`),
    which FFmpeg decodes for the JAX CLI and the port's host decoder for
    its own."""
    from tools.torch_make_video_fixtures import write_libav
    tmp = scene["tmp"] / "from_h264"
    tmp.mkdir()
    video = str(tmp / "clip.mp4")
    frames = [cv2.imread(os.path.join(scene["frames"], f), cv2.IMREAD_COLOR)[..., ::-1]
              for f in sorted(os.listdir(scene["frames"]))]
    write_libav(video, frames, ["profile=baseline", "x264-params=ref=2:partitions=all"])
    video_file_matches_the_jax_package(scene, reference, capsys, tmp, video)


def test_infer_video_on_an_h264_high_file_matches_the_jax_package(scene, reference, capsys):
    """The same with libx264's defaults (High profile: CABAC, B-pyramid,
    the 8x8 transform, weighted prediction) in an .mp4, whose frames the
    port's decoder reorders into display order as FFmpeg does."""
    from tools.torch_make_video_fixtures import write_libav
    tmp = scene["tmp"] / "from_h264_high"
    tmp.mkdir()
    video = str(tmp / "clip.mp4")
    frames = [cv2.imread(os.path.join(scene["frames"], f), cv2.IMREAD_COLOR)[..., ::-1]
              for f in sorted(os.listdir(scene["frames"]))]
    write_libav(video, frames, ["profile=high"])
    video_file_matches_the_jax_package(scene, reference, capsys, tmp, video)


def test_infer_video_on_an_xvid_avi_matches_the_jax_package(scene, reference, capsys):
    """The same with the scene's frames as an XviD .avi from libxvid with
    B-frames and four vectors (packed B-frames, XviD's IDCT), which FFmpeg
    decodes for the JAX CLI and the port's MPEG-4 decoder for its own. The
    libxvid wrapper does not flush XviD's last B-frames: two more copies of
    the last frame make the file hold the scene's five."""
    from tools.torch_make_video_fixtures import write_libav
    tmp = scene["tmp"] / "from_xvid"
    tmp.mkdir()
    video = str(tmp / "clip.avi")
    frames = [cv2.imread(os.path.join(scene["frames"], f), cv2.IMREAD_COLOR)[..., ::-1]
              for f in sorted(os.listdir(scene["frames"]))]
    write_libav(video, frames + frames[-1:] * 2,
                ["encoder=libxvid", "tag=XVID", "bf=2", "flags=+mv4"])
    video_file_matches_the_jax_package(scene, reference, capsys, tmp, video)


def video_file_matches_the_jax_package(scene, reference, capsys, tmp, video):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts", "infer_video.py")
    spec = importlib.util.spec_from_file_location("jax_infer_video_cli", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax_dir = str(tmp / "jax_frames")
    assert module.parse_video(video, jax_dir, 1) == FRAMES
    out = str(tmp / "port")
    result = infer_video.main(["--checkpoint", scene["ckpt"], "--input", video, "--output", out,
                               "--device", "cpu"])
    assert f"extracted {FRAMES} frames" in capsys.readouterr().out
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(os.path.join(out, "input_frames"))) == names
    for n in names:
        with open(os.path.join(jax_dir, n), "rb") as a, \
                open(os.path.join(out, "input_frames", n), "rb") as b:
            assert a.read() == b.read(), n
    ext = result["extraction"]
    assert ext["frames"] == FRAMES and len(ext["decode_ms"]) == len(ext["encode_ms"]) == FRAMES
    assert result["windows"] == FRAMES - 2

    def load(f):
        img = cv2.imread(os.path.join(jax_dir, f), cv2.IMREAD_COLOR)[..., ::-1]
        return cv2.resize(img, (W, H)).astype(np.float32) / 255.0

    accum, want = TrajectoryAccumulator(), []
    for i in range(1, FRAMES - 1):
        depth, poses = reference["fn"](
            reference["variables"], jnp.asarray(load(names[i])[None]),
            jnp.asarray(np.stack([load(names[i - 1]), load(names[i + 1])])[None]),
            jnp.asarray(reference["K"][None]))
        want.append(np.asarray(depth))
        accum.add(np.asarray(poses)[0], np.asarray(poses)[1])
    depths = np.load(os.path.join(out, "depths.npy"))
    for got, ref in zip(depths, want):
        assert rel_l2(got, ref) <= 1e-4
    traj = np.asarray(json.load(open(os.path.join(out, "trajectory.json"))))
    np.testing.assert_allclose(traj, np.stack(accum.trajectory), atol=1e-4, rtol=0)


def test_infer_video_fusion_runs(scene):
    out = str(scene["tmp"] / "fused")
    result = infer_video.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                               "--output", out, "--fusion-views", "2", "--device", "cpu"])
    assert result["windows"] == FRAMES - 2 and result["points"] >= 0
    assert len(result["decode_ms"]) == FRAMES                 # each frame decoded once


BA_H, BA_W, BA_FRAMES = 96, 128, 8


def video_of_the_wavy_surface(n, rng):
    """A stand-in for the net in `open_model`: window i gets the exact depth
    of the wavy surface seen by frame i (camera-to-world T_i, the dummy
    calibration) and the relative poses T_{i-1}^-1 T_i, T_{i+1}^-1 T_i with
    twist noise 0.02, so that the chained trajectory is the path with drift
    and BA has something to correct."""
    from dro_sfm_torch.ba.lie import se3_exp
    from dro_sfm_torch.data.video import dummy_calibration as t_calibration
    from tools.torch_bench_ba import wavy_depth
    K = t_calibration(BA_W, BA_H)
    T = [np.eye(4)]
    for i in range(1, n):
        T.append(np.eye(4))
        T[-1][:3, 3] = [0.06 * i, 0.02 * np.sin(0.5 * i), 0.03 * i]
    depth = {i: wavy_depth(BA_H, BA_W, K, T[i]) for i in range(n)}
    noise = se3_exp(torch.from_numpy(rng.normal(size=(n, 2, 6)) * 0.02)).numpy()
    index = iter(range(1, n - 1))

    def infer(target, refs):
        i = next(index)
        rel = np.stack([np.linalg.inv(T[i - 1]) @ T[i], np.linalg.inv(T[i + 1]) @ T[i]])
        return depth[i], (rel @ noise[i]).astype(np.float32)

    return infer, K


def test_infer_video_ba_matches_the_jax_package(scene, tmp_path, monkeypatch):
    """``--ba --ba-stride 1`` on 6 windows: each window a keyframe, an edge
    between keyframes at most 2 apart. The JAX side copies the JAX CLI's
    block (`scripts/infer_video.py:215-244`) on the port's depths and chained
    poses. The windows come from the exact wavy surface with noisy relative
    poses (`video_of_the_wavy_surface`), so that BA moves the keyframes."""
    from dro_sfm_tpu.ba import BAProblem, optimize_dense_ba
    from dro_sfm_torch.scripts import frames as frames_mod
    folder = tmp_path / "frames"
    folder.mkdir()
    first = sorted(os.listdir(scene["frames"]))[0]
    for i in range(BA_FRAMES):
        (folder / f"{i:04d}.png").write_bytes(open(os.path.join(scene["frames"], first),
                                                   "rb").read())
    runs = {}
    for name, extra in (("no_ba", []), ("ba", ["--ba", "--ba-stride", "1"])):
        infer, K = video_of_the_wavy_surface(BA_FRAMES, np.random.default_rng(7))
        monkeypatch.setattr(frames_mod, "open_model",
                            lambda *a, **k: (infer, (BA_H, BA_W), K))
        out = str(tmp_path / name)
        runs[name] = infer_video.main(["--checkpoint", scene["ckpt"], "--input", str(folder),
                                       "--output", out, "--device", "cpu"] + extra)
        runs[name]["trajectory"] = np.asarray(json.load(open(os.path.join(
            out, "trajectory.json"))))
    ba = runs["ba"]["ba"]
    assert ba["keyframes"] == list(range(6)) and ba["edges"] == 18
    assert runs["no_ba"]["ba"] is None
    before = runs["no_ba"]["trajectory"].astype(np.float32)
    after = runs["ba"]["trajectory"]
    depths = np.load(str(tmp_path / "ba" / "depths.npy"))
    s = 4
    K_ba = dummy_calibration(BA_W, BA_H)
    K_ba[0] /= s
    K_ba[1] /= s
    ei, ej = zip(*[(a, b) for a in range(6) for b in range(max(0, a - 2), min(6, a + 3))
                   if a != b])
    refined, sigmas = optimize_dense_ba(
        BAProblem(jnp.asarray(before), jnp.asarray(depths[:, ::s, ::s]), jnp.asarray(K_ba),
                  jnp.asarray(ei), jnp.asarray(ej)), stride=1, iters=6)
    np.testing.assert_allclose(after, np.asarray(refined), rtol=0, atol=1e-4)
    scales = np.load(str(tmp_path / "ba" / "ba_scales.npy"))
    np.testing.assert_allclose(scales, np.exp(np.asarray(sigmas)), rtol=0, atol=1e-4)
    assert np.abs(after - before).max() > 1e-3 and np.abs(scales - 1).max() > 1e-4
    assert np.isfinite(scales).all() and (scales > 0).all()


def test_infer_and_infer_pose_match_the_jax_package(scene, reference):
    out = scene["tmp"] / "single"
    written = infer.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                          "--output", str(out), "--ply", "--device", "cpu"])
    assert len(written) == FRAMES and len(list(out.glob("*.ply"))) == FRAMES
    load, fn, K = reference["load"], reference["fn"], reference["K"]
    files = reference["files"]
    for i, path in enumerate(written):
        prev_f, next_f = files[max(i - 1, 0)], files[min(i + 1, FRAMES - 1)]
        depth, _ = fn(reference["variables"], jnp.asarray(load(files[i])[None]),
                      jnp.asarray(np.stack([load(prev_f), load(next_f)])[None]),
                      jnp.asarray(K[None]))
        assert rel_l2(load_depth(path), np.asarray(depth)) <= 1e-4
        assert np.array_equal(np.load(path)["intrinsics"], K)
    # a single frame is its own context; a png holds depth * 256 as uint16
    png = infer.main(["--checkpoint", scene["ckpt"], "--input", os.path.join(
        scene["frames"], files[1]), "--output", str(out / "png"), "--save", "png",
        "--device", "cpu"])
    one = load(files[1])
    depth, _ = fn(reference["variables"], jnp.asarray(one[None]),
                  jnp.asarray(np.stack([one, one])[None]), jnp.asarray(K[None]))
    got = cv2.imread(png[0], cv2.IMREAD_ANYDEPTH).astype(int)
    want = (np.asarray(depth) * 256.0).astype(np.uint16).astype(int)
    assert got.shape == (H, W) and np.abs(got - want).max() <= 1

    traj_path = str(scene["tmp"] / "pose.json")
    infer_pose.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                     "--output", traj_path, "--device", "cpu"])
    np.testing.assert_allclose(np.asarray(json.load(open(traj_path))),
                               reference["trajectory"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("ext", [".jpg", ".bmp"])
def test_jpeg_and_bmp_frames_match_the_jax_package(scene, reference, tmp_path, ext):
    """The same frames as JPEG (4:2:0, quality 95) or BMP files, read by the
    port's codec and, for the JAX package, by OpenCV."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for f in reference["files"]:
        img = cv2.imread(os.path.join(scene["frames"], f))
        cv2.imwrite(str(frames / f.replace(".png", ext)), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    result = infer_video.main(["--checkpoint", scene["ckpt"], "--input", str(frames),
                               "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert result["windows"] == FRAMES - 2
    files = sorted(os.listdir(frames))

    def load(f):
        img = cv2.imread(str(frames / f), cv2.IMREAD_COLOR)[..., ::-1]
        return img.astype(np.float32) / 255.0

    depths = np.load(str(tmp_path / "out" / "depths.npy"))
    for i in range(1, FRAMES - 1):
        depth, _ = reference["fn"](
            reference["variables"], jnp.asarray(load(files[i])[None]),
            jnp.asarray(np.stack([load(files[i - 1]), load(files[i + 1])])[None]),
            jnp.asarray(reference["K"][None]))
        assert rel_l2(depths[i - 1], np.asarray(depth)) <= 1e-4


def test_what_is_not_ported_raises(scene, tmp_path):
    common = ["--checkpoint", scene["ckpt"], "--device", "cpu"]
    jpg_dir = tmp_path / "jpg"
    jpg_dir.mkdir()
    for i in range(3):
        (jpg_dir / f"{i}.jpg").write_bytes(lossless_gray(np.zeros((H, W), np.uint8)))
    flv = tmp_path / "clip.flv"
    flv.write_bytes(b"FLV\x01\x05\x00\x00\x00\x09" + bytes(64))
    corrupt = tmp_path / "clip.mp4"
    corrupt.write_bytes(b"\x00\x00\x00\x18ftypisom" + np.random.default_rng(0).bytes(4096))
    cases = [
        (infer_video.main, ["--input", str(flv), "--output", str(tmp_path)], "FLV.*ROADMAP C"),
        (infer_video.main, ["--input", str(jpg_dir), "--output", str(tmp_path)],
         "lossless"),
    ]
    for main, args, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            main(common + args)
    with pytest.raises(ValueError, match="clip.mp4"):
        infer_video.main(common + ["--input", str(corrupt), "--output", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            infer_pose.main(["--checkpoint", scene["ckpt"], "--input", scene["frames"],
                             "--output", str(tmp_path / "t.json")])
