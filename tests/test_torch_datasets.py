"""The port's dataset readers against the JAX package's, on the same trees (CPU).

Each tree is written with OpenCV as `tests/test_datasets.py` and
`tests/test_dgp.py` write theirs: JPEG colour frames (PNG for KITTI, a BMP
and a PNG among the video frames; ScanNet's and the video folders' JPEG
frames cycle through baseline, progressive with restarts, arithmetic-coded
from the system's libjpeg and CMYK from Pillow, and an RLE8 BMP joins the
video frames), 16-bit PNG depth (millimetres for
ScanNet and Matterport, at half the image size so that the nearest resize to
the image runs; KITTI's ``groundtruth`` at /256), ``.npy`` depth (DeMoN),
lidar point clouds (DGP), poses, intrinsics and split files. Every dataset
name is built through both packages' ``setup_dataset`` from the same config,
in training mode (resize to ``image_shape``, colour jitter 0.2/0.2/0.2/0.05)
and in validation mode (resize, ground-truth depth at full resolution), and
every key of every sample must be equal: images, depth, intrinsics and poses
bit for bit. The JAX package decodes and resizes with OpenCV; the port with
its own codec and numpy (`dro_sfm_torch.utils.image_io`,
`dro_sfm_torch.data.transforms`).
"""
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_tpu.data import setup_dataset as jax_setup
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch.data import setup_dataset
from dro_sfm_torch.utils.config import load_config
from tools.torch_image_kinds import bmp_file, libjpeg_write, rle_encode

H, W = 48, 64
JITTER = [0.2, 0.2, 0.2, 0.05]


def frame(seed, h=H, w=W):
    """A smooth gradient plus noise, uint8 BGR."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, (xx + yy + 40 * seed) % 256], -1)
    return np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


JPEG_KINDS = ("baseline", "progressive", "arithmetic", "cmyk")


def write_jpg(path, seed, h=H, w=W, kind="baseline"):
    """``frame(seed)`` as a JPEG file of ``kind`` (`JPEG_KINDS`)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bgr = frame(seed, h, w)
    if kind == "arithmetic":
        path.write_bytes(libjpeg_write(bgr[..., ::-1], "-arith", "-quality", "90",
                                       "-restart", "3"))
    elif kind == "cmyk":
        Image.fromarray(bgr[..., ::-1]).convert("CMYK").save(path, "JPEG", quality=90)
    else:
        extra = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2] \
            if kind == "progressive" else []
        cv2.imwrite(str(path), bgr, [cv2.IMWRITE_JPEG_QUALITY, 90] + extra)


def write_rle8_bmp(path, seed):
    """``frame(seed)`` quantized to 256 colours as an RLE8 BMP."""
    img = Image.fromarray(frame(seed)[..., ::-1]).quantize(256)
    pal = np.array(img.getpalette(), np.uint8).reshape(-1, 3)[:256]
    path.write_bytes(bmp_file(W, H, 8, rle_encode(np.array(img), 8), compression=1, palette=pal))


def write_depth_mm(path, seed, h=H // 2, w=W // 2):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    depth = np.random.default_rng(100 + seed).integers(500, 5000, (h, w)).astype(np.uint16)
    depth[0, 0] = 0
    cv2.imwrite(str(path), depth)


def write_pose(path, t):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    a = 0.05 * t
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = [0.1 * t, 0.02 * t, 0.0]
    np.savetxt(path, pose)


def scannet_tree(tmp, n=22):
    root = tmp / "scans"
    scene = "scene0000_00"
    names = [f"{i:06d}.jpg" for i in range(0, 5 * n, 5)]
    for i, name in enumerate(names):
        write_jpg(root / scene / "color" / name, i, kind=JPEG_KINDS[i % len(JPEG_KINDS)])
        write_depth_mm(root / scene / "depth" / name.replace(".jpg", ".png"), i)
        write_pose(root / scene / "pose" / name.replace(".jpg", ".txt"), i)
    os.makedirs(root / scene / "intrinsic")
    np.savetxt(root / scene / "intrinsic" / "intrinsic_color.txt",
               [[50.0, 0, 31.5, 0], [0, 50.0, 23.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    with open(tmp / "train_split.txt", "w") as f:
        f.writelines(f"{scene}/color {name}\n" for name in names)
    with open(tmp / "tuples.txt", "w") as f:
        f.write(f"{scene}/color {names[2]} {names[0]} {names[4]}\n")
        f.write(f"{scene}/color {names[7]} {names[5]} {names[9]}\n")
    os.makedirs(tmp / "splits")

    def group(target, partner):
        base = f"data/scannet/scans/{scene}"
        return "".join([f"{base}/frame-{target}.color.jpg\n",
                        f"{base}/frame-{partner}.color.jpg\n"]
                       + [f"{base}/ignored-{i}.txt\n" for i in range(5)])

    with open(tmp / "splits" / "banet_train.txt", "w") as f:
        f.write(group("000020", "000025") + group("000050", "000045")
                + group("000005", "000010"))
    return str(root)


def kitti_tree(tmp):
    root = tmp / "kitti"
    date = "2011_09_26"
    drive = f"{date}/{date}_drive_0001_sync"
    for i in range(6):
        name = f"{i:010d}"
        img = root / drive / "image_02" / "data" / f"{name}.png"
        os.makedirs(img.parent, exist_ok=True)
        cv2.imwrite(str(img), frame(i))
        oxts = root / drive / "oxts" / "data" / f"{name}.txt"
        os.makedirs(oxts.parent, exist_ok=True)
        vals = [49.0 + i * 1e-5, 8.43 + i * 2e-5, 110.0, 0.01 * i, 0.0, 0.1 * i] + [0.0] * 24
        np.savetxt(str(oxts), np.array(vals)[None], fmt="%.8f")
        depth = root / drive / "proj_depth" / "groundtruth" / "image_02" / f"{name}.png"
        os.makedirs(depth.parent, exist_ok=True)
        gt = np.random.default_rng(i).integers(256, 20000, (H, W)).astype(np.uint16)
        gt[::3, ::2] = 0
        cv2.imwrite(str(depth), gt)
    with open(root / date / "calib_cam_to_cam.txt", "w") as f:
        f.write("P_rect_02: 50.0 0.0 31.5 4.5 0.0 50.0 23.5 0.1 0.0 0.0 1.0 0.003\n")
        f.write("R_rect_00: 0.9999 0.0093 -0.0073 -0.0093 0.9999 -0.0043 0.0074 0.0042 0.9999\n")
    with open(root / date / "calib_velo_to_cam.txt", "w") as f:
        f.write("R: 0.0075 -0.9999 -0.0006 0.0148 0.0007 -0.9999 0.9999 0.0075 0.0148\n"
                "T: -0.0041 -0.0763 -0.2717\n")
    with open(root / date / "calib_imu_to_velo.txt", "w") as f:
        f.write("R: 1 0.0008 -0.002 -0.0008 0.9999 0.0148 0.002 -0.0148 0.9999\n"
                "T: -0.8087 0.3196 -0.7997\n")
    with open(root / "split.txt", "w") as f:
        f.writelines(f"{drive}/image_02/data/{i:010d}.png\n" for i in range(1, 5))
    return str(root)


def demon_tree(tmp):
    root = tmp / "demon"
    folders = {"sun3d_two": 2, "rgbd_three": 3, "scenes11_three": 3}
    for k, (name, views) in enumerate(folders.items()):
        d = root / name
        rows = []
        for i in range(views):
            write_jpg(d / f"{i:04d}.jpg", 10 * k + i)
            np.save(d / f"{i:04d}.npy",
                    np.random.default_rng(i).uniform(0.5, 9, (H, W)).astype(np.float32))
            T = np.eye(4)
            T[:3, 3] = [0.2 * i, -0.05 * i, 0.01 * k]
            rows.append(T[:3].reshape(-1))
        np.savetxt(d / "poses.txt", np.stack(rows))
        np.savetxt(d / "cam.txt", [[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]])
    with open(root / "train.txt", "w") as f:
        f.writelines(f"{name}\n" for name in folders)
    return str(root)


def matterport_tree(tmp):
    root = tmp / "matterport"
    names = [f"{i:013d}.jpg" for i in range(14)]
    for i, name in enumerate(names):
        write_jpg(root / "sceneA" / "cam_left" / name, i)
        write_depth_mm(root / "sceneA" / "depth" / name.replace(".jpg", ".png"), i)
        step = 0.3 if i in (6, 7) else 0.05          # two large moves for the adaptive cut
        write_pose(root / "sceneA" / "pose" / name.replace(".jpg", ".txt"), i * step / 0.05)
    with open(root / "split.txt", "w") as f:
        f.writelines(f"sceneA/cam_left {name}\n" for name in names)
    return str(root)


def video_tree(tmp):
    root = tmp / "video"
    for seq, n in (("seq0", 7), ("seq1", 5)):
        for i in range(n):
            path = root / seq / f"{i:06d}.jpg"
            write_jpg(path, i + 10 * len(seq), kind=JPEG_KINDS[i % len(JPEG_KINDS)])
    cv2.imwrite(str(root / "seq1" / "000005.png"), frame(77))
    cv2.imwrite(str(root / "seq1" / "000006.bmp"), frame(78))
    write_rle8_bmp(root / "seq1" / "000007.bmp", 79)
    return str(root)


def dgp_tree(tmp):
    root = tmp / "ddad"
    scene_dir = root / "scene_000"
    cam, lidar = "camera_01", "lidar"
    ys, xs = np.mgrid[-1.0:1.0:16j, -2.0:3.0:32j]
    points = np.stack([xs.ravel(), ys.ravel(), 4.0 + 0.3 * np.sin(xs.ravel())], -1)
    os.makedirs(scene_dir / "point_cloud" / lidar)
    data, samples = [], []

    def pose(tx):
        return {"translation": {"x": tx, "y": 0.0, "z": 0.0},
                "rotation": {"qw": 0.999, "qx": 0.01, "qy": 0.03, "qz": 0.0}}

    for t in range(4):
        ts = f"{t:016d}"
        write_jpg(scene_dir / "rgb" / cam / f"{ts}.jpg", t)
        np.savez(scene_dir / "point_cloud" / lidar / f"{ts}.npz", data=points)
        data += [{"key": f"img{t}", "id": {"name": cam, "timestamp": ts},
                  "datum": {"image": {"filename": f"rgb/{cam}/{ts}.jpg", "pose": pose(0.5 * t)}}},
                 {"key": f"pc{t}", "id": {"name": lidar, "timestamp": ts},
                  "datum": {"point_cloud": {"filename": f"point_cloud/{lidar}/{ts}.npz",
                                            "pose": pose(0.0)}}}]
        samples.append({"id": {"timestamp": ts}, "datum_keys": [f"img{t}", f"pc{t}"],
                        "calibration_key": "calib0"})
    os.makedirs(scene_dir / "calibration")
    with open(scene_dir / "calibration" / "calib0.json", "w") as f:
        json.dump({"names": [cam, lidar], "intrinsics": [
            {"fx": 50.0, "fy": 50.0, "cx": 31.5, "cy": 23.5}, {}]}, f)
    with open(scene_dir / "scene.json", "w") as f:
        json.dump({"name": "scene_000", "samples": samples, "data": data}, f)
    with open(root / "scene_dataset_v1.0.json", "w") as f:
        json.dump({"scene_splits": {"0": {"filenames": ["scene_000/scene.json"]}}}, f)
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trees")
    return {"scannet": scannet_tree(tmp), "kitti": kitti_tree(tmp), "demon": demon_tree(tmp),
            "matterport": matterport_tree(tmp), "video": video_tree(tmp),
            "dgp": dgp_tree(tmp)}


# name -> (tree, split, section overrides, image_shape)
CASES = {
    "KITTI": ("kitti", "split.txt", {"depth_type": ["groundtruth"]}, (32, 48)),
    "Scannet": ("scannet", "train_split.txt", {"depth_type": ["groundtruth"]}, (24, 32)),
    "ScannetTest": ("scannet", "tuples.txt", {"depth_type": ["groundtruth"]}, (32, 48)),
    "ScannetTestMF": ("scannet", "tuples.txt", {"depth_type": ["groundtruth"]}, (24, 32)),
    "ScannetBA": ("scannet", "train_split.txt", {"depth_type": ["groundtruth"]}, (32, 48)),
    "MatterportBA": ("scannet", "train_split.txt",
                     {"depth_type": ["groundtruth"], "back_context": 2,
                      "forward_context": 2}, (24, 32)),
    "Demon": ("demon", "train.txt", {"depth_type": ["groundtruth"]}, (32, 48)),
    "DemonMF": ("demon", "train.txt", {"depth_type": ["groundtruth"]}, (24, 32)),
    "Matterport": ("matterport", "split.txt", {"depth_type": ["groundtruth"]}, (32, 48)),
    "MatterportTest": ("matterport", "split.txt", {"depth_type": ["groundtruth"]}, (24, 32)),
    "Video": ("video", "", {}, (32, 48)),
    "Video_Random": ("video", "", {"strides": [2]}, (24, 32)),
    "Image": ("video", "", {"back_context": 0}, (36, 40)),
    "DGP": ("dgp", "train", {"depth_type": ["lidar"], "cameras": [["camera_01"]]}, (32, 48)),
}


def build(setup, load, trees, name, mode):
    tree, split, extra, shape = CASES[name]
    key = "train" if mode == "train" else "validation"
    section = {"dataset": [name], "path": [trees[tree]], "split": [split],
               "back_context": 1, "forward_context": 1, **extra}
    cfg = load(overrides={"datasets": {
        "augmentation": {"image_shape": list(shape), "jittering": JITTER}, key: section}})
    ds = setup(cfg.datasets[key], cfg.datasets.augmentation, mode)
    return ds if mode == "train" else ds[0]


@pytest.mark.parametrize("mode", ["train", "validation"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_matches_jax(trees, name, mode):
    ours = build(setup_dataset, load_config, trees, name, mode)
    ref = build(jax_setup, jax_load_config, trees, name, mode)
    assert len(ours) == len(ref) > 0
    shape = CASES[name][3]
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b), (i, sorted(a), sorted(b))
        assert a["rgb"].shape == (*shape, 3) and a["rgb"].dtype == np.float32
        for key in b:
            x, y = a[key], b[key]
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (i, key)
                assert np.array_equal(x, y), (i, key, np.abs(x.astype(float) - y).max())
            else:
                assert x == y, (i, key)
        if mode != "train" and "depth" in b:
            assert a["depth"].shape[:2] != shape     # ground truth at full resolution


def test_unported_names_raise():
    cfg = load_config(overrides={"datasets": {"train": {"dataset": ["NoSuchSet"]}}})
    with pytest.raises(KeyError, match="NoSuchSet"):
        setup_dataset(cfg.datasets.train, cfg.datasets.augmentation, "train")
    # NYU is read now: its missing default folder raises, no empty dataset
    cfg = load_config(overrides={"datasets": {"train": {"dataset": ["NYU"]}}})
    with pytest.raises(FileNotFoundError):
        setup_dataset(cfg.datasets.train, cfg.datasets.augmentation, "train")


def test_decode_cache_returns_copies(trees):
    from dro_sfm_torch.data.kitti import load_image_rgb
    path = os.path.join(trees["video"], "seq0", "000001.jpg")
    a = load_image_rgb(path)
    a[:] = 0
    b = load_image_rgb(path)
    assert np.array_equal(b, cv2.imread(path)[..., ::-1]) and b.any()
    with pytest.raises(FileNotFoundError):
        load_image_rgb(path + ".missing")
