"""Dataset split generation and filtering.

    python -m dro_sfm_torch.scripts.generate_splits --root /data/scannet/scans \
        --layout scannet --out splits/train_split.txt \
        [--test-scenes splits/test_scenes.txt] [--max-rot 0.5 --max-trans 1.0]
        [--val-tail 500 --test-tail 100] [--depth-vis] [--traj-obj] [--tuple-context 1]

The port's copy of `tools/generate_splits.py`: scan a scene tree, drop
frames whose pose is missing, not finite, not a rotation, or moves more
than ``--max-rot`` / ``--max-trans`` from the previous frame's, and write the
split; with ``--val-tail``/``--test-tail`` each scene's last frames go to
``<out>.val`` and ``<out>.test``; ``--tuple-context`` writes target and
context tuples. ``--depth-vis`` renders each millimetre depth PNG's inverse
depth (``depth_vis/``) and the frame masked where the depth is invalid
(``<image_dir>_vis/``) as JPEGs, through the port's PNG reader and JPEG
encoder (the bytes OpenCV writes at quality 95); ``--traj-obj`` writes each
scene's camera trajectory as OBJ, in the world and from the first frame.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

LAYOUTS = {
    "scannet": {"image_dir": "color", "pose_dir": "pose", "ext": ".jpg"},
    "matterport": {"image_dir": "cam_left", "pose_dir": "pose", "ext": ".jpg"},
}


def pose_ok(pose: np.ndarray) -> bool:
    """A finite pose whose rotation has determinant 1."""
    if not np.all(np.isfinite(pose)):
        return False
    return abs(np.linalg.det(pose[:3, :3]) - 1.0) < 1e-2


def motion_ok(prev: np.ndarray, cur: np.ndarray, max_rot: float, max_trans: float) -> bool:
    rel = np.linalg.inv(prev) @ cur
    angle = np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))
    return angle < max_rot and np.linalg.norm(rel[:3, 3]) < max_trans


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def generate_depth_vis(scene_dir: str, lay: dict, depth_max: float = 10.0) -> int:
    """Inverse-depth colormaps (``depth_vis/``) and frames masked where the
    depth is 0 or beyond ``depth_max`` (``<image_dir>_vis/``), as JPEGs;
    returns the depth maps rendered."""
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.image_io import encode_jpeg, read_image_rgb, read_png
    depth_dir = os.path.join(scene_dir, "depth")
    img_dir = os.path.join(scene_dir, lay["image_dir"])
    if not os.path.isdir(depth_dir):
        return 0
    vis_dir = os.path.join(scene_dir, "depth_vis")
    img_vis_dir = os.path.join(scene_dir, lay["image_dir"] + "_vis")
    os.makedirs(vis_dir, exist_ok=True)
    os.makedirs(img_vis_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(depth_dir)):
        if not fname.endswith(".png"):
            continue
        try:
            depth_png = read_png(os.path.join(depth_dir, fname))
        except (ValueError, NotImplementedError):
            continue                     # not a PNG the reader takes
        depth_png = depth_png[..., 0]
        depth = depth_png.astype(np.float32) / 1000.0
        invalid = (depth_png == 0) | (depth > depth_max)
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
        vis = (viz_inv_depth(inv) * 255).astype(np.uint8)
        vis[invalid] = 0
        base = os.path.splitext(fname)[0]
        _write(os.path.join(vis_dir, base + ".jpg"), encode_jpeg(vis, quality=95))
        ip = os.path.join(img_dir, base + lay["ext"])
        if os.path.exists(ip):
            rgb = read_image_rgb(ip)
            if rgb.shape[:2] == invalid.shape:
                rgb = rgb.copy()
                rgb[invalid] = 0
                _write(os.path.join(img_vis_dir, base + ".jpg"), encode_jpeg(rgb, quality=95))
        n += 1
    return n


def write_traj_obj(scene_dir: str, poses) -> None:
    """The camera trajectory as OBJ: in the world, and from the first frame."""
    from dro_sfm_torch.visualization.demo_video import poses_to_obj
    if not poses:
        return
    poses_to_obj(os.path.join(scene_dir, "camera_trajectory_w.obj"), poses)
    inv0 = np.linalg.inv(poses[0])
    poses_to_obj(os.path.join(scene_dir, "camera_trajectory_c.obj"), [inv0 @ p for p in poses])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="split generation")
    p.add_argument("--root", required=True)
    p.add_argument("--layout", choices=sorted(LAYOUTS), default="scannet")
    p.add_argument("--out", required=True)
    p.add_argument("--test-scenes", default=None, help="file listing scene names to exclude")
    p.add_argument("--max-rot", type=float, default=0.5)
    p.add_argument("--max-trans", type=float, default=1.0)
    p.add_argument("--val-tail", type=int, default=0,
                   help=">0: hold out this many tail frames per scene for val "
                        "(written to <out>.val)")
    p.add_argument("--test-tail", type=int, default=0,
                   help=">0: hold out this many final frames per scene for test "
                        "(written to <out>.test)")
    p.add_argument("--depth-vis", action="store_true",
                   help="render depth colormaps + masked rgb previews")
    p.add_argument("--traj-obj", action="store_true",
                   help="export per-scene camera-trajectory OBJs")
    p.add_argument("--tuple-context", type=int, default=0,
                   help=">0: write BA-style tuple lines 'scene target ctx...' with "
                        "+-N-frame context (the ScannetBA/MatterportBA split format)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    lay = LAYOUTS[args.layout]
    exclude = set()
    if args.test_scenes and os.path.exists(args.test_scenes):
        with open(args.test_scenes) as f:
            exclude = {line.split("/")[0].strip() for line in f if line.strip()}
    train_lines, val_lines, test_lines = [], [], []
    dropped = 0
    for scene in sorted(os.listdir(args.root)):
        if scene in exclude:
            print(f"skip test scene {scene}")
            continue
        scene_dir = os.path.join(args.root, scene)
        img_dir = os.path.join(scene_dir, lay["image_dir"])
        pose_dir = os.path.join(scene_dir, lay["pose_dir"])
        if not os.path.isdir(img_dir):
            continue
        frames = sorted((f for f in os.listdir(img_dir) if f.endswith(lay["ext"])),
                        key=lambda f: int("".join(c for c in f if c.isdigit()) or 0))
        prev_pose = None
        kept, poses = [], []
        for fname in frames:
            pose_path = os.path.join(pose_dir, os.path.splitext(fname)[0] + ".txt")
            if not os.path.exists(pose_path):
                dropped += 1
                continue
            pose = np.genfromtxt(pose_path)
            if not pose_ok(pose):
                dropped += 1
                continue
            if prev_pose is not None and not motion_ok(prev_pose, pose, args.max_rot,
                                                       args.max_trans):
                dropped += 1
                prev_pose = pose
                continue
            prev_pose = pose
            kept.append((f"{scene}/{lay['image_dir']}", fname))
            poses.append(pose.reshape(4, 4))
        if args.tuple_context > 0:
            c = args.tuple_context
            kept = [" ".join([kept[i][0], kept[i][1]]
                             + [kept[j][1] for j in list(range(i - c, i))
                                + list(range(i + 1, i + 1 + c))])
                    for i in range(c, len(kept) - c)]
        else:
            kept = [f"{scene_rel} {fname}" for scene_rel, fname in kept]
        tail = args.val_tail + args.test_tail
        if tail and len(kept) > tail:
            train_lines.extend(kept[:-tail])
            if args.val_tail:
                val_lines.extend(kept[-tail:-args.test_tail] if args.test_tail
                                 else kept[-tail:])
            if args.test_tail:
                test_lines.extend(kept[-args.test_tail:])
        else:
            train_lines.extend(kept)
        if args.depth_vis:
            n = generate_depth_vis(scene_dir, lay)
            print(f"  {scene}: {n} depth-vis frames")
        if args.traj_obj:
            write_traj_obj(scene_dir, poses)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(train_lines) + "\n")
    print(f"wrote {len(train_lines)} train entries ({dropped} dropped) -> {args.out}")
    for tag, lines in (("val", val_lines), ("test", test_lines)):
        if lines:
            path = args.out + "." + tag
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"wrote {len(lines)} {tag} entries -> {path}")


if __name__ == "__main__":
    main()
