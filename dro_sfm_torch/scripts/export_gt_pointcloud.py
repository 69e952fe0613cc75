"""Fuse a scene's ground-truth depth maps into one coloured point cloud.

    python -m dro_sfm_torch.scripts.export_gt_pointcloud --scene /data/scans/scene0000_00 \
        --out scene0000.ply [--layout scannet|matterport] [--stride 10]
        [--pixel-stride 4] [--voxel 0.05] [--depth-max 10]

The port's copy of `tools/export_gt_pointcloud.py`, on the port's
`visualization/pointcloud.py:fuse_scene_pointcloud` (host numpy).
"""
from __future__ import annotations

import argparse

LAYOUTS = {
    "scannet": dict(image_dir="color", depth_dir="depth", pose_dir="pose",
                    intrinsics_file="intrinsic/intrinsic_color.txt"),
    "matterport": dict(image_dir="cam_left", depth_dir="depth", pose_dir="pose",
                       intrinsics_file="intrinsic.txt"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GT depth -> fused point cloud")
    ap.add_argument("--scene", required=True, help="scene directory")
    ap.add_argument("--out", required=True, help=".ply or .obj output")
    ap.add_argument("--layout", choices=sorted(LAYOUTS), default="scannet")
    ap.add_argument("--stride", type=int, default=10, help="frame stride")
    ap.add_argument("--pixel-stride", type=int, default=4)
    ap.add_argument("--voxel", type=float, default=0.0,
                    help=">0 enables voxel-grid downsampling (metres)")
    ap.add_argument("--depth-max", type=float, default=10.0)
    args = ap.parse_args(argv)
    from dro_sfm_torch.visualization.pointcloud import fuse_scene_pointcloud
    n = fuse_scene_pointcloud(args.scene, args.out, stride=args.stride,
                              pixel_stride=args.pixel_stride, voxel=args.voxel,
                              depth_max=args.depth_max, **LAYOUTS[args.layout])
    print(f"wrote {n} points -> {args.out}")
    return n


if __name__ == "__main__":
    main()
