"""Video SfM CLI of the port: a frame folder -> depth maps, trajectory, point cloud.

    python -m dro_sfm_torch.scripts.infer_video --checkpoint x.ckpt --input frames/ \
        --output out/ [--fusion-views 3] [--ba] [--gt-poses poses/] [--device cpu]

The port's counterpart of `scripts/infer_video.py`: 3-frame windows ``i-1,
i, i+1`` for ``i = 1 ... n-2`` over a folder of frames (PNG, JPEG, BMP), the poses
chained with monocular scale propagation, each depth filtered (gradient,
range) and, with ``--fusion-views`` > 1, fused with the previous views by
geometric consistency on the device, and a global coloured point cloud
accumulated. With ``--ba`` the keyframes (every ``--ba-stride``-th window)
are refined by dense bundle adjustment on their depth maps downsampled by 4,
each covisible with the two keyframes on either side
(`dro_sfm_torch.ba.optimize_dense_ba`, stride 1, 6 iterations), their poses
replace the chained ones in the trajectory and ``ba_scales.npy`` holds their
depth scales. Writes ``depths.npy`` (memmapped, one map per window),
``trajectory.json``, ``trajectory_pose.obj`` and ``pointcloud.ply``; with
``--gt-poses`` it prints the ATE after sim3 alignment (after BA). Runs on
the card unless ``--device cpu``.

Not ported: the annotated video ``depth_vis.mp4``, its panels and
``trajectory.png`` (OpenCV and matplotlib, ROADMAP A9: a note is printed,
``--fps`` only sets that video's rate), video input and ``--gt-depth``
(ROADMAP A9), which raise.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch video SfM")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input", required=True, help="frame folder")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--sample-rate", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=500)
    p.add_argument("--image-shape", type=int, nargs=2, default=None)
    p.add_argument("--fusion-views", type=int, default=0,
                   help=">1 enables geometric-consistency fusion over N views")
    p.add_argument("--depth-max", type=float, default=10.0)
    p.add_argument("--grad-max", type=float, default=0.05)
    p.add_argument("--ply-stride", type=int, default=4,
                   help="subsample factor for point-cloud accumulation")
    p.add_argument("--ba", action="store_true",
                   help="refine the keyframe trajectory with dense bundle adjustment "
                        "(Schur-reduced Gauss-Newton)")
    p.add_argument("--ba-stride", type=int, default=2, help="keyframe subsampling for BA")
    p.add_argument("--gt-poses", default=None,
                   help="directory of per-frame GT pose txts ([4,4], matched by frame "
                        "base name): prints the ATE after sim3 alignment")
    p.add_argument("--gt-depth", default=None, help="GT depth panel (ROADMAP A9: raises)")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns what it measured: the number of windows, each
    window's pose matrices ([2,4,4]: to the
    previous and the next frame) and milliseconds (host clock, the result on
    the host), each frame's decode milliseconds, the point count, the ATE
    (None without ground truth) and, with ``--ba``, the keyframes' window
    indices and the BA's milliseconds (host clock, the result on the host)."""
    args = parse_args(argv)
    from dro_sfm_torch.scripts.frames import A9, FrameLoader, list_frames, open_model
    from dro_sfm_torch.visualization.demo_video import VIDEO_NOT_PORTED
    if args.gt_depth:
        raise NotImplementedError(f"--gt-depth feeds the colormapped GT panel ({A9})")
    if not os.path.isdir(args.input):
        raise NotImplementedError(f"{args.input}: decoding a video is {A9}; pass a "
                                  "folder of frames")
    import numpy as np
    import torch

    from dro_sfm_torch.inference import TrajectoryAccumulator, filter_depth, geometric_fusion
    from dro_sfm_torch.utils.device import resolve_device
    from dro_sfm_torch.visualization.demo_video import align_to_gt, load_gt_poses, poses_to_obj
    from dro_sfm_torch.visualization.pointcloud import depth_to_points, write_ply

    files = list_frames(args.input, args.sample_rate)[:args.max_frames]
    if len(files) <= 2:
        raise ValueError(f"need at least 3 frames in {args.input}, found {len(files)}")
    os.makedirs(args.output, exist_ok=True)
    device = resolve_device(args.device)
    infer, shape, K = open_model(args.checkpoint, device, args.image_shape)
    load = FrameLoader(shape)
    K_dev = torch.as_tensor(K, device=device)

    accum = TrajectoryAccumulator()
    depth_list, pose_list, all_points, all_colors, window_ms, pose_mats = [], [], [], [], [], []
    depths_out = None
    n_out = len(files) - 2
    for i in range(1, len(files) - 1):
        target = load(files[i])
        refs = np.stack([load(files[i - 1]), load(files[i + 1])])
        t0 = time.perf_counter()
        depth, poses = infer(target, refs)
        window_ms.append(1e3 * (time.perf_counter() - t0))
        pose_mats.append(poses)
        if depths_out is None:
            depths_out = np.lib.format.open_memmap(
                os.path.join(args.output, "depths.npy"), mode="w+",
                dtype=np.float32, shape=(n_out, *depth.shape))
        depths_out[i - 1] = depth

        global_pose = accum.add(poses[0], poses[1])
        filtered = filter_depth(depth, grad_max=args.grad_max, depth_max=args.depth_max)
        depth_list.append(filtered)
        pose_list.append(global_pose)
        if args.fusion_views > 1 and len(depth_list) > args.fusion_views:
            def dev(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=device)
            filtered = geometric_fusion(
                dev(depth_list[-1]), dev(np.stack(depth_list[-args.fusion_views:-1])),
                dev(pose_list[-1]), dev(np.stack(pose_list[-args.fusion_views:-1])),
                K_dev, thres_view=args.fusion_views // 2).cpu().numpy()

        s = args.ply_stride
        K_sub = K.copy()
        K_sub[0] /= s
        K_sub[1] /= s
        pts, colors = depth_to_points(filtered[::s, ::s], K_sub, global_pose,
                                      target[::s, ::s])
        all_points.append(pts)
        all_colors.append(colors)
        if i % 10 == 0:
            print(f"[{i}/{len(files) - 2}] frames processed")
    depths_out.flush()

    ba = None
    if args.ba and len(pose_list) >= 3:
        ba = bundle_adjust(args.ba_stride, depths_out, pose_list, K, device, args.output)
        accum.trajectory = pose_list

    gt_poses = load_gt_poses(args.gt_poses, files[1:-1]) if args.gt_poses else None
    ate = None
    if gt_poses is not None and len(gt_poses) == len(pose_list):
        _, ate = align_to_gt(pose_list, gt_poses)
        print(f"ATE-RMSE vs GT trajectory (sim3-aligned): {ate:.4f} m")
    elif args.gt_poses:
        print("warning: GT poses missing/unmatched; no ATE")

    accum.save_json(os.path.join(args.output, "trajectory.json"))
    poses_to_obj(os.path.join(args.output, "trajectory_pose.obj"), pose_list)
    pts = np.concatenate(all_points)
    write_ply(os.path.join(args.output, "pointcloud.ply"), pts, np.concatenate(all_colors))
    steady = sorted(window_ms[1:]) or window_ms
    print(f"outputs in {args.output}: depths.npy, trajectory.json, trajectory_pose.obj, "
          f"pointcloud.ply ({pts.shape[0]} points); {n_out} windows, "
          f"{steady[len(steady) // 2]:.2f} ms per window (median after the first), "
          f"{np.median(load.decode_ms):.2f} ms per frame decode on {device}")
    print(f"not written: {VIDEO_NOT_PORTED}")
    return {"windows": n_out, "pose_mats": pose_mats, "window_ms": window_ms,
            "decode_ms": load.decode_ms, "points": int(pts.shape[0]), "ate": ate, "ba": ba}


BA_DOWNSAMPLE = 4                  # the keyframes' depth maps, as the JAX CLI
BA_COVISIBLE = 2                   # keyframes on either side that share an edge


def bundle_adjust(stride, depths, pose_list, K, device, output) -> dict:
    """Dense BA of the keyframes ``0, stride, 2 stride, ...`` of
    ``pose_list``, in place, as the JAX CLI runs it: depths [n,H,W] taken
    every 4th pixel, intrinsics with their first two rows divided by 4 (the
    JAX CLI's rule, not `scale_intrinsics`' pixel-centre one), an edge
    between each pair of keyframes at most 2 apart, `optimize_dense_ba`
    with stride 1 and 6 iterations. Writes ``ba_scales.npy`` (the
    keyframes' depth scales)."""
    import numpy as np
    import torch

    from dro_sfm_torch.ba import BAProblem, optimize_dense_ba
    kf = list(range(0, len(pose_list), stride))
    s = BA_DOWNSAMPLE
    K_ba = K.copy()
    K_ba[0] /= s
    K_ba[1] /= s
    ei, ej = covisibility_edges(len(kf))
    problem = BAProblem(
        torch.from_numpy(np.stack([pose_list[i] for i in kf]).astype(np.float32)),
        torch.from_numpy(np.stack([depths[i][::s, ::s] for i in kf])),
        torch.from_numpy(K_ba), ei, ej)
    t0 = time.perf_counter()
    refined, sigmas = optimize_dense_ba(BAProblem(*(t.to(device) for t in problem)),
                                        stride=1, iters=6)
    refined, scales = refined.cpu().numpy(), torch.exp(sigmas).cpu().numpy()
    ms = 1e3 * (time.perf_counter() - t0)
    for a, i in enumerate(kf):
        pose_list[i] = refined[a]
    np.save(os.path.join(output, "ba_scales.npy"), scales)
    print(f"dense BA refined {len(kf)} keyframes over {len(ei)} edges in {ms:.1f} ms "
          f"(scales {scales.round(3)})")
    return {"keyframes": kf, "ms": ms, "edges": len(ei)}


def covisibility_edges(k: int):
    """(edges_i, edges_j) [E]: every ordered pair of ``k`` keyframes at most
    BA_COVISIBLE apart."""
    import torch
    pairs = [(a, b) for a in range(k)
             for b in range(max(0, a - BA_COVISIBLE), min(k, a + BA_COVISIBLE + 1)) if a != b]
    return torch.tensor([a for a, _ in pairs]), torch.tensor([b for _, b in pairs])


if __name__ == "__main__":
    main()
