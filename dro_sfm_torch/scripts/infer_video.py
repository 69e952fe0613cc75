"""Video SfM CLI of the port: a video file or a frame folder -> depth maps,
trajectory, point cloud and the annotated demo video.

    python -m dro_sfm_torch.scripts.infer_video --checkpoint x.ckpt --input frames/ \
        --output out/ [--fusion-views 3] [--ba] [--gt-poses poses/] [--gt-depth depth/] \
        [--device cpu]

The port's counterpart of `scripts/infer_video.py`: a video file
(``--input clip.mp4``: MP4, MOV or AVI of MPEG-4 Part 2 video, as OpenCV's
``mp4v`` writes it, or of H.264 Constrained Baseline, Main or High video
(8-bit 4:2:0 progressive), as phones, webcams and libx264 at its defaults
write it, or MJPEG AVI) is first split, as the JAX CLI's
``parse_video`` splits it, into ``<output>/input_frames/{i:06d}.jpg``: every
``--sample-rate``-th frame, decoded on the host
(`dro_sfm_torch.utils.video_io.VideoReader`) and written as JPEG at quality
95 (``cv2.imwrite``'s bytes); that folder, in name order and cut at
``--max-frames``, is the input. Other codecs and containers (H.265, FLV,
MPEG, WMV), MPEG-4 tools beyond Simple Profile and H.264 tools beyond
those (interlace, 4:2:2 and 4:4:4, bit depth above 8: ROADMAP A22) raise
`NotImplementedError`, a broken file `ValueError` (ROADMAP C). Then 3-frame windows ``i-1,
i, i+1`` for ``i = 1 ... n-2`` over the folder of frames (PNG, JPEG, BMP), the
poses chained with monocular scale propagation, each depth filtered
(gradient, range) and, with ``--fusion-views`` > 1, fused with the previous
views by geometric consistency on the device, and a global coloured point
cloud accumulated. Each window's half-size panels (the frame, its
colormapped inverse depth, the validity overlay and, with ``--gt-depth`` (a
folder of uint16 millimetre PNGs matched by base name), the ground truth's)
are written under ``panels/``. With ``--ba`` the keyframes (every
``--ba-stride``-th window) are refined by dense bundle adjustment on their
depth maps downsampled by 4, each covisible with the two keyframes on either
side (`dro_sfm_torch.ba.optimize_dense_ba`, stride 1, 6 iterations), their
poses replace the chained ones in the trajectory and ``ba_scales.npy`` holds
their depth scales. Writes ``depths.npy`` (memmapped, one map per window),
``trajectory.json``, ``trajectory.png`` (`plot_trajectory`),
``trajectory_pose.obj``, ``pointcloud.ply`` and, after BA, the annotated
8-panel video ``depth_vis.mp4`` (`DemoVideoComposer`; MPEG-4 Part 2 in MP4,
as OpenCV's mp4v writes it, from the host encoder `VideoWriter`); with
``--gt-poses`` it prints the ATE after sim3 alignment and draws
the trajectory panels against the ground truth. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch video SfM")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input", required=True, help="video file or frame folder")
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
                        "base name): prints the ATE after sim3 alignment and draws the GT "
                        "trajectory panels")
    p.add_argument("--gt-depth", default=None,
                   help="directory of per-frame GT depth pngs (mm, matched by base name) "
                        "for the GT-depth panel")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None, canvases=None) -> dict:
    """Run the CLI. Returns what it measured: the number of windows, each
    window's pose matrices ([2,4,4]: to the previous and the next frame)
    and milliseconds (host clock, the result on the host), each frame's
    decode milliseconds, for a video file the extraction's frames and each
    frame's video decode and JPEG encode milliseconds (``extraction``, None
    for a folder), the point count, the ATE (None without ground
    truth), with ``--ba`` the keyframes' window indices and the BA's
    milliseconds, and for the video each frame's compose and encode
    milliseconds (host clock), its frame size and its bytes. A list passed
    as ``canvases`` receives each composed frame (uint8 RGB)."""
    args = parse_args(argv)
    from dro_sfm_torch.scripts.frames import (
        VIDEO_EXT, FrameLoader, extract_frames, list_frames, open_model)
    extraction = None
    if os.path.isdir(args.input):
        files = list_frames(args.input, args.sample_rate)
    else:
        if os.path.splitext(args.input)[1].lower() not in VIDEO_EXT:
            raise ValueError(f"{args.input}: neither a frame folder nor a video file "
                             f"({', '.join(VIDEO_EXT)})")
        os.makedirs(args.output, exist_ok=True)
        frames_dir = os.path.join(args.output, "input_frames")
        extraction = extract_frames(args.input, frames_dir, args.sample_rate)
        print(f"extracted {extraction['frames']} frames")
        files = [os.path.join(frames_dir, f) for f in sorted(os.listdir(frames_dir))]
    files = files[:args.max_frames]
    import numpy as np
    import torch

    from dro_sfm_torch.data.scannet import read_png_depth_mm
    from dro_sfm_torch.inference import TrajectoryAccumulator, filter_depth, geometric_fusion
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.device import resolve_device
    from dro_sfm_torch.utils.image_io import read_image_rgb, resize_bilinear_u8, write_png
    from dro_sfm_torch.utils.video_io import VideoWriter
    from dro_sfm_torch.visualization.demo_video import (
        DemoVideoComposer, align_to_gt, cloud_topdown_panel, draw_trajectory_panel,
        load_gt_poses, poses_to_obj)
    from dro_sfm_torch.visualization.pointcloud import depth_to_points, write_ply
    from dro_sfm_torch.visualization.trajectory import plot_trajectory

    if len(files) <= 2:
        raise ValueError(f"need at least 3 frames in {args.input}, found {len(files)}")
    os.makedirs(args.output, exist_ok=True)
    device = resolve_device(args.device)
    infer, shape, K = open_model(args.checkpoint, device, args.image_shape)
    load = FrameLoader(shape)
    K_dev = torch.as_tensor(K, device=device)
    ph, pw = shape[0] // 2, shape[1] // 2
    panels_dir = os.path.join(args.output, "panels")
    os.makedirs(panels_dir, exist_ok=True)

    def spill(kind, idx, img):
        write_png(os.path.join(panels_dir, f"{kind}_{idx:06d}.png"),
                  resize_bilinear_u8(img, (ph, pw)))

    def unspill(kind, idx):
        path = os.path.join(panels_dir, f"{kind}_{idx:06d}.png")
        return read_image_rgb(path) if os.path.exists(path) else None

    accum = TrajectoryAccumulator()
    depth_list, pose_list, all_points, all_colors, window_ms, pose_mats = [], [], [], [], [], []
    cloud_counts, frame_names = [], []
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

        # the window's panels: rgb, inverse-depth colormap, validity overlay,
        # ground-truth depth, at half size
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
        rgb_u8 = (target * 255).astype(np.uint8)
        valid = (filtered > 0).astype(np.float32)[..., None]
        m = i - 1
        spill("rgb", m, rgb_u8)
        spill("depth", m, (viz_inv_depth(inv) * 255).astype(np.uint8))
        spill("mask", m, (rgb_u8 * (0.35 + 0.65 * valid)).astype(np.uint8))
        if args.gt_depth:
            base = os.path.splitext(os.path.basename(files[i]))[0]
            gtp = os.path.join(args.gt_depth, base + ".png")
            if os.path.exists(gtp):
                gtd = read_png_depth_mm(gtp)[..., 0]
                gti = np.where(gtd > 0, 1.0 / np.maximum(gtd, 1e-6), 0.0)
                spill("gtd", m, (viz_inv_depth(gti) * 255).astype(np.uint8))
        cloud_counts.append(sum(len(p) for p in all_points))
        frame_names.append(os.path.basename(files[i]))
        if i % 10 == 0:
            print(f"[{i}/{len(files) - 2}] frames processed")
    depths_out.flush()

    ba = None
    if args.ba and len(pose_list) >= 3:
        ba = bundle_adjust(args.ba_stride, depths_out, pose_list, K, device, args.output)
        accum.trajectory = pose_list

    gt_poses = load_gt_poses(args.gt_poses, files[1:-1]) if args.gt_poses else None
    ate = gt_positions = aligned_poses = None
    if gt_poses is not None and len(gt_poses) == len(pose_list):
        aligned, ate = align_to_gt(pose_list, gt_poses)
        gt_positions = np.stack([p[:3, 3] for p in gt_poses])
        # the panel against the ground truth draws the sim3-aligned prediction
        aligned_poses = []
        for a in aligned:
            T = np.eye(4)
            T[:3, 3] = a
            aligned_poses.append(T)
        print(f"ATE-RMSE vs GT trajectory (sim3-aligned): {ate:.4f} m")
    elif args.gt_poses:
        print("warning: GT poses missing/unmatched; trajectory panels render pred only")

    accum.save_json(os.path.join(args.output, "trajectory.json"))
    plot_trajectory(os.path.join(args.output, "trajectory.png"), accum.trajectory,
                    gt_poses=gt_poses)
    poses_to_obj(os.path.join(args.output, "trajectory_pose.obj"), pose_list)
    pts = np.concatenate(all_points)
    colors = np.concatenate(all_colors)
    write_ply(os.path.join(args.output, "pointcloud.ply"), pts, colors)

    # The annotated video, after BA so that the trajectories are the refined ones.
    composer = DemoVideoComposer(shape, model_path=args.checkpoint, data_path=args.input,
                                 sample_rate=args.sample_rate, max_frames=args.max_frames,
                                 fps=args.fps)
    video_path = os.path.join(args.output, "depth_vis.mp4")
    compose_ms = []
    panel_size = (ph, pw)
    with VideoWriter(video_path, args.fps) as writer:
        for i in range(len(frame_names)):
            t0 = time.perf_counter()
            panels = {
                "rgb": unspill("rgb", i),
                "mask": unspill("mask", i),
                "depth": unspill("depth", i),
                "traj": draw_trajectory_panel(pose_list, i, size=panel_size, label="pred"),
                "cloud": cloud_topdown_panel(pts[:cloud_counts[i]], colors[:cloud_counts[i]],
                                             size=panel_size),
            }
            gtd = unspill("gtd", i) if args.gt_depth else None
            if gtd is not None:
                panels["depth_gt"] = gtd
            if gt_positions is not None:
                panels["traj_vs_gt"] = draw_trajectory_panel(
                    aligned_poses, i, size=panel_size, overlay=gt_positions,
                    label="pred-sim3(b) vs gt(r)")
                panels["traj_gt"] = draw_trajectory_panel(
                    gt_poses, i, size=panel_size, color=(255, 90, 90), label="gt")
            frame = composer.compose(panels, i, frame_names[i], ate=ate)
            compose_ms.append(1e3 * (time.perf_counter() - t0))
            writer.write(frame)
            if canvases is not None:
                canvases.append(frame)
        encode_ms = writer.encode_ms
    video_bytes = os.path.getsize(video_path)
    H, W = composer.frame_size
    steady = sorted(window_ms[1:]) or window_ms
    if extraction is not None:
        print(f"{args.input}: {extraction['frames']} frames extracted at "
              f"{np.median(extraction['decode_ms']):.2f} ms per frame video decode and "
              f"{np.median(extraction['encode_ms']):.2f} ms per frame JPEG encode (medians)")
    print(f"outputs in {args.output}: depths.npy, panels/, trajectory.json/png/obj, "
          f"pointcloud.ply ({pts.shape[0]} points), depth_vis.mp4 ({W}x{H} annotated "
          f"8-panel mp4v, {video_bytes} bytes); {n_out} windows, "
          f"{steady[len(steady) // 2]:.2f} ms per window (median after the first), "
          f"{np.median(load.decode_ms):.2f} ms per frame decode, "
          f"{np.median(compose_ms):.2f} ms compose and {np.median(encode_ms):.2f} ms encode "
          f"per video frame on {device}")
    return {"windows": n_out, "pose_mats": pose_mats, "window_ms": window_ms,
            "decode_ms": load.decode_ms, "points": int(pts.shape[0]), "ate": ate, "ba": ba,
            "compose_ms": compose_ms, "encode_ms": encode_ms, "frame_size": (H, W),
            "video_bytes": video_bytes, "video": video_path, "extraction": extraction}


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
