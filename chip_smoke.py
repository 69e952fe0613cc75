#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (supervised,
self-supervised, semi-supervised and single-frame), its trainer, its
dataset readers (NYU's HDF5 dumps among them), its training in several
processes, its serving export, its bundle adjustment, its demo video, its
split of image heights over several processes, its stride-4 feature net,
its reading of upstream torch weights and its video input, on one NVIDIA
GPU and check their kernels.

    python3 chip_smoke.py              # on one card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device: the card's name and power limit, torch and CUDA versions; TF32 is
   switched off for cuDNN convolutions and matmuls so that fp32 means fp32;
2. build: every kernel of the path from ``dro_sfm_torch/csrc`` with nvcc;
3. kernel vs plain: K1 (`warp_diff`) against its plain PyTorch version at
   the serving shapes (B=1 and 8, bf16 and fp32) and at edge cases, with
   timings of the kernel, the plain version and a library yardstick;
4. serving: DepthPoseNet it12-h-out (bf16, random weights from a seed)
   answers requests through `make_infer_fn` at 192x640, N=2, B=1 and B=8;
   K1's launch count is reset just before and read just after, and must be
   24 per request;
5. end to end: the same net and inputs with the plain warp on the card,
   compared with the kernel run in fp32 and in bf16;
6. profile: device time by kernel over one B=8 request (torch.profiler),
   and the card's busy share of that request;
7. K2/K3 vs plain: the warp-cost backward kernels (`warp_diff_bwd_feat`,
   `warp_diff_bwd_coords`) against their plain versions at the training
   shapes (B=1 and 8, bf16 and fp32) and at edge cases (a warp that
   collapses into one cell among them), each beside its stated tolerance;
   two K2 calls must give the same bits; timings of the kernel, the plain
   version, the library yardstick (`grid_sampler_2d_backward`) and the
   bound;
8. training: the supervised step (SupModelMF it12-h-out, bf16, 192x640,
   N=2, B=8) through `make_train_step`, from random weights with the heads'
   last convolution scaled down (`start_weights`): one warm-up step and 10
   timed steps; every launch count is reset just before and read just
   after, and must be 24 (K1), 24 (K2) and 18 (K3) per step; the loss
   finite at every step, every parameter and BatchNorm statistic moved, and
   Adam's moments finite;
9. training end to end: one step's gradients with the kernels against the
   plain warp on the card (B=2, flip off), fp32 with TF32 off and bf16,
   each leaf against a stated bar; the bars must fail planted faults (K2 or
   K3 leaving out one tap), as must phase 7's;
10. profile: device time by kernel over one B=8 train step, and the card's
   busy share of it;
11. K4 vs plain: the bare warp `tent_warp` and its gradient (K2 and K3 with
   sign +1) at the warp shapes, a ragged last tile, features at an odd
   element offset and the edge cases, each forward on the variant its shape
   calls for ("direct" or "unaligned"); the entry point's path (counts reset
   before, read after) launches K4, K2 and K3 once each; both variants timed
   warm and cold (L2 flushed) beside `grid_sample` and the bound at B=8 and
   B=1 bf16 and B=8 fp32, failing if K4 is slower than `grid_sample`;
12. K5/K6 vs plain: the fused GRU pass and its two backward kernels at the
   path's depth and pose shapes, both axes, bf16 and fp32, B=1, and edge
   cases, each beside its bar; two K5 calls and two K6 calls must give the
   same bits; planted faults (K5 and K6-input leaving out a tap, K6-weight a
   split's pixels); the CUDA launches of one K5, K6-input and K6-weight call
   (2, 4 and 2); timings against the bound, the split path's pass and, for
   K6-weight, cuDNN's weight gradients;
13. serving with ``sep_conv="pallas"``: B=1 and B=8 through `make_infer_fn`,
   24 K1 and 48 K5 launches a request, the split path timed in turns; both
   paths' outputs compared in fp32 and bf16;
14. training with ``sep_conv="pallas"``: as phase 8, launches a step K1 24,
   K2 24, K3 18, K5 48, K6-input 48, K6-weight 48;
15. its gradients through K5/K6 against the plain GRU pass (B=2, fp32 and
   bf16);
16. profile of one of its train steps, with the device time of the K5 and
   K6 kernels summed by name prefix;
17. self-supervised training: the SelfSupModelMF step (it12-h-out bf16,
   192x640, N=2, B=8, ``sep_conv="split"``, the photometric loss with the
   config defaults: SSIM 0.85, ``min`` reduce, automask, smoothness 0.001,
   gamma 0.85) through `make_train_step` from `start_weights`, on rendered
   scenes of the `Synthetic` dataset (`make_scene_batch`): one warm-up
   step and 10 timed ones, counts reset just before and read just after,
   24 (K1), 24 (K2) and 18 (K3) a step, losses finite, every parameter
   moved; ms/step, frames/s, peak MiB;
18. its profile: device time by kernel over one step, the card's busy share;
19. its gradients through the kernels against the plain path (B=2 rendered
   scenes, flip off, `tame_weights`, phase 9's bars): with the default
   loss, fp32 and bf16, ``sep_conv="split"`` K1-K3 against the plain warp
   and ``sep_conv="pallas"`` K6 against the plain GRU backward after K5;
   with the mean over views, fp32, K5/K6 against the plain GRU pass,
   forward and backward; each run's launches checked (K5, K6-input,
   K6-weight 48 each with "pallas");
20. the other tasks on rendered scenes, 3 timed steps each at 192x640 B=8:
   SemiSupModelMFPose
   (the supervised step's launches), and the single-frame SupModel and
   SelfSupModel (no kernel); losses finite;
21. trainer: `Trainer.fit` on ``configs/train_synthetic_192x640.yaml``
   through the port's config reader (2 epochs of 2 B=8 steps on 16
   synthetic scenes, one B=4 validation batch each, checkpoints under
   ``build/trainer_train_synthetic_192x640``), from the config's own
   initialisation: every count reset just before and read just after, K1
   24, K2 24, K3 18 a train step and K1 48 an eval batch; losses and
   metrics finite; the last epoch's checkpoint written; a resume whose net,
   Adam moments and step equal the file's bits; the eval CLI (``python -m
   dro_sfm_torch.scripts.eval``) in a subprocess, its ``abs_rel_pp_gt``
   within 1e-5 relative of the last validation's; one more epoch with
   ``sep_conv="pallas"`` (K5, K6-input, K6-weight 48 a step, K5 96 an eval
   batch). It prints the train frames/s beside phase 8's, the loader's
   alone and the ms of an eval batch;
22. the same (without the fused epoch) on
   ``configs/train_synthetic_selfsup.yaml`` (SelfSupModelMF it12-h-out
   bf16 96x128), checkpoints under ``build/trainer_train_synthetic_selfsup``;
23. apps: a checkpoint in the JAX package's format (flax msgpack written by
   the port's own writer: it12-h-out weights from `start_weights`, Adam's
   moments after one step, the sidecar of
   ``configs/train_synthetic_192x640.yaml``) loaded by `load_model` and
   by a resumed `Trainer`, both bit-equal to the source, the trainer taking
   one counted step (K1 24, K2 24, K3 18); 12 rendered 192x640 frames
   written as PNG and read back bit-equal; the ``infer_video`` CLI in this
   process (fp32, ``--fusion-views 3``, ``--gt-poses``), counts reset just
   before and read just after: K1 24 a window and nothing else; its depths
   and poses against the same windows through the plain warp, printed only
   (at these weights the eval-mode refinement is chaotic: 3.4e-7 to 2.0e-5
   by call on unchanged code, `PERF.md`), then the same CLI run at
   `tame_weights` (the same launch check) held to the plain warp within
   1e-5 relative L2; `geometric_fusion` on the card against the CPU away from
   its thresholds, on the CLI's depths and on the scene's exact ones; ms per
   window, PNG decode ms per frame;
24. datasets: training from dataset files. The host image codec
   (``csrc/image_codec.cpp``) built with the C++ compiler; the committed
   JPEG and BMP fixtures (``dro_sfm_torch/testdata/jpeg``: baseline,
   progressive, arithmetic-coded and CMYK JPEG, BMP of each kind) decoded
   to OpenCV's sha256; JPEG (by kind), PNG, row-filter and uint8 resize
   times on this host. A ScanNet tree (the 480x640 JPEG views of
   `SCENE_FRAMES`: baseline, progressive, arithmetic-coded progressive and
   CMYK; millimetre depth and poses of the renderer that drew them) trains ``configs/train_scannet_mf_gt_view3.yaml``
   through `Trainer` (SupModelMF it12-h-out, B=8, 240x320, 2 epochs of 3
   steps, each validated on one B=4 ScannetTest batch with ground truth at
   480x640) and a KITTI drive of 375x1242 PNG frames with 16-bit ground
   truth trains ``configs/train_kitti_mf_gt.yaml`` (it12-h, B=2, 320x960, 2
   epochs of 2 steps), each
   from `tame_weights`: counts reset just before fit() and read just after,
   K1 24, K2 24, K3 18 a step and K1 48 an eval batch, or it fails; losses
   and metrics finite. It prints the loader's frames/s alone, the trainer's
   and the bare step's. Then one B=2 batch of every other reader
   (ScannetTest, ScannetTestMF, ScannetBA, Demon, DemonMF, Matterport,
   MatterportTest, Video, Video_Random, Image, DGP) through `make_loader`
   and `device_prefetch` onto the card, its schema checked. The trees live
   under ``build/datasets`` and are removed at the end;
25. dist_trainer: training in several processes. (a) `Trainer.fit` on
   ``configs/train_synthetic_192x640.yaml`` (SupModelMF it12-h-out bf16
   192x640 B=8, one epoch of 2 steps, one B=4 validation batch) in a
   process group of world size 1 on NCCL, counts reset just before fit()
   and read just after (K1 24, K2 24, K3 18 a step, K1 48 an eval batch),
   its losses, net, Adam moments and step equal bit for bit to the same fit
   without a process group (deterministic library algorithms in both);
   (b) two spawned ranks on this one card over gloo (NCCL refuses two ranks
   on one device), B=4 each from `tame_weights` on a batch whose second
   half (rank 1's) is dimmed: the step's launches on every rank, the ranks'
   gradients equal bit for bit, and against the one-process B=8 step the
   loss and every gradient leaf in bf16 (bar max(BF16_BAR, the leaf's bf16
   own error)) and in fp32 (1e-5 on the loss, 1e-2 and cosine 0.9999 on a
   leaf; the same fp32 step with the halves swapped is printed as the order
   of the sums' own reach), BatchNorm statistics within 1e-3; ms a step,
   the collectives' share of a profiled step (host time in the
   ``collective:`` spans); the sharded validation of (a)'s checkpoint, its 36
   depth metrics within 1e-5 of (a)'s; (c) planted faults that must fail:
   rank 1's BatchNorm skipping the reduction, and a validation shard that
   drops a sample (both ranks must raise). A rank that raises or outlives
   120 s fails the phase. ``python3 tools/torch_dist_nccl.py`` runs the
   step and `Trainer.fit` on every card of a host with several, NCCL
   between them;
26. nyu: NYU from its HDF5 dumps without h5py. Every committed fixture
   (``dro_sfm_torch/testdata/hdf5``: each layout and filter, and a 480x640
   session with a contiguous and gzip-chunked frames) read by
   ``utils/hdf5.py`` to h5py's sha256; the reader's host ms a frame by
   layout; ``configs/train_nyu_mf_gt.yaml`` at 480x640 B=4 on the committed
   session (its sample repeated through `RepeatedDataset`), 3 bf16 steps
   from `tame_weights` through `Trainer.fit` and one NYUtest eval batch,
   counts reset just before fit() and read just after: K1 24, K2 24, K3 18
   a step and K1 48 the eval batch. The recipe's SupModelMF reads
   ground-truth poses, which NYU's dumps lack (the JAX step raises as the
   port's does), so the steps are SelfSupModelMF's with the recipe's
   photometric settings;
27. export: the serving export. Phase 4's it12-h-out weights in an
   it4-h-out net (`EXPORT_VERSION`, a cut depth) at 192x640,
   N=2, exported for "cuda" (`export_serving_artifact`) as a static B=1
   bf16 program, a dynamic-batch fp32 program and a static B=1 bf16
   program with ``sep_conv="pallas"``, each loaded back
   (`load_serving_artifact`); every request through a loaded program,
   counts reset just before and read just after, launches K1 8 (and K5 16
   with "pallas") and nothing else, and matches the live `make_infer_fn`
   within 1e-4 (max |depth delta| and |pose delta|, fp32 and bf16) at B=1,
   and at B=8 for the dynamic program; a gather-warp program (no
   ``dro_sfm::warp_diff`` node) must fail the same launch check. Prints the
   seconds to export and load, the bytes, and the ms of a request through
   the program and through the live function (CUDA events, in turns);
28. ba: bundle adjustment on the card, fp32 with TF32 off (no kernel of
   its own: PyTorch operators, as the JAX package runs XLA's). The
   benchmark's problem (`tools/torch_bench_ba.py`: 32 keyframes of 48x64,
   stride 2, 6 iterations) against the port's CPU run, in fp64 (1e-9) and
   in fp32 (the same LM decisions; poses 5e-4 and log-scales 5e-5, fp32's
   reach on this problem, with H's and the solve's card-CPU gaps printed);
   24 iterations cutting the ATE at least 4.5x with the scales within
   0.015 (`tests/test_ba.py:245-286`'s bars); the GNC, coarse-to-fine and
   robust schedules' ATE and ms; `infer_video --ba`'s operating point (128
   keyframes of 48x160, stride 1, +-2 keyframes, 6 iterations): ms a run,
   `gn_iter_ms`, `edges_per_sec`, peak MiB and the device ms of the
   accumulation, the Schur solve and the cost; the host syncs of one
   LM-guarded iteration (`torch.cuda.set_sync_debug_mode("warn")`);
   ``infer_video --ba`` without ``--device`` on phase `apps`'s frames
   (``ba_scales.npy`` finite and positive, the keyframes moved, the other
   poses not, K1 24 launches a window); the edge split on two spawned gloo
   ranks on this card against one process (fp64 1e-9, fp32 as above, the
   ranks bit-equal).

29. demo: the slice's demo path on the card at 192x640, fp32, seed-0
   it12-h-out weights with the heads scaled (`start_weights`, the port's
   checkpoint format): 12 rendered frames (PNG), their poses and their
   exact depths (uint16 millimetre PNG); ``infer_video`` with
   ``--gt-poses`` and ``--gt-depth`` in this process, counts reset just
   before and read just after: K1 24 a window and nothing else; the mp4v
   ``depth_vis.mp4`` read back by the port (``VideoReader``): ``windows``
   frames of the composer's frame size, each bit-equal to the host
   encoder's reconstruction of the canvas `compose` returned (the encoder
   run again on the canvases) and within DEMO_PSNR dB of it; the ``depth``
   panels equal to the
   host `viz_inv_depth` of ``depths.npy`` resized as OpenCV resizes, bit
   for bit; ``infer --save viz`` on 2 frames (K1 24 a frame; the panel's
   top half the frame); ``vis`` renders the run's ``pointcloud.ply`` on
   the card bit-equal to the CPU, and an mp4v turntable is timed. Prints ms
   a window, compose and encode ms a video frame, bytes a frame and PSNR,
   and ``vis`` ms a frame on the card;
30. spatial: the height split (``arch.spatial_shards`` = 2, D = 1) on two
   spawned ranks on this card over gloo. (b) K1-K3 at the bands' shapes
   (P = 12x80 target pixels of B=8 against the gathered 24x80 context maps,
   coordinates on every row of the view and outside it, both bands) and
   K5/K6 axis 1 on the bands widened by 4 rows (20x80, depth B=8 and pose
   B*N=16), bf16 and fp32, against their plain versions at the bars of
   phases 3, 7 and 12, with the bf16 times; (a) 192x640 N=2 B=8, each case
   of `SPATIAL_CASES`, the multi-frame nets at `SPATIAL_VERSION` (it4-h-out,
   a cut depth; the perceptual case at it12-h-out, where its bar was set):
   SupModelMF on noise from `tame_weights`,
   ``sep_conv`` "split" and "pallas", fp32 and bf16; on rendered scenes,
   the photometric loss at the config defaults (the ``min`` with the
   automask), SelfSupModelMF bf16 with either GRU path, SemiSupModelMFPose
   bf16, the single-frame SelfSupModel fp32 (seed-0 ResNets, bands down to
   stride 32) and SelfSupModelMF fp32 with the perceptual term (0.1; the
   VGG net whole on every rank on gathered images): each rank's step on its
   96 rows, counts reset just before and read just after (`train_launches`:
   K1 8, K2 8, K3 6, and K5, K6-input, K6-weight 16 with "pallas", at it4;
   K1 24, K2 24, K3 18 at it12; none for SelfSupModel), its exchanges by function (a host profile of that step,
   counted from its raw events by `span_table`),
   ms and host syncs by line of one more step (torch's sync debug mode;
   gloo's own copies are not ATen's and do not count), against one process
   on the whole batch (phase 25's `dist_verdict`: the fp32 loss within 1e-5
   relative and fp32 leaves within 1e-2, or within twice fp32's own reach
   where the multi-frame photometric loss's reach passes that (one
   process's step on the samples in reverse order); a bf16 case's loss
   within BF16_BAR and its leaves against its fp32 twin's own error; where
   a case's precision cannot hold its leaves (`spatial_leaves_held`: bf16
   under the photometric ``min``, whose near-ties make bf16 leaves chaotic;
   SelfSupModel's fp32, whose pose encoder's backward cancels) each rank
   also takes a twin at the next precision, held to one process's: the
   fp32 step, or the fp64 gradient within 1e-8 and its loss within 1e-12),
   the ranks' gradients and parameters after Adam equal bit for bit, and
   each rank's peak memory, which must be below one process's; (c) `Trainer.fit` on
   ``configs/train_synthetic_192x640.yaml`` and on
   ``configs/train_synthetic_selfsup.yaml`` at 192x640, fp32, with
   ``arch.spatial_shards: 2`` (2 steps of B=8, one B=4 validation batch)
   from `tame_weights`, their launches a step and an eval batch checked,
   each validation against a one-process `Trainer` on its checkpoint (every
   metric within 1e-5 relative plus 1e-7, phase 25's bar). A rank that
   raises or outlives 600 s fails.
31. stride4: `DepthPoseNet(feat_ratio=4)` (it12-h-out bf16, 192x640, N=2;
   maps of 48x160, 4x the pixels of stride 8) from `start_weights`'s seed
   and head scale. Serving at B=1 and B=8 through `make_infer_fn` with
   either GRU path, counts reset just before and read just after: K1 24 a
   request (and K5 48 with "pallas"), nothing else; the B=1 request against
   the plain warp in fp32 and bf16 (phase 5's bars); the B=8 SupModelMF step
   (phase 8's memory policy) from `tame_weights` with either GRU path, K1
   24, K2 24, K3 18 (K5, K6-input, K6-weight 48) a step, and its gradients
   (deterministic algorithms, remat) against the plain warp at phase 9's
   bars and against the plain GRU pass at phase 15's (in bf16 raised, leaf
   by leaf, to twice the split path's distance to the plain pass; phase
   15's planted faults must fail); K1-K3 (f1 [8,7680,128] against 16 maps of
   48x160x128) and K5/K6 (the depth pass 8x48x160 and the pose pass
   16x48x160, D=128, Cx=160, both axes) against their plain versions at the
   bars of phases 3, 7 and 12, bf16 and fp32, with the bf16 times, bounds
   and library yardsticks; a profile of one more step a GRU path; ms a
   request, ms a step and peak memory;
32. torch_weights: upstream torch weights through the port alone (the
   card's machine has no flax, jax or yacs): the port's seed-0 it12-h-out net
   under the reference's names saved as the reference's ``.ckpt``, its
   config pickled as ``yacs.config.CfgNode``; ``python -m
   dro_sfm_torch.scripts.convert_torch_weights dro-ckpt`` (its load check on
   the card, `load_model` bit-equal to the source), then
   ``eval_reference_ckpt`` on a rendered 192x256 ScanNet scene on the card
   (K1 48 an eval batch and nothing else; every metric within 1e-6 relative
   of the same weights loaded straight into a `Trainer`'s net); ``resnet18``
   and ``vgg16`` state dicts of random arrays under torchvision's names
   converted and grafted by a `Trainer`'s warm start
   (``pretrained_encoders``, ``percep_net.checkpoint_path``) bit for bit;
   a checkpoint pickling a foreign global refused. Its files live under
   ``build/torch_weights`` and are removed at the end.

33. video: a video file as ``infer_video``'s input. The host MPEG-4 decoder
   (``csrc/mpeg4_video.cpp``) built with this machine's C++ compiler; every
   committed video (``dro_sfm_torch/testdata/video``: MP4, MOV and AVI, odd
   sizes, all three TCOEF escapes, AC prediction and DQUANT; Advanced Simple
   Profile from FFmpeg's encoder and XviD: B-VOPs packed in AVI and in MP4,
   four vectors, quarter sample, MPEG quantisation, custom matrices, video
   packets, data partitioning, GMC, XviD's IDCT) demuxed and decoded to the
   sha256 of OpenCV's packets, luma planes and RGB frames in display order
   (``fixtures.json``, bar 0 levels), the decoder's counts too, and each
   refused stream raising `NotImplementedError` naming its tool (interlace,
   old XviD and DivX builds); decode ms a frame at 640x480 and 1280x720 of
   Simple Profile and of XviD (B-VOPs, four vectors). The host MPEG-4 encoder
   (``csrc/mpeg4_encode.cpp``) built the same way re-encodes the decoded
   frames of ``walk_640x480.mp4`` and ``walk_1280x720.mp4`` to mp4v MP4
   (`VideoWriter`, QP 3, an I-VOP every 12 frames): encode ms a frame
   (median, min, max), bytes a frame and PSNR against its input, host
   clock; the re-decode is held bit-equal to the encoder's reconstruction,
   every frame. Then ``infer_video`` on
   ``walk_640x480.mp4`` (36 frames extracted, the windows over the first 12:
   10, for the script's time) at it12-h-out fp32
   192x640 with `start_weights`'s seed-0 weights (the port's checkpoint
   format) and no ``--device``, counts reset just before and read just
   after: K1 24 a window and nothing else; the CLI again on the first 12
   extracted ``input_frames/``, its depths and poses bit-equal. At these weights the
   eval-mode refinement is chaotic (`tame_weights`), so the plain warp's
   distance is printed only; the CLI runs the clip again at `tame_weights`
   (the same launch check), its depths and poses against the same windows
   through the plain warp within 1e-5 relative L2 (phase ``apps``' bar).
   Prints the extraction's decode, encode and whole ms a frame and ms a
   window. Then ``infer_video`` on ``xvid_640x480.avi`` (XviD at ``bf`` 2 and
   four vectors, packed B-frames in AVI: 36 frames extracted, the windows
   over the first 12: 10, for the script's time) at `start_weights`,
   counts reset just before and read just after: K1 24 a window and nothing
   else, the plain warp's distance printed only; at `tame_weights` (the
   same launch check) held to the plain warp within 1e-5. Then H.264: the
   host decoder ``csrc/h264_video.cpp`` and its
   headers built the same way; every committed H.264 clip
   (``dro_sfm_torch/testdata/h264``: Constrained Baseline in MP4, MOV and
   AVI, an IDR picture every 8 frames, cropped, several slices and
   references, every partition, constrained intra, deblocking offsets and
   off, four VUI matrices; libx264's High defaults in MP4, MOV and AVI at
   640x480 and 1280x720, with IDR pictures every 8 frames, on a fade, with
   temporal direct, cabac_init_idc 1 and 2, noise in CABAC slices, JVT
   and custom scaling lists; Main and High tools under CAVLC) held to the
   sha256 of OpenCV's packets (an MP4's as stored), luma and RGB in output
   order (B slices reordered, the frames an MP4's edit list trims left
   out), bar 0 levels, each refused stream raising naming its tool; decode
   ms a frame at 640x480 and 1280x720 of both profiles; ``infer_video`` on
   ``high_640x480.mp4`` (libx264's defaults: 23 frames extracted, the
   windows over the first 12: 10, for the script's time) at
   `start_weights`, counts reset just before and read just after: K1 24 a
   window and nothing else, the plain warp's distance printed only; at
   `tame_weights` (the same launch check) held to the plain warp within
   1e-5.

``--only`` runs a subset of the phases after the build and prints no result
line. The last three lines of standard output are the ``kernels`` JSON line
(K1-K6; launches of K1-K3 from the self-supervised training path, of K5
and K6 from the ``sep_conv="pallas"`` supervised one, K4's from its entry
point's path; then K1-K3 and K5/K6 at stride 4, their launches from phase
31's serving and training runs; K1's first entry adds phase 33's),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 on the tensor cores, dense
SERVE_H, SERVE_W, VIEWS, REQUESTS = 192, 640, 2, 20
K1_STEPS_PER_REQUEST = 24          # it12: 3 outer x (4 depth + 4 pose) steps
TRAIN_B, TRAIN_STEPS = 8, 10
# Per train step: K1 and K2 run in all 24 refinement steps. K3 runs where the
# coordinates need a gradient: not in the first depth and the first pose step
# of each outer iteration, whose coordinates come from the detached state.
TRAIN_LAUNCHES = {"K1": 24, "K2": 24, "K3": 3 * (3 + 3)}
# With sep_conv="pallas" every refinement step runs two GRU passes (K5) and
# their backward (K6-input, K6-weight) besides.
TRAIN_LAUNCHES_PALLAS = {**TRAIN_LAUNCHES, "K5": 48, "K6-input": 48, "K6-weight": 48}
HEAD_SCALE = 0.1                   # on the random heads' last convolution
# Kernel vs plain bf16 gradients: a leaf's bar is BF16_BAR, or
# BF16_SHARE of bf16's own error where that reaches BF16_OWN_NOISY.
BF16_BAR, BF16_OWN_NOISY, BF16_SHARE = 2e-2, 0.1, 0.25


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events). A sleep kernel holds the stream while the host enqueues the
    calls, so the events time the device work and not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)           # ~100 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound(f1, features, coords):
    """Least time of one K1 call on this card: each f1, coords and out byte
    once plus the feature rows these coordinates reference, over the memory
    rate; 9 fp32 operations per output element over the fp32 rate."""
    bn, h, w, c = features.shape
    x0, y0 = coords[..., 0].floor(), coords[..., 1].floor()
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            img = torch.arange(bn, device=coords.device)[:, None].expand_as(xi)
            rows.append(((img * h + yi) * w + xi)[ok].long())
    n_rows = torch.unique(torch.cat(rows)).numel()
    out_bytes = coords.shape[0] * coords.shape[1] * c * f1.element_size()
    n_bytes = (f1.numel() * f1.element_size() + n_rows * c * features.element_size()
               + coords.numel() * 4 + out_bytes)
    ops = 9 * coords.shape[0] * coords.shape[1] * c
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def k1_inputs(gen, b, n, h, w, c, dtype, kind):
    """f1 [b,h*w,c], features [b*n,h,w,c], coords [b*n,h*w,2] on the card.
    ``kind``: "serving" (the pixel grid moved by a near-identity pose, a few
    pixels of noise, some pixels out of view), "integer", "outside" (-10),
    "far" (+-1e8), "collapse" (every pixel of a view in one cell)."""
    dev = "cuda"
    p = h * w
    f1 = torch.randn(b, p, c, generator=gen, device=dev).to(dtype)
    features = torch.randn(b * n, h, w, c, generator=gen, device=dev).to(dtype)
    gy, gx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(1, p, 2).float()
    if kind == "serving":
        coords = grid + 1.5 * torch.randn(b * n, p, 2, generator=gen, device=dev)
    elif kind == "integer":
        coords = grid + torch.randint(-2, 3, (b * n, 1, 2), generator=gen, device=dev)
    elif kind == "outside":
        coords = torch.full((b * n, p, 2), -10.0, device=dev)
    elif kind == "far":
        sign = torch.randint(0, 2, (b * n, p, 2), generator=gen, device=dev) * 2 - 1
        coords = torch.where(torch.rand(b * n, p, 2, generator=gen, device=dev) < 0.5,
                             1e8 * sign, grid.expand(b * n, p, 2))
    elif kind == "collapse":
        cell = torch.tensor([w // 2, h // 2], device=dev)
        coords = cell + 0.25 + 0.5 * torch.rand(b * n, p, 2, generator=gen, device=dev)
    else:
        raise ValueError(kind)
    return f1, features, coords.float().contiguous()


def k1_tolerance(dtype, ref):
    """Stated bar for kernel vs plain. The kernel repeats the plain version's
    fp32 operations in the same order without fused multiply-adds, so they
    should agree exactly; the bar still allows one rounding step of the
    output dtype (bf16: 2^-7 relative; fp32: 2^-22 relative)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    return rel * ref.float().abs().max().item() + 1e-30


def phase_k1(warp_diff, warp_diff_plain):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            cases.append((f"serving B={b}", b, VIEWS, 24, 80, 128, dtype, "serving"))
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("6x10", 2, VIEWS, 6, 10, 128, dtype, "serving"),
                  ("6x10 C=6", 2, VIEWS, 6, 10, 6, dtype, "serving"),
                  ("integer", 1, VIEWS, 24, 80, 128, dtype, "integer"),
                  ("outside -10", 1, VIEWS, 24, 80, 128, dtype, "outside"),
                  ("far +-1e8", 1, VIEWS, 24, 80, 128, dtype, "far")]
    results = {}
    for name, b, n, h, w, c, dtype, kind in cases:
        f1, features, coords = k1_inputs(gen, b, n, h, w, c, dtype, kind)
        out = warp_diff(f1, features, coords, n)
        torch.cuda.synchronize()
        ref = warp_diff_plain(f1, features, coords, n)
        err = (out.float() - ref.float()).abs().max().item()
        tol = k1_tolerance(dtype, ref)
        dt = str(dtype).replace("torch.", "")
        line = f"K1 {name:12s} {dt:8s} max_abs_err {err:.3e} tol {tol:.3e}"
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            base = f1.repeat_interleave(n, 0)
            if not torch.equal(out[outside], base[outside]):
                fail(f"K1 {name} {dt}: out-of-view pixels are not f1 - 0")
        if err > tol or not torch.isfinite(out).all():
            fail(line)
        if name.startswith("serving"):
            results[(b, dt)] = r = time_k1(f1, features, coords, n, ref)
            lib_err, r["max_abs_err"] = r.pop("library_err"), err
            line += (f" | kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
                     f"{r['library_ms']:.4f} ms (err {lib_err:.2e}) bound "
                     f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        print(line, flush=True)
    return results


def time_k1(f1, features, coords, n, ref):
    """Kernel, plain, library and bound times of K1 on one input, and the
    library yardstick's largest error against the plain result ``ref``.
    The yardstick is `grid_sample` on the channel-last view and the
    difference from f1; it wants the grid in the features' dtype (bf16 costs
    it ~0.3 px of precision; it is timed, never used)."""
    from dro_sfm_torch.ops.tent_warp import warp_diff, warp_diff_plain
    bn, h, w, c = features.shape
    b = bn // n
    grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)],
                        -1) * 2 - 1).to(features.dtype)
    feat_nchw = features.permute(0, 3, 1, 2)

    def library():
        warped = F.grid_sample(feat_nchw, grid[:, None], mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        return f1.view(b, 1, h * w, c) - warped.view(b, n, c, h * w).transpose(-1, -2)

    out = {"library_err": (library().reshape_as(ref).float() - ref.float()).abs().max().item(),
           "ms": time_ms(lambda: warp_diff(f1, features, coords, n)),
           "plain_ms": time_ms(lambda: warp_diff_plain(f1, features, coords, n)),
           "library_ms": time_ms(library)}
    out["bound_ms"], out["bound_by"] = k1_bound(f1, features, coords)
    return out


def make_request(gen, b):
    target = torch.rand(b, SERVE_H, SERVE_W, 3, generator=gen)
    refs = torch.rand(b, VIEWS, SERVE_H, SERVE_W, 3, generator=gen)
    K = torch.tensor([[0.58 * SERVE_W, 0.0, 0.5 * SERVE_W],
                      [0.0, 1.92 * SERVE_H, 0.5 * SERVE_H],
                      [0.0, 0.0, 1.0]]).expand(b, 3, 3).contiguous()
    return target.cuda(), refs.cuda(), K.cuda()


def phase_serving(DepthPoseNet, make_infer_fn, counters, gpu):
    net = DepthPoseNet(version="it12-h-out", mixed_precision=True,
                       warp_impl="pallas", device="cuda",
                       generator=torch.Generator().manual_seed(0))
    infer = make_infer_fn(net, device="cuda")
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    K1_COUNTER = counters["K1"]
    for c in counters.values():              # the serving path starts here
        c.reset()
    for b, req in requests.items():
        before = K1_COUNTER.launches
        infer(*req)                          # warm-up request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            depth, mats = infer(*req)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        ms = times[len(times) // 2]
        launched = K1_COUNTER.launches - before
        if launched != K1_STEPS_PER_REQUEST * (REQUESTS + 1):
            fail(f"serving B={b}: K1 launched {launched} times for "
                 f"{REQUESTS + 1} requests, want {K1_STEPS_PER_REQUEST} each")
        if depth.shape != (b, SERVE_H, SERVE_W) or mats.shape != (b, VIEWS, 4, 4):
            fail(f"serving B={b}: shapes {tuple(depth.shape)}, {tuple(mats.shape)}")
        if not (torch.isfinite(depth).all() and torch.isfinite(mats).all()):
            fail(f"serving B={b}: non-finite output")
        if not ((depth >= 0.1 - 1e-4) & (depth <= 100.0 + 1e-2)).all():
            fail(f"serving B={b}: depth outside [min_depth, max_depth]")
        print(f"serving it12-h-out bf16 192x640 N=2 B={b}: median {ms:.2f} ms/request "
              f"(min {times[0]:.2f}, max {times[-1]:.2f}, {REQUESTS} requests) "
              f"{1e3 * b / ms:.1f} frames/s, K1 {launched // (REQUESTS + 1)} "
              f"launches/request, peak {torch.cuda.max_memory_allocated() / 2**20:.0f}"
              f" MiB on {gpu}", flush=True)
    launches = K1_COUNTER.launches           # the serving path ends here
    if counters["K2"].launches or counters["K3"].launches:
        fail("serving launched a backward kernel")
    return net, requests, launches


def phase_end_to_end(DepthPoseNet, net_bf16, requests, feat_ratio=8):
    """Kernel vs plain warp through the whole net (at ``feat_ratio``) on the
    card. The kernel repeats the plain version bit for bit, so the two runs
    differ only where library convolutions vary from run to run: the bar is
    1e-5 relative (L2) in fp32 and 1e-2 in bf16."""
    req = requests[1]
    state = net_bf16.state_dict()
    what = "" if feat_ratio == 8 else f"feat_ratio={feat_ratio} "
    for mp, bar in ((False, 1e-5), (True, 1e-2)):
        outs = {}
        for impl in ("pallas", "gather"):
            net = DepthPoseNet(version="it12-h-out", mixed_precision=mp, feat_ratio=feat_ratio,
                               warp_impl=impl, device="cuda")
            net.load_state_dict(state, strict=True)
            with torch.inference_mode():
                outs[impl] = net(*req, last_only=True)
        for key in ("inv_depths", "pose_vecs"):
            a, b = outs["pallas"][key], outs["gather"][key]
            rel = ((a - b).norm() / b.norm()).item()
            line = (f"end to end {what}{'bf16' if mp else 'fp32'} {key}: kernel vs plain "
                    f"rel L2 {rel:.3e} (bar {bar:.0e}), max abs "
                    f"{(a - b).abs().max().item():.3e}")
            if not (rel <= bar and torch.isfinite(a).all()):
                fail(line)
            print(line, flush=True)


def profile_request(net, requests, make_infer_fn):
    """Device time by kernel over one B=8 request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    infer = make_infer_fn(net, device="cuda")
    req = requests[8]
    infer(*req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(*req)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    print(f"profile B=8: wall {wall_us:.0f} us, device busy {total:.0f} us "
          f"({100 * total / wall_us:.1f}%)", flush=True)
    if total == 0:
        print("profile B=8: the profiler recorded no device time (not measured)")
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e):9.0f} us {e.count:5d}x  {e.key[:90]}")
    for e in kernels:
        if "tent_warp" in e.key:
            print(f"profile B=8: K1 {device_us(e):.0f} us over {e.count} launches, "
                  f"{device_us(e) / e.count:.2f} us each")


def k2_bound(coords, g, h, w, dtype):
    """Least time of one K2 call: g and coords read once and d_features
    written once in its dtype, over the memory rate; one multiply and one
    add per channel of each in-view tap over the fp32 rate."""
    bn, p, c = g.shape
    n_bytes = (g.numel() * g.element_size() + coords.numel() * 4
               + bn * h * w * c * torch.finfo(dtype).bits // 8)
    ops = 2 * c * int(_taps(coords, h, w)[1].sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def k3_bound(features, coords, g):
    """Least time of one K3 call: g, coords and the feature rows the taps
    reference read once, d_coords written once, over the memory rate; per
    channel of each pixel with a tap in view, 4 tap differences, 4
    weightings, 2 sums and 2 products with g accumulated (12 operations)
    over the fp32 rate."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    n_rows = torch.unique(index[valid]).numel()
    n_bytes = (g.numel() * g.element_size() + coords.numel() * 4
               + n_rows * c * features.element_size() + coords.numel() * 4)
    ops = 12 * c * int(valid.any(0).sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _taps(coords, h, w):
    from dro_sfm_torch.ops.resample import bilinear_taps
    return bilinear_taps(coords, h, w)


def k2_tolerance(coords, g, h, w, dtype, ref):
    """Stated bar for K2 vs plain. Both sum the same fp32 products into each
    feature element, K2 in its fixed order, the plain version with
    index_add_ (on the card, atomics in run-dependent order): a reordering
    of n adds moves the sum by at most
    n * 2^-24 of the sum of magnitudes. The bar allows 64 adds (a near-
    identity warp sends 4 to 16 taps to an element) against the largest
    sum of |w g|; in bf16 one rounding step (2^-7 of the largest output)
    comes on top, since a reordered fp32 sum may round to the neighbour."""
    from dro_sfm_torch.ops.tent_warp import warp_diff_bwd_feat_plain
    mag = warp_diff_bwd_feat_plain(coords, g.float().abs(), h, w, torch.float32)
    tol = 64 * 2.0 ** -24 * mag.abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * ref.float().abs().max().item()
    return tol + 1e-30


def k3_tolerance(features, coords, g):
    """Stated bar for K3 vs plain: the C channel products of a pixel are
    summed in another order (16 lanes then a shuffle tree, against torch's
    reduction), each order within C * 2^-24 of the sum of magnitudes; the
    bar is twice that against the largest per-pixel sum of |g| times the
    four taps' |F|, which bounds sum |g * dF|."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    f = features.reshape(bn * h * w, c).float().abs()[index.reshape(-1)]
    f = (f.reshape(4, *coords.shape[:2], c) * valid[..., None]).sum(0)
    scale = (g.float().abs() * f).sum(-1).max().item()
    return 2 * c * 2.0 ** -24 * scale + 1e-30


def phase_k23(gen):
    """K2 and K3 against their plain versions at the training shapes and at
    the edge cases, K2 twice (the same bits), K2 timed where the warp
    collapses into one cell; returns the B=8 timings by dtype."""
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
    )
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            cases.append((f"training B={b}", b, VIEWS, 24, 80, 128, dtype, "serving"))
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("6x10", 2, VIEWS, 6, 10, 128, dtype, "serving"),
                  ("6x10 C=6", 2, VIEWS, 6, 10, 6, dtype, "serving"),
                  ("integer", 1, VIEWS, 24, 80, 128, dtype, "integer"),
                  ("outside -10", 1, VIEWS, 24, 80, 128, dtype, "outside"),
                  ("far +-1e8", 1, VIEWS, 24, 80, 128, dtype, "far"),
                  ("collapse B=8", 8, VIEWS, 24, 80, 128, dtype, "collapse")]
    results = {}
    for name, b, n, h, w, c, dtype, kind in cases:
        _, features, coords = k1_inputs(gen, b, n, h, w, c, dtype, kind)
        g = torch.randn(b * n, h * w, c, generator=gen, device="cuda").to(dtype)
        d_feat = warp_diff_bwd_feat(coords, g, h, w, dtype)
        again = warp_diff_bwd_feat(coords, g, h, w, dtype)
        d_co = warp_diff_bwd_coords(features, coords, g)
        torch.cuda.synchronize()
        ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype)
        ref_co = warp_diff_bwd_coords_plain(features, coords, g)
        dt = str(dtype).replace("torch.", "")
        err2 = (d_feat.float() - ref_feat.float()).abs().max().item()
        err3 = (d_co - ref_co).abs().max().item()
        tol2 = k2_tolerance(coords, g, h, w, dtype, ref_feat)
        tol3 = k3_tolerance(features, coords, g)
        same = torch.equal(d_feat, again)
        line = (f"K2/K3 {name:12s} {dt:8s} K2 max_abs_err {err2:.3e} tol {tol2:.3e}"
                f" | K3 max_abs_err {err3:.3e} tol {tol3:.3e} | two K2 calls bitwise equal:"
                f" {same}")
        if not same:
            fail(line)
        if d_feat.dtype != dtype or d_co.dtype != torch.float32:
            fail(f"{line}: dtypes {d_feat.dtype}, {d_co.dtype}")
        if not (torch.isfinite(d_feat).all() and torch.isfinite(d_co).all()):
            fail(f"{line}: non-finite gradient")
        if err2 > tol2 or err3 > tol3:
            fail(line)
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            if (d_co[outside] != 0).any():
                fail(f"K3 {name} {dt}: out-of-view pixels have a coordinate gradient")
            if kind == "outside" and (d_feat != 0).any():
                fail(f"K2 {name} {dt}: out-of-view pixels scattered into the features")
        if kind == "integer":
            # every pixel with a tap in view has a nonzero coordinate gradient
            inview = _taps(coords, h, w)[1].any(0)
            nonzero = (d_co[inview] != 0).any(-1).float().mean().item()
            line += f" | nonzero d_coords in view {100 * nonzero:.2f}%"
            if nonzero < 0.99:
                fail(f"K3 {name} {dt}: the right-sided subgradient is missing ({line})")
        if kind == "collapse":
            ms = time_ms(lambda: warp_diff_bwd_feat(coords, g, h, w, dtype))
            line += f" | K2 kernel {ms:.4f} ms ({k2_split(coords, g, h, w, dtype)})"
        if name.startswith("training") or kind == "collapse":
            # the bars must fail a kernel that leaves out one tap
            bad2 = faulty_backward("K2")[1](coords, g, h, w, dtype)
            bad3 = faulty_backward("K3")[1](features, coords, g)
            e2 = (bad2.float() - ref_feat.float()).abs().max().item()
            e3 = (bad3 - ref_co).abs().max().item()
            line += f" | planted faults: K2 err {e2:.3e}, K3 err {e3:.3e}"
            if e2 <= tol2 or e3 <= tol3:
                fail(f"{line}: a bar passes a kernel that leaves out a tap")
        if name.startswith("training"):
            results[(b, dt)] = time_k23(features, coords, g, dtype)
            r = results[(b, dt)]
            line += (f" | K2 kernel {r['K2']['ms']:.4f} ms plain {r['K2']['plain_ms']:.4f}"
                     f" library {r['K2']['library_ms']:.4f} bound {r['K2']['bound_ms']:.4f}"
                     f" | K3 kernel {r['K3']['ms']:.4f} ms plain {r['K3']['plain_ms']:.4f}"
                     f" library {r['K3']['library_ms']:.4f} bound {r['K3']['bound_ms']:.4f}"
                     f" | library K2+K3 in one call {r['library_both_ms']:.4f} ms"
                     f" | K2 by launch: {k2_split(coords, g, h, w, dtype)}")
            r["K2"]["max_abs_err"], r["K3"]["max_abs_err"] = err2, err3
        print(line, flush=True)
    return results


K2_KERNELS = ("tent_warp_bwd_feat_plan", "tent_warp_bwd_feat_gather")


def kernel_us(fn, names, reps=10):
    """Mean device us a call of ``fn`` spends in the kernels whose names
    hold each of ``names`` (torch.profiler over ``reps`` calls, the second
    of two sessions: the first can drop launches)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {n: sum(device_us(e) for e in events if n in e.key) / reps for n in names}


def k2_split(coords, g, h, w, dtype):
    """K2's device time by launch, as text."""
    from dro_sfm_torch.ops.tent_warp import warp_diff_bwd_feat
    us = kernel_us(lambda: warp_diff_bwd_feat(coords, g, h, w, dtype), K2_KERNELS)
    return ", ".join(f"{n.rsplit('_', 1)[-1]} {v:.2f} us" for n, v in us.items())


def time_k23(features, coords, g, dtype):
    """Kernel, plain, library and bound times of K2 and K3 on one input.
    The library yardstick is ATen's `grid_sampler_2d_backward` on the same
    tensors (channel-last views, normalised grid in the features' dtype),
    asked for the input gradient (K2), the grid gradient (K3), or both."""
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
    )
    bn, h, w, c = features.shape
    p = coords.shape[1]
    grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)], -1)
            * 2 - 1).to(dtype)[:, None]                        # [bn,1,P,2]
    feat_nchw = features.permute(0, 3, 1, 2)
    g_nchw = g.reshape(bn, 1, p, c).permute(0, 3, 1, 2)

    def library(mask):
        return torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, feat_nchw, grid, 0, 0, True, mask)

    out = {"K2": {"ms": time_ms(lambda: warp_diff_bwd_feat(coords, g, h, w, dtype)),
                  "plain_ms": time_ms(lambda: warp_diff_bwd_feat_plain(coords, g, h, w,
                                                                       dtype)),
                  "library_ms": time_ms(lambda: library([True, False]))},
           "K3": {"ms": time_ms(lambda: warp_diff_bwd_coords(features, coords, g)),
                  "plain_ms": time_ms(lambda: warp_diff_bwd_coords_plain(features, coords,
                                                                         g)),
                  "library_ms": time_ms(lambda: library([False, True]))},
           "library_both_ms": time_ms(lambda: library([True, True]))}
    out["K2"]["bound_ms"], out["K2"]["bound_by"] = k2_bound(coords, g, h, w, dtype)
    out["K3"]["bound_ms"], out["K3"]["bound_by"] = k3_bound(features, coords, g)
    return out


def make_train_batch(b, h=SERVE_H, w=SERVE_W, n=VIEWS, seed=0):
    """The synthetic batch of the JAX package's training benchmark: uniform
    images, depth uniform in [1, 60], identity context poses, on the card;
    the un-jittered originals that the photometric term reads are the
    images themselves."""
    gen = torch.Generator().manual_seed(seed)
    K = torch.tensor([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2],
                      [0, 0, 1.0]])
    batch = {"rgb": torch.rand(b, h, w, 3, generator=gen),
             "rgb_context": torch.rand(b, n, h, w, 3, generator=gen),
             "intrinsics": K.expand(b, 3, 3).contiguous(),
             "depth": 1.0 + 59.0 * torch.rand(b, h, w, 1, generator=gen),
             "pose_context": torch.eye(4).expand(b, n, 4, 4).contiguous()}
    batch["rgb_original"], batch["rgb_context_original"] = batch["rgb"], batch["rgb_context"]
    return {k: v.cuda() for k, v in batch.items()}


def make_scene_batch(b, h=SERVE_H, w=SERVE_W, n=VIEWS, seed=0):
    """A batch of the `Synthetic` dataset that the self-supervised configs
    train on, rendered at h x w: a smooth textured plane a scene, the
    context views the same scene from known relative poses (so each is a
    warp of the target), exact depth, no colour jitter (the originals are
    the images), on the card."""
    from dro_sfm_torch.data import SyntheticConfig, SyntheticDataset
    from dro_sfm_torch.data.loader import collate
    data = SyntheticDataset(SyntheticConfig(num_scenes=b, height=h, width=w, num_context=n,
                                            seed=seed), mode="train", image_shape=(h, w))
    batch = collate([data[i] for i in range(b)])
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()
            if k not in ("idx", "filename")}


def train_config(**overrides):
    from dro_sfm_torch.models.sfm import SfmModelConfig, resolve_memory_policy
    remat, unroll = resolve_memory_policy("auto", "auto", TRAIN_B, (SERVE_H, SERVE_W))
    kw = dict(name="SupModelMF", version="it12-h-out", min_depth=0.2, max_depth=80.0,
              flip_lr_prob=0.5, mixed_precision=True, warp_impl="pallas",
              remat=remat, scan_unroll=unroll)
    return SfmModelConfig(**{**kw, **overrides})


def start_weights(cfg):
    """The net the training phases start from: random weights from seed 0
    with the last convolution of every depth and pose head scaled by
    HEAD_SCALE. At the unscaled random weights the refinement's poses run to
    10 and the gradient norm to 1e24 (the JAX package's step does the same
    from its own random weights), Adam's second moment overflows for
    millions of elements and those stop moving."""
    return scale_heads(cfg.build_net(device="cuda", generator=torch.Generator().manual_seed(0)))


def scale_heads(net):
    """``net`` with the last convolution of every depth and pose head
    scaled by HEAD_SCALE, in place."""
    with torch.no_grad():
        for k, p in net.named_parameters():
            if k.endswith("head.conv2.weight"):
                p.mul_(HEAD_SCALE)
    return net


def grad_norm(params):
    return torch.sqrt(sum((p.grad.double() ** 2).sum() for p in params
                          if p.grad is not None)).item()


def phase_train(counters, gpu, sep_conv="split", want=TRAIN_LAUNCHES, name="SupModelMF",
                steps=TRAIN_STEPS, make_batch=make_train_batch):
    """The training path of task ``name`` (it12-h-out bf16 for the
    multi-frame names, the fp32 single-frame nets for the others) at
    192x640 N=2 B=8 with ``sep_conv`` on ``make_batch(8)``: one warm-up step
    and ``steps`` timed ones; ``want`` the launches of each kernel a step
    (others 0)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    cfg = train_config(sep_conv=sep_conv, name=name)
    want = {k: want.get(k, 0) for k in counters}
    net = start_weights(cfg)
    opt = make_optimizer(net, steps_per_epoch=1000)     # config-default Adam, StepLR
    state = create_train_state(net, opt, device="cuda")
    train_step = make_train_step(cfg, net, opt, device="cuda")
    batch = make_batch(TRAIN_B)
    flips = torch.Generator().manual_seed(1)
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for c in counters.values():              # the training path starts here
        c.reset()
    params = dict(net.named_parameters())
    per_step, times, losses, norms = [], [], [], []
    for i in range(steps + 1):               # one warm-up step, then timed
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        start = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, flips)
        torch.cuda.synchronize()
        if i > 0:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"].item())
        per_step.append({k: c.launches - start[k] for k, c in counters.items()})
        if i in (0, steps):                  # outside the timed steps
            norms.append(grad_norm(params.values()))
    launches = {k: c.launches for k, c in counters.items()}   # the path ends here
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"{name} train step {i}: launches {got}, want {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"training {name}: non-finite loss {losses}")
    # Every parameter and every BatchNorm statistic moved, and no element of
    # Adam's moments overflowed (an infinite second moment freezes its
    # element: the update m / sqrt(v) is zero).
    after = net.state_dict()
    stale = [k for k, v in before.items()
             if not k.endswith("num_batches_tracked") and torch.equal(v, after[k])]
    if stale:
        fail(f"training {name}: parameters or statistics never moved: {stale[:5]}")
    moments = state.optimizer.torch_optimizer.state
    n_bad = sum(int((~torch.isfinite(moments[p][m])).sum())
                for p in params.values() for m in ("exp_avg", "exp_avg_sq"))
    if n_bad:
        fail(f"training {name}: {n_bad} elements of Adam's moments are not finite")
    print(f"training {name}: all {len(params)} parameter tensors and every BatchNorm "
          f"statistic moved, Adam's moments finite; gradient norm {norms[0]:.3e} "
          f"(first step) -> {norms[-1]:.3e} (last step)", flush=True)
    if state.step != steps + 1:
        fail(f"training {name}: state.step {state.step}")
    times.sort()
    ms = times[len(times) // 2]
    net_desc = ("single-frame nets fp32" if cfg.single_frame
                else f"{cfg.version} bf16 remat={cfg.remat} sep_conv={sep_conv}")
    print(f"training {name} {net_desc} {SERVE_H}x{SERVE_W} N=2 B={TRAIN_B} "
          f"{make_batch.__name__}: "
          f"median {ms:.2f} ms/step (min {times[0]:.2f}, max {times[-1]:.2f}, "
          f"{steps} steps) {1e3 * TRAIN_B / ms:.1f} frames/s, peak {peak:.0f} MiB, "
          f"launches/step {per_step[-1]}, loss {losses[0]:.4f} -> {losses[-1]:.4f} on {gpu}",
          flush=True)
    return state, train_step, batch, launches, ms


def train_gradients(cfg, state_dict, batch, feat_ratio=8):
    """Parameter gradients of one training forward + backward (flip off),
    the net at ``feat_ratio``."""
    from dro_sfm_torch.models.sfm import forward_and_loss
    net = cfg.build_net(device="cuda") if feat_ratio == 8 else stride4_net(cfg)
    net.load_state_dict(state_dict, strict=True)
    loss, _ = forward_and_loss(cfg, net, batch, None, do_flip=False)
    loss.backward()
    return {k: p.grad.detach().double() for k, p in net.named_parameters()}, loss.item()


def faulty_backward(kernel):
    """The warp backward with one planted fault: kernel K2 or K3 (``kernel``
    "K2" or "K3") leaves out the (0, 0) tap of every pixel, the heaviest
    tap of a near-identity warp. It runs the real kernel and takes that
    tap's share back out. Returns (name of the `ops.tent_warp` function to
    replace, the faulty function)."""
    from dro_sfm_torch.ops import tent_warp
    from dro_sfm_torch.ops.resample import bilinear_taps
    k2, k3 = tent_warp.warp_diff_bwd_feat, tent_warp.warp_diff_bwd_coords

    def feat(coords, g, h, w, dtype):
        out = k2(coords, g, h, w, torch.float32)
        index, valid, weight, _, _ = bilinear_taps(coords, h, w)
        ok = valid[0]
        out.view(-1, g.shape[-1]).index_add_(0, index[0][ok],
                                             weight[0][ok][:, None] * g.float()[ok])
        return out.to(dtype)

    def coords_grad(features, coords, g):
        # d = -<g, e> with e_x = (1-wy)(F01 - F00) + ..., e_y = (1-wx)(F10 - F00)
        # + ...: without F00, d_x loses (1-wy)<g, F00> and d_y (1-wx)<g, F00>.
        out = k3(features, coords, g)
        bn, h, w, c = features.shape
        index, valid, _, wx, wy = bilinear_taps(coords, h, w)
        f00 = features.reshape(-1, c).float()[index[0]] * valid[0][..., None]
        dot = (g.float() * f00).sum(-1)
        return out - torch.stack([(1 - wy) * dot, (1 - wx) * dot], dim=-1)

    return {"K2": ("warp_diff_bwd_feat", feat),
            "K3": ("warp_diff_bwd_coords", coords_grad)}[kernel]


def bf16_bar(own):
    """The bf16 bar of one leaf, given bf16's own error there (the plain
    warp's bf16 gradient against its fp32 gradient, relative L2)."""
    return BF16_BAR if own < BF16_OWN_NOISY else max(BF16_BAR, BF16_SHARE * own)


def compare_grads(got_all, ref_all, fp32_ref=None, fp32_bar=1e-4, floors=None):
    """Each leaf of ``got_all`` against ``ref_all`` in fp64: fp32 bars
    (cosine >= 0.99999, rel L2 <= ``fp32_bar``) when ``fp32_ref`` is None,
    else bf16 bars from bf16's own error against ``fp32_ref``, raised to
    ``floors[leaf]`` where ``floors`` gives one. Returns
    (leaves beyond their bar, leaves whose bf16 bar is relaxed, (worst rel
    L2, its leaf), worst cosine); the entries of the two lists are (leaf,
    rel L2, cosine, own error or None, bar). A zero gradient must stay zero;
    a non-finite one is beyond every bar."""
    beyond, relaxed, worst, worst_cos = [], [], (-1.0, ""), 1.0
    for k, ref in ref_all.items():
        got = got_all[k]
        if not torch.isfinite(got).all() or (ref.norm().item() == 0
                                             and got.norm().item() != 0):
            beyond.append((k, math.inf, 0.0, None, 0.0))
            continue
        if ref.norm().item() == 0:
            continue
        r, cos = rel_l2(got, ref), cosine(got, ref)
        if fp32_ref is None:
            own, bar, ok = None, fp32_bar, r <= fp32_bar and cos >= 0.99999
        else:
            own = rel_l2(ref, fp32_ref[k])
            bar = max(bf16_bar(own), (floors or {}).get(k, 0.0))
            ok = r <= bar
            if own >= BF16_OWN_NOISY:
                relaxed.append((k, r, cos, own, bar))
        if not ok:
            beyond.append((k, r, cos, own, bar))
        worst, worst_cos = max(worst, (r, k)), min(worst_cos, cos)
    return beyond, relaxed, worst, worst_cos


def rel_l2(a, b):
    return (a - b).norm().item() / b.norm().item()


def cosine(a, b):
    return (a * b).sum().item() / (a.norm().item() * b.norm().item())


def phase_train_end_to_end():
    """Gradients of one step through the kernels against the plain warp on
    the card, same weights and batch, B=2, flip off, deterministic library
    algorithms (cuDNN's, and index_add_ without atomics), so that the runs
    differ by the warp's backward alone. The weights are those the training
    phase starts from (`start_weights`).

    fp32 (TF32 off): every leaf at cosine >= 0.99999 and relative L2 <= 1e-4
    (K2 sums with atomics and K3 reduces channels in another order: fp32
    reordering, carried through the backward).

    bf16: every leaf at relative L2 <= 2e-2 (BF16_BAR), except where bf16's
    own error (the plain warp's bf16 gradient against its fp32 gradient)
    reaches 0.1: those leaves, where bf16's gradient sums with deep
    cancellation, may differ by 0.25 of that error. The relaxed leaves are
    printed with their readings.

    Planted faults (`faulty_backward`: K2, then K3, leaves out one tap) must
    fail the fp32 bar, and the K3 fault the bf16 bar. A K2 fault moves no
    leaf by more than K2's share of it, printed here (under 1% on the chip),
    which bf16's own error hides: phase 7's bar on K2 alone catches it.

    Leaves are compared in fp64; a zero gradient stays zero."""
    from dro_sfm_torch.ops import tent_warp
    state_dict = start_weights(train_config()).state_dict()
    batch = make_train_batch(2, seed=2)
    grads, losses = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # ops with no deterministic twin
        torch.use_deterministic_algorithms(True, warn_only=True)
        for mp in (False, True):
            for impl, fault in (("pallas", None), ("gather", None), ("pallas", "K2"),
                                ("pallas", "K3")):
                cfg = train_config(mixed_precision=mp, warp_impl=impl, remat=False)
                name, fn = faulty_backward(fault) if fault else (None, None)
                real = getattr(tent_warp, name) if fault else None
                if fault:
                    setattr(tent_warp, name, fn)
                try:
                    grads[mp, fault or impl], losses[mp, fault or impl] = \
                        train_gradients(cfg, state_dict, batch)
                finally:
                    if fault:
                        setattr(tent_warp, name, real)
        torch.use_deterministic_algorithms(False)

    fp32_ref = grads[False, "gather"]
    top = max(g.norm().item() for g in fp32_ref.values())
    for mp, dt in ((False, "fp32"), (True, "bf16")):
        ref_all = grads[mp, "gather"]
        own_ref = fp32_ref if mp else None
        beyond, relaxed, worst, worst_cos = compare_grads(grads[mp, "pallas"], ref_all,
                                                          own_ref)
        for k, r, cos, own, bar in beyond:
            print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own {own} "
                  f"bar {bar:.3e}")
        if beyond:
            fail(f"end to end training {dt}: {len(beyond)} leaves beyond their bar")
        extra = (f"; bar {BF16_BAR:g}, relaxed on {len(relaxed)} leaves (own error >= "
                 f"{BF16_OWN_NOISY:g}), listed below" if mp else "")
        print(f"end to end training {dt} B=2: kernel vs plain gradients over "
              f"{len(ref_all)} leaves (largest fp32 norm {top:.3e}), worst rel L2 "
              f"{worst[0]:.3e} ({worst[1]}), worst cosine {worst_cos:.7f}, loss "
              f"{losses[mp, 'pallas']:.6f} vs {losses[mp, 'gather']:.6f}{extra}",
              flush=True)
        for k, r, cos, own, bar in relaxed:
            print(f"  relaxed: {k} rel L2 {r:.3e} own {own:.3e} bar {bar:.3e}")
        for fault in ("K2", "K3"):
            beyond, _, worst, _ = compare_grads(grads[mp, fault], ref_all, own_ref)
            print(f"end to end training {dt}, planted fault ({fault} leaves out one "
                  f"tap): {len(beyond)} leaves beyond their bar, worst rel L2 "
                  f"{worst[0]:.3e} ({worst[1]})", flush=True)
            if not beyond and (fault == "K3" or not mp):
                fail(f"end to end training {dt}: the bar passes a {fault} that leaves "
                     "out a tap")


# --- K4: the bare warp `tent_warp` -------------------------------------------

def k4_bound(features, coords):
    """Least time of one K4 call: the feature rows the taps reference,
    coords and the fp32 output once over the memory rate; 8 fp32 operations
    per output element over the fp32 rate."""
    bn, h, w, c = features.shape
    index, valid = _taps(coords, h, w)[:2]
    n_rows = torch.unique(index[valid]).numel()
    n_bytes = (n_rows * c * features.element_size() + coords.numel() * 4
               + coords.shape[0] * coords.shape[1] * c * 4)
    ops = 8 * coords.shape[0] * coords.shape[1] * c
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def time_cold_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with a cold L2: before each call a 64 MB
    buffer (more than the card's 50 MB L2) is written and a second one read,
    so that neither ``fn``'s data nor dirty lines, whose write-back would
    fall in ``fn``'s time, stay in L2; each call is timed by its own pair of
    events. As in `time_ms`, a sleep kernel holds the stream while the host
    enqueues everything."""
    flush = torch.empty(16 * 2 ** 20, device="cuda")                 # 64 MB of fp32
    clean = torch.zeros(16 * 2 ** 20, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for i, (start, end) in enumerate(events):
        flush.fill_(float(i))
        clean.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# K4's variants: the wrapper runs "direct" where the rows allow 16-byte
# accesses and "unaligned" otherwise (C = 6, features at an odd element
# offset).
K4_TIMED = (("warp B=8", torch.bfloat16), ("warp B=1", torch.bfloat16),
            ("warp B=8", torch.float32))
K4_TARGET = 0.5                    # of its bound, at B=8 bf16 (printed, not a bar)


def time_k4(features, coords):
    """K4's two variants ("unaligned" on a copy of the features one element
    off an aligned address) warm and cold, beside the plain version,
    `grid_sample` and the bound, on one input."""
    from dro_sfm_torch.ops.tent_warp import tent_warp, tent_warp_plain
    h, w = features.shape[1:3]
    grid = (torch.stack([coords[..., 0] / (w - 1), coords[..., 1] / (h - 1)], -1)
            * 2 - 1).to(features.dtype)[:, None]
    feat_nchw = features.permute(0, 3, 1, 2)
    odd = misaligned(features)
    runs = {"direct": lambda: tent_warp(features, coords),
            "unaligned": lambda: tent_warp(odd, coords),
            "library": lambda: F.grid_sample(feat_nchw, grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True)}
    r = {}
    for name, fn in runs.items():
        r[name] = time_ms(fn)
        r[name + "_cold"] = time_cold_ms(fn)
    r["plain"] = time_ms(lambda: tent_warp_plain(features, coords))
    r["bound"], r["bound_by"] = k4_bound(features, coords)
    return r


def phase_k4(gen, counters):
    """K4 (`tent_warp`) against `tent_warp_plain`, and its gradient (K2 and
    K3 with sign +1, K3 on the fp32 cotangent beside bf16 features) against
    the plain versions, at the warp shapes (16 maps of 24x80x128, bf16 and
    fp32, and B=1), a ragged last tile (41x47), features one element off an
    aligned address (the unaligned variant at full width) and the edge
    cases. Bars: K1's for the forward (the same taps and fp32 sums: one
    rounding step of the fp32 output), phase 7's for K2 and K3. Each forward
    must be planned (`k4_plan`, on its own pointers) on the variant its
    shape and alignment call for. The B=8 bf16 case is driven through the
    entry point with every count reset just before and read just after (the
    K4 path): K4, K2 and K3 one launch each. At B=8 bf16, B=1 bf16 and B=8
    fp32 both variants are timed (`time_k4`), warm and cold, beside the
    plain version, `grid_sample` and the bound; the phase fails if K4
    ("direct", the wrapper's) is slower than `grid_sample` there. Returns
    (timings, launches of that path)."""
    from dro_sfm_torch.kernels import sm_count
    from dro_sfm_torch.ops.tent_warp import (
        k4_plan,
        tent_warp,
        tent_warp_plain,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat_plain,
    )
    cases = [(f"warp B={b}", b, 24, 80, 128, dt, "serving", False)
             for dt in (torch.bfloat16, torch.float32) for b in (1, 8)]
    for dt in (torch.bfloat16, torch.float32):
        cases += [("ragged 41x47", 8, 41, 47, 128, dt, "serving", False),
                  ("odd offset", 8, 24, 80, 128, dt, "serving", True),
                  ("6x10", 2, 6, 10, 128, dt, "serving", False),
                  ("6x10 C=6", 2, 6, 10, 6, dt, "serving", False),
                  ("integer", 1, 24, 80, 128, dt, "integer", False),
                  ("outside -10", 1, 24, 80, 128, dt, "outside", False),
                  ("far +-1e8", 1, 24, 80, 128, dt, "far", False)]
    timings, path = {}, None
    for name, b, h, w, c, dtype, kind, odd in cases:
        _, features, coords = k1_inputs(gen, b, VIEWS, h, w, c, dtype, kind)
        g = torch.randn(b * VIEWS, h * w, c, generator=gen, device="cuda")   # fp32
        feat = (misaligned(features) if odd else features.clone()).requires_grad_()
        co = coords.clone().requires_grad_()
        main = name == "warp B=8" and dtype == torch.bfloat16
        if main:
            for cnt in counters.values():          # the K4 path starts here
                cnt.reset()
        out = tent_warp(feat, co)
        ran = k4_plan(co.shape[0] * co.shape[1], c, feat.element_size(), feat.data_ptr(),
                      out.data_ptr(), sm_count(0)).variant
        d_feat, d_co = torch.autograd.grad(out, (feat, co), g)
        torch.cuda.synchronize()
        if main:
            path = {k: cnt.launches for k, cnt in counters.items()}   # and ends here
        ref = tent_warp_plain(features, coords)
        ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype, sign=1.0)
        ref_co = warp_diff_bwd_coords_plain(features, coords, g, sign=1.0)
        dt = str(dtype).replace("torch.", "")
        err = (out - ref).abs().max().item()
        err2 = (d_feat.float() - ref_feat.float()).abs().max().item()
        err3 = (d_co - ref_co).abs().max().item()
        tol = k1_tolerance(torch.float32, ref)
        tol2 = k2_tolerance(coords, g, h, w, dtype, ref_feat)
        tol3 = k3_tolerance(features, coords, g)
        want_variant = "unaligned" if odd or c % 4 else "direct"
        line = (f"K4 {name:12s} {dt:8s} {ran:9s} max_abs_err {err:.3e} tol {tol:.3e} | "
                f"d_features {err2:.3e} tol {tol2:.3e} | d_coords {err3:.3e} tol {tol3:.3e}")
        if ran != want_variant:
            fail(f"{line}: K4 planned variant {ran!r}, want {want_variant!r}")
        if (out.dtype, d_feat.dtype, d_co.dtype) != (torch.float32, dtype, torch.float32):
            fail(f"{line}: dtypes {out.dtype}, {d_feat.dtype}, {d_co.dtype}")
        if not all(torch.isfinite(t).all() for t in (out, d_feat, d_co)):
            fail(f"{line}: non-finite")
        if err > tol or err2 > tol2 or err3 > tol3:
            fail(line)
        if kind in ("outside", "far"):
            outside = (coords.abs() > 1e3).any(-1) | (coords < -3).any(-1)
            if (out[outside] != 0).any() or (d_co[outside] != 0).any():
                fail(f"K4 {name} {dt}: out-of-view pixels sample or get a gradient")
        if main:
            line += f" | path launches {path}"
        print(line, flush=True)
        if (name, dtype) in K4_TIMED:
            r = time_k4(features, coords)
            share = r["bound"] / r["direct"]
            print(f"K4 timing {name} {dt} (us, warm / cold): "
                  + " | ".join(f"{v} {1e3 * r[v]:.2f} / {1e3 * r[v + '_cold']:.2f}"
                               for v in ("direct", "unaligned"))
                  + f" | grid_sample {1e3 * r['library']:.2f} / "
                  f"{1e3 * r['library_cold']:.2f} | plain {1e3 * r['plain']:.2f} | bound "
                  f"{1e3 * r['bound']:.2f} ({r['bound_by']}) | K4 at {100 * share:.1f}% of "
                  f"its bound, target {100 * K4_TARGET:.0f}% "
                  f"{'met' if share >= K4_TARGET else 'missed'}", flush=True)
            if r["direct"] >= r["library"]:
                fail(f"K4 {name} {dt}: {r['direct']:.4f} ms, slower than grid_sample "
                     f"({r['library']:.4f} ms)")
            if main:
                timings = {"max_abs_err": err, "ms": r["direct"], "plain_ms": r["plain"],
                           "bound_ms": r["bound"], "bound_by": r["bound_by"],
                           "library_ms": r["library"]}
    want = {"K4": 1, "K2": 1, "K3": 1}
    if {k: v for k, v in path.items() if v} != want:
        fail(f"the K4 path launched {path}, want {want}")
    return timings, path


# --- K5, K6: the fused separable-GRU pass ------------------------------------

GRU_D, GRU_CX = 128, 160           # it12-h-out: hidden 128, context 32 + encoder 128


def gru_inputs(gen, b, h, w, d, cx, dtype):
    """h, x [b,h,w,*] in ``dtype``, fp32 weights He-normal over the 5*C1
    fan-in and small biases, a cotangent g; all on the card."""
    c1 = d + cx
    dev = "cuda"
    std = math.sqrt(2.0 / (5 * c1))
    return {"h": torch.tanh(torch.randn(b, h, w, d, generator=gen, device=dev)).to(dtype),
            "x": torch.relu(torch.randn(b, h, w, cx, generator=gen, device=dev)).to(dtype),
            "wzr": std * torch.randn(5, c1, 2 * d, generator=gen, device=dev),
            "bzr": 0.1 * torch.randn(2 * d, generator=gen, device=dev),
            "wq": std * torch.randn(5, c1, d, generator=gen, device=dev),
            "bq": 0.1 * torch.randn(d, generator=gen, device=dev),
            "g": torch.randn(b, h, w, d, generator=gen, device=dev).to(dtype)}


def gru_bars(dtype):
    """Stated bars for K5/K6 vs plain, relative to the largest element of
    the plain result. fp32: 2^-14, for sums of up to 5 * 288 * 2 products
    (and, in the weight gradients, of every pixel of the batch) taken in
    another order. bf16: a reordered fp32 sum may round a gate, q, daq or
    dazr to the neighbouring bf16 value (2^-8 relative), and the outputs
    round once more: the forward 2^-6 (two rounding steps of the output), dh
    and dx 2^-5 (a flipped daq or dazr reaches them through a transposed
    conv, then dh rounds), the fp32 weight and bias gradients 2^-7 (a
    flipped daq or dazr moves one of the summed terms by 2^-8 of itself)."""
    if dtype == torch.float32:
        return {"fwd": 2.0 ** -14, "act": 2.0 ** -14, "weight": 2.0 ** -14}
    return {"fwd": 2.0 ** -6, "act": 2.0 ** -5, "weight": 2.0 ** -7}


GRU_GRADS = ("dh", "dx", "dwzr", "dbzr", "dwq", "dbq")


def gru_flops(inp, factor):
    """Multiply-adds x 2 of ``factor`` x D output channels of 5-tap convs
    over C1 inputs at every pixel: 3 for K5 and K6-weight, 6 for K6-input."""
    b, h, w, d = inp["h"].shape
    return 2.0 * b * h * w * 5 * (d + inp["x"].shape[-1]) * factor * d


def gru_bound(inp, factor, n_bytes):
    dtype = inp["h"].dtype
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    by_ops, by_bytes = gru_flops(inp, factor) / peak, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


def gru_bounds(inp):
    """Least times of K5, K6-input, K6-weight on this input: the operations
    over the tensor-core bf16 or the fp32 rate, against the bytes of each
    input read once and each output written once (K6-input's outputs include
    r*h, daq and dazr, which K6-weight reads)."""
    e = inp["h"].element_size()
    b, h, w, d = inp["h"].shape
    cx, n = inp["x"].shape[-1], b * h * w
    w_bytes = 5 * (d + cx) * 3 * d * e
    act = n * (d + cx) * e
    return {"K5": gru_bound(inp, 3, act + n * d * e + w_bytes),
            "K6-input": gru_bound(inp, 6, act + 2 * n * d * e + n * (d + cx) * e
                                  + 4 * n * d * e + w_bytes),
            "K6-weight": gru_bound(inp, 3, act + 4 * n * d * e + 5 * (d + cx) * 3 * d * 4)}


def split_pass(inp, axis):
    """The yardstick: one directional pass of `SepConvGRU`'s split path on the
    same tensors (NCHW views, cuDNN convolutions and the gate glue) and a
    function running its backward (autograd, retaining the graph)."""
    from dro_sfm_torch.models.update import SepConvGRU
    b, hh, ww, d = inp["h"].shape
    dtype = inp["h"].dtype
    gru = SepConvGRU(d, inp["x"].shape[-1], dtype=dtype, conv_impl="split").cuda()
    convzr, convq = (gru.convzr1, gru.convq1) if axis == 2 else (gru.convzr2, gru.convq2)
    with torch.no_grad():
        for conv, name in ((convzr, "wzr"), (convq, "wq")):
            wt = inp[name].permute(2, 1, 0)                     # [out, C1, 5]
            conv.weight.copy_(wt[:, :, None, :] if axis == 2 else wt[:, :, :, None])
            conv.bias.copy_(inp["b" + name[1:]])
    h = inp["h"].permute(0, 3, 1, 2).requires_grad_()
    x = inp["x"].permute(0, 3, 1, 2).requires_grad_()

    def fwd():
        zr = torch.sigmoid(convzr(torch.cat([h, x], dim=1)))
        z, r = zr.split(d, dim=1)
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q

    out = fwd()
    g = inp["g"].permute(0, 3, 1, 2)
    params = [h, x, convzr.weight, convzr.bias, convq.weight, convq.bias]
    return fwd, lambda: torch.autograd.grad(out, params, g, retain_graph=True)


def k5_fault(inp, axis, gru_pass):
    """K5 leaving out tap 0 of the candidate conv: the real kernel with that
    tap's weights zeroed."""
    wq = inp["wq"].clone()
    wq[0] = 0
    return gru_pass.gru_pass_fwd(inp["h"], inp["x"], inp["wzr"], inp["bzr"], wq,
                                 inp["bq"], axis)


def gru_intermediates(inp, axis, gru_pass):
    """The plain version's operands of the weight gradients, in the layout
    [B,H,W,*] and the compute dtype: [h, x], [r h, x], T(daq), T(dazr); and
    r in fp32."""
    args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
    cdt = inp["h"].dtype
    hs = gru_pass._shift_last(args[0], axis)
    xs = gru_pass._shift_last(args[1], axis)
    d = hs.shape[-1]
    hx, z, r, rhx, q, _ = gru_pass._recompute(hs, xs, args[2].to(cdt), args[3],
                                              args[4].to(cdt), args[5])
    gf = gru_pass._shift_last(inp["g"], axis).float()
    qf, zf, hf, rf = q.float(), z.float(), hs.float(), r.float()
    daq = ((gf * zf) * (1.0 - qf * qf)).to(cdt)
    drh = gru_pass._conv_t(daq, args[4].to(cdt))[..., :d]
    dazr = torch.cat([gf * (qf - hf) * zf * (1.0 - zf), drh * hf * rf * (1.0 - rf)],
                     dim=-1).to(cdt)
    return [gru_pass._shift_last(t, axis) for t in (hx, rhx, daq, dazr, rf)]


def k6_fault(inp, axis, gru_pass, dh, dx, mid):
    """K6-input leaving out tap 0 of the daq transposed conv (the tap that
    pairs daq[s - 2] with Wq[4]): the real kernel's dh and dx with that tap's
    share taken back out, the share from the plain version's daq and r."""
    _, _, daq, _, r = mid
    d = dh.shape[-1]
    cdt = inp["h"].dtype
    daq_s = gru_pass._shift_last(daq, axis)
    share = gru_pass._taps(daq_s.float())[0] @ inp["wq"][4].to(cdt).float().t()
    share = gru_pass._shift_last(share, axis)
    return ((dh.float() - share[..., :d] * r).to(dh.dtype),
            (dx.float() - share[..., d:]).to(dx.dtype))


def k6w_fault(inp, axis, gru_pass, dwq, mid):
    """K6-weight leaving out one split's pixels of dWq (the middle split of
    the wrapper's plan): the real kernel's dWq with the plain `_conv_w` of
    those pixels taken back out."""
    _, rhx, daq, _, _ = mid
    b, hh, ww, d = inp["h"].shape
    plan = gru_pass.k6_weight_plan(b, hh, ww, axis, gru_pass._round16(d),
                                   gru_pass._round16(inp["x"].shape[-1]), gru_pass.sm_count(0))
    pixels = gru_pass.k6_split_pixels(b, hh, ww, axis, *plan)[plan[1] // 2]
    mask = torch.zeros(b * hh * ww, dtype=daq.dtype, device=daq.device)
    mask[torch.tensor(pixels, device=daq.device)] = 1
    mask = mask.view(b, hh, ww, 1)
    shift = lambda t: gru_pass._shift_last(t, axis)          # noqa: E731
    return dwq - gru_pass._conv_w(shift(rhx), shift(daq * mask))


def kernel_name(key):
    """A profiler key's kernel name, without return type, namespace,
    template arguments and parameters."""
    name = key.split("(")[0].split("<")[0].split()
    return name[-1].split("::")[-1] if name else key


GRU_PREFIXES = {"K5": "gru_pass_fwd", "K6-input": "gru_pass_bwd_input",
                "K6-weight": "gru_pass_bwd_weight"}
GRU_CUDA_LAUNCHES = {"K5": 2, "K6-input": 4, "K6-weight": 2}


def gru_cuda_launches(inp, axis, gru_pass):
    """The CUDA launches of one K5, one K6-input and one K6-weight wrapper
    call: the kernel nodes of a CUDA graph that captures the call, counted
    through the CUDA driver (cuGraphGetNodes, cuGraphNodeGetType)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
    prep = gru_pass._Prepared(*args)
    _, _, scratch = gru_pass._launch_k6_input(prep, inp["g"], axis)
    calls = {"K5": lambda: gru_pass._launch_k5(prep, axis),
             "K6-input": lambda: gru_pass._launch_k6_input(prep, inp["g"], axis),
             "K6-weight": lambda: gru_pass._launch_k6_weight(prep, scratch, axis)}
    out = {}
    for k, fn in calls.items():
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        kinds = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            kinds.append(kind.value)
        del graph
        out[k] = (kinds.count(0), len(kinds))       # 0: CU_GRAPH_NODE_TYPE_KERNEL
    return out


def phase_gru(gen):
    """K5, K6-input and K6-weight against their plain versions on the card:
    the depth pass's shape of the training path (B=8, 24x80, D=128, Cx=160)
    and the pose pass's (B*N=16), both axes, bf16 and fp32; B=1; D=32 Cx=24
    (not multiples of 16); D=32 Cx=20 (in bf16 not whole 16-byte chunks:
    the wrapper pads); a 3-pixel line; 6x10. Each result beside its bar
    (`gru_bars`); two K5 calls and two K6 calls on the same inputs must give
    the same bits; one K5 call must make 2 CUDA launches, K6-input 4,
    K6-weight 2;
    the bars must fail K5 leaving out a tap, K6-input leaving out a tap of a
    transposed conv and K6-weight leaving out a split's pixels (`k5_fault`,
    `k6_fault`, `k6w_fault`). At the path's shapes (bf16 and fp32) and at
    B=1 (bf16): kernel, plain, split-pass, cuDNN weight-gradient and bound
    times. Returns the timings by (shape, dtype, axis)."""
    from dro_sfm_torch.ops import gru_pass
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, what in ((8, "depth"), (16, "pose"), (1, "B=1")):
            for axis in (2, 1):
                cases.append((what, b, 24, 80, GRU_D, GRU_CX, dtype, axis))
        for axis in (2, 1):
            cases += [("D32 Cx24", 2, 8, 16, 32, 24, dtype, axis),
                      ("D32 Cx20", 2, 8, 16, 32, 20, dtype, axis),
                      ("3-px line", 2, 3, 7, 32, 24, dtype, axis),
                      ("6x10", 2, 6, 10, GRU_D, GRU_CX, dtype, axis)]
    timings = {}
    inp = gru_inputs(gen, 8, 24, 80, GRU_D, GRU_CX, torch.bfloat16)
    for axis in (2, 1):
        for k, (n_kernels, n_nodes) in gru_cuda_launches(inp, axis, gru_pass).items():
            line = (f"K5/K6 CUDA launches of one {k} call (depth, bf16, axis {axis}): "
                    f"{n_kernels} (kernel nodes of the captured call, of {n_nodes} nodes)")
            if n_kernels != GRU_CUDA_LAUNCHES[k]:
                fail(f"{line}, want {GRU_CUDA_LAUNCHES[k]}")
            print(line, flush=True)
    for what, b, hh, ww, d, cx, dtype, axis in cases:
        inp = gru_inputs(gen, b, hh, ww, d, cx, dtype)
        args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
        out = gru_pass.gru_pass_fwd(*args, axis)
        out_again = gru_pass.gru_pass_fwd(*args, axis)
        grads = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
        again = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
        torch.cuda.synchronize()
        ref = gru_pass.gru_pass_plain(*args, axis)
        refs = gru_pass.gru_pass_bwd_plain(*args, inp["g"], axis)
        bars = gru_bars(dtype)
        dt = str(dtype).replace("torch.", "")

        def rel(a, r):
            return (a.float() - r.float()).abs().max().item() / max(
                r.float().abs().max().item(), 1e-30)

        errs = {"K5": rel(out, ref)}
        line = (f"K5/K6 {what:9s} {b:2d}x{hh}x{ww} D={d} Cx={cx} axis {axis} {dt:8s} "
                f"K5 {errs['K5']:.2e} (bar {bars['fwd']:.1e})")
        bad = errs["K5"] > bars["fwd"] or out.dtype != dtype
        for name, got, want in zip(GRU_GRADS, grads, refs):
            bar = bars["act" if name in ("dh", "dx") else "weight"]
            errs[name] = rel(got, want)
            line += f" {name} {errs[name]:.2e}"
            bad |= (errs[name] > bar or got.shape != want.shape or got.dtype != want.dtype
                    or not torch.isfinite(got).all())
        line += f" (bars {bars['act']:.1e}, {bars['weight']:.1e})"
        same5 = torch.equal(out, out_again)
        same = all(torch.equal(a, c) for a, c in zip(grads, again))
        line += f" | two K5 calls bitwise equal: {same5}, two K6 calls: {same}"
        if bad or not same or not same5 or not torch.isfinite(out).all():
            fail(line)
        mid = gru_intermediates(inp, axis, gru_pass)
        f5 = rel(k5_fault(inp, axis, gru_pass), ref)
        f6 = max(rel(a, r) for a, r in zip(k6_fault(inp, axis, gru_pass, *grads[:2], mid),
                                           refs[:2]))
        f6w = rel(k6w_fault(inp, axis, gru_pass, grads[4], mid), refs[4])
        line += f" | planted faults: K5 {f5:.2e}, K6-input {f6:.2e}, K6-weight {f6w:.2e}"
        if f5 <= bars["fwd"] or f6 <= bars["act"] or f6w <= bars["weight"]:
            fail(f"{line}: a bar passes a planted fault")
        if (what in ("depth", "pose") and (axis == 2 or dtype == torch.bfloat16)
                or what == "B=1" and dtype == torch.bfloat16):
            r = time_gru(inp, axis, gru_pass, mid)
            for k in r:
                r[k]["max_abs_err"] = max(errs[n] for n in (
                    ("K5",) if k == "K5" else ("dh", "dx") if k == "K6-input"
                    else GRU_GRADS[2:]))
            line += "".join(f" | {k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} "
                            f"split {v['split_ms']:.4f} library {v['library_ms']:.4f} "
                            f"bound {v['bound_ms']:.4f}" for k, v in r.items())
            pair = r["K6-input"]["ms"] + r["K6-weight"]["ms"]
            line += (f" | K6 pair {pair:.4f} ms vs split backward "
                     f"{r['K6-input']['split_ms']:.4f} ms")
            timings[(what, dt, axis)] = r
        print(line, flush=True)
    return timings


def wgrad_yardstick(inp, axis, mid):
    """K6-weight's yardstick: cuDNN's weight and bias gradients of the split
    path's two convolutions (`convolution_backward`, output_mask (False,
    True, True)) on the plain version's operands, as one function. Timed
    beside the kernel; the port never calls it."""
    hx, rhx, daq, dazr, _ = mid
    cdt = inp["h"].dtype
    pad = [0, 2] if axis == 2 else [2, 0]
    nchw = lambda t: t.permute(0, 3, 1, 2)                   # noqa: E731

    def weight(w):                                           # [5, C1, O] -> OIHW
        wt = w.permute(2, 1, 0).to(cdt)
        return (wt[:, :, None, :] if axis == 2 else wt[:, :, :, None]).contiguous()

    ops = [(nchw(dazr), nchw(hx), weight(inp["wzr"])), (nchw(daq), nchw(rhx), weight(inp["wq"]))]

    def run():
        return [torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], [1, 1], pad, [1, 1], False, [0, 0], 1,
            [False, True, True]) for g, x, w in ops]
    return run


def time_gru(inp, axis, gru_pass, mid):
    """Kernel, plain, split-pass, library and bound times of K5, K6-input
    and K6-weight on one input. The plain time of both K6 halves is that of
    `gru_pass_bwd_plain`, which computes all six gradients; the split time of
    K5 is the split pass's forward, of K6-input and K6-weight its backward
    (all its gradients: cuDNN's data and weight gradients of both
    convolutions and the glue). The library time is the split time but for
    K6-weight: cuDNN's weight and bias gradients alone (`wgrad_yardstick`)."""
    args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
    prep = gru_pass._Prepared(*args)
    _, _, scratch = gru_pass._launch_k6_input(prep, inp["g"], axis)
    split_fwd, split_bwd = split_pass(inp, axis)
    bwd_plain = time_ms(lambda: gru_pass.gru_pass_bwd_plain(*args, inp["g"], axis), reps=5)
    split_bwd_ms, split_fwd_ms = time_ms(split_bwd), time_ms(split_fwd)
    out = {"K5": {"ms": time_ms(lambda: gru_pass._launch_k5(prep, axis)),
                  "plain_ms": time_ms(lambda: gru_pass.gru_pass_plain(*args, axis), reps=5),
                  "split_ms": split_fwd_ms, "library_ms": split_fwd_ms},
           "K6-input": {"ms": time_ms(lambda: gru_pass._launch_k6_input(prep, inp["g"], axis)),
                        "plain_ms": bwd_plain, "split_ms": split_bwd_ms,
                        "library_ms": split_bwd_ms},
           "K6-weight": {"ms": time_ms(lambda: gru_pass._launch_k6_weight(prep, scratch, axis)),
                         "plain_ms": bwd_plain, "split_ms": split_bwd_ms,
                         "library_ms": time_ms(wgrad_yardstick(inp, axis, mid))}}
    for k, (ms, by) in gru_bounds(inp).items():
        out[k]["bound_ms"], out[k]["bound_by"] = ms, by
    return out


def phase_serving_pallas(DepthPoseNet, make_infer_fn, counters, state, gpu):
    """Serving with ``sep_conv="pallas"``: the same it12-h-out bf16 weights
    as phase 4, B=1 and B=8 through `make_infer_fn`, every count reset just
    before and read just after: K1 24 and K5 48 launches a request, no other
    kernel. The split path is timed in the same phase, requests alternating.
    Then, from `tame_weights` (the random eval-mode net is chaotic: two fp32
    runs that sum in another order part by tens of percent), the outputs of
    both paths on the card in fp32 (TF32 off), bar 1e-4
    relative L2 (the same math; the fused pass sums its convolutions in
    another order than cuDNN, through 24 recurrent steps); in bf16 each
    path's distance to fp32 is printed, the fused path's held to the bar
    5e-2 of the CPU tests' bf16 net. Returns the launches."""
    nets = {}
    for sep in ("pallas", "split"):
        nets[sep] = DepthPoseNet(version="it12-h-out", mixed_precision=True,
                                 warp_impl="pallas", sep_conv=sep, device="cuda")
        nets[sep].load_state_dict(state, strict=True)
    infer = {k: make_infer_fn(v, device="cuda") for k, v in nets.items()}
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    for c in counters.values():              # the pallas serving path starts here
        c.reset()
    for b, req in requests.items():
        for f in infer.values():
            f(*req)                          # warm-up requests
        torch.cuda.synchronize()
        times = {"pallas": [], "split": []}
        counted = {k: 0 for k in counters}
        for _ in range(REQUESTS):
            for sep in ("pallas", "split"):
                before = {k: c.launches for k, c in counters.items()}
                t0 = time.perf_counter()
                depth, mats = infer[sep](*req)
                torch.cuda.synchronize()
                times[sep].append(1e3 * (time.perf_counter() - t0))
                if sep == "pallas":
                    for k, c in counters.items():
                        counted[k] += c.launches - before[k]
                    if not (torch.isfinite(depth).all() and torch.isfinite(mats).all()):
                        fail(f"serving pallas B={b}: non-finite output")
        per_req = {k: v // REQUESTS for k, v in counted.items() if v}
        want = {"K1": K1_STEPS_PER_REQUEST, "K5": 2 * K1_STEPS_PER_REQUEST}
        if per_req != want or any(v % REQUESTS for v in counted.values()):
            fail(f"serving pallas B={b}: launches {counted} over {REQUESTS} requests, want "
                 f"{want} each")
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        print(f"serving sep_conv=pallas it12-h-out bf16 192x640 N=2 B={b}: median "
              f"{med['pallas']:.2f} ms/request (min {min(times['pallas']):.2f}, max "
              f"{max(times['pallas']):.2f}) {1e3 * b / med['pallas']:.1f} frames/s | "
              f"sep_conv=split in turns: median {med['split']:.2f} ms (min "
              f"{min(times['split']):.2f}, max {max(times['split']):.2f}) | launches/request "
              f"{per_req} on {gpu}", flush=True)
    launches = {k: c.launches for k, c in counters.items()}   # the path ends here
    state = tame_weights(state)
    req = requests[1]
    outs = {}
    for mp in (False, True):
        for sep in ("pallas", "split"):
            net = DepthPoseNet(version="it12-h-out", mixed_precision=mp, warp_impl="pallas",
                               sep_conv=sep, device="cuda")
            net.load_state_dict(state, strict=True)
            with torch.inference_mode():
                outs[mp, sep] = net(*req, last_only=True)
    for key in ("inv_depths", "pose_vecs"):
        ref = outs[False, "split"][key]
        rel32 = rel_l2(outs[False, "pallas"][key], ref)
        rel16 = {sep: rel_l2(outs[True, sep][key], ref) for sep in ("pallas", "split")}
        line = (f"serving end to end {key}: pallas vs split fp32 rel L2 {rel32:.3e} (bar "
                f"1e-4); bf16 vs fp32: pallas {rel16['pallas']:.3e} (bar 5e-2), split "
                f"{rel16['split']:.3e}")
        if not (rel32 <= 1e-4 and rel16["pallas"] <= 5e-2):
            fail(line)
        print(line, flush=True)
    return launches


def tame_weights(state, seed=0):
    """The weights of the CPU parity tests (`tests/test_torch_modules.py:
    fill_variables`), drawn with torch from ``seed``: convolution kernels
    N(0, 1/fan_in) (the last convolution of the depth and pose heads times
    0.3), convolution biases N(0, 0.01), BatchNorm scales U(0.5, 1.5), shifts
    and means N(0, 0.1), variances U(0.5, 2). At the seed-0 random weights the
    eval-mode refinement at 192x640 is chaotic (the split path's fp32 and bf16
    runs part by 0.15 relative L2, and fp32 runs that sum in another order by
    up to 0.7); at these it is not."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        module, leaf = k.rsplit(".", 1)
        if leaf == "weight" and v.ndim == 4:
            gain = 0.3 if k.endswith("head.conv2.weight") else 1.0
            new = torch.randn(v.shape, generator=gen) * gain / math.sqrt(v[0].numel())
        elif leaf == "running_var":
            new = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
        elif "bn" in module.rsplit(".", 1)[-1] and leaf == "weight":
            new = 0.5 + torch.rand(v.shape, generator=gen)
        elif leaf == "running_mean" or "bn" in module.rsplit(".", 1)[-1]:
            new = 0.1 * torch.randn(v.shape, generator=gen)
        else:
            new = 0.01 * torch.randn(v.shape, generator=gen)
        out[k] = new.to(device=v.device, dtype=v.dtype)
    return out


@contextlib.contextmanager
def swapped_gru(gru_pass, fwd, bwd):
    """Context: `gru_sep1d_pass` runs ``fwd`` and ``bwd`` in place of
    `gru_pass_fwd` and `gru_pass_bwd` (on CUDA tensors too)."""
    real = gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd
    gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd = fwd, bwd
    try:
        yield
    finally:
        gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd = real


def without_wq_tap0(fn):
    """``fn`` (`gru_pass_fwd` or `gru_pass_bwd`) run with tap 0 of the
    candidate conv's weights zeroed: the kernel leaving out that tap (K6
    in its recompute and in the transposed conv of daq)."""
    def run(h, x, wzr, bzr, wq, bq, *rest):
        wq = wq.clone()
        wq[0] = 0
        return fn(h, x, wzr, bzr, wq, bq, *rest)
    return run


GRU_E2E_FLOOR_FACTOR = 4


def phase_train_pallas_end_to_end():
    """One step's gradients with ``sep_conv="pallas"`` through K5/K6 against
    the same step through the plain GRU pass on the card (B=2, flip off,
    deterministic library algorithms), at `tame_weights`, fp32 (TF32 off)
    and bf16, each leaf against a stated bar.

    fp32: cosine >= 0.99999 and rel L2 <= max(1e-4, 4 x the floor), the
    floor being the widest per-leaf distance between the split path and
    the plain pass on the same step: the same math in fp32, cuDNN's sum
    order against the plain version's, carried through 24 recurrent steps
    and the backward. bf16: phase 9's bars (`compare_grads`), bf16's own
    error taken from the plain pass's bf16 and fp32 gradients.

    Planted faults, in fp32 and bf16: K5 leaving out tap 0 of the candidate
    conv, and K6 doing so (`without_wq_tap0`); each must put leaves beyond
    the bars.

    Why `tame_weights`: at the start weights of phase 8 the training
    forward amplifies a reordered fp32 sum, so the kernel and the plain
    pass part by tens of percent there, as far as the split path and the
    plain pass do; both readings are printed, not held. Phase 9 holds the
    warp kernels at the start weights because K1 repeats its plain version
    bit for bit, so both of its runs share one forward."""
    from dro_sfm_torch.ops import gru_pass
    start = start_weights(train_config()).state_dict()
    batch = make_train_batch(2, seed=2)
    kernel = (gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd)
    swaps = {"plain": (gru_pass.gru_pass_plain, gru_pass.gru_pass_bwd_plain),
             "K5 fault": (without_wq_tap0(kernel[0]), kernel[1]),
             "K6 fault": (kernel[0], without_wq_tap0(kernel[1]))}

    def run(state, mp, variant):
        cfg = train_config(mixed_precision=mp, remat=False,
                           sep_conv="split" if variant == "split" else "pallas")
        with swapped_gru(gru_pass, *swaps.get(variant, kernel)):
            return train_gradients(cfg, state, batch)

    grads, losses = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        chaos = {v: run(start, False, v)[0] for v in ("kernel", "plain", "split")}
        tame = tame_weights(start)
        for mp in (False, True):
            for v in ("kernel", "plain", "K5 fault", "K6 fault") + (() if mp else ("split",)):
                grads[mp, v], losses[mp, v] = run(tame, mp, v)
        torch.use_deterministic_algorithms(False)
    floors = {}
    for name, got, ref in (("start weights fp32: K5/K6 vs plain", chaos["kernel"],
                            chaos["plain"]),
                           ("start weights fp32: split vs plain", chaos["split"],
                            chaos["plain"]),
                           ("tame weights fp32: split vs plain (the floor)",
                            grads[False, "split"], grads[False, "plain"])):
        _, _, floors[name], worst_cos = compare_grads(got, ref)
        print(f"end to end training sep_conv=pallas, {name}, printed, not held: worst rel "
              f"L2 {floors[name][0]:.3e} ({floors[name][1]}), worst cosine {worst_cos:.7f}",
              flush=True)
    fp32_bar = max(1e-4, GRU_E2E_FLOOR_FACTOR * floors[name][0])
    failed = []
    for mp, dt in ((False, "fp32"), (True, "bf16")):
        ref, own = grads[mp, "plain"], (grads[False, "plain"] if mp else None)
        beyond, relaxed, worst, worst_cos = compare_grads(grads[mp, "kernel"], ref, own,
                                                          fp32_bar)
        for k, r, cos, own_err, bar in beyond:
            print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own {own_err} "
                  f"bar {bar:.3e}")
        bar_text = (f"bar {BF16_BAR:g}, {len(relaxed)} leaves on relaxed bars" if mp
                    else f"bar {fp32_bar:.3e}")
        print(f"end to end training sep_conv=pallas {dt} B=2 at tame weights: K5/K6 vs "
              f"plain GRU pass over {len(ref)} leaves, {len(beyond)} beyond their bar "
              f"({bar_text}), worst rel L2 {worst[0]:.3e} ({worst[1]}), worst cosine "
              f"{worst_cos:.7f}, loss {losses[mp, 'kernel']:.6f} vs "
              f"{losses[mp, 'plain']:.6f}", flush=True)
        if beyond:
            failed.append(f"{dt}: {len(beyond)} leaves beyond their bar")
        for fault in ("K5 fault", "K6 fault"):
            n, _, worst, _ = compare_grads(grads[mp, fault], ref, own, fp32_bar)
            print(f"end to end training sep_conv=pallas {dt}, planted {fault} (tap 0 of Wq "
                  f"left out): {len(n)} leaves beyond their bar, worst rel L2 "
                  f"{worst[0]:.3e} ({worst[1]})", flush=True)
            if not n:
                failed.append(f"{dt}: the bar passes the planted {fault}")
    if failed:
        fail("end to end training sep_conv=pallas " + "; ".join(failed))


def span_table(prof):
    """{function: (calls, host ms)} of the ``collective:`` spans of a host
    profile, from its raw events: what ``key_averages()`` gives for them,
    without building the profile's Python event tree (which took 107 s of a
    spatial rank's 254 over its nine profiled steps on an H100 host)."""
    from dro_sfm_torch.parallel.collectives import SPAN
    table = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN) and e.device_type() == torch.autograd.DeviceType.CPU:
            calls, ms = table.get(name[len(SPAN):], (0, 0.0))
            table[name[len(SPAN):]] = (calls + 1, ms + e.duration_ns() / 1e6)
    return table


def device_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_train_step(state, train_step, batch):
    """Device time by kernel over one B=8 train step (torch.profiler); with
    ``sep_conv="pallas"`` also the sums over the K5 and K6 kernels by name
    prefix, each with its mean per wrapper call."""
    from torch.profiler import ProfilerActivity, profile

    from dro_sfm_torch.ops.gru_pass import K5_COUNTER, K6I_COUNTER, K6W_COUNTER
    flips = torch.Generator().manual_seed(3)
    wrappers = {"K5": K5_COUNTER, "K6-input": K6I_COUNTER, "K6-weight": K6W_COUNTER}
    before = {k: c.launches for k, c in wrappers.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, flips)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    print(f"profile train step B={TRAIN_B}: wall {wall_us:.0f} us, device busy "
          f"{total:.0f} us ({100 * total / wall_us:.1f}%), {sum(e.count for e in kernels)}"
          " kernel launches", flush=True)
    if total == 0:
        print("profile train step: the profiler recorded no device time (not measured)")
    for e in sorted(kernels, key=device_us, reverse=True)[:20]:
        print(f"  {device_us(e):9.0f} us {e.count:5d}x  {e.key[:90]}")
    for e in kernels:
        if "tent_warp" in e.key or "gru_pass" in e.key:
            print(f"profile train step: {e.key[:60]} {device_us(e):.0f} us over "
                  f"{e.count} launches, {device_us(e) / e.count:.2f} us each")
    for k, prefix in GRU_PREFIXES.items():
        calls = wrappers[k].launches - before[k]
        if not calls:
            continue
        mine = [e for e in kernels if kernel_name(e.key).startswith(prefix)]
        total = sum(device_us(e) for e in mine)
        print(f"profile train step: {k} ({prefix}*) {total:.0f} us over "
              f"{sum(e.count for e in mine)} launches in {calls} wrapper calls, "
              f"{total / calls:.2f} us a call", flush=True)


# --- the self-supervised, semi-supervised and single-frame tasks ---------------

# The photometric loss does not change the net's warps: a SelfSupModelMF or
# SemiSupModelMFPose step launches the supervised step's kernels
# (TRAIN_LAUNCHES, TRAIN_LAUNCHES_PALLAS).
TASK_STEPS = 3


def counted_gradients(cfg, state, batch, counters):
    """`train_gradients` and the launches of each kernel it made."""
    start = {k: c.launches for k, c in counters.items()}
    grads, loss = train_gradients(cfg, state, batch)
    return grads, loss, {k: c.launches - start[k] for k, c in counters.items()}


def phase_selfsup_end_to_end(counters):
    """The self-supervised step's gradients through the kernels against the
    plain path on the card, B=2 rendered scenes (`make_scene_batch`), flip
    off, deterministic library algorithms, at `tame_weights`, each leaf
    against phase 9's bars (`compare_grads`): fp32 (TF32 off) cosine >=
    0.99999 and relative L2 <= 1e-4; bf16 from bf16's own error.

    With the config-default loss, fp32 and bf16:
    1. ``sep_conv="split"``: K1-K3 against the plain warp (K1 repeats its
       plain version bit for bit, so both runs share one forward);
    2. ``sep_conv="pallas"``: K5 with K6-input and K6-weight against K5
       with the plain GRU backward (one forward shared).
    With the mean over views in place of the ``min``, fp32:
    3. ``sep_conv="pallas"``: K5/K6 against the plain GRU pass, forward and
       backward, at phase 15's bar for that comparison: relative L2 <=
       max(1e-4, 4 x the floor), the floor being the widest per-leaf
       distance between the split path and the plain pass on the same step
       (fp32 sums in other orders in the forward, carried through 24
       recurrent steps and the backward).

    Why 2 shares its forward: the default loss's ``min`` over the SSIM
    residuals of the views and the identity switches at pixels where two
    forwards that differ by rounding (K5 and the plain pass sum in other
    orders) rank them apart, and the gradient moves by far more than
    rounding. That comparison is printed, not held, as is 3 on phase 8's
    batch of uniform noise (`make_train_batch`), where no context view is a
    warp of the target: the warp's gradient with respect to a sample's
    position is the image difference across its cell, and on noise it jumps
    to an unrelated one whenever the sample crosses into the next cell.

    Each run's launches are checked: K1 24, K2 24, K3 18, and with "pallas"
    K5 48 and K6-input, K6-weight 48 (0 with the plain pass or backward).
    Planted faults, in fp32, must put leaves beyond the bars: K3 leaving out
    one tap (`faulty_backward`) on the split path, K6 leaving out tap 0 of
    the candidate conv (`without_wq_tap0`) on the pallas path, and K5 doing
    so in 3."""
    from dro_sfm_torch.losses.photometric import PhotometricLossConfig
    from dro_sfm_torch.ops import gru_pass, tent_warp
    tame = tame_weights(start_weights(train_config()).state_dict())
    batches = {"scenes": make_scene_batch(2, seed=2), "noise": make_train_batch(2, seed=2)}
    kernel = (gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd)
    plain = (gru_pass.gru_pass_plain, gru_pass.gru_pass_bwd_plain)
    plain_bwd = (kernel[0], plain[1])
    k6_fault = (kernel[0], without_wq_tap0(kernel[1]))
    split, fused = {"warp_impl": "pallas"}, {"sep_conv": "pallas"}
    mean = {"photometric": PhotometricLossConfig(photometric_reduce_op="mean")}
    k3_name, k3_fault = faulty_backward("K3")
    k5_only = {**TRAIN_LAUNCHES, "K5": TRAIN_LAUNCHES_PALLAS["K5"]}
    runs = {  # name: (config overrides, GRU pass, K3 in place of K3, launches)
        "split kernel": (split, kernel, None, TRAIN_LAUNCHES),
        "split plain": ({"warp_impl": "gather"}, kernel, None, {}),
        "split K3 fault": (split, kernel, k3_fault, TRAIN_LAUNCHES),
        "pallas kernel": (fused, kernel, None, TRAIN_LAUNCHES_PALLAS),
        "pallas plain": (fused, plain_bwd, None, k5_only),
        "pallas K6 fault": (fused, k6_fault, None, TRAIN_LAUNCHES_PALLAS),
        "pallas plain pass": (fused, plain, None, TRAIN_LAUNCHES),
        "mean kernel": ({**fused, **mean}, kernel, None, TRAIN_LAUNCHES_PALLAS),
        "mean plain": ({**fused, **mean}, plain, None, TRAIN_LAUNCHES),
        "mean split": ({**split, **mean}, kernel, None, TRAIN_LAUNCHES),
        "mean K5 fault": ({**fused, **mean}, (without_wq_tap0(kernel[0]), kernel[1]), None,
                          TRAIN_LAUNCHES_PALLAS),
    }
    plan = [("scenes", False, name) for name in runs]
    plan += [("scenes", True, name) for name in ("split kernel", "split plain",
                                                 "pallas kernel", "pallas plain")]
    plan += [("noise", False, name) for name in ("mean kernel", "mean plain")]
    grads, losses, failed = {}, {}, []
    real_k3 = getattr(tent_warp, k3_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        for data, mp, name in plan:
            overrides, gru, k3, want = runs[name]
            cfg = train_config(name="SelfSupModelMF", mixed_precision=mp, remat=False,
                               **overrides)
            setattr(tent_warp, k3_name, k3 or real_k3)
            try:
                with swapped_gru(gru_pass, *gru):
                    grads[data, mp, name], losses[data, mp, name], launches = (
                        counted_gradients(cfg, tame, batches[data], counters))
            finally:
                setattr(tent_warp, k3_name, real_k3)
            want = {k: want.get(k, 0) for k in counters}
            if launches != want:
                failed.append(f"{name} {data} mp={mp}: launches {launches}, want {want}")
        torch.use_deterministic_algorithms(False)
    _, _, floor, _ = compare_grads(grads["scenes", False, "mean split"],
                                   grads["scenes", False, "mean plain"])
    mean_bar = max(1e-4, GRU_E2E_FLOOR_FACTOR * floor[0])
    print(f"end to end selfsup fp32 B=2 scenes, mean over views: split vs plain GRU pass "
          f"(the floor) worst rel L2 {floor[0]:.3e} ({floor[1]}), bar {mean_bar:.3e}",
          flush=True)
    for what, path, fault, bar in (("sep_conv=split", "split", "K3 fault", 1e-4),
                                   ("sep_conv=pallas", "pallas", "K6 fault", 1e-4),
                                   ("sep_conv=pallas mean over views", "mean", "K5 fault",
                                    mean_bar)):
        beyond, _, worst, _ = compare_grads(grads["scenes", False, f"{path} {fault}"],
                                            grads["scenes", False, f"{path} plain"],
                                            fp32_bar=bar)
        print(f"end to end selfsup {what} fp32, planted {fault}: {len(beyond)} leaves "
              f"beyond their bar, worst rel L2 {worst[0]:.3e} ({worst[1]})", flush=True)
        if not beyond:
            failed.append(f"{what}: the bar passes the planted {fault}")
    comparisons = [  # (what, data, bf16, kernel run, plain run, held)
        ("sep_conv=split, K1-K3 vs plain warp", "scenes", False, "split kernel",
         "split plain", True),
        ("sep_conv=split, K1-K3 vs plain warp", "scenes", True, "split kernel",
         "split plain", True),
        ("sep_conv=pallas, K5 + K6 vs K5 + plain GRU backward", "scenes", False,
         "pallas kernel", "pallas plain", True),
        ("sep_conv=pallas, K5 + K6 vs K5 + plain GRU backward", "scenes", True,
         "pallas kernel", "pallas plain", True),
        ("sep_conv=pallas mean over views, K5 + K6 vs plain GRU pass", "scenes", False,
         "mean kernel", "mean plain", True),
        ("sep_conv=pallas, K5 + K6 vs plain GRU pass", "scenes", False, "pallas kernel",
         "pallas plain pass", False),
        ("sep_conv=pallas mean over views, K5 + K6 vs plain GRU pass", "noise", False,
         "mean kernel", "mean plain", False),
    ]
    for what, data, mp, run, ref_run, held in comparisons:
        got, ref = grads[data, mp, run], grads[data, mp, ref_run]
        own = grads[data, False, ref_run] if mp else None
        bar = mean_bar if run == "mean kernel" else 1e-4
        beyond, relaxed, worst, worst_cos = compare_grads(got, ref, own, bar)
        if held:
            for k, r, cos, own_err, leaf_bar in beyond:
                print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own "
                      f"{own_err} bar {leaf_bar:.3e}")
        bars = f"{len(relaxed)} on relaxed bf16 bars" if mp else f"bar {bar:.3e}"
        print(f"end to end selfsup {'bf16' if mp else 'fp32'} B=2 {data} at tame weights"
              f"{'' if held else ', printed, not held'}, {what}: {len(ref)} leaves, "
              f"{len(beyond)} beyond their bar ({bars}), "
              f"worst rel L2 {worst[0]:.3e} ({worst[1]}), worst cosine {worst_cos:.7f}, "
              f"loss {losses[data, mp, run]:.6f} vs {losses[data, mp, ref_run]:.6f}",
              flush=True)
        if held and beyond:
            failed.append(f"{what} {'bf16' if mp else 'fp32'}: {len(beyond)} leaves beyond "
                          "their bar")
    if failed:
        fail("end to end selfsup: " + "; ".join(failed))


def phase_tasks(counters, gpu):
    """A few steps of the other task models at 192x640 B=8: SemiSupModelMFPose
    (it12-h-out bf16, the supervised step's launches), and the single-frame
    SupModel and SelfSupModel (fp32 ResNets, no kernel launched), on
    rendered scenes. Losses finite, launches as stated. Returns each task's
    median ms/step."""
    out = {}
    for name, want in (("SemiSupModelMFPose", TRAIN_LAUNCHES), ("SupModel", {}),
                       ("SelfSupModel", {})):
        out[name] = phase_train(counters, gpu, want=want, name=name, steps=TASK_STEPS,
                                make_batch=make_scene_batch)[4]
        torch.cuda.empty_cache()
    return out


# --- the trainer: training and evaluation from a config -----------------------

TRAINER_CONFIG = ROOT / "configs" / "train_synthetic_192x640.yaml"
SELFSUP_CONFIG = ROOT / "configs" / "train_synthetic_selfsup.yaml"
TRAINER_EPOCHS = 2
# Per evaluation batch: the forward and the flipped forward, each 24 K1 (and
# with sep_conv="pallas" 48 K5) launches.
EVAL_LAUNCHES = {"K1": 48}
EVAL_LAUNCHES_PALLAS = {"K1": 48, "K5": 96}


def trainer_config(sep_conv="split", max_epochs=TRAINER_EPOCHS, config=TRAINER_CONFIG):
    """``config`` cut to 2 training steps an epoch (16 scenes, B=8) and one
    validation batch (4 scenes, B=4; the test split the same, for the eval
    CLI), checkpoints and depth files under ``build/``."""
    from dro_sfm_torch.utils.config import load_config
    build = trainer_build_dir(config)
    evaluation = {"dataset": ["Synthetic"], "path": ["7"], "split": ["4"],
                  "batch_size": 4, "num_workers": 2}
    return load_config(str(config), overrides={
        "arch": {"max_epochs": max_epochs},
        "checkpoint": {"filepath": str(build / "ckpt")},
        "save": {"folder": str(build / "depth"),
                 "depth": {"png": False, "rgb": False, "viz": False}},
        "model": {"depth_net": {"sep_conv": sep_conv}},
        "datasets": {"train": {"split": ["16"], "repeat": [1]},
                     "validation": evaluation, "test": evaluation}})


def trainer_build_dir(config):
    return ROOT / "build" / f"trainer_{config.stem}"


class CountedStep:
    """A training or evaluation step that records, for every call, the
    launches of each kernel and what the step returned; with ``timed`` also
    its milliseconds (host clock between synchronisations)."""

    def __init__(self, fn, counters, timed=False):
        self.fn, self.counters, self.timed = fn, counters, timed
        self.launches, self.outputs, self.ms = [], [], []

    def __call__(self, *args, **kwargs):
        start = {k: c.launches for k, c in self.counters.items()}
        if self.timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.timed:
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t0))
        self.launches.append({k: c.launches - start[k] for k, c in self.counters.items()})
        self.outputs.append(out)
        return out


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and torch's deterministic operators
    (a warning, silenced, where one has none), as phase dist_trainer sets
    them; the settings restored after."""
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn


def deterministic_step(fn):
    """``fn`` run under `deterministic_algorithms` at each call."""
    def step(*args, **kwargs):
        with deterministic_algorithms():
            return fn(*args, **kwargs)
    return step


def counted_trainer(trainer, counters):
    """Wrap the trainer's training step, its evaluation step and its epochs
    (to keep each epoch's train metrics)."""
    train = trainer.train_step = CountedStep(trainer.train_step, counters)
    evaluate = CountedStep(trainer.eval_step_for(False), counters, timed=True)
    trainer._eval_steps[False] = evaluate
    epochs = trainer.train_epoch = CountedStep(trainer.train_epoch, {})
    return train, evaluate, epochs


def check_launches(what, calls, want, counters):
    want = {k: want.get(k, 0) for k in counters}
    for i, got in enumerate(calls):
        if got != want:
            fail(f"trainer: {what} {i}: launches {got}, want {want}")


def trainer_state(trainer):
    """The net's tensors, Adam's moments by parameter name, and the step."""
    names = {id(p): k for k, p in trainer.net.named_parameters()}
    moments = {names[id(p)]: v for p, v in trainer.optimizer.torch_optimizer.state.items()}
    return dict(trainer.net.state_dict()), moments, trainer.state.step


def saved_state(trainer, path):
    """The same three from the checkpoint file (the optimizer's state is
    keyed by parameter index, in the order of `named_parameters`)."""
    payload = torch.load(path, map_location="cuda", weights_only=True)
    names = [k for k, _ in trainer.net.named_parameters()]
    moments = {names[i]: v for i, v in payload["optimizer"]["state"].items()}
    return payload["net"], moments, payload["step"]


def same_state(a, b):
    """Names of the tensors that differ in any bit between two states."""
    (net_a, mom_a, step_a), (net_b, mom_b, step_b) = a, b
    bad = [k for k in net_a.keys() | net_b.keys()
           if k not in net_a or k not in net_b or not torch.equal(net_a[k], net_b[k])]
    bad += [f"adam {k}.{m}" for k in mom_a.keys() | mom_b.keys()
            for m in ("exp_avg", "exp_avg_sq", "step")
            if k not in mom_a or k not in mom_b
            or not torch.equal(mom_a[k][m].cpu(), mom_b[k][m].cpu())]
    return bad + (["step"] if step_a != step_b else [])


def check_finite(what, metrics):
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        fail(f"trainer: {what}: non-finite metrics {dict(list(bad.items())[:6])}")


def phase_trainer(counters, gpu, step_ms, config=TRAINER_CONFIG, fused_epoch=True):
    """The port's program around the step: `Trainer.fit` on ``config``
    (`TRAINER_CONFIG`: SupModelMF it12-h-out bf16 192x640 B=8, Adam with the
    global-norm clip; `SELFSUP_CONFIG`: SelfSupModelMF it12-h-out bf16
    96x128 B=8, its warm-up), from the config's own initialisation from
    arch.seed, `TRAINER_EPOCHS` epochs of 2 steps, each validated (one B=4
    batch) and checkpointed; a resume from the last checkpoint, bit for bit;
    the eval CLI on it in a subprocess, against the last validation; with
    ``fused_epoch`` one more epoch with ``sep_conv="pallas"``. ``step_ms``:
    the bare step's median ms/step in this run at the same task (None when
    that phase did not run)."""
    import shutil

    from dro_sfm_torch.training.trainer import Trainer
    # The trainer runs with torch's default precision settings, as a user
    # of the CLIs does (cuDNN may take TF32 in the fp32 head convolutions),
    # so that the eval CLI's process computes what this one computes.
    precision = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    shutil.rmtree(trainer_build_dir(config), ignore_errors=True)
    try:
        cfg = trainer_config(config=config)
        trainer = Trainer(cfg, device="cuda")
        t0 = time.perf_counter()
        n = sum(len(b["idx"]) for b in trainer.train_loader)
        loader_fps = n / (time.perf_counter() - t0)
        train, evaluate, epochs = counted_trainer(trainer, counters)
        for c in counters.values():          # the trainer's path starts here
            c.reset()
        metrics = trainer.fit()
        launches = {k: c.launches for k, c in counters.items()}   # and ends here
        steps = len(train.launches)
        if steps != TRAINER_EPOCHS * len(trainer.train_loader) or len(evaluate.ms) != TRAINER_EPOCHS:
            fail(f"trainer: {steps} train steps, {len(evaluate.ms)} eval batches")
        check_launches("train step", train.launches, TRAIN_LAUNCHES, counters)
        check_launches("eval batch", evaluate.launches, EVAL_LAUNCHES, counters)
        want = {k: steps * TRAIN_LAUNCHES.get(k, 0) + TRAINER_EPOCHS * EVAL_LAUNCHES.get(k, 0)
                for k in counters}
        if launches != want:
            fail(f"trainer: launches over fit() {launches}, want {want}")
        losses = [m["loss"].item() for _, m in train.outputs]
        if not all(math.isfinite(v) for v in losses):
            fail(f"trainer: non-finite loss at the config's initialisation {losses}; "
                 "see ROADMAP C")
        check_finite("fit()", metrics)
        for out in evaluate.outputs:
            if not bool(torch.isfinite(out["metrics"]).all()):
                fail("trainer: non-finite per-sample metrics in an eval batch")
        last = [p for _, p in trainer.checkpointer.saved
                if Path(p).name.startswith(f"epoch={TRAINER_EPOCHS - 1:02d}_")]
        if not last or not Path(last[0]).is_file():
            fail(f"trainer: no checkpoint of the last epoch in {trainer.checkpointer.saved}")
        ckpt = last[0]
        fps = [e["train_frames_per_sec"] for e in epochs.outputs]
        vs = (f", the bare step at 192x640 {1e3 * TRAIN_B / step_ms:.1f} frames/s "
              f"({step_ms:.2f} ms/step)" if step_ms else "")
        shape = "x".join(str(v) for v in cfg.datasets.augmentation.image_shape)
        dtype = "bf16" if cfg.model.depth_net.mixed_precision else "fp32"
        print(f"trainer fit {config.name} {cfg.model.name} {cfg.model.depth_net.version} "
              f"{dtype} {shape} B={TRAIN_B}: "
              f"{TRAINER_EPOCHS} epochs x {len(trainer.train_loader)} steps, train "
              f"{' / '.join(f'{v:.1f}' for v in fps)} frames/s by epoch{vs}; loader alone "
              f"{loader_fps:.1f} frames/s ({trainer.train_loader.num_workers} threads); "
              f"eval batch B=4 {' / '.join(f'{v:.1f}' for v in evaluate.ms)} ms; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; abs_rel_pp_gt "
              f"{metrics['abs_rel_pp_gt']:.6f}; launches per step {train.launches[-1]}, "
              f"per eval batch {evaluate.launches[-1]}; on {gpu}", flush=True)

        # Resume: the restored state is the saved one, bit for bit.
        resumed = Trainer(cfg, resume=ckpt, device="cuda")
        bad = same_state(trainer_state(resumed), saved_state(resumed, ckpt))
        bad += same_state(trainer_state(resumed), trainer_state(trainer))
        if bad or resumed.current_epoch != TRAINER_EPOCHS:
            fail(f"trainer: resume differs in {bad[:6]} (epoch {resumed.current_epoch})")
        print(f"trainer resume: {len(trainer_state(resumed)[0])} net tensors, Adam's "
              f"moments and step {resumed.state.step} equal to the checkpoint's bits",
              flush=True)
        del trainer, resumed

        # The eval CLI in its own process, on the same checkpoint.
        res = subprocess.run([sys.executable, "-m", "dro_sfm_torch.scripts.eval",
                              "--checkpoint", ckpt], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            fail(f"trainer: eval CLI failed ({res.returncode}):\n{res.stderr[-3000:]}")
        evaluated = json.loads(res.stdout[res.stdout.rindex("\n{") + 1:])
        a, b = evaluated["abs_rel_pp_gt"], metrics["abs_rel_pp_gt"]
        if not abs(a - b) <= 1e-5 * abs(b):
            fail(f"trainer: eval CLI abs_rel_pp_gt {a!r}, last validation {b!r}")
        check_finite("eval CLI", evaluated)
        print(f"trainer eval CLI: abs_rel_pp_gt {a!r} against validation's {b!r} "
              f"(relative {abs(a - b) / abs(b):.2e}, bar 1e-5)", flush=True)

        if not fused_epoch:
            return
        # One more epoch with the fused GRU passes.
        fused = Trainer(trainer_config("pallas", TRAINER_EPOCHS + 1), resume=ckpt,
                        device="cuda")
        train, evaluate, epochs = counted_trainer(fused, counters)
        for c in counters.values():
            c.reset()
        metrics_p = fused.fit()
        check_launches("pallas train step", train.launches, TRAIN_LAUNCHES_PALLAS, counters)
        check_launches("pallas eval batch", evaluate.launches, EVAL_LAUNCHES_PALLAS,
                       counters)
        if len(train.launches) != len(fused.train_loader) or len(evaluate.ms) != 1:
            fail(f"trainer: pallas epoch ran {len(train.launches)} steps, "
                 f"{len(evaluate.ms)} eval batches")
        losses_p = [m["loss"].item() for _, m in train.outputs]
        if not all(math.isfinite(v) for v in losses_p):
            fail(f"trainer: non-finite loss with sep_conv=pallas {losses_p}")
        check_finite("pallas fit()", metrics_p)
        print(f"trainer sep_conv=pallas epoch {TRAINER_EPOCHS}: train "
              f"{epochs.outputs[0]['train_frames_per_sec']:.1f} frames/s, eval batch "
              f"{evaluate.ms[0]:.1f} ms, losses {' '.join(f'{v:.4f}' for v in losses_p)}, "
              f"abs_rel_pp_gt {metrics_p['abs_rel_pp_gt']:.6f}; launches per step "
              f"{train.launches[-1]}, per eval batch {evaluate.launches[-1]}", flush=True)
        del fused
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = precision
        torch.cuda.empty_cache()


APPS_FRAMES = 12                   # 10 sliding windows
APPS_BUILD = ROOT / "build" / "apps"
FUSION_MARGIN = 1e-4               # JAX-side distance kept from every threshold


def render_video(n, h, w):
    """``n`` frames of a `Synthetic` scene (three planes) seen by a camera
    that moves forward and sideways: uint8 RGB frames, camera-to-world
    poses, exact depth maps and the renderer's intrinsics."""
    import numpy as np

    from dro_sfm_torch.data import SyntheticConfig, SyntheticDataset
    data = SyntheticDataset(SyntheticConfig(height=h, width=w, num_planes=3, seed=3))
    planes, _ = data._scene(0)
    frames, poses, depths = [], [], []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = [0.03 * i, 0.004 * i, 0.05 * i]
        rgb, depth = data._render(planes, T)
        frames.append((rgb * 255).astype(np.uint8))
        poses.append(T)
        depths.append(depth[..., 0])
    return frames, poses, depths, data.K


def write_jax_checkpoint(path, net, optimizer, step, epoch, config):
    """What the JAX package's ``save_checkpoint`` writes for this state,
    written by the port (no flax on this machine): flax msgpack of
    {params, batch_stats, opt_state, step} and the json sidecar."""
    import numpy as np

    from dro_sfm_torch.convert import optimizer_state_to_jax, to_jax_variables
    from dro_sfm_torch.utils.msgpack import packb
    variables = to_jax_variables(net.state_dict())
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"],
               "opt_state": optimizer_state_to_jax(net, optimizer, step),
               "step": np.asarray(step)}
    Path(path).write_bytes(packb(payload))
    Path(path + ".json").write_text(json.dumps({"epoch": epoch, "step": step,
                                                "config": config}))


def fusion_check(depths, poses, K, what):
    """`geometric_fusion` on the card against the same call on the CPU:
    equal masks and fused depth (1e-5 relative) at every pixel that lies,
    on the CPU, more than FUSION_MARGIN from a threshold or a rounding
    boundary in every view. Returns (compared share, kept share)."""
    import numpy as np

    from dro_sfm_torch.inference import geometric_fusion, reproject_with_depth
    cpu = [torch.as_tensor(np.asarray(a, np.float32)) for a in
           (depths[-1], np.stack(depths[:-1]), poses[-1], np.stack(poses[:-1]), K)]
    want = geometric_fusion(*cpu, thres_view=len(depths) // 2)
    got = geometric_fusion(*[t.cuda() for t in cpu], thres_view=len(depths) // 2).cpu()
    d_re, x2, y2 = reproject_with_depth(*cpu)
    h, w = depths[-1].shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    ref = cpu[0]
    dist = torch.sqrt((x2 - xs) ** 2 + (y2 - ys) ** 2)
    rel_diff = (d_re - ref).abs() / ref.clamp_min(1e-10)
    # where each view samples the source depth (nearest, round half to even)
    rel = torch.linalg.inv(cpu[3]) @ cpu[2]
    pts = (torch.stack([xs, ys, torch.ones_like(xs)], -1) @ torch.linalg.inv(cpu[4]).T) \
        * ref[..., None]
    proj = (pts[None] @ rel[:, None, :3, :3].transpose(-1, -2) + rel[:, None, None, :3, 3]) \
        @ cpu[4].T
    xy = proj[..., :2] / proj[..., 2:].clamp_min(1e-10)
    half = ((xy - xy.floor()) - 0.5).abs().amin(-1)
    ok = ((dist - 1).abs() > FUSION_MARGIN) & ((rel_diff - 1e-3).abs() > 1e-3 * FUSION_MARGIN) \
        & (half > FUSION_MARGIN)
    ok = ok.all(0)
    bad = ~torch.isclose(got[ok], want[ok], rtol=1e-5, atol=0)
    if bad.any() or not torch.isfinite(got).all():
        fail(f"apps: geometric_fusion on the card differs from the CPU ({what}) at "
             f"{int(bad.sum())} of {int(ok.sum())} pixels away from the thresholds")
    return float(ok.float().mean()), float((want > 0).float().mean())


def phase_apps(counters, gpu):
    """A checkpoint of the JAX package's format, served and resumed on the
    card: it12-h-out weights from seed 0 (heads scaled, `start_weights`) and
    Adam's moments after one step, written as the JAX package writes them
    with the sidecar of `TRAINER_CONFIG`; `load_model` bit-equal to the
    source; a `Trainer` resumed from it, bit for bit, for one counted step;
    APPS_FRAMES rendered frames written as PNG and read back bit-equal; the
    ``infer_video`` CLI in this process (fp32, --fusion-views 3,
    --gt-poses), its K1 launches 24 a window, its depths and poses against
    the same windows through the plain warp (printed), the same at
    `tame_weights` (held to 1e-5), its fusion on the card against the
    CPU."""
    import shutil

    import numpy as np

    from dro_sfm_torch.data.video import dummy_calibration
    from dro_sfm_torch.inference import filter_depth, load_model, save_model
    from dro_sfm_torch.scripts import infer_video
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    from dro_sfm_torch.training.trainer import Trainer, model_config_from
    from dro_sfm_torch.utils.image_io import read_image_rgb, write_png
    t_start = time.perf_counter()
    shutil.rmtree(APPS_BUILD, ignore_errors=True)
    (APPS_BUILD / "frames").mkdir(parents=True)
    (APPS_BUILD / "gt").mkdir()
    cfg = trainer_config()
    cfg.checkpoint.filepath = str(APPS_BUILD / "ckpt")
    cfg.save.folder = str(APPS_BUILD / "depth")

    # The source: seed-0 weights and Adam's moments after one step.
    tcfg = model_config_from(cfg)
    net = start_weights(tcfg)
    opt = make_optimizer(net, cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=2)
    state = create_train_state(net, opt, device="cuda")
    state, _ = make_train_step(tcfg, net, opt, device="cuda")(
        state, make_scene_batch(2), None, do_flip=False)
    path = str(APPS_BUILD / "jax.ckpt")
    write_jax_checkpoint(path, net, opt, state.step, 0, cfg.to_dict())
    source = (dict(net.state_dict()),
              {k: opt.torch_optimizer.state[p] for k, p in net.named_parameters()}, state.step)
    print(f"apps: wrote a JAX-format checkpoint, {Path(path).stat().st_size / 2**20:.1f} MiB "
          f"(params, batch_stats, Adam behind the clip, step {state.step})", flush=True)

    served = load_model(path, device="cuda")
    bad = same_state((served.state_dict(), {}, 0), (source[0], {}, 0))
    if bad or (served.mixed_precision, served.warp_impl) != (False, "pallas"):
        fail(f"apps: load_model differs from the source in {bad[:6]} or serves "
             f"mixed_precision={served.mixed_precision} warp_impl={served.warp_impl}")
    resumed = Trainer(cfg, resume=path, device="cuda")
    bad = same_state(trainer_state(resumed), source)
    if bad or resumed.current_epoch != 1:
        fail(f"apps: the resumed trainer differs in {bad[:6]} (epoch {resumed.current_epoch})")
    del net, opt, state
    step = CountedStep(resumed.train_step, counters)
    batch = next(iter(resumed.train_loader))
    for c in counters.values():              # the resumed step's path starts here
        c.reset()
    resumed.state, metrics = step(resumed.state, resumed._place_train(batch),
                                  torch.Generator().manual_seed(0))
    check_launches("resumed step", step.launches, TRAIN_LAUNCHES, counters)
    if not math.isfinite(metrics["loss"].item()) or resumed.state.step != source[2] + 1:
        fail(f"apps: resumed step loss {metrics['loss'].item()}, step {resumed.state.step}")
    print(f"apps: load_model and the resumed Trainer bit-equal to the source; one resumed "
          f"step (B={len(batch['idx'])}, loss {metrics['loss'].item():.4f}) launched "
          f"{step.launches[0]}", flush=True)
    del resumed, step

    # Frames: PNG, written and read back by the port.
    frames, poses, gt_depths, K_render = render_video(APPS_FRAMES, SERVE_H, SERVE_W)
    for i, (img, T) in enumerate(zip(frames, poses)):
        name = APPS_BUILD / "frames" / f"{i:06d}.png"
        write_png(str(name), img)
        if not np.array_equal(read_image_rgb(str(name)), img):
            fail(f"apps: {name.name} does not read back bit-equal")
        np.savetxt(APPS_BUILD / "gt" / f"{i:06d}.txt", T)

    for c in counters.values():              # the serving application starts here
        c.reset()
    t0 = time.perf_counter()
    result = infer_video.main([
        "--checkpoint", path, "--input", str(APPS_BUILD / "frames"),
        "--output", str(APPS_BUILD / "out"), "--fusion-views", "3",
        "--gt-poses", str(APPS_BUILD / "gt"), "--depth-max", "25", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}   # and ends here
    windows = result["windows"]
    want = {k: (K1_STEPS_PER_REQUEST * windows if k == "K1" else 0) for k in counters}
    if windows != APPS_FRAMES - 2 or launches != want or launches["K1"] == 0:
        fail(f"apps: infer_video ran {windows} windows with launches {launches}, want {want}")
    if result["ate"] is None or not math.isfinite(result["ate"]):
        fail(f"apps: no finite ATE ({result['ate']})")

    # The same windows through the plain warp. At the source weights the
    # eval-mode refinement is chaotic (`tame_weights`): the distance there
    # varies by call on unchanged code (3.4e-7 to 2.0e-5), so it is printed
    # only, and the bar (1e-5) holds the same CLI run at tame_weights, its
    # launches counted too.
    depths = np.load(APPS_BUILD / "out" / "depths.npy")
    ref_d, ref_m = plain_windows(path, APPS_BUILD / "frames", "*.png")
    chaotic = {what: float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
               for what, got, ref in (("depths", depths, ref_d),
                                      ("poses", np.stack(result["pose_mats"]), ref_m))}
    if not np.isfinite(depths).all():
        fail("apps: infer_video gave depths that are not finite")
    served.load_state_dict(tame_weights(served.state_dict()))
    tame = str(APPS_BUILD / "tame.pt")
    save_model(served, tame)
    for c in counters.values():              # the run at tame_weights starts here
        c.reset()
    tamed = infer_video.main([
        "--checkpoint", tame, "--input", str(APPS_BUILD / "frames"),
        "--output", str(APPS_BUILD / "tame_out"), "--fusion-views", "3",
        "--gt-poses", str(APPS_BUILD / "gt"), "--depth-max", "25", "--device", "cuda",
        "--image-shape", str(SERVE_H), str(SERVE_W)])
    launches_t = {k: c.launches for k, c in counters.items()}   # and ends here
    if tamed["windows"] != windows or launches_t != want:
        fail(f"apps: infer_video at tame_weights ran {tamed['windows']} windows with "
             f"launches {launches_t}, want {want}")
    ref_d, ref_m = plain_windows(tame, APPS_BUILD / "frames", "*.png")
    for what, got, ref in (("depths", np.load(APPS_BUILD / "tame_out" / "depths.npy"), ref_d),
                           ("poses", np.stack(tamed["pose_mats"]), ref_m)):
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        line = (f"apps: infer_video {what} against the plain warp over {windows} windows: "
                f"at tame_weights rel L2 {rel:.3e} (bar 1e-5; K1 {launches_t['K1']} launches), "
                f"at the source weights {chaotic[what]:.3e} (chaotic, printed only)")
        if not (rel <= 1e-5 and np.isfinite(got).all()):
            fail(line)
        print(line, flush=True)

    # Fusion on the card against the CPU: the CLI's last three filtered
    # depths and poses, and the exact depths and poses of the scene.
    traj = json.loads((APPS_BUILD / "out" / "trajectory.json").read_text())
    cases = (("predicted", [filter_depth(d) for d in depths[-3:]], traj[-3:],
              dummy_calibration(SERVE_W, SERVE_H)),
             ("exact", gt_depths[-3:], poses[-3:], K_render))
    shares = {what: fusion_check(d, p, k, what) for what, d, p, k in cases}
    steady = sorted(result["window_ms"][1:])
    ms = steady[len(steady) // 2]
    decode = sorted(result["decode_ms"])[len(result["decode_ms"]) // 2]
    print(f"apps infer_video it12-h-out fp32 {SERVE_H}x{SERVE_W} N=2 B=1: {windows} windows, "
          f"median {ms:.2f} ms/window (min {steady[0]:.2f}, max {steady[-1]:.2f}, after the "
          f"first {result['window_ms'][0]:.2f}), PNG decode median {decode:.2f} ms/frame "
          f"(min {min(result['decode_ms']):.2f}, max {max(result['decode_ms']):.2f}), CLI "
          f"{cli_s:.1f} s, K1 {launches['K1']} launches ({launches['K1'] // windows}/window), "
          f"{result['points']} points, ATE {result['ate']:.4f}; fusion card vs CPU compared "
          f"at {shares['predicted'][0]:.1%} / {shares['exact'][0]:.1%} of pixels (kept "
          f"{shares['predicted'][1]:.1%} / {shares['exact'][1]:.1%}); phase "
          f"{time.perf_counter() - t_start:.1f} s on {gpu}", flush=True)
    return launches


DATASETS_BUILD = ROOT / "build" / "datasets"
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "jpeg"
SCANNET_CONFIG = ROOT / "configs" / "train_scannet_mf_gt_view3.yaml"
KITTI_CONFIG = ROOT / "configs" / "train_kitti_mf_gt.yaml"
SCANNET_STEPS, KITTI_STEPS = 3, 2          # a training epoch
DATASET_EPOCHS = 2                          # the first is the start-up
# Read through make_loader and device_prefetch; "train" resizes and jitters.
OTHER_READERS = {"ScannetTest": "validation", "ScannetTestMF": "validation",
                 "ScannetBA": "train", "Demon": "train", "DemonMF": "train",
                 "Matterport": "train", "MatterportTest": "validation", "Video": "train",
                 "Video_Random": "train", "Image": "train", "DGP": "validation"}


def host_ms(fn, reps=20):
    """Median host milliseconds of ``fn`` over ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def check_fixtures():
    """Decode every committed image fixture (baseline, progressive,
    arithmetic-coded and CMYK JPEG; BMP of each kind) with the port's codec
    and hold it to OpenCV's sha256; returns the fixtures' table."""
    import hashlib

    from dro_sfm_torch.utils.image_io import read_image_rgb
    meta = json.loads((FIXTURES / "fixtures.json").read_text())
    for name, entry in meta["files"].items():
        img = read_image_rgb(str(FIXTURES / name))
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            fail(f"datasets: {name} decodes to {img.shape} sha256 {digest[:16]}, OpenCV's "
                 f"{entry['shape']} {entry['sha256'][:16]}")
    return meta


def depth_png_bytes(path, depth, scale):
    """A uint16 depth PNG (``depth * scale``, 0 where invalid) at ``path``."""
    import numpy as np

    from dro_sfm_torch.utils.image_io import write_png
    d = np.where(np.isfinite(depth) & (depth > 0), depth * scale, 0)
    write_png(str(path), np.clip(d, 0, 65535).astype(np.uint16))
    return Path(path).read_bytes()


# The colour frame of each view in the scene trees: view 0 baseline 4:2:0,
# view 1 progressive with restarts, view 2 progressive arithmetic-coded,
# view 3 CMYK.
SCENE_FRAMES = ("view0.jpg", "view1_progressive.jpg", "view2_arith_progressive.jpg",
                "view3_cmyk.jpg")


def write_scene_trees(root, meta):
    """ScanNet, BA-Net, DeMoN, Matterport, video and DGP trees under
    ``root`` from the fixtures: `SCENE_FRAMES` copied as colour frames,
    each view's depth and camera-to-world pose from the renderer that drew
    it. Returns the ScanNet data root."""
    import numpy as np

    from dro_sfm_torch.data import SyntheticConfig, SyntheticDataset
    data = SyntheticDataset(SyntheticConfig(**meta["render"]))
    planes, poses = data._scene(meta["scene"])
    depths = [data._render(planes, p)[1][..., 0] for p in poses]
    jpgs = [(FIXTURES / name).read_bytes() for name in SCENE_FRAMES]
    root.mkdir(parents=True)
    mm = [depth_png_bytes(root / f"mm{i}.png", d, 1000.0) for i, d in enumerate(depths)]
    K = data.K.astype(np.float64)

    def frame(color_dir, name, i):
        """View ``i % 4`` as frame ``name``: the JPEG in ``color_dir``, the
        millimetre depth in ``../depth`` and the pose in ``../pose``."""
        v, stem = i % len(jpgs), name[:-4]
        for path, blob in ((color_dir / name, jpgs[v]),
                           (color_dir.parent / "depth" / f"{stem}.png", mm[v])):
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(blob)
        (color_dir.parent / "pose").mkdir(exist_ok=True)
        np.savetxt(color_dir.parent / "pose" / f"{stem}.txt", poses[v])

    # ScanNet: every 5th of the listed frames is read, so only those exist.
    scans, scene = root / "scans", "scene0000_00"
    kept = [f"{i:06d}.jpg" for i in range(0, 5 * (8 * SCANNET_STEPS + 2), 5)]
    for i, name in enumerate(kept):
        frame(scans / scene / "color", name, i)
    (scans / scene / "intrinsic").mkdir()
    K4 = np.eye(4)
    K4[:3, :3] = K
    np.savetxt(scans / scene / "intrinsic" / "intrinsic_color.txt", K4)
    (root / "train_split.txt").write_text("".join(
        f"{scene}/color {i:06d}.jpg\n" for i in range(5 * len(kept))))
    (root / "avail.txt").write_text("".join(f"{scene}/color {n}\n" for n in kept))
    (root / "test_split_view3.txt").write_text("".join(
        f"{scene}/color {kept[t]} {kept[t - 1]} {kept[t + 1]}\n" for t in range(1, 5)))
    (root / "splits").mkdir()
    groups = [(20, 25), (40, 35), (60, 65), (80, 75)]
    (root / "splits" / "banet_train.txt").write_text("".join(
        f"data/scannet/scans/{scene}/frame-{t:06d}.color.jpg\n"
        f"data/scannet/scans/{scene}/frame-{p:06d}.color.jpg\n"
        + "".join(f"data/scannet/scans/{scene}/x{k}.txt\n" for k in range(5))
        for t, p in groups))

    # DeMoN: two three-view folders and a two-view one (poses world->camera).
    demon = root / "demon"
    for k, views in enumerate((3, 3, 2)):
        d = demon / f"sun3d_{k}"
        d.mkdir(parents=True)
        for v in range(views):
            (d / f"{v:04d}.jpg").write_bytes(jpgs[(k + v) % len(jpgs)])
            np.save(d / f"{v:04d}.npy", depths[(k + v) % len(jpgs)])
        np.savetxt(d / "poses.txt", np.stack([np.linalg.inv(poses[(k + v) % len(jpgs)])[:3]
                                              .reshape(-1) for v in range(views)]))
        np.savetxt(d / "cam.txt", K)
    (demon / "train.txt").write_text("sun3d_0\nsun3d_1\nsun3d_2\n")

    # Matterport: 30 frames, so that both downsamplings keep samples.
    mp = root / "matterport"
    names = [f"{i:013d}.jpg" for i in range(30)]
    for i, name in enumerate(names):
        frame(mp / "sceneA" / "cam_left", name, i)
    (mp / "split.txt").write_text("".join(f"sceneA/cam_left {n}\n" for n in names))

    # Video and image folders.
    for i in range(8):
        path = root / "video" / "seq0" / f"{i:06d}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(jpgs[i % len(jpgs)])

    # DGP: one scene of four samples, lidar points on a plane 4 m ahead.
    sd = root / "ddad" / "scene_000"
    (sd / "point_cloud" / "lidar").mkdir(parents=True)
    (sd / "rgb" / "camera_01").mkdir(parents=True)
    (sd / "calibration").mkdir()
    ys, xs = np.mgrid[-2.0:2.0:60j, -3.0:3.0:80j]
    points = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 4.0)], -1)
    datums, samples = [], []
    for t in range(4):
        ts = f"{t:016d}"
        (sd / "rgb" / "camera_01" / f"{ts}.jpg").write_bytes(jpgs[t])
        np.savez(sd / "point_cloud" / "lidar" / f"{ts}.npz", data=points)
        tx = {"translation": {"x": float(poses[t][0, 3]), "y": float(poses[t][1, 3]),
                              "z": float(poses[t][2, 3])}, "rotation": {"qw": 1.0}}
        datums += [{"key": f"img{t}", "id": {"name": "camera_01", "timestamp": ts},
                    "datum": {"image": {"filename": f"rgb/camera_01/{ts}.jpg", "pose": tx}}},
                   {"key": f"pc{t}", "id": {"name": "lidar", "timestamp": ts},
                    "datum": {"point_cloud": {"filename": f"point_cloud/lidar/{ts}.npz",
                                              "pose": {}}}}]
        samples.append({"datum_keys": [f"img{t}", f"pc{t}"], "calibration_key": "c0"})
    (sd / "calibration" / "c0.json").write_text(json.dumps({
        "names": ["camera_01", "lidar"],
        "intrinsics": [{"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}, {}]}))
    (sd / "scene.json").write_text(json.dumps({"name": "scene_000", "samples": samples,
                                               "data": datums}))
    (root / "ddad" / "scene_dataset_v1.0.json").write_text(json.dumps(
        {"scene_splits": {"1": {"filenames": ["scene_000/scene.json"]}}}))
    return scans


def write_kitti_tree(root, n=2 * KITTI_STEPS + 2):
    """A KITTI raw drive of ``n`` rendered 375x1242 PNG frames, OXTS
    packets, calibration and 16-bit ground-truth depth (every third row
    empty, as projected lidar is sparse). Returns the frames' render time."""
    import numpy as np

    from dro_sfm_torch.data import SyntheticConfig, SyntheticDataset
    from dro_sfm_torch.utils.image_io import write_png
    t0 = time.perf_counter()
    data = SyntheticDataset(SyntheticConfig(height=375, width=1242, num_planes=3,
                                            num_context=n - 1, seed=1))
    planes, poses = data._scene(0)
    date = "2011_09_26"
    drive = root / date / f"{date}_drive_0001_sync"
    for i, pose in enumerate(poses):
        rgb, depth = data._render(planes, pose)
        name = f"{i:010d}"
        for sub in ("image_02/data", "oxts/data", "proj_depth/groundtruth/image_02"):
            (drive / sub).mkdir(parents=True, exist_ok=True)
        write_png(str(drive / "image_02" / "data" / f"{name}.png"),
                  (rgb * 255).astype(np.uint8))
        gt = depth[..., 0].copy()
        gt[::3] = 0
        depth_png_bytes(drive / "proj_depth" / "groundtruth" / "image_02" / f"{name}.png",
                        gt, 256.0)
        vals = [49.0 + 1e-5 * i, 8.43 + 2e-5 * i, 110.0, 0.002 * i, 0.0, 0.01 * i] + [0.0] * 24
        np.savetxt(drive / "oxts" / "data" / f"{name}.txt", np.array(vals)[None], fmt="%.9f")
    K = data.K
    (root / date / "calib_cam_to_cam.txt").write_text(
        f"P_rect_02: {K[0, 0]} 0 {K[0, 2]} 45.0 0 {K[1, 1]} {K[1, 2]} 0.2 0 0 1 0.003\n"
        "R_rect_00: 0.9999 0.0093 -0.0073 -0.0093 0.9999 -0.0043 0.0074 0.0042 0.9999\n")
    (root / date / "calib_velo_to_cam.txt").write_text(
        "R: 0.0075 -0.9999 -0.0006 0.0148 0.0007 -0.9999 0.9999 0.0075 0.0148\n"
        "T: -0.0041 -0.0763 -0.2717\n")
    (root / date / "calib_imu_to_velo.txt").write_text(
        "R: 1 0.0008 -0.002 -0.0008 0.9999 0.0148 0.002 -0.0148 0.9999\n"
        "T: -0.8087 0.3196 -0.7997\n")
    rel = f"{date}/{date}_drive_0001_sync/image_02/data"
    (root / "train_split.txt").write_text("".join(f"{rel}/{i:010d}.png\n"
                                                  for i in range(1, n - 1)))
    (root / "val_split.txt").write_text("".join(f"{rel}/{i:010d}.png\n" for i in (1, 2)))
    return time.perf_counter() - t0


def dataset_trainer(config, counters, steps, eval_shapes, gpu, **overrides):
    """`Trainer.fit` for `DATASET_EPOCHS` epochs of ``config`` with ``overrides``, from
    `tame_weights`: every count reset just before fit() and read just after;
    K1 24, K2 24, K3 18 a step and K1 48 an eval batch; finite losses and
    metrics; the first train and eval batches of the shapes asked for.
    Prints the loader's frames/s alone, the trainer's and the bare step's,
    the first two with every frame decoded (decode cache off)."""
    from dro_sfm_torch.data import kitti as frame_reader
    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import load_config
    cfg = load_config(str(config), overrides={"arch": {"max_epochs": DATASET_EPOCHS},
                                              **overrides})
    trainer = Trainer(cfg, device="cuda")
    b = cfg.datasets.train.batch_size
    h, w = cfg.datasets.augmentation.image_shape
    tb = next(iter(trainer.train_loader))
    vb = next(iter(trainer.val_loaders[0]))
    got = (tb["rgb"].shape, tb["depth"].shape, vb["rgb"].shape, vb["depth"].shape)
    want = ((b, h, w, 3), (b, h, w, 1), *eval_shapes)
    if got != want:
        fail(f"datasets: {config.name} batches {got}, want {want}")
    with torch.no_grad():
        trainer.net.load_state_dict(tame_weights(trainer.net.state_dict()))
    bare = trainer.train_step
    train, evaluate, epochs = counted_trainer(trainer, counters)
    # The loader and the trainer are timed with the readers' decode cache
    # off: these trees fit in it, a dataset does not, so every frame a
    # sample names is decoded.
    cache_size = frame_reader._DECODE_CACHE_SIZE
    frame_reader._DECODE_CACHE_SIZE = 0
    frame_reader._decode_cache.clear()
    try:
        t0 = time.perf_counter()
        frames = sum(len(batch["idx"]) for batch in trainer.train_loader)
        loader_fps = frames / (time.perf_counter() - t0)
        for c in counters.values():          # this slice's path starts here
            c.reset()
        metrics = trainer.fit()
        launches = {k: c.launches for k, c in counters.items()}   # and ends here
    finally:
        frame_reader._DECODE_CACHE_SIZE = cache_size
    if len(train.launches) != DATASET_EPOCHS * steps or not evaluate.launches:
        fail(f"datasets: {config.name}: {len(train.launches)} steps, "
             f"{len(evaluate.launches)} eval batches")
    check_launches(f"{config.name} train step", train.launches, TRAIN_LAUNCHES, counters)
    check_launches(f"{config.name} eval batch", evaluate.launches, EVAL_LAUNCHES, counters)
    losses = [m["loss"].item() for _, m in train.outputs]
    if not all(math.isfinite(v) for v in losses):
        fail(f"datasets: {config.name}: non-finite losses {losses}")
    check_finite(config.name, metrics)
    placed = trainer._place_train(tb)
    flips = torch.Generator().manual_seed(0)
    step_ms = host_ms(lambda: (bare(trainer.state, placed, flips),
                               torch.cuda.synchronize()), reps=3)
    fps = " / ".join(f"{e['train_frames_per_sec']:.1f}" for e in epochs.outputs)
    print(f"datasets trainer {config.name} {cfg.model.depth_net.version} {h}x{w} B={b}: "
          f"{DATASET_EPOCHS} epochs x {steps} steps, losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}, abs_rel_pp_gt "
          f"{metrics['abs_rel_pp_gt']:.4f}; train {fps} frames/s by epoch against the bare "
          f"step's "
          f"{1e3 * b / step_ms:.1f} ({step_ms:.1f} ms/step, batch on the card); loader "
          f"alone {loader_fps:.1f} frames/s ({trainer.train_loader.num_workers} threads); "
          f"decode cache off for both; "
          f"eval batch {' / '.join(f'{v:.1f}' for v in evaluate.ms)} ms; launches per step "
          f"{train.launches[-1]}, per eval batch {evaluate.launches[-1]}; eval images "
          f"{vb['rgb'].shape[1:3]}, ground truth {vb['depth'].shape[1:3]}; on {gpu}",
          flush=True)
    del trainer, placed
    torch.cuda.empty_cache()
    return launches


def check_batch(name, batch, placed, shape):
    """The sample schema on a collated batch and its copy on the card."""
    import numpy as np

    b = len(batch["idx"])
    rgb, ctx = batch["rgb"], batch["rgb_context"]
    bad = []
    if rgb.shape != (b, *shape, 3) or rgb.dtype != np.float32 or not 0 <= rgb.min() \
            or rgb.max() > 1:
        bad.append(f"rgb {rgb.shape} {rgb.dtype}")
    if ctx.ndim != 5 or ctx.shape[0] != b or ctx.shape[2:] != rgb.shape[1:]:
        bad.append(f"rgb_context {ctx.shape}")
    if batch["intrinsics"].shape != (b, 3, 3):
        bad.append(f"intrinsics {batch['intrinsics'].shape}")
    if "depth" in batch and (batch["depth"].ndim != 4 or batch["depth"].shape[-1] != 1):
        bad.append(f"depth {batch['depth'].shape}")
    if "pose_context" in batch and batch["pose_context"].shape != (b, ctx.shape[1], 4, 4):
        bad.append(f"pose_context {batch['pose_context'].shape}")
    for k, t in placed.items():
        if t.device.type != "cuda" or not torch.equal(
                t.cpu(), torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))):
            bad.append(f"{k} on the card")
        if not bool(torch.isfinite(t).all()):
            bad.append(f"{k} not finite")
    if bad:
        fail(f"datasets: {name}: {', '.join(bad)}")


def phase_datasets(counters, gpu):
    """Training from dataset files: the host codec built and held to
    OpenCV's bytes on the committed JPEG and BMP fixtures; decode times by
    JPEG kind and resize times;
    ScanNet (JPEG) and KITTI (PNG) trees trained through `Trainer` from
    their configs (this slice's path: launches checked per step and eval
    batch); one batch of every other reader through `make_loader` and
    `device_prefetch` onto the card."""
    import shutil
    import zlib

    import numpy as np

    from dro_sfm_torch import hostlib
    from dro_sfm_torch.data import make_loader, setup_dataset
    from dro_sfm_torch.data.loader import device_prefetch, to_device
    from dro_sfm_torch.utils.config import load_config
    from dro_sfm_torch.utils.image_io import (
        _chunks,
        _unfilter,
        decode_jpeg,
        png_unfilter,
        read_png,
        resize_bilinear_u8,
        write_png,
    )
    t_start = time.perf_counter()
    precision = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    shutil.rmtree(DATASETS_BUILD, ignore_errors=True)
    try:
        fresh = not hostlib.library_path("image_codec").is_file()
        t0 = time.perf_counter()
        library = hostlib.build("image_codec")
        built = (f"built {library.name} in {time.perf_counter() - t0:.1f} s" if fresh else
                 f"{library.name} found built (by phase apps, which reads PNG, or before "
                 f"this run)")
        meta = check_fixtures()

        # Decode and resize times on this host.
        jpg = (FIXTURES / "view0.jpg").read_bytes()
        kinds = {"4:2:0": "view0.jpg", "4:4:4": "view0_444.jpg",
                 "progressive": "view1_progressive.jpg", "arithmetic": "view2_arith.jpg",
                 "arithmetic progressive": "view2_arith_progressive.jpg",
                 "CMYK": "view3_cmyk.jpg"}
        blobs = {k: (FIXTURES / name).read_bytes() for k, name in kinds.items()}
        view = decode_jpeg(jpg)
        DATASETS_BUILD.mkdir(parents=True)
        write_png(str(DATASETS_BUILD / "view0.png"), view)
        kitti = DATASETS_BUILD / "kitti"
        render_s = write_kitti_tree(kitti)
        frame = next((kitti / "2011_09_26").rglob("image_02/data/0000000001.png"))
        idat = b"".join(body for kind, body in _chunks(frame.read_bytes(), str(frame))
                        if kind == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(375, 1242 * 3 + 1)
        kframe = read_png(str(frame))
        times = {
            **{f"jpeg 480x640 {k}": host_ms(lambda b=b: decode_jpeg(b)) for k, b in blobs.items()},
            "png 480x640": host_ms(lambda: read_png(str(DATASETS_BUILD / "view0.png"))),
            "png 375x1242": host_ms(lambda: read_png(str(frame))),
            "unfilter 375x1242 C++": host_ms(lambda: png_unfilter(rows, 3)),
            "unfilter 375x1242 numpy": host_ms(
                lambda: _unfilter(rows[:, 1:].reshape(375, 1242, 3), rows[:, 0]), reps=5),
            "resize 480x640->240x320": host_ms(lambda: resize_bilinear_u8(view, (240, 320))),
            "resize 375x1242->320x960": host_ms(
                lambda: resize_bilinear_u8(kframe, (320, 960))),
        }
        print(f"datasets codec: {built}; {len(meta['files'])} JPEG and BMP "
              f"fixtures equal OpenCV {meta['opencv']}'s sha256 ({meta['opencv_libjpeg']}); "
              f"scene frames {', '.join(SCENE_FRAMES)}; host ms (median): "
              + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
              + f"; KITTI frames rendered and written in {render_s:.1f} s; on {gpu}",
              flush=True)

        scans = write_scene_trees(DATASETS_BUILD / "scenes", meta)
        build = DATASETS_BUILD / "runs"
        quiet = {"depth": {"png": False, "rgb": False, "viz": False}}
        scannet_eval = {"path": [str(scans)], "split": ["test_split_view3.txt"],
                        "batch_size": 4, "num_workers": 4}
        launches = dataset_trainer(
            SCANNET_CONFIG, counters, SCANNET_STEPS, ((4, 240, 320, 3), (4, 480, 640, 1)), gpu,
            checkpoint={"filepath": str(build / "scannet")},
            save={"folder": str(build / "scannet_depth"), **quiet},
            datasets={"train": {"path": [str(scans)], "split": ["train_split.txt"],
                                "num_workers": 8},
                      "validation": scannet_eval, "test": scannet_eval})
        kitti_eval = {"path": [str(kitti)], "split": ["val_split.txt"], "batch_size": 2,
                      "num_workers": 4}
        dataset_trainer(
            KITTI_CONFIG, counters, KITTI_STEPS, ((2, 320, 960, 3), (2, 375, 1242, 1)), gpu,
            checkpoint={"filepath": str(build / "kitti")},
            save={"folder": str(build / "kitti_depth"), **quiet},
            datasets={"train": {"path": [str(kitti)], "split": ["train_split.txt"],
                                "repeat": [1], "num_workers": 8},
                      "validation": kitti_eval, "test": kitti_eval})

        # Every other reader: one batch onto the card.
        scenes = DATASETS_BUILD / "scenes"
        sources = {"ScannetTest": (scans, "test_split_view3.txt", {}),
                   "ScannetTestMF": (scans, "test_split_view3.txt", {}),
                   "ScannetBA": (scans, "avail.txt", {}),
                   "Demon": (scenes / "demon", "train.txt", {}),
                   "DemonMF": (scenes / "demon", "train.txt", {}),
                   "Matterport": (scenes / "matterport", "split.txt", {}),
                   "MatterportTest": (scenes / "matterport", "split.txt", {}),
                   "Video": (scenes / "video", "", {"depth_type": [""]}),
                   "Video_Random": (scenes / "video", "", {"depth_type": [""]}),
                   "Image": (scenes / "video", "", {"depth_type": [""]}),
                   "DGP": (scenes / "ddad", "val", {"depth_type": ["lidar"],
                                                     "cameras": [["camera_01"]]})}
        shape = (240, 320)
        report = []
        for name, mode in OTHER_READERS.items():
            path, split, extra = sources[name]
            key = "train" if mode == "train" else "validation"
            section = {"dataset": [name], "path": [str(path)], "split": [split],
                       "depth_type": ["groundtruth"], "back_context": 1,
                       "forward_context": 1, **extra}
            cfg = load_config(overrides={"datasets": {
                "augmentation": {"image_shape": list(shape),
                                 "jittering": [0.2, 0.2, 0.2, 0.05]}, key: section}})
            ds = setup_dataset(cfg.datasets[key], cfg.datasets.augmentation, mode)
            ds = ds if mode == "train" else ds[0]
            t0 = time.perf_counter()
            loader = make_loader(ds, 2, mode, num_workers=2)
            keys = ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")
            batch, placed = next(device_prefetch(
                loader, lambda b: to_device(b, torch.device("cuda"), keys), depth=1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            check_batch(name, batch, placed, shape)
            extras = [f"depth {batch['depth'].shape[1]}x{batch['depth'].shape[2]}"] \
                if "depth" in batch else []
            extras += ["poses"] if "pose_context" in batch else []
            report.append(f"{name} ({mode}, {len(ds)} samples, {batch['rgb_context'].shape[1]} "
                          f"context, {', '.join(extras) or 'no ground truth'}) {ms:.0f} ms")
        print(f"datasets readers: one B=2 batch each through make_loader and "
              f"device_prefetch at {shape[0]}x{shape[1]}: " + "; ".join(report), flush=True)
        print(f"datasets: phase {time.perf_counter() - t_start:.1f} s on {gpu}", flush=True)
        return launches
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = precision
        shutil.rmtree(DATASETS_BUILD, ignore_errors=True)
        torch.cuda.empty_cache()


# --- training in several processes ---------------------------------------------

DIST_BUILD = ROOT / "build" / "dist_trainer"
DIST_WORLD = 2
DIST_TIMEOUT = 120                 # seconds the ranks of a run may take
DIST_TIMED_STEPS = 3


def counter_map():
    from dro_sfm_torch.ops.gru_pass import K5_COUNTER, K6I_COUNTER, K6W_COUNTER
    from dro_sfm_torch.ops.tent_warp import K1_COUNTER, K2_COUNTER, K3_COUNTER, K4_COUNTER
    return {"K1": K1_COUNTER, "K2": K2_COUNTER, "K3": K3_COUNTER, "K4": K4_COUNTER,
            "K5": K5_COUNTER, "K6-input": K6I_COUNTER, "K6-weight": K6W_COUNTER}


def dist_config(tag, train=True):
    """`trainer_config` cut to one epoch (2 steps of B=8, one B=4 validation
    batch), checkpoints under ``build/dist_trainer/<tag>``; without
    ``train`` an evaluation-only config."""
    cfg = trainer_config(max_epochs=1)
    cfg.checkpoint.filepath = str(DIST_BUILD / tag / "ckpt")
    cfg.save.folder = str(DIST_BUILD / tag / "depth")
    if not train:
        cfg.datasets.train.dataset = []
    return cfg


def dist_fit(tag, counters):
    """`Trainer.fit` of `dist_config` with deterministic library algorithms:
    (losses, validation metrics, launches a step, a batch and over fit(),
    ms a step, the state after, the checkpoint)."""
    from dro_sfm_torch.training.trainer import Trainer
    trainer = Trainer(dist_config(tag), device="cuda")
    train = trainer.train_step = CountedStep(trainer.train_step, counters, timed=True)
    evaluate = CountedStep(trainer.eval_step_for(False), counters)
    trainer._eval_steps[False] = evaluate
    for c in counters.values():              # the trainer's path starts here
        c.reset()
    metrics = trainer.fit()
    launches = {k: c.launches for k, c in counters.items()}   # and ends here
    losses = [m["loss"].item() for _, m in train.outputs]
    (ckpt,) = [p for _, p in trainer.checkpointer.saved]
    state = trainer_state(trainer)
    return losses, metrics, train.launches, evaluate.launches, launches, train.ms, state, ckpt


def flip_generator_for(flip):
    """A generator whose first flip draw (probability 0.5) is ``flip``."""
    from dro_sfm_torch.models.sfm import draw_flip
    seed = next(s for s in range(100)
                if draw_flip(torch.Generator().manual_seed(s), 0.5) == flip)
    return torch.Generator().manual_seed(seed)


def dist_batch():
    """The global B=8 batch of the two-rank step: `make_train_batch` with
    the last 4 images (rank 1's shard) at half brightness, so that a shard's
    BatchNorm statistics differ from the global batch's."""
    batch = make_train_batch(TRAIN_B, seed=4)
    for k in ("rgb", "rgb_context", "rgb_original", "rgb_context_original"):
        batch[k] = batch[k].clone()
        batch[k][TRAIN_B // 2:] *= 0.5
    return batch


def dist_step(cfg, state, batch, generator, do_flip=None):
    """One `make_train_step` step from ``state`` on ``batch``: (net,
    optimizer, step, TrainState, metrics, gradients before the update in
    fp64, the state after)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    net = cfg.build_net(device="cuda")
    net.load_state_dict(state, strict=True)
    opt = make_optimizer(net, steps_per_epoch=1000)
    train_state = create_train_state(net, opt, device="cuda")
    grads, update = {}, opt.step

    def step_keeping_grads(count):
        grads.update({k: p.grad.detach().double() for k, p in net.named_parameters()})
        update(count)

    opt.step = step_keeping_grads
    step = make_train_step(cfg, net, opt, device="cuda")
    train_state, metrics = step(train_state, batch, generator, do_flip=do_flip)
    opt.step = update
    after = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return net, step, train_state, {k: v.item() for k, v in metrics.items()}, grads, after


def skipped_reduction(layers):
    """`layers._global_moments` on a rank whose BatchNorm skips the
    reduction: the sums still go round (so the ranks stay in step, forward
    and backward), but the rank normalises with its shard's statistics."""
    real = layers._global_moments

    def local(xf):
        gmean, gvar = real(xf)
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        return mean + 0.0 * gmean, var + 0.0 * gvar
    return local


def dist_rank(rank, world, store, job_path, out_dir):
    """One rank of the two-rank run on the card (gloo, the same card for
    both): the step on this rank's shard of the job's batch and its
    launches; the step again with rank 1's BatchNorm skipping the
    reduction; timed steps and a profiled one; validation of the job's
    checkpoint, and again with a shard that drops a sample. Writes
    ``out_dir/rank<R>.pt``."""
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    marks = [("entered", time.time())]
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        from dro_sfm_torch.models import layers
        from dro_sfm_torch.training.trainer import Trainer
        counters = counter_map()
        job = torch.load(job_path, map_location="cuda", weights_only=False)
        per = TRAIN_B // world
        shard = {k: v[rank * per:(rank + 1) * per] for k, v in job["batch"].items()}
        cfg = train_config()
        out = {}
        # The step: rank 0 draws no flip, rank 1 a flip; rank 0's holds.
        for c in counters.values():
            c.reset()
        net, step, state, metrics, grads, after = dist_step(
            cfg, job["state"], shard, flip_generator_for(rank != 0))
        out["launches"] = {k: c.launches for k, c in counters.items()}
        out["step"] = (metrics, grads, after)
        marks.append(("bf16 step", time.time()))
        out["step_fp32"] = dist_step(train_config(mixed_precision=False), job["state"], shard,
                                     flip_generator_for(rank != 0))[3:]
        marks.append(("fp32 step", time.time()))
        # Timed steps and one profiled step, continuing from there.
        flips = torch.Generator().manual_seed(5)
        times = []
        for _ in range(DIST_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, shard, flips)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            step(state, shard, flips)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        # The host's time inside each collective's span (gloo copies CUDA
        # tensors through the host, so it includes waiting for the kernels
        # queued before the collective).
        spans = span_table(prof)
        out["ms"] = times
        out["profile"] = (wall, spans)
        del net, step, state
        marks.append(("timed steps", time.time()))
        # Rank 1's BatchNorm skips the reduction.
        real = layers._global_moments
        if rank == 1:
            layers._global_moments = skipped_reduction(layers)
        try:
            _, _, _, metrics, grads, after = dist_step(
                cfg, job["state"], shard, flip_generator_for(rank != 0))
        finally:
            layers._global_moments = real
        out["fault_bn"] = (metrics, grads, after)
        marks.append(("fault step", time.time()))
        # Validation of the one-process trainer's checkpoint, sharded, with
        # the library algorithms that trainer ran.
        trainer = Trainer(dist_config(f"eval_rank{rank}", train=False), resume=job["ckpt"],
                          device="cuda")
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("ignore", UserWarning)
        for c in counters.values():
            c.reset()
        out["validate"] = trainer.validate()
        out["eval_launches"] = {k: c.launches for k, c in counters.items()}
        loader = trainer.val_loaders[0]

        class DropsASample:
            """The validation loader, rank 1's first genuine sample dropped."""
            dataset = loader.dataset

            def __len__(self):
                return len(loader)

            def __iter__(self):
                for i, batch in enumerate(loader):
                    if rank == 1 and i == 0:
                        batch["valid"] = batch["valid"].copy()
                        batch["valid"][0] = False
                    yield batch

        try:
            trainer.validate(DropsASample())
            out["drop"] = None
        except RuntimeError as e:
            out["drop"] = str(e)
        marks.append(("validation", time.time()))
        out["marks"] = marks
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start_dist_ranks(job_path):
    """Spawn the `DIST_WORLD` ranks of `dist_rank`: (processes, deadline)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = DIST_BUILD / "gloo_store"
    procs = [ctx.Process(target=dist_rank, args=(r, DIST_WORLD, str(store), str(job_path),
                                                 str(DIST_BUILD)))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + DIST_TIMEOUT


def join_dist_ranks(procs, deadline):
    """Each rank's results; fails on a rank that raises or outlives
    `DIST_TIMEOUT`."""
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        fail(f"dist_trainer: ranks {hung} still ran after {DIST_TIMEOUT} s")
    if codes != [0] * DIST_WORLD:
        fail(f"dist_trainer: ranks' exit codes {codes}")
    return [torch.load(DIST_BUILD / f"rank{r}.pt", map_location="cuda", weights_only=False)
            for r in range(DIST_WORLD)]


def stats_beyond(after, ref_after, bar=1e-3):
    """BatchNorm statistics of ``after`` farther than ``bar`` from
    ``ref_after`` (relative to the largest element)."""
    return [k for k, v in ref_after.items() if k.endswith(("running_mean", "running_var"))
            and (after[k] - v).abs().max().item() > bar * v.abs().max().item()]


def dist_verdict(result, ref, own=None, reach=None):
    """(failures, (worst rel L2, its leaf), the loss's relative error) of a
    rank's step against the one-process step on the whole batch. In bf16
    (``own``: each leaf's bf16 own error, the one-process bf16 gradient
    against the fp32 one) the loss within BF16_BAR relative and each leaf
    within max(BF16_BAR, own) relative L2: two bf16 steps that round at
    other points (another batch size runs other cuDNN algorithms) part by
    up to bf16's own error. In fp32 the loss within 1e-5 relative and each
    leaf at cosine >= 0.9999 and relative L2 <= 1e-2, the reach of the
    order of the sums (`tests/test_torch_dist_train.py`); with ``reach``
    (each leaf's relative L2 between two one-process steps that differ in
    the order of the samples) a leaf's bar is the larger of 1e-2 and twice
    its reach, the cosine implied (`tests/test_torch_spatial_tasks.py`;
    phase spatial's multi-frame fp32 photometric steps at B=8 pass 1e-2).
    Both: the BatchNorm statistics within 1e-3 of the largest element."""
    (metrics, grads, after), (ref_metrics, ref_grads, ref_after) = result, ref
    failures, worst = [], (0.0, "")
    rel = abs(metrics["loss"] - ref_metrics["loss"]) / abs(ref_metrics["loss"])
    if not rel <= (BF16_BAR if own else 1e-5):
        failures.append(f"loss {metrics['loss']!r} vs {ref_metrics['loss']!r}")
    for k, want in ref_grads.items():
        got = grads[k]
        if want.norm().item() == 0:
            if got.norm().item() != 0:
                failures.append(f"{k} nonzero where one process has zero")
            continue
        r, cos = rel_l2(got, want), cosine(got, want)
        if own:
            bar = max(BF16_BAR, own.get(k, 0.0))
        else:
            bar = max(1e-2, 2.0 * reach.get(k, 0.0)) if reach else 1e-2
        if not (r <= bar and (own or bar > 1e-2 or cos >= 0.9999)):
            failures.append(f"{k} rel L2 {r:.3e} cosine {cos:.6f} bar {bar:.3e}")
        worst = max(worst, (r, k))
    failures += [f"{k} beyond 1e-3" for k in stats_beyond(after, ref_after)]
    return failures, worst, rel


def leaf_errors(grads, ref_grads):
    """Each leaf's relative L2 from ``ref_grads`` (nonzero leaves)."""
    return {k: rel_l2(grads[k], g) for k, g in ref_grads.items() if g.norm().item() > 0}


def phase_dist_trainer(counters, gpu):
    """Training in several processes (see the module docstring, phase 25)."""
    import shutil

    import torch.distributed as dist
    shutil.rmtree(DIST_BUILD, ignore_errors=True)
    DIST_BUILD.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        # (a) World size 1 on NCCL against the same trainer without a group.
        with deterministic_algorithms():
            alone = dist_fit("alone", counters)
            dist.init_process_group("nccl", store=dist.FileStore(str(DIST_BUILD / "nccl_store"), 1),
                                    rank=0, world_size=1, device_id=torch.device("cuda", 0))
            try:
                nccl = dist_fit("nccl", counters)
            finally:
                dist.destroy_process_group()
        losses, metrics, step_launches, eval_launches, launches, ms, state, ckpt = nccl
        check_launches("world-size-1 train step", step_launches, TRAIN_LAUNCHES, counters)
        check_launches("world-size-1 eval batch", eval_launches, EVAL_LAUNCHES, counters)
        if len(step_launches) != 2 or len(eval_launches) != 1:
            fail(f"dist_trainer: {len(step_launches)} steps, {len(eval_launches)} eval batches")
        want = {k: 2 * TRAIN_LAUNCHES.get(k, 0) + EVAL_LAUNCHES.get(k, 0) for k in counters}
        if launches != want:
            fail(f"dist_trainer: launches over fit() {launches}, want {want}")
        if losses != alone[0] or not all(math.isfinite(v) for v in losses):
            fail(f"dist_trainer: world size 1 on NCCL losses {losses}, without a "
                 f"process group {alone[0]}")
        check_finite("world-size-1 fit()", metrics)
        same = not same_state(state, alone[6])
        print(f"dist_trainer (a) world size 1 on NCCL, train_synthetic_192x640 it12-h-out "
              f"bf16 192x640 B=8: losses {losses} bit-equal to the run without a process "
              f"group; net, Adam and step {'bit-equal' if same else 'NOT bit-equal'}; "
              f"ms a step {' / '.join(f'{v:.2f}' for v in ms)} (without a group "
              f"{' / '.join(f'{v:.2f}' for v in alone[5])}); launches per step "
              f"{step_launches[-1]}, per eval batch {eval_launches[-1]}; both fits "
              f"{time.perf_counter() - t_phase:.1f} s; on {gpu}", flush=True)

        # (b) Two ranks on this card over gloo against one process on B=8.
        start = tame_weights(start_weights(train_config()).state_dict())
        batch = dist_batch()
        job = DIST_BUILD / "job.pt"
        torch.save({"state": {k: v.cpu() for k, v in start.items()},
                    "batch": {k: v.cpu() for k, v in batch.items()}, "ckpt": ckpt}, job)
        t0, spawned = time.perf_counter(), time.time()
        procs = start_dist_ranks(job)        # the references meanwhile, as they start up
        fp32 = train_config(mixed_precision=False)
        ref = dist_step(train_config(), start, batch, None, do_flip=False)[3:]
        ref32 = dist_step(fp32, start, batch, None, do_flip=False)[3:]
        own = leaf_errors(ref[1], ref32[1])
        # The order of the sums' own reach: one process, the halves swapped.
        swapped = {k: torch.cat([v[TRAIN_B // 2:], v[:TRAIN_B // 2]]) for k, v in batch.items()}
        floor = sorted(leaf_errors(dist_step(fp32, start, swapped, None, do_flip=False)[4],
                                   ref32[1]).values())
        torch.cuda.empty_cache()
        print(f"dist_trainer (b) one process B=8 from tame_weights: bf16 own error (against "
              f"fp32) by leaf median {sorted(own.values())[len(own) // 2]:.3e}, largest "
              f"{max(own.values()):.3e}; fp32 with the halves swapped against fp32: median "
              f"{floor[len(floor) // 2]:.3e}, largest {floor[-1]:.3e}", flush=True)
        ranks = join_dist_ranks(*procs)
        spawn_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            got = {k: v for k, v in res["launches"].items()}
            want = {k: TRAIN_LAUNCHES.get(k, 0) for k in counters}
            if got != want:
                fail(f"dist_trainer: rank {r} step launches {got}, want {want}")
            failures, worst, rel = dist_verdict(res["step"], ref, own)
            failures32, worst32, rel32 = dist_verdict(res["step_fp32"], ref32)
            for what, bad in (("bf16", failures), ("fp32", failures32)):
                if bad:
                    fail(f"dist_trainer: rank {r} {what} against one process: {bad[:6]}")
            wall, spans = res["profile"]
            in_spans = sum(t for _, t in spans.values())
            print(f"dist_trainer (b) rank {r} of 2 on one card (gloo), B=4 a rank, against "
                  f"one process on B=8: bf16 loss {res['step'][0]['loss']:.6f} vs "
                  f"{ref[0]['loss']:.6f} (relative {rel:.2e}, bar {BF16_BAR:g}), worst "
                  f"leaf rel L2 {worst[0]:.3e} ({worst[1]}, own error {own.get(worst[1], 0.0):.3e}); "
                  f"fp32 loss relative {rel32:.2e} (bar 1e-5), worst leaf {worst32[0]:.3e} "
                  f"({worst32[1]}, bar 1e-2); BatchNorm statistics within 1e-3; "
                  f"launches {got}; ms a step {' / '.join(f'{v:.2f}' for v in res['ms'])}; "
                  f"collectives' share of the profiled step (host time in the "
                  f"collective spans) {in_spans:.2f} of {wall:.2f} ms "
                  f"({100 * in_spans / wall:.1f}%): " + ", ".join(
                      f"{k} {n}x {t:.2f} ms" for k, (n, t) in sorted(spans.items())),
                  flush=True)
            print(f"  rank {r} seconds after the spawn: " + ", ".join(
                f"{what} {t - spawned:.1f}" for what, t in res["marks"]), flush=True)
        if not all(torch.equal(ranks[0]["step"][1][k], ranks[1]["step"][1][k])
                   for k in ref[1]):
            fail("dist_trainer: the two ranks hold different gradients")
        # Validation, sharded, of (a)'s checkpoint against (a)'s last validation.
        for r, res in enumerate(ranks):
            if res["eval_launches"] != {k: EVAL_LAUNCHES.get(k, 0) for k in counters}:
                fail(f"dist_trainer: rank {r} eval launches {res['eval_launches']}")
            for mode in ("", "_pp", "_gt", "_pp_gt"):
                for m in ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3",
                          "SILog", "l1_inv"):
                    a, b = res["validate"][m + mode], metrics[m + mode]
                    if not abs(a - b) <= 1e-5 * abs(b) + 1e-7:
                        fail(f"dist_trainer: rank {r} validation {m + mode} {a!r}, one "
                             f"process {b!r}")
        print(f"dist_trainer (b) validation on 2 ranks: the 36 depth metrics within 1e-5 "
              f"of (a)'s, abs_rel_pp_gt {ranks[0]['validate']['abs_rel_pp_gt']!r} vs "
              f"{metrics['abs_rel_pp_gt']!r}; the ranks' run {spawn_s:.1f} s", flush=True)

        # (c) Planted faults.
        caught = [dist_verdict(res["fault_bn"], ref, own)[0] for res in ranks]
        if not any(caught):
            fail("dist_trainer: the bars pass a rank whose BatchNorm skips the reduction")
        print(f"dist_trainer (c) rank 1's BatchNorm skipping the reduction: "
              f"{[len(c) for c in caught]} failures by rank, e.g. {(caught[1] or caught[0])[:2]}",
              flush=True)
        drops = [res["drop"] for res in ranks]
        if not all(d and "saw 3 samples, expected 4" in d for d in drops):
            fail(f"dist_trainer: a shard that drops a sample passed: {drops}")
        print(f"dist_trainer (c) a validation shard that drops a sample: both ranks raise "
              f"({drops[0]!r})", flush=True)
    finally:
        shutil.rmtree(DIST_BUILD, ignore_errors=True)
        torch.cuda.empty_cache()


HDF5_FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "hdf5"
NYU_CONFIG = ROOT / "configs" / "train_nyu_mf_gt.yaml"
NYU_BUILD = ROOT / "build" / "nyu"
NYU_STEPS = 3


def check_hdf5_fixtures():
    """Read every committed HDF5 fixture with the port's reader and hold
    each dataset to h5py's sha256; returns the fixtures' table."""
    import hashlib

    from dro_sfm_torch.utils.hdf5 import open_h5
    meta = json.loads((HDF5_FIXTURES / "fixtures.json").read_text())
    for name, entries in meta["files"].items():
        f = open_h5(HDF5_FIXTURES / name)
        if sorted(f) != sorted(entries):
            fail(f"nyu: {name} holds {sorted(f)}, h5py wrote {sorted(entries)}")
        for key, e in entries.items():
            a = f[key]
            digest = hashlib.sha256(a.tobytes()).hexdigest()
            if (a.dtype.str, list(a.shape), digest) != (e["dtype"], e["shape"], e["sha256"]):
                fail(f"nyu: {name}:{key} reads as {a.dtype.str} {a.shape} sha256 "
                     f"{digest[:16]}, h5py's {e['dtype']} {e['shape']} {e['sha256'][:16]}")
    return meta


def phase_nyu(counters, gpu):
    """NYU from its HDF5 dumps without h5py: every committed fixture read by
    `utils/hdf5.py` to h5py's sha256; the reader's ms a 480x640 frame by
    layout; then ``configs/train_nyu_mf_gt.yaml`` (it12-h-out bf16,
    480x640, B=4, one context frame each side) on the committed session, its
    one sample repeated to `NYU_STEPS` steps of B=4 in one epoch and
    validated on one NYUtest batch, from `tame_weights`. The recipe's
    SupModelMF reads ground-truth poses, which NYU's dumps do not hold (the
    JAX step raises on them as the port's does), so the steps are
    SelfSupModelMF's, with the recipe's photometric settings (automask,
    ``min`` over views): every
    count reset just before fit() and read just after, K1 24, K2 24, K3 18 a
    step and K1 48 an eval batch, or it fails; losses and metrics finite.
    Checkpoints under ``build/nyu``, removed at the end."""
    import shutil

    from dro_sfm_torch.data.nyu import read_h5_sample
    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import load_config
    meta = check_hdf5_fixtures()
    root = HDF5_FIXTURES / meta["nyu_session"]
    reads = []
    for path in sorted(root.glob("*.h5")):
        entries = meta["files"][str(path.relative_to(HDF5_FIXTURES))]
        kind = ", ".join(f"{k} {meta['layouts'][str(e['layout'])]}"
                         + "".join(f"+{f}" for f in e["filters"])
                         for k, e in sorted(entries.items(), reverse=True))
        reads.append(f"{path.name} ({kind}) {host_ms(lambda: read_h5_sample(str(path)), 10):.2f}")
    print(f"nyu reader: {len(meta['files'])} HDF5 fixtures equal h5py {meta['h5py']}'s "
          f"sha256; host ms a 480x640 frame (rgb and depth, median of 10): "
          f"{'; '.join(reads)}; on {gpu}", flush=True)
    nyu = str(root.parent)
    evaluation = {"path": [nyu], "num_workers": 1}
    cfg = load_config(str(NYU_CONFIG), overrides={
        "arch": {"max_epochs": 1},
        "checkpoint": {"filepath": str(NYU_BUILD / "ckpt")},
        "save": {"folder": str(NYU_BUILD / "depth"),
                 "depth": {"png": False, "rgb": False, "viz": False}},
        "model": {"name": "SelfSupModelMF"},
        "datasets": {"train": {"path": [nyu], "repeat": [4 * NYU_STEPS], "num_workers": 4},
                     "validation": evaluation, "test": evaluation}})
    try:
        trainer = Trainer(cfg, device="cuda")
        b = cfg.datasets.train.batch_size
        h, w = cfg.datasets.augmentation.image_shape
        tb, vb = next(iter(trainer.train_loader)), next(iter(trainer.val_loaders[0]))
        got = (tb["rgb"].shape, tb["rgb_context"].shape, tb["depth"].shape, vb["rgb"].shape)
        want = ((b, h, w, 3), (b, 2, h, w, 3), (b, h, w, 1), (1, h, w, 3))
        if got != want or (b, h, w) != (4, 480, 640):
            fail(f"nyu: batches {got}, want {want} at B=4 480x640")
        with torch.no_grad():
            trainer.net.load_state_dict(tame_weights(trainer.net.state_dict()))
        train = trainer.train_step = CountedStep(trainer.train_step, counters, timed=True)
        evaluate = CountedStep(trainer.eval_step_for(False), counters, timed=True)
        trainer._eval_steps[False] = evaluate
        for c in counters.values():          # this slice's NYU path starts here
            c.reset()
        metrics = trainer.fit()
        launches = {k: c.launches for k, c in counters.items()}   # and ends here
    finally:
        shutil.rmtree(NYU_BUILD, ignore_errors=True)
    if len(train.launches) != NYU_STEPS or len(evaluate.launches) != 1:
        fail(f"nyu: {len(train.launches)} steps, {len(evaluate.launches)} eval batches")
    check_launches("nyu train step", train.launches, TRAIN_LAUNCHES, counters)
    check_launches("nyu eval batch", evaluate.launches, EVAL_LAUNCHES, counters)
    losses = [m["loss"].item() for _, m in train.outputs]
    if not all(math.isfinite(v) for v in losses):
        fail(f"nyu: non-finite losses {losses}")
    check_finite("nyu", metrics)
    print(f"nyu trainer train_nyu_mf_gt.yaml {cfg.model.name} "
          f"{cfg.model.depth_net.version} bf16 {h}x{w} B={b}: {NYU_STEPS} steps "
          f"{' / '.join(f'{v:.1f}' for v in train.ms)} ms (the first with start-up), "
          f"losses {' '.join(f'{v:.4f}' for v in losses)}, eval batch (B=1) "
          f"{evaluate.ms[0]:.1f} ms, abs_rel_pp_gt {metrics['abs_rel_pp_gt']:.4f}; launches "
          f"per step {train.launches[-1]}, per eval batch {evaluate.launches[-1]}; on {gpu}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


EXPORT_BUILD = ROOT / "build" / "export"
EXPORT_REQUESTS = 10
# The exported net's depth: phase 4's it12-h-out weights at 4 refinement
# iterations (K1 8 a request), which carries every node kind of it12's
# program; torch.export's and the load's seconds grow with the iterations
# (at it12 they took 110 of the phase's 141 s on an H100 host).
EXPORT_VERSION = "it4-h-out"
# Artifact against the live network on the same card, max |delta| of depth
# and of the pose matrices, fp32 and bf16: the JAX round-trip check's atol
# (both run the same kernels on the same inputs in the same order; every
# program met it at 0 on an H100).
EXPORT_BAR = 1e-4


def artifact_problems(what, call, req, counters, spec, sep_conv):
    """Run one request through ``call`` with every count reset just before
    and read just after; the launches a serving program of ``spec`` must
    make: K1 one a refinement step, and with ``sep_conv="pallas"`` K5 two,
    nothing else. Returns (the launches, what differs: empty if nothing)."""
    steps = 2 * spec.total_iters
    want = {"K1": steps, **({"K5": 2 * steps} if sep_conv == "pallas" else {})}
    for c in counters.values():
        c.reset()
    call(*req)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items() if c.launches}
    return got, ([] if got == want else [f"{what}: launches {got}, want {want}"])


def alternated_ms(fns, req, reps=EXPORT_REQUESTS):
    """Median ms of a request through each of ``fns`` (CUDA events around
    each, synchronised), the functions taking turns."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*req)
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def phase_export(DepthPoseNet, make_infer_fn, counters, state, gpu):
    """The serving export on the card: phase 4's it12-h-out weights in an
    `EXPORT_VERSION` net at 192x640, N=2, exported by
    `export_serving_artifact` for "cuda" as a
    static B=1 bf16 program, a dynamic-batch fp32 program and a static B=1
    bf16 program with ``sep_conv="pallas"``, each loaded back by
    `load_serving_artifact` (the ops' registrations only). Each request
    through a loaded program, counts reset just before and read just after,
    launches K1 two a refinement iteration (and K5 four with "pallas") and
    nothing else, and matches
    the live `make_infer_fn` of the same net (max |depth delta| and max
    |pose delta| within `EXPORT_BAR`) at B=1, and B=8 for the dynamic
    program. Planted fault: a program of a gather-warp net (it2-h-out-seq2)
    must fail the same launch check. Prints the seconds to export and load,
    the bytes, and the ms of a request through the program and through the
    live function at B=1 and B=8 (CUDA events, in turns)."""
    import shutil

    from dro_sfm_torch import export_serving as es
    from dro_sfm_torch.models.depth_pose_net import VersionSpec
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    spec = VersionSpec.parse(EXPORT_VERSION)
    cases = (("static B=1 bf16", True, "split", False, (1,)),
             ("dynamic-batch fp32", False, "split", True, (1, 8)),
             ("static B=1 bf16 sep_conv=pallas", True, "pallas", False, (1,)))
    launches = {k: 0 for k in counters}
    try:
        for name, mp, sep, dynamic, batches in cases:
            net = DepthPoseNet(version=EXPORT_VERSION, mixed_precision=mp, sep_conv=sep,
                               device="cuda")
            net.load_state_dict(state, strict=True)
            out = EXPORT_BUILD / name.replace(" ", "_").replace("=", "")
            t0 = time.perf_counter()
            es.export_serving_artifact(net, str(out), 1, VIEWS, (SERVE_H, SERVE_W),
                                       platforms=("cuda",), dynamic_batch=dynamic)
            export_s = time.perf_counter() - t0
            meta = json.loads((out / es.META).read_text())
            t0 = time.perf_counter()
            art = es.load_serving_artifact(str(out), "cuda")
            load_s = time.perf_counter() - t0
            steps = 2 * spec.total_iters
            if meta["kernel_nodes"]["cuda"] != {"K1": steps,
                                                "K5": 2 * steps if sep == "pallas" else 0}:
                fail(f"export {name}: kernel nodes {meta['kernel_nodes']}")
            live = make_infer_fn(net, device="cuda")
            for b in batches:
                req = requests[b]
                got, bad = artifact_problems(f"export {name} B={b}", art.call, req,
                                             counters, spec, sep)
                if bad:
                    fail("; ".join(bad))
                for k, v in got.items():
                    launches[k] += v
                frozen, ref = art.call(*req), live(*req)
                d_depth = float((frozen[0] - ref[0]).abs().max())
                d_pose = float((frozen[1] - ref[1]).abs().max())
                if frozen[0].shape != (b, SERVE_H, SERVE_W) or not (
                        d_depth <= EXPORT_BAR and d_pose <= EXPORT_BAR):
                    fail(f"export {name} B={b}: shape {tuple(frozen[0].shape)}, max |depth "
                         f"delta| {d_depth:.3e}, max |pose delta| {d_pose:.3e}, bar "
                         f"{EXPORT_BAR:g}")
                ms = alternated_ms({"artifact": art.call, "live": live}, req)
                print(f"export {name} {EXPORT_VERSION} 192x640 N=2 B={b}: export "
                      f"{export_s:.1f} s, load {load_s:.1f} s, {meta['bytes']} bytes; against live "
                      f"make_infer_fn max |depth delta| {d_depth:.3e}, max |pose delta| "
                      f"{d_pose:.3e} (bar {EXPORT_BAR:g}); launches a request {got}; "
                      f"ms a request (median of {EXPORT_REQUESTS}, in turns) artifact "
                      f"{ms['artifact']:.2f}, live {ms['live']:.2f}; on {gpu}", flush=True)
            del net, art, live
            shutil.rmtree(out, ignore_errors=True)
        # planted fault: a program without dro_sfm::warp_diff fails the check
        small = VersionSpec.parse("it2-h-out-seq2")
        net = DepthPoseNet(version="it2-h-out-seq2", warp_impl="gather", device="cuda")
        out = EXPORT_BUILD / "gather"
        es.export_serving_artifact(net, str(out), 1, VIEWS, (SERVE_H, SERVE_W),
                                   platforms=("cuda",))
        art = es.load_serving_artifact(str(out), "cuda")
        _, bad = artifact_problems("export gather-warp it2-h-out-seq2", art.call,
                                   requests[1], counters, small, "split")
        if not bad:
            fail("export: a program with no dro_sfm::warp_diff node passed the launch check")
        print(f"export planted fault: the gather-warp program fails the launch check "
              f"({bad[0]})", flush=True)
    finally:
        shutil.rmtree(EXPORT_BUILD, ignore_errors=True)
    return launches


BA_BUILD = ROOT / "build" / "ba"
BA_K, BA_H, BA_W = 32, 48, 64              # tools/torch_bench_ba.py's default problem
BA_CLI_K, BA_CLI_H, BA_CLI_W = 128, 48, 160  # infer_video --ba at 192x640: depth / 4
# The card against the CPU, and two ranks against one process, at BA_K
# keyframes after 6 iterations. In fp64 each pair agrees to about 3e-14. In
# fp32 the summation order alone moves the result farther than the JAX
# package's bars for its 4-keyframe mesh test (1e-4 on poses, 1e-5 on
# log-scales, tests/test_ba.py:207-214, which tests/test_torch_ba_dist.py
# holds): this problem turns H's rounding (2e-6 relative between card and
# CPU) into 2.3e-4 on the poses and 2.9e-5 on the log-scales, and the JAX
# package's own fp32 run on the CPU lies 2.8e-4 / 4.0e-5 from the port's fp64
# one (PERF.md, PR 13). So fp32 is held to that reach.
BA_FP64_BAR = 1e-9
BA_FP32_BARS = (5e-4, 5e-5)
BA_TIMED = 3                               # timed runs after a warm-up


def float64(problem):
    """The problem with its poses, depths and intrinsics in fp64."""
    return type(problem)(*(t.double() if t.is_floating_point() else t for t in problem))


def timed_runs(fn, reps=BA_TIMED):
    """(the result of a warm-up call, host ms of ``reps`` more calls, each
    between two `torch.cuda.synchronize`)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, times


def ba_rank(rank, world, store, job_path, out_dir):
    """One rank of the two-rank BA on the card (gloo, the same card for
    both): `make_sharded_optimizer` over the default group on the job's
    padded problem, in fp32 (timed again after the first run) and in fp64.
    Writes ``out_dir/rank<R>.pt``."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        from dro_sfm_torch.ba.dense_ba import BAProblem, make_sharded_optimizer
        job = torch.load(job_path, map_location="cuda", weights_only=False)
        run = make_sharded_optimizer(None, stride=2, iters=job["iters"])
        problem = BAProblem(*job["problem"])
        out = {"fp32": run(problem), "fp64": run(float64(problem))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(problem)
        torch.cuda.synchronize()
        out["ms"] = 1e3 * (time.perf_counter() - t0)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def ba_cli_checkpoint():
    """A checkpoint and frames for ``infer_video --ba``: phase `apps`'s net
    and frames (`start_weights` served in fp32, in the port's own checkpoint
    format; APPS_FRAMES rendered frames as PNG)."""
    import numpy as np

    from dro_sfm_torch.inference import save_model
    from dro_sfm_torch.training.trainer import model_config_from
    from dro_sfm_torch.utils.image_io import write_png
    (BA_BUILD / "frames").mkdir(parents=True, exist_ok=True)
    (BA_BUILD / "gt").mkdir(exist_ok=True)
    net = start_weights(model_config_from(trainer_config())).eval()
    net.mixed_precision = False
    path = str(BA_BUILD / "net.pt")
    save_model(net, path)
    frames, poses, _, _ = render_video(APPS_FRAMES, SERVE_H, SERVE_W)
    for i, (img, T) in enumerate(zip(frames, poses)):
        write_png(str(BA_BUILD / "frames" / f"{i:06d}.png"), img)
        np.savetxt(BA_BUILD / "gt" / f"{i:06d}.txt", T)
    return path, BA_BUILD / "frames", BA_BUILD / "gt"


def phase_ba(counters, gpu):
    """Bundle adjustment on the card (fp32, TF32 off): the benchmark's
    problem against the port's own CPU run (poses, log-scales, the LM
    guard's accept sequence), the ATE cut of 24 iterations, the schedules,
    the CLI's operating point (ms an iteration, edges/s, peak memory, the
    accumulate / solve / cost split), the host syncs of one iteration,
    ``infer_video --ba`` end to end, and the edge split on two ranks against
    one process."""
    import shutil
    import warnings

    import numpy as np

    from dro_sfm_torch.ba import dense_ba as D
    from dro_sfm_torch.ba.precision import fp32_matmuls
    from dro_sfm_torch.inference import TrajectoryAccumulator
    from dro_sfm_torch.scripts import infer_video
    from dro_sfm_torch.scripts.infer_video import covisibility_edges
    from dro_sfm_torch.visualization.trajectory import absolute_trajectory_error
    from tools.torch_bench_ba import build_problem, pad_edges
    t_start = time.perf_counter()
    shutil.rmtree(BA_BUILD, ignore_errors=True)
    BA_BUILD.mkdir(parents=True)

    def ate(poses, gt):
        return absolute_trajectory_error(list(poses.cpu().numpy()), list(gt))

    def accepts_of(problem, iters, **kw):
        stride, robust_c = kw.get("stride", 2), kw.get("robust_c", 0.25)
        with fp32_matmuls():
            return D._gn_loop(problem, lambda p: D._accumulate(p, stride, robust_c), iters,
                              1e-2, 0, kw.get("max_step", 0.05),
                              lambda p: D._total_cost(p, stride, robust_c))

    # 1) the bench problem at k=32, 6 iterations: card against the CPU, in
    # fp64 (the same algorithm: BA_FP64_BAR) and in fp32 (the same LM
    # decisions, within the reach of fp32's summation order: BA_FP32_BARS)
    cpu, gt, scale_noise = build_problem(BA_K, BA_H, BA_W, device="cpu")
    card = D.BAProblem(*(t.cuda() for t in cpu))
    runs = {}
    for name, prob in (("cpu", cpu), ("card", card), ("cpu64", float64(cpu)),
                       ("card64", float64(card))):
        poses, sigmas, acc = accepts_of(prob, 6)
        runs[name] = (poses.cpu().double(), sigmas.cpu().double(), acc.cpu().tolist())

    def dist(a, b):
        return (float((runs[a][0] - runs[b][0]).abs().max()),
                float((runs[a][1] - runs[b][1]).abs().max()))

    d32, d64 = dist("card", "cpu"), dist("card64", "cpu64")
    # where fp32's order enters: H at the start, and the solve of one H
    with fp32_matmuls():
        H, b = D._accumulate(cpu, 2, 0.25)
        H_card = D._accumulate(card, 2, 0.25)[0].cpu()
        step = D._schur_solve(H, b, BA_K, 1e-2, 0)[0]
        step_card = D._schur_solve(H.cuda(), b.cuda(), BA_K, 1e-2, 0)[0].cpu()
    h_rel = float((H_card - H).abs().max() / H.abs().max())
    solve_gap = float((step_card - step).abs().max())
    line = (f"ba card vs CPU k={BA_K} {BA_H}x{BA_W} stride 2, 6 iterations: fp64 poses "
            f"{d64[0]:.3e}, log-scales {d64[1]:.3e} (bar {BA_FP64_BAR}); fp32 poses {d32[0]:.3e} "
            f"(bar {BA_FP32_BARS[0]}), log-scales {d32[1]:.3e} (bar {BA_FP32_BARS[1]}); fp32 "
            f"from fp64: card {dist('card', 'card64')[0]:.3e} / {dist('card', 'card64')[1]:.3e}, "
            f"CPU {dist('cpu', 'cpu64')[0]:.3e} / {dist('cpu', 'cpu64')[1]:.3e}; accepts card "
            f"{runs['card'][2]} CPU {runs['cpu'][2]} (fp64 {runs['card64'][2]} / "
            f"{runs['cpu64'][2]}); H at the start card vs CPU {h_rel:.2e} relative, the "
            f"solve of the CPU's H {solve_gap:.2e} apart (steps up to "
            f"{float(step.abs().max()):.3f})")
    if not (max(d64) <= BA_FP64_BAR and d32[0] <= BA_FP32_BARS[0] and d32[1] <= BA_FP32_BARS[1]
            and runs["card"][2] == runs["cpu"][2] and runs["card64"][2] == runs["cpu64"][2]):
        fail(line)
    print(line, flush=True)

    # 2) quality at 24 iterations (tests/test_ba.py:245-286's bars)
    (poses, sigmas), ms = timed_runs(lambda: D.optimize_dense_ba(
        card, stride=2, iters=24, damping=1e-2, max_step=0.1), reps=1)
    ate0, ate1 = ate(card.poses, gt), ate(poses, gt)
    scale_err = float(np.abs(np.exp(sigmas.cpu().numpy()) * scale_noise - 1.0).max())
    line = (f"ba quality k={BA_K} 24 iterations: ATE {ate0:.5f} -> {ate1:.5f} "
            f"({ate0 / ate1:.2f}x, bar 4.5x), scales within {scale_err:.4f} (bar 0.015), "
            f"{ms[0]:.1f} ms ({ms[0] / 24:.2f} ms an iteration)")
    if not (ate1 < ate0 / 4.5 and scale_err <= 0.015):
        fail(line)
    print(line, flush=True)

    # 3) the schedules at k=32
    for name, fn in (("gnc", lambda: D.optimize_dense_ba_scheduled(card, stride=2)),
                     ("c2f", lambda: D.optimize_dense_ba_c2f(card, stride=2)),
                     ("robust", lambda: D.optimize_dense_ba_robust(card, stride=2))):
        (poses, sigmas), ms = timed_runs(fn, reps=1)
        if not (torch.isfinite(poses).all() and torch.isfinite(sigmas).all()):
            fail(f"ba schedule {name}: non-finite result")
        print(f"ba schedule {name} k={BA_K}: ATE {ate0:.5f} -> {ate(poses, gt):.5f}, "
              f"{ms[0]:.1f} ms", flush=True)

    # 4) infer_video's operating point: 128 keyframes of 48x160, +-2 keyframes
    big, _, _ = build_problem(BA_CLI_K, BA_CLI_H, BA_CLI_W, device="cuda")
    ei, ej = covisibility_edges(BA_CLI_K)
    big = big._replace(edges_i=ei.cuda(), edges_j=ej.cuda())
    n_edges = int(big.edges_i.shape[0])
    torch.cuda.reset_peak_memory_stats()
    (poses, sigmas), ms = timed_runs(lambda: D.optimize_dense_ba(big, stride=1, iters=6))
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not torch.isfinite(poses).all():
        fail("ba CLI point: non-finite poses")
    best = min(ms)
    with fp32_matmuls():
        H, b = D._accumulate(big, 1, 0.25)
        split = {"accumulate": time_ms(lambda: D._accumulate(big, 1, 0.25), reps=3, warmup=1),
                 "solve": time_ms(lambda: D._schur_solve(H, b, BA_CLI_K, 1e-2, 0), reps=10,
                                  warmup=2),
                 "cost": time_ms(lambda: D._total_cost(big, 1, 0.25), reps=3, warmup=1)}
    print(f"ba CLI point k={BA_CLI_K} {BA_CLI_H}x{BA_CLI_W} stride 1, {n_edges} edges, "
          f"M={BA_CLI_H * BA_CLI_W}, "
          f"6 iterations: {', '.join(f'{t:.1f}' for t in ms)} ms a run, gn_iter_ms "
          f"{best / 6:.2f}, edges_per_sec {n_edges * 6 / (best / 1e3):.0f}, peak "
          f"{peak:.0f} MiB; device ms accumulate {split['accumulate']:.2f}, Schur solve "
          f"{split['solve']:.2f}, cost {split['cost']:.2f}; {gpu}", flush=True)
    del H, b

    # 5) host syncs of one GN iteration (the LM guard's cost included)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            accepts_of(card, 1, stride=2)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()]
    print(f"ba host syncs in one LM-guarded GN iteration at k={BA_K}: {len(syncs)}"
          + (f" ({sorted(set(syncs))[:3]})" if syncs else ""), flush=True)

    # 6) the CLI end to end, on the card by default
    ckpt, frames, gt_dir = ba_cli_checkpoint()
    for c in counters.values():
        c.reset()
    result = infer_video.main(["--checkpoint", ckpt, "--input", str(frames), "--output",
                               str(BA_BUILD / "out"), "--gt-poses", str(gt_dir),
                               "--image-shape", str(SERVE_H), str(SERVE_W), "--ba"])
    launches = {k: c.launches for k, c in counters.items()}
    scales = np.load(BA_BUILD / "out" / "ba_scales.npy")
    accum = TrajectoryAccumulator()
    for mats in result["pose_mats"]:
        accum.add(mats[0], mats[1])
    before = np.stack(accum.trajectory)
    after = np.asarray(json.loads((BA_BUILD / "out" / "trajectory.json").read_text()))
    kf = result["ba"]["keyframes"]
    moved = float(np.abs(after[kf] - before[kf]).max())
    others = [i for i in range(len(after)) if i not in kf]
    line = (f"ba infer_video --ba (no --device) on {result['windows']} windows: keyframes {kf}, "
            f"{result['ba']['edges']} edges, BA {result['ba']['ms']:.1f} ms, scales "
            f"{np.round(scales, 4).tolist()}, keyframe poses moved up to {moved:.3e}, ATE "
            f"{result['ate']}, K1 {launches['K1']} launches")
    if not (np.isfinite(scales).all() and (scales > 0).all() and len(scales) == len(kf)
            and moved > 0 and np.array_equal(after[others], before[others].astype(after.dtype))
            and launches["K1"] == K1_STEPS_PER_REQUEST * result["windows"]):
        fail(line)
    print(line, flush=True)

    # 7) the edge split on two ranks against one process (gloo on this card)
    import multiprocessing
    padded = pad_edges(card, 2)
    job = BA_BUILD / "job.pt"
    torch.save({"problem": [t.cpu() for t in padded], "iters": 6}, job)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ba_rank, args=(r, 2, str(BA_BUILD / "store"), str(job),
                                               str(BA_BUILD))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if codes != [0, 0]:
        fail(f"ba: the two ranks' exit codes {codes}")
    ranks = [torch.load(BA_BUILD / f"rank{r}.pt", map_location="cuda", weights_only=False)
             for r in range(2)]
    one, one_ms = timed_runs(lambda: D.optimize_dense_ba(padded, stride=2, iters=6), reps=1)
    one64 = D.optimize_dense_ba(float64(padded), stride=2, iters=6)
    d32 = [float((a - b).abs().max()) for a, b in zip(ranks[0]["fp32"], one)]
    d64 = [float((a - b).abs().max()) for a, b in zip(ranks[0]["fp64"], one64)]
    same = all(torch.equal(a, b) for key in ("fp32", "fp64")
               for a, b in zip(ranks[0][key], ranks[1][key]))
    line = (f"ba two ranks (gloo, one card) k={BA_K}, {padded.edges_i.shape[0]} edges, against "
            f"one process: fp64 poses {d64[0]:.3e}, log-scales {d64[1]:.3e} (bar {BA_FP64_BAR}); "
            f"fp32 poses {d32[0]:.3e} (bar {BA_FP32_BARS[0]}), log-scales {d32[1]:.3e} (bar "
            f"{BA_FP32_BARS[1]}); ranks bit-equal {same}; {ranks[0]['ms']:.1f} / "
            f"{ranks[1]['ms']:.1f} ms a run a rank against {one_ms[0]:.1f} in one process")
    if not (max(d64) <= BA_FP64_BAR and d32[0] <= BA_FP32_BARS[0]
            and d32[1] <= BA_FP32_BARS[1] and same):
        fail(line)
    print(line, flush=True)
    shutil.rmtree(BA_BUILD, ignore_errors=True)
    print(f"ba: phase {time.perf_counter() - t_start:.1f} s on {gpu}", flush=True)
    return launches


DEMO_BUILD = ROOT / "build" / "demo"
DEMO_FRAMES = 12                           # 10 sliding windows
DEMO_PSNR = 30.0                           # dB, a video frame against its canvas
VIS_FRAMES = 12                            # vis: turntable frames


def demo_inputs():
    """Phase `demo`'s checkpoint (`start_weights` served in fp32, the port's
    own format) and its DEMO_FRAMES rendered frames (PNG), poses (txt) and
    exact depths (uint16 millimetre PNG) under DEMO_BUILD."""
    import numpy as np

    from dro_sfm_torch.inference import save_model
    from dro_sfm_torch.training.trainer import model_config_from
    from dro_sfm_torch.utils.image_io import write_png
    for d in ("frames", "gt", "gt_depth", "two"):
        (DEMO_BUILD / d).mkdir(parents=True, exist_ok=True)
    net = start_weights(model_config_from(trainer_config())).eval()
    net.mixed_precision = False
    path = str(DEMO_BUILD / "net.pt")
    save_model(net, path)
    frames, poses, depths, _ = render_video(DEMO_FRAMES, SERVE_H, SERVE_W)
    for i, (img, T, depth) in enumerate(zip(frames, poses, depths)):
        write_png(str(DEMO_BUILD / "frames" / f"{i:06d}.png"), img)
        if i < 2:
            write_png(str(DEMO_BUILD / "two" / f"{i:06d}.png"), img)
        np.savetxt(DEMO_BUILD / "gt" / f"{i:06d}.txt", T)
        write_png(str(DEMO_BUILD / "gt_depth" / f"{i:06d}.png"),
                  np.clip(depth * 1000, 0, 65535).astype(np.uint16))
    return path, frames


def psnr_db(a, b) -> float:
    import numpy as np
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def phase_demo(counters, gpu):
    """The slice's demo path on the card (phase 29 of the docstring)."""
    import shutil

    import numpy as np

    from dro_sfm_torch.scripts import infer, infer_video, vis
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.image_io import read_png, resize_bilinear_u8
    from dro_sfm_torch.utils.video_io import Mpeg4Encoder, VideoReader
    from dro_sfm_torch.visualization.splat import View, render_points
    t_start = time.perf_counter()
    shutil.rmtree(DEMO_BUILD, ignore_errors=True)
    ckpt, frames = demo_inputs()
    out = DEMO_BUILD / "out"

    # 1) infer_video with both ground truths, its launches counted
    canvases = []
    for c in counters.values():              # the demo path starts here
        c.reset()
    t0 = time.perf_counter()
    result = infer_video.main([
        "--checkpoint", ckpt, "--input", str(DEMO_BUILD / "frames"), "--output", str(out),
        "--gt-poses", str(DEMO_BUILD / "gt"), "--gt-depth", str(DEMO_BUILD / "gt_depth"),
        "--image-shape", str(SERVE_H), str(SERVE_W), "--device", "cuda"], canvases=canvases)
    cli_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}   # and ends here
    windows = result["windows"]
    want = {k: (K1_STEPS_PER_REQUEST * windows if k == "K1" else 0) for k in counters}
    if windows != DEMO_FRAMES - 2 or launches != want:
        fail(f"demo: infer_video ran {windows} windows with launches {launches}, want {want}")

    # 2) the video read back by the port, against the encoder's reconstruction
    # of the composed canvases (cropped to even sides, as the writer crops)
    reader = VideoReader(result["video"])
    video = list(reader)
    h, w = result["frame_size"][0] & ~1, result["frame_size"][1] & ~1
    encoder = Mpeg4Encoder(h, w, reader.fps)
    exact = 0
    for f, c in zip(video, canvases):
        encoder.encode(c[:h, :w])
        exact += bool(np.array_equal(f, encoder.reconstruction()))
    encoder.close()
    sizes = {f.shape for f in video}
    psnrs = [psnr_db(f, c[:h, :w]) for f, c in zip(video, canvases)]
    video_bytes = result["video_bytes"]
    line = (f"demo depth_vis.mp4: {len(video)} frames of {sorted(sizes)} at {reader.fps} fps, "
            f"want {windows} of {result['frame_size']}; bit-equal to the encoder's "
            f"reconstruction {exact}/{len(video)}; PSNR against the canvases min "
            f"{min(psnrs):.2f} dB, mean {sum(psnrs) / len(psnrs):.2f} dB, max "
            f"{max(psnrs):.2f} dB (bar {DEMO_PSNR}); {video_bytes / windows:.1f} bytes a frame")
    if not (len(video) == len(canvases) == windows == exact
            and sizes == {(h, w, 3)} and min(psnrs) >= DEMO_PSNR):
        fail(line)
    print(line, flush=True)

    # 3) the depth panels against the host colormap of depths.npy
    depths = np.load(out / "depths.npy")
    bad = []
    for m, depth in enumerate(depths):
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
        want_panel = resize_bilinear_u8((viz_inv_depth(inv) * 255).astype(np.uint8),
                                        (SERVE_H // 2, SERVE_W // 2))
        if not np.array_equal(read_png(str(out / "panels" / f"depth_{m:06d}.png")), want_panel):
            bad.append(m)
    gtd = sorted((out / "panels").glob("gtd_*.png"))
    if bad or len(gtd) != windows or not np.isfinite(depths).all():
        fail(f"demo: depth panels {bad} differ from viz_inv_depth of depths.npy, or "
             f"{len(gtd)} ground-truth panels for {windows} windows")
    print(f"demo panels: {windows} depth panels bit-equal to the host viz_inv_depth of "
          f"depths.npy, {len(gtd)} ground-truth depth panels, trajectory.png "
          f"{(out / 'trajectory.png').stat().st_size} bytes", flush=True)

    # 4) infer --save viz on two frames
    for c in counters.values():
        c.reset()
    written = infer.main(["--checkpoint", ckpt, "--input", str(DEMO_BUILD / "two"),
                          "--output", str(DEMO_BUILD / "viz"), "--save", "viz",
                          "--image-shape", str(SERVE_H), str(SERVE_W), "--device", "cuda"])
    viz_launches = counters["K1"].launches
    tops = [np.array_equal(read_png(p)[:SERVE_H],
                           ((frames[i].astype(np.float32) / 255.0) * 255).astype(np.uint8))
            for i, p in enumerate(written)]
    if len(written) != 2 or not all(tops) or viz_launches != 2 * K1_STEPS_PER_REQUEST:
        fail(f"demo: infer --save viz wrote {written}, top halves equal {tops}, K1 "
             f"{viz_launches} launches (want {2 * K1_STEPS_PER_REQUEST})")

    # 5) vis: the run's cloud on the card against the CPU, and a timed turntable
    pts, cols = vis.read_ply(str(out / "pointcloud.ply"))
    view = View(pts.min(0), pts.max(0), (vis.SIZE, vis.SIZE), 20.0, 30.0)
    on_card = render_points(torch.tensor(pts, device="cuda"), torch.tensor(cols, device="cuda"),
                            view).cpu()
    on_cpu = render_points(torch.tensor(pts), torch.tensor(cols), view)
    turn = vis.main(["--ply", str(out / "pointcloud.ply"), "--trajectory",
                     str(out / "trajectory.json"), "--output", str(DEMO_BUILD / "turn.mp4"),
                     "--frames", str(VIS_FRAMES), "--device", "cuda"])
    vis_ms = sorted(turn["render_ms"][1:])
    line = (f"demo vis: {len(pts)} points at {vis.SIZE}x{vis.SIZE}, card and CPU "
            f"bit-equal {torch.equal(on_card, on_cpu)} ({int((on_card != 255).any(-1).sum())} "
            f"pixels drawn); turntable of {VIS_FRAMES} frames: median {vis_ms[len(vis_ms) // 2]:.2f} "
            f"ms a frame on the card (host clock around the render and its copy to the host)")
    if not torch.equal(on_card, on_cpu) or len(turn["frames"]) != VIS_FRAMES:
        fail(line)
    print(line, flush=True)

    steady = sorted(result["window_ms"][1:])
    compose = sorted(result["compose_ms"])
    encode = sorted(result["encode_ms"])
    print(f"demo infer_video it12-h-out fp32 {SERVE_H}x{SERVE_W} N=2 B=1 --gt-poses --gt-depth: "
          f"{windows} windows, median {steady[len(steady) // 2]:.2f} ms/window (min "
          f"{steady[0]:.2f}, max {steady[-1]:.2f}); video {result['frame_size'][1]}x"
          f"{result['frame_size'][0]}: compose median {compose[len(compose) // 2]:.2f} ms/frame "
          f"(min {compose[0]:.2f}, max {compose[-1]:.2f}), encode median "
          f"{encode[len(encode) // 2]:.2f} ms/frame (min {encode[0]:.2f}, max {encode[-1]:.2f}), "
          f"{video_bytes / windows:.1f} bytes/frame ({video_bytes} bytes mp4v); CLI "
          f"{cli_s:.1f} s; K1 "
          f"{launches['K1']} launches ({launches['K1'] // windows}/window), infer --save viz K1 "
          f"{viz_launches} on 2 frames; ATE {result['ate']:.4f}; phase "
          f"{time.perf_counter() - t_start:.1f} s on {gpu}", flush=True)
    shutil.rmtree(DEMO_BUILD, ignore_errors=True)
    return launches


SPATIAL_BUILD = ROOT / "build" / "spatial"
SPATIAL_S = 2                              # ranks of the height split, D = 1
SPATIAL_B = 8                              # the global batch of (a)
SPATIAL_TIMED = 1                          # timed steps a case and rank
SPATIAL_TIMEOUT = 600                      # seconds the ranks may take
SPATIAL_PERCEP = 0.1                       # the perceptual case's percep_loss_weight
# The (a) cases' depth: 4 refinement iterations, a cut depth (at it12 a
# rank's step took 3-5 s, and the phase 356 of the script's 1,038 s on an
# H100), but for the perceptual case: its fp32 leaves are held to twice
# fp32's own reach, a bar set at it12, and at it4 the split's refinement
# leaves lie beyond it (1.22e-2 to 2.12e-2 against 1.11e-2 to 1.51e-2).
SPATIAL_VERSION = "it4-h-out"
SPATIAL_PERCEP_VERSION = "it12-h-out"
# (a)'s cases: (task, sep_conv, bf16, perceptual term). SupModelMF on the
# noise batch of `make_train_batch`, the other tasks on rendered scenes
# (`make_scene_batch`), the photometric loss at the config defaults (the
# ``min`` with the automask); SelfSupModel runs the single-frame ResNets.
SPATIAL_CASES = (("SupModelMF", "split", False, False), ("SupModelMF", "split", True, False),
                 ("SupModelMF", "pallas", False, False), ("SupModelMF", "pallas", True, False),
                 ("SelfSupModelMF", "split", True, False),
                 ("SelfSupModelMF", "pallas", True, False),
                 ("SemiSupModelMFPose", "split", True, False),
                 ("SelfSupModel", "split", False, False),
                 ("SelfSupModelMF", "split", False, True))


def spatial_case_version(case):
    return SPATIAL_PERCEP_VERSION if case[3] else SPATIAL_VERSION


def spatial_case_config(task, sep_conv, mixed, percep):
    """`train_config` of an (a) case."""
    from dro_sfm_torch.losses.photometric import PhotometricLossConfig
    photometric = PhotometricLossConfig(percep_loss_weight=SPATIAL_PERCEP if percep else 0.0)
    return train_config(name=task, sep_conv=sep_conv, mixed_precision=mixed,
                        photometric=photometric,
                        version=spatial_case_version((task, sep_conv, mixed, percep)))


def spatial_case_name(case):
    task, sep_conv, mixed, percep = case
    return (f"{task} {sep_conv} {'bf16' if mixed else 'fp32'}"
            + (f" percep {SPATIAL_PERCEP}" if percep else ""))


def spatial_case_inputs(case, job):
    """(state, batch) of an (a) case from the job: the multi-frame nets
    start from `tame_weights`, SelfSupModel from its seed-0 net."""
    task = case[0]
    state = job["states"]["sf" if task == "SelfSupModel" else "mf"]
    return state, job["batches"]["noise" if task == "SupModelMF" else "scenes"]


def spatial_leaves_held(case):
    """Whether (a) holds a case's gradient leaves to one process's at the
    case's own precision. Not in bf16 under the photometric ``min`` over
    views: its near-ties turn bf16 rounding into gradient jumps, so that one
    process's bf16 leaves lie up to 0.83 (relative L2, cosine 0.5) from its
    fp32 twin's (as phase selfsup_e2e prints the default loss's bf16
    gradients only). Not for SelfSupModel in fp32: its pose encoder's batch
    norms feed a spatial mean, whose backward cancels almost wholly, so that
    the order of fp32's sums moves some leaves past 1e-2 at B=8 while one
    process lies within 5e-3 of fp64 there. Such a case's loss, BatchNorm
    statistics, launches and peak are held, and its leaves through a twin at
    the next precision that every rank also steps: the fp32 case
    (`spatial_twin`), or for SelfSupModel the gradient in fp64
    (`spatial_grads64`)."""
    return not (case[0] != "SupModelMF" and case[2]) and case[0] != "SelfSupModel"


def spatial_twin(case):
    """The fp32 case of the same task, GRU path and loss."""
    return (case[0], case[1], False, case[3])


def spatial_grads64(case, state, batch):
    """(loss, gradient leaves on the host) of an (a) case's step computed in
    fp64: the train step's forward, backward and gradient sum, without the
    optimizer or the flip, on this process's band under a height split."""
    from dro_sfm_torch.models.layers import Conv2d
    from dro_sfm_torch.models.sfm import forward_and_loss
    from dro_sfm_torch.parallel import spatial
    from dro_sfm_torch.parallel.collectives import average_gradients
    from dro_sfm_torch.parallel.mesh import current_layout
    cfg = spatial_case_config(*case)
    net = cfg.build_net(device=batch["rgb"].device)
    net.load_state_dict(state, strict=True)
    net.double()
    for m in net.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = torch.float64
    batch = {k: v.double() for k, v in batch.items()}
    band = spatial.band_for(current_layout(), batch["rgb"].shape[1], cfg.deepest_stride)
    with spatial.active(band):
        loss, _ = forward_and_loss(cfg, net, batch, None, do_flip=False)
        loss.backward()
    average_gradients(net.parameters())
    return loss.item(), {k: p.grad.detach().cpu() for k, p in net.named_parameters()}


def train_launches(version, pallas):
    """The launches of one train step of ``version``: K1 and K2 in every
    refinement step, K3 in all but the first depth and pose step of each
    outer iteration, and with "pallas" K5, K6-input and K6-weight twice a
    step (`TRAIN_LAUNCHES_PALLAS` at it12)."""
    from dro_sfm_torch.models.depth_pose_net import VersionSpec
    spec = VersionSpec.parse(version)
    steps = 2 * spec.total_iters
    out = {"K1": steps, "K2": steps, "K3": steps - 2 * spec.outer_iters}
    if pallas:
        out.update({k: 2 * steps for k in ("K5", "K6-input", "K6-weight")})
    return out


def spatial_case_launches(case):
    """The launches a step of an (a) case must make."""
    if case[0] == "SelfSupModel":
        return {}
    return train_launches(spatial_case_version(case), case[1] == "pallas")


def spatial_trainer_config(tag, shards, config=TRAINER_CONFIG):
    """`trainer_config` of ``config`` (2 steps of B=8, one B=4 validation
    batch) at 192x640 and fp32 with ``arch.spatial_shards`` = ``shards``,
    files under ``build/spatial/<tag>``; evaluation only for ``shards`` =
    1."""
    cfg = trainer_config(max_epochs=1, config=config)
    cfg.arch.spatial_shards = shards
    cfg.datasets.augmentation.image_shape = (SERVE_H, SERVE_W)
    cfg.model.depth_net.mixed_precision = False
    cfg.checkpoint.filepath = str(SPATIAL_BUILD / tag / "ckpt")
    cfg.save.folder = str(SPATIAL_BUILD / tag / "depth")
    if shards == 1:
        cfg.datasets.train.dataset = []
    return cfg


# (c)'s Trainers: tag -> config
SPATIAL_TRAINERS = {"split": TRAINER_CONFIG, "split_selfsup": SELFSUP_CONFIG}


def spatial_rank(rank, world, store, job_path, out_dir):
    """One rank of the height split on the card (gloo, the same card for
    both): (a) each case of `SPATIAL_CASES` one counted step on this rank's
    band (its exchanges by function, from a host profile), its peak memory,
    timed steps, a step's host syncs; (c) `Trainer.fit` of each
    `SPATIAL_TRAINERS` config. Waits for ``go`` beside the job before any
    work on the card. Writes ``out_dir/rank<R>.pt``."""
    import datetime
    import gc

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=200))
    try:
        from dro_sfm_torch.parallel import spatial
        from dro_sfm_torch.parallel.mesh import make_layout
        from dro_sfm_torch.training.trainer import Trainer
        layout = make_layout(SPATIAL_S)
        counters = counter_map()
        go = Path(job_path).with_name("go")
        while not go.exists():
            time.sleep(0.2)
        stages, last = {}, [time.perf_counter()]

        def lap(stage):
            """Seconds since the last lap, summed by stage."""
            now = time.perf_counter()
            stages[stage] = stages.get(stage, 0.0) + now - last[0]
            last[0] = now

        job = torch.load(job_path, map_location="cuda", weights_only=False)
        bands = {k: spatial.split_rows(v, layout) for k, v in job["batches"].items()}
        out = {"rows": bands["noise"]["rgb"].shape[1], "steps": {}, "trainers": {},
               "stages": stages}
        lap("job")
        for case in SPATIAL_CASES:
            state, _ = spatial_case_inputs(case, job)
            band = bands["noise" if case[0] == "SupModelMF" else "scenes"]
            gc.collect()                         # the last case's net and Adam
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            lap("inputs and gc")
            for c in counters.values():          # the split step's path starts here
                c.reset()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                net, step, state, metrics, grads, after = dist_step(
                    spatial_case_config(*case), state, band, flip_generator_for(rank != 0))
            launches = {k: c.launches for k, c in counters.items()}   # and ends here
            lap("counted step")
            exchanges = {k: calls for k, (calls, _) in span_table(prof).items()}
            lap("profile tables")
            peak = torch.cuda.max_memory_allocated()
            flips, times = torch.Generator().manual_seed(5), []
            for _ in range(SPATIAL_TIMED):
                ms, syncs = timed_syncs(lambda: step(state, band, flips))
                times.append(ms)
            lap("timed steps")
            out["steps"][case] = {"launches": launches, "peak": peak, "ms": times,
                                  "exchanges": exchanges, "syncs": syncs,
                                  "step": on_host(metrics, grads, after)}
            del net, step, state
            lap("to the host")
            if not spatial_leaves_held(case):    # its leaves, held through a twin
                gc.collect()
                torch.cuda.empty_cache()
                start = spatial_case_inputs(case, job)[0]
                out["steps"][case]["twin"] = (
                    on_host(*dist_step(spatial_case_config(*spatial_twin(case)), start, band,
                                       flip_generator_for(rank != 0))[3:])
                    if case[2] else spatial_grads64(case, start, band))
                lap("twins")
        # (c) the Trainers from the yaml configs, from the job's weights
        for tag, config in SPATIAL_TRAINERS.items():
            gc.collect()
            torch.cuda.empty_cache()
            lap("inputs and gc")
            trainer = Trainer(spatial_trainer_config(tag, SPATIAL_S, config), device="cuda")
            trainer.net.load_state_dict(job["states"]["mf"], strict=True)
            lap("Trainer()")
            train = trainer.train_step = CountedStep(trainer.train_step, counters, timed=True)
            # the validation as the one process's is run (phase spatial (c))
            evaluate = CountedStep(deterministic_step(trainer.eval_step_for(False)), counters)
            trainer._eval_steps[False] = evaluate
            for c in counters.values():          # the split trainer's path starts here
                c.reset()
            t0 = time.perf_counter()
            metrics = trainer.fit()
            fit_s = time.perf_counter() - t0
            out["trainers"][tag] = {
                "metrics": metrics, "s": fit_s, "ms": train.ms,
                "launches": {k: c.launches for k, c in counters.items()},
                "step_launches": train.launches, "eval_launches": evaluate.launches,
                "saved": [p for _, p in trainer.checkpointer.saved]}
            del trainer, train, evaluate
            lap("fit()")
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def host_syncs(fn):
    """The host synchronisations with the card during ``fn()`` (torch's sync
    debug mode), counted by the line that made them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                               if "synchroniz" in str(w.message).lower())


def timed_syncs(fn):
    """(ms, `host_syncs`) of ``fn()``, from its start to the card's end."""
    start = []
    syncs = host_syncs(lambda: (start.append(time.perf_counter()), fn()))
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - start[0]), syncs


def on_host(metrics, grads, after):
    """A step's results with its tensors moved to the host (off the peaks
    of the next cases)."""
    return (metrics, {k: v.cpu() for k, v in grads.items()},
            {k: v.cpu() for k, v in after.items()})


def spatial_band_inputs(gen, b, n, h, hb, w, c, dtype, r0):
    """K1-K3 at a band's shapes: f1 [b, hb*w, c] (the band's pixels),
    features [b*n, h, w, c] (the gathered context maps), coords [b*n, hb*w, 2]
    whose x is the band's grid with 1.5 px of noise and whose y falls
    anywhere from 2 rows above the view to 2 below it, so that every row of
    the view and the outside are sampled."""
    dev = "cuda"
    p = hb * w
    f1 = torch.randn(b, p, c, generator=gen, device=dev).to(dtype)
    features = torch.randn(b * n, h, w, c, generator=gen, device=dev).to(dtype)
    gx = torch.arange(w, device=dev).repeat(hb).float()
    x = gx + 1.5 * torch.randn(b * n, p, generator=gen, device=dev)
    y = -2.0 + (h + 3.0) * torch.rand(b * n, p, generator=gen, device=dev)
    y[:, :w] = r0 + 0.25            # and the band's own first row
    return f1, features, torch.stack([x, y], -1).contiguous()


def phase_spatial_kernels(gen):
    """(b): K1-K3 at the band shapes of (a) (B=2, N=2, 12 of 24 rows of 80,
    C=128, both bands) and K5/K6 axis 1 on the bands widened by 4 rows each
    side (depth B=2 and pose B*N=4, 20x80), bf16 and fp32, against their
    plain versions at the bars of phases k1, k23 and gru; the bf16 times."""
    from dro_sfm_torch.ops import gru_pass
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff,
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
        warp_diff_plain,
    )
    h, w, c, hb = SERVE_H // 8, SERVE_W // 8, 128, SERVE_H // 8 // SPATIAL_S
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for band in range(SPATIAL_S):
            f1, features, coords = spatial_band_inputs(gen, SPATIAL_B, VIEWS, h, hb, w, c,
                                                       dtype, band * hb)
            rows = torch.unique(coords[..., 1].floor().long().clamp(-1, h))
            if rows.numel() != h + 2:
                fail(f"spatial (b): the band's coordinates sample {rows.numel()} of "
                     f"{h + 2} rows")
            g = torch.randn(SPATIAL_B * VIEWS, hb * w, c, generator=gen, device="cuda").to(dtype)
            out = warp_diff(f1, features, coords, VIEWS)
            d_feat = warp_diff_bwd_feat(coords, g, h, w, dtype)
            d_co = warp_diff_bwd_coords(features, coords, g)
            torch.cuda.synchronize()
            ref = warp_diff_plain(f1, features, coords, VIEWS)
            ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype)
            ref_co = warp_diff_bwd_coords_plain(features, coords, g)
            errs = {"K1": (out.float() - ref.float()).abs().max().item(),
                    "K2": (d_feat.float() - ref_feat.float()).abs().max().item(),
                    "K3": (d_co - ref_co).abs().max().item()}
            tols = {"K1": k1_tolerance(dtype, ref),
                    "K2": k2_tolerance(coords, g, h, w, dtype, ref_feat),
                    "K3": k3_tolerance(features, coords, g)}
            line = (f"spatial (b) band {band} of {SPATIAL_S}: K1-K3 P={hb}x{w} against "
                    f"{SPATIAL_B * VIEWS}x{h}x{w}x{c} {dt}: " + ", ".join(
                        f"{k} max_abs_err {errs[k]:.3e} tol {tols[k]:.3e}" for k in errs))
            if any(errs[k] > tols[k] for k in errs) or not all(
                    torch.isfinite(t).all() for t in (out, d_feat, d_co)):
                fail(line)
            if dtype == torch.bfloat16 and band == SPATIAL_S - 1:
                calls = {"K1": (lambda: warp_diff(f1, features, coords, VIEWS),
                                lambda: warp_diff_plain(f1, features, coords, VIEWS),
                                k1_bound(f1, features, coords)),
                         "K2": (lambda: warp_diff_bwd_feat(coords, g, h, w, dtype),
                                lambda: warp_diff_bwd_feat_plain(coords, g, h, w, dtype),
                                k2_bound(coords, g, h, w, dtype)),
                         "K3": (lambda: warp_diff_bwd_coords(features, coords, g),
                                lambda: warp_diff_bwd_coords_plain(features, coords, g),
                                k3_bound(features, coords, g))}
                for k, (kernel, plain, (bound, by)) in calls.items():
                    timings[k] = {"max_abs_err": errs[k], "ms": time_ms(kernel),
                                  "plain_ms": time_ms(plain, reps=5, warmup=1),
                                  "bound_ms": bound, "bound_by": by}
                line += " | " + ", ".join(
                    f"{k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} bound "
                    f"{v['bound_ms']:.4f} ({v['bound_by']})" for k, v in timings.items())
            print(line, flush=True)
        for what, b in (("depth", SPATIAL_B), ("pose", SPATIAL_B * VIEWS)):
            inp = gru_inputs(gen, b, hb + 8, w, GRU_D, GRU_CX, dtype)
            args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
            out = gru_pass.gru_pass_fwd(*args, 1)
            grads = gru_pass.gru_pass_bwd(*args, inp["g"], 1)
            torch.cuda.synchronize()
            ref = gru_pass.gru_pass_plain(*args, 1)
            refs = gru_pass.gru_pass_bwd_plain(*args, inp["g"], 1)
            bars = gru_bars(dtype)

            def rel(a, r):
                return (a.float() - r.float()).abs().max().item() / max(
                    r.float().abs().max().item(), 1e-30)

            errs = {"K5": rel(out, ref)}
            bad = errs["K5"] > bars["fwd"]
            for name, got, want in zip(GRU_GRADS, grads, refs):
                errs[name] = rel(got, want)
                bad |= errs[name] > bars["act" if name in ("dh", "dx") else "weight"]
            line = (f"spatial (b) K5/K6 axis 1 on the widened band, {what} {b}x{hb + 8}x{w} "
                    f"D={GRU_D} Cx={GRU_CX} {dt}: " + " ".join(
                        f"{k} {v:.2e}" for k, v in errs.items())
                    + f" (bars {bars['fwd']:.1e}, {bars['act']:.1e}, {bars['weight']:.1e})")
            if bad or not torch.isfinite(out).all():
                fail(line)
            if dtype == torch.bfloat16 and what == "depth":
                r = time_gru(inp, 1, gru_pass, gru_intermediates(inp, 1, gru_pass))
                for k in r:
                    r[k]["max_abs_err"] = max(errs[n] for n in (
                        ("K5",) if k == "K5" else ("dh", "dx") if k == "K6-input"
                        else GRU_GRADS[2:]))
                    timings[k] = r[k]
                line += "".join(f" | {k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} "
                                f"bound {v['bound_ms']:.4f}" for k, v in r.items())
            print(line, flush=True)
    return timings


def spatial_reference(case, state, batch, timed=SPATIAL_TIMED):
    """One process's step of an (a) case on the whole batch: its results on
    the host, peak bytes and ms of ``timed`` more steps."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, step, train_state, metrics, grads, after = dist_step(
        spatial_case_config(*case), state, batch, None, do_flip=False)
    peak = torch.cuda.max_memory_allocated()
    flips, times = torch.Generator().manual_seed(5), []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, _ = step(train_state, batch, flips)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    del net, step, train_state
    return {"step": on_host(metrics, grads, after), "peak": peak, "ms": times}


def spatial_verdicts(ranks, refs, own, reach, counters, gpu):
    """(a)'s problems: each case of every rank against one process, as
    phase_spatial sets out; every line printed before a failure."""
    problems = []
    for case in SPATIAL_CASES:
        name, want, ref = spatial_case_name(case), spatial_case_launches(case), refs[case]
        for r, res in enumerate(ranks):
            got = res["steps"][case]
            if got["launches"] != {k: want.get(k, 0) for k in counters}:
                problems.append(f"rank {r} {name} step launches {got['launches']}, want {want}")
            twin = spatial_twin(case)

            def leaf(key, worst):
                return (f"{worst[0]:.3e} ({worst[1]}" + (
                    f", fp32's own reach there {reach[key].get(worst[1], 0.0):.3e}"
                    if key in reach else "") + ")")

            failures, worst, rel = dist_verdict(got["step"], ref["step"], own.get(case),
                                                reach.get(case))
            leaves = f"worst leaf rel L2 {leaf(case, worst)}"
            if not spatial_leaves_held(case):
                failures = [f for f in failures if f.startswith("loss ") or "beyond" in f]
                if case[2]:
                    more, held, _ = dist_verdict(got["twin"], refs[twin]["step"],
                                                 reach=reach[twin])
                else:
                    more, held = verdict64(got["twin"], ref["fp64"])
                failures += [f"{'fp32' if case[2] else 'fp64'} twin: {f}" for f in more]
                leaves = (f"leaves printed only, worst {leaf(case, worst)}; its "
                          f"{'fp32' if case[2] else 'fp64'} twin's worst leaf rel L2 "
                          f"{leaf(twin, held)}")
            if failures:
                problems.append(f"rank {r} {name} against one process: {failures[:6]}")
            if not got["peak"] < ref["peak"]:
                problems.append(f"rank {r} {name} peak {got['peak']} bytes, one process "
                                f"{ref['peak']}")
            print(f"spatial (a) rank {r} of {SPATIAL_S} on one card (gloo), {name}, "
                  f"{spatial_case_version(case) + ' ' if case[0] != 'SelfSupModel' else ''}"
                  f"192x640 "
                  f"B={SPATIAL_B} "
                  f"N={VIEWS}, {SERVE_H // SPATIAL_S} rows a rank, against one process: loss "
                  f"{got['step'][0]['loss']:.6f} vs {ref['step'][0]['loss']:.6f} (relative "
                  f"{rel:.2e}), {leaves}; launches {got['launches']}; exchanges a step "
                  f"{sum(got['exchanges'].values())} ("
                  + ", ".join(f"{k} {n}" for k, n in sorted(got["exchanges"].items()))
                  + f"); host syncs a step {sum(got['syncs'].values())} ("
                  + (", ".join(f"{k} {n}x" for k, n in got["syncs"].most_common(4)) or "none")
                  + f"); ms a step "
                  f"{' / '.join(f'{v:.2f}' for v in got['ms'])} (one process "
                  f"{' / '.join(f'{v:.2f}' for v in ref['ms'])}); peak "
                  f"{got['peak'] / 2**20:.1f} MiB (one process {ref['peak'] / 2**20:.1f} MiB); "
                  f"on {gpu}", flush=True)
        a, b = ranks[0]["steps"][case]["step"], ranks[1]["steps"][case]["step"]
        if not (all(torch.equal(a[1][k], b[1][k]) for k in a[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2])):
            problems.append(f"the ranks' gradients or parameters after Adam differ ({name})")
    return problems


def verdict64(result, ref):
    """(failures, (worst rel L2, its leaf)) of a rank's `spatial_grads64`
    against one process's: the loss within 1e-12 relative and each leaf
    within 1e-8, fp64's rounding amplified by the backward's cancellations
    (2e-16 and 2e-13 on the CPU at 64x96)."""
    (loss, grads), (ref_loss, ref_grads) = result, ref
    worst = max((e, k) for k, e in leaf_errors(grads, ref_grads).items())
    rel = abs(loss - ref_loss) / abs(ref_loss)
    failures = [] if rel <= 1e-12 else [f"loss {loss!r} vs {ref_loss!r}"]
    return failures + [f"{k} rel L2 {e:.3e}" for k, e in leaf_errors(grads, ref_grads).items()
                       if not e <= 1e-8], worst


def phase_spatial(counters, gpu):
    """The height split (see the module docstring, phase 30)."""
    import multiprocessing
    import shutil

    from dro_sfm_torch.training.metrics import POSE_METRIC_NAMES
    from dro_sfm_torch.training.trainer import Trainer
    shutil.rmtree(SPATIAL_BUILD, ignore_errors=True)
    SPATIAL_BUILD.mkdir(parents=True)
    t_phase = time.perf_counter()
    sf = spatial_case_config("SelfSupModel", "split", False, False)
    job = {"states": {"mf": tame_weights(start_weights(train_config()).state_dict()),
                      "sf": start_weights(sf).state_dict()},
           "batches": {"noise": make_train_batch(SPATIAL_B, seed=6),
                       "scenes": make_scene_batch(SPATIAL_B, seed=6)}}
    job_path = SPATIAL_BUILD / "job.pt"
    torch.save({part: {name: {k: v.cpu() for k, v in d.items()} for name, d in job[part].items()}
                for part in job}, job_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=spatial_rank, args=(
        r, SPATIAL_S, str(SPATIAL_BUILD / "gloo_store"), str(job_path), str(SPATIAL_BUILD)))
        for r in range(SPATIAL_S)]
    for p in procs:                            # they start up while the references run
        p.start()
    deadline = time.monotonic() + SPATIAL_TIMEOUT
    try:
        timings = phase_spatial_kernels(torch.Generator(device="cuda").manual_seed(7))
        # (a)'s references: one process on the whole batch, peak and ms;
        # each bf16 case's fp32 twin (its leaves' own error, and the
        # reference of the ranks' fp32 step where its bf16 leaves are not
        # held), SelfSupModel's fp64 gradient; for each fp32 step of the
        # multi-frame photometric loss the step on the samples in reverse
        # order (fp32's reach on each leaf, which the ``min``'s near-ties
        # widen)
        refs, own, reach = {}, {}, {}
        for case in SPATIAL_CASES:
            state, batch = spatial_case_inputs(case, job)
            refs[case] = spatial_reference(case, state, batch)
        for case in SPATIAL_CASES:
            state, batch = spatial_case_inputs(case, job)
            twin = spatial_twin(case)
            if case[2]:
                if twin not in refs:
                    refs[twin] = spatial_reference(twin, state, batch, 0)
                own[case] = leaf_errors(refs[case]["step"][1], refs[twin]["step"][1])
            if not spatial_leaves_held(case) and not case[2]:
                refs[case]["fp64"] = spatial_grads64(case, state, batch)
            elif case[0] != "SupModelMF" and (twin == case or not spatial_leaves_held(case)):
                flipped = {k: v.flip(0) for k, v in batch.items()}
                reach[twin] = leaf_errors(spatial_reference(twin, state, flipped, 0)["step"][1],
                                          refs[twin]["step"][1])
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t_phase
        (SPATIAL_BUILD / "go").touch()         # the ranks' work on the card starts here
        t_go = time.perf_counter()
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung or codes != [0] * SPATIAL_S:
        fail(f"spatial: ranks {hung} still ran after {SPATIAL_TIMEOUT} s, exit codes {codes}")
    ranks_s = time.perf_counter() - t_go
    t0 = time.perf_counter()
    ranks = [torch.load(SPATIAL_BUILD / f"rank{r}.pt", weights_only=False)
             for r in range(SPATIAL_S)]
    load_s = time.perf_counter() - t0
    if [r["rows"] for r in ranks] != [SERVE_H // SPATIAL_S] * SPATIAL_S:
        fail(f"spatial: rows a rank {[r['rows'] for r in ranks]}")

    # (a) each case against one process
    problems = spatial_verdicts(ranks, refs, own, reach, counters, gpu)
    if problems:
        fail(f"spatial: {problems}")

    # (c) the Trainers: launches, and each validation against one process
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for tag, config in SPATIAL_TRAINERS.items():
        for r, res in enumerate(ranks):
            tr = res["trainers"][tag]
            check_launches(f"spatial rank {r} {tag} train step", tr["step_launches"],
                           TRAIN_LAUNCHES, counters)
            check_launches(f"spatial rank {r} {tag} eval batch", tr["eval_launches"],
                           EVAL_LAUNCHES, counters)
            if len(tr["step_launches"]) != 2 or len(tr["eval_launches"]) != 1:
                fail(f"spatial: rank {r} {tag} {len(tr['step_launches'])} steps, "
                     f"{len(tr['eval_launches'])} eval batches")
            check_finite(f"spatial rank {r} {tag} fit()", tr["metrics"])
        (ckpt,) = ranks[0]["trainers"][tag]["saved"]
        if ranks[1]["trainers"][tag]["saved"]:
            fail(f"spatial: rank 1 wrote a {tag} checkpoint")
        # both validations under the deterministic algorithms (the ranks' in
        # spatial_rank): each side's sums then fall in one order, run to run
        def one_process(batch_size):
            cfg = spatial_trainer_config(f"one_{tag}", 1, config)
            cfg.datasets.validation.batch_size = batch_size
            with deterministic_algorithms():
                return Trainer(cfg, resume=ckpt, device="cuda").validate()
        single = one_process(4)
        gaps, over = {}, []
        for k, v in single.items():
            got = ranks[0]["trainers"][tag]["metrics"][k]
            if ranks[1]["trainers"][tag]["metrics"][k] != got:
                fail(f"spatial: the ranks' {tag} validation {k} differ")
            gaps[k] = abs(got - v) / max(abs(v), 1e-12)
            if not abs(got - v) <= 1e-5 * abs(v) + 1e-7:         # phase dist_trainer's bar
                over.append(k)
        # fp32's own reach on this checkpoint, as (a) measures it on samples
        # in another order: the one process's validation a sample at a time,
        # its convolutions' sums in another order (cuDNN picks its algorithm
        # by shape); a depth metric past phase dist_trainer's bar is held to
        # twice it. The pose metrics are computed over a batch's poses
        # together, so a sample at a time is no reach for them: they keep
        # the bar.
        free = one_process(1)
        reach = {k: abs(free[k] - v) / max(abs(v), 1e-12) for k, v in single.items()
                 if not k.startswith(POSE_METRIC_NAMES)}
        for k in over:
            if not gaps[k] <= 2 * reach.get(k, 0.0):
                fail(f"spatial: {tag} validation {k} {ranks[0]['trainers'][tag]['metrics'][k]!r}"
                     f", one process {single[k]!r}: relative gap {gaps[k]:.3e} over the bar "
                     f"1e-5 and over twice fp32's reach {reach[k]:.3e}")
        tr = ranks[0]["trainers"][tag]
        print(f"spatial (c) Trainer, {config.stem} at 192x640 fp32 with arch.spatial_shards: "
              f"{SPATIAL_S} on {SPATIAL_S} ranks (gloo, one card), from tame_weights: fit() "
              f"{tr['s']:.1f} s, ms a step {' / '.join(f'{v:.2f}' for v in tr['ms'])}, launches "
              f"over fit() {tr['launches']}; its validation against one process on its "
              f"checkpoint, both under the deterministic algorithms: abs_rel_pp_gt "
              f"{tr['metrics']['abs_rel_pp_gt']!r} vs {single['abs_rel_pp_gt']!r}; relative gap "
              f"by metric " + ", ".join(f"{k} {g:.2e}" for k, g in gaps.items())
              + f" (bar 1e-5 relative + 1e-7 on every metric, as phase dist_trainer; past it, "
              f"twice fp32's reach: the one process at B=1 against B=4, by depth metric "
              + ", ".join(f"{k} {r:.2e}" for k, r in reach.items() if r)
              + f"; {len(over)} past the bar); on {gpu}", flush=True)
    print(f"spatial: references and (b) {refs_s:.1f} s, the ranks' run after go "
          f"{ranks_s:.1f} s; rank 0's seconds by stage: " + ", ".join(
              f"{k} {v:.1f}" for k, v in ranks[0]["stages"].items())
          + f"; the ranks' results loaded in {load_s:.1f} s", flush=True)
    shutil.rmtree(SPATIAL_BUILD, ignore_errors=True)
    torch.cuda.empty_cache()
    steps = ranks[0]["steps"]
    return steps[("SupModelMF", "pallas", True, False)]["launches"], timings, {
        "self-supervised": steps[("SelfSupModelMF", "pallas", True, False)]["launches"]}


# --- stride4: the stride-4 feature net, DepthPoseNet(feat_ratio=4) -----------

STRIDE4 = 4
STRIDE4_REQUESTS = 5                       # timed requests a batch and GRU path
STRIDE4_STEPS = 2                          # a warm-up and a timed step a GRU path
STRIDE4_SPLIT_FACTOR = 2.0                 # bf16 K5/K6 leaves: x the split path's distance


def stride4_net(cfg=None, state=None):
    """`DepthPoseNet(feat_ratio=4)` on the card with ``cfg``'s settings
    (default `train_config()`): ``state`` loaded strictly, else the seed-0
    weights with the heads scaled as `start_weights` scales them. No config
    sets ``feat_ratio``, so the net is built here and handed to the entry
    points (`make_infer_fn`, `make_train_step`)."""
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    cfg = cfg or train_config()
    net = DepthPoseNet(version=cfg.version, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
                       feat_ratio=STRIDE4, mixed_precision=cfg.mixed_precision,
                       warp_impl=cfg.warp_impl, sep_conv=cfg.sep_conv, remat=cfg.remat,
                       device="cuda", generator=torch.Generator().manual_seed(0))
    if state is None:
        return scale_heads(net)
    net.load_state_dict(state, strict=True)
    return net


def stride4_serving(counters, gpu, start, requests):
    """(1) B=1 and B=8 requests through `make_infer_fn` with either GRU
    path, every count reset just before and read just after each batch's
    requests: K1 24 a request, K5 48 with "pallas", nothing else. Returns
    the launches and the median ms by (GRU path, B)."""
    from dro_sfm_torch.inference import make_infer_fn
    launches, ms = {k: 0 for k in counters}, {}
    for sep in ("split", "pallas"):
        infer = make_infer_fn(stride4_net(train_config(sep_conv=sep), start), device="cuda")
        want = {"K1": K1_STEPS_PER_REQUEST,
                **({"K5": 2 * K1_STEPS_PER_REQUEST} if sep == "pallas" else {})}
        for b, req in requests.items():
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():      # the stride-4 serving path starts here
                c.reset()
            times = []
            for i in range(STRIDE4_REQUESTS + 1):           # one warm-up request
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                depth, mats = infer(*req)
                torch.cuda.synchronize()
                if i:
                    times.append(1e3 * (time.perf_counter() - t0))
            got = {k: c.launches for k, c in counters.items()}   # and ends here
            n = STRIDE4_REQUESTS + 1
            per = {k: v // n for k, v in got.items() if v}
            if per != want or any(v % n for v in got.values()):
                fail(f"stride4 serving {sep} B={b}: launches {got} over {n} requests, "
                     f"want {want} each")
            if depth.shape != (b, SERVE_H, SERVE_W) or mats.shape != (b, VIEWS, 4, 4):
                fail(f"stride4 serving B={b}: shapes {tuple(depth.shape)}, {tuple(mats.shape)}")
            if not (torch.isfinite(depth).all() and torch.isfinite(mats).all()):
                fail(f"stride4 serving {sep} B={b}: non-finite output")
            if not ((depth >= 0.2 - 1e-4) & (depth <= 80.0 + 1e-2)).all():
                fail(f"stride4 serving {sep} B={b}: depth outside [min_depth, max_depth]")
            for k in counters:
                launches[k] += got[k]
            times.sort()
            ms[sep, b] = times[len(times) // 2]
            print(f"stride4 serving it12-h-out bf16 192x640 feat_ratio=4 (maps 48x160) N=2 "
                  f"B={b} sep_conv={sep}: median {ms[sep, b]:.2f} ms/request (min "
                  f"{times[0]:.2f}, max {times[-1]:.2f}, {STRIDE4_REQUESTS} requests) "
                  f"{1e3 * b / ms[sep, b]:.1f} frames/s, launches/request {per}, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB on {gpu}", flush=True)
    return launches, ms


def stride4_training(counters, gpu, tame):
    """(3) The B=8 SupModelMF step (bf16, phase 8's memory policy: no remat,
    so K1 runs once a refinement step) through `make_train_step`
    from ``tame`` with either GRU path: a warm-up and a timed step, every
    count reset just before and read just after, each step's launches K1
    24, K2 24, K3 18 (K5, K6-input, K6-weight 48 with "pallas"). Returns the
    launches, ms a step and peak MiB by GRU path. A third step, outside the
    counts, is profiled (`profile_train_step`)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    batch = make_train_batch(TRAIN_B)
    launches, ms, peak = {k: 0 for k in counters}, {}, {}
    for sep, want in (("split", TRAIN_LAUNCHES), ("pallas", TRAIN_LAUNCHES_PALLAS)):
        cfg = train_config(sep_conv=sep)
        net = stride4_net(cfg, tame)
        opt = make_optimizer(net, steps_per_epoch=1000)
        state = create_train_state(net, opt, device="cuda")
        train_step = make_train_step(cfg, net, opt, device="cuda")
        want = {k: want.get(k, 0) for k in counters}
        flips = torch.Generator().manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():          # the stride-4 training path starts here
            c.reset()
        for i in range(STRIDE4_STEPS):
            start = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch, flips)
            loss = metrics["loss"].item()
            step_ms = 1e3 * (time.perf_counter() - t0)
            got = {k: c.launches - start[k] for k, c in counters.items()}
            if got != want:
                fail(f"stride4 train step {i} sep_conv={sep}: launches {got}, want {want}")
            if not math.isfinite(loss):
                fail(f"stride4 train step {i} sep_conv={sep}: loss {loss}")
        for k, c in counters.items():        # and ends here
            launches[k] += c.launches
        ms[sep], peak[sep] = step_ms, torch.cuda.max_memory_allocated() / 2**20
        print(f"stride4 training SupModelMF it12-h-out bf16 remat={cfg.remat} 192x640 "
              f"feat_ratio=4 N=2 "
              f"B={TRAIN_B} sep_conv={sep} at tame weights: {ms[sep]:.2f} ms/step (the "
              f"second of {STRIDE4_STEPS}), {1e3 * TRAIN_B / ms[sep]:.1f} frames/s, peak "
              f"{peak[sep]:.0f} MiB, launches/step {got}, loss {loss:.4f} on {gpu}",
              flush=True)
        print(f"stride4 profile sep_conv={sep}:", flush=True)
        profile_train_step(state, train_step, batch)
        del net, opt, state, train_step
        torch.cuda.empty_cache()
    return launches, ms, peak


def stride4_gradients(tame):
    """(3) One B=8 step's gradients (flip off, deterministic library
    algorithms; remat, which recomputes each refinement step in the
    backward, to hold fp32 at B=8 in memory) at ``tame``.

    K1-K3 against the plain warp at phase 9's bars (fp32 1e-4 and cosine
    0.99999; bf16 `compare_grads`).

    K5/K6 against the plain GRU pass at phase 15's bars in fp32: max(1e-4,
    4 x the split path's worst distance to the plain pass). In bf16 phase
    15's bar (`compare_grads`, 0.25 of bf16's own error on noisy leaves)
    rejects the split path too at stride 4: cuDNN's bf16 gradients lie
    0.64 of bf16's own error from the plain pass on the encoders' leaves,
    as far as the kernel's (`tools/torch_gru_bf16_reach.py`). So a leaf's
    bf16 bar is the larger of phase 15's and twice the split path's
    distance to the plain pass on that leaf (STRIDE4_SPLIT_FACTOR). The
    planted faults of phase 15 (K5 or K6 leaving out tap 0 of Wq) must fail
    both precisions' bars."""
    from dro_sfm_torch.ops import gru_pass
    batch = make_train_batch(TRAIN_B, seed=2)
    kernel_gru = (gru_pass.gru_pass_fwd, gru_pass.gru_pass_bwd)
    runs = {"kernels": ("pallas", "split", kernel_gru),      # also the split path
            "plain warp": ("gather", "split", kernel_gru),
            "K5/K6": ("pallas", "pallas", kernel_gru),
            "plain GRU pass": ("pallas", "pallas",
                               (gru_pass.gru_pass_plain, gru_pass.gru_pass_bwd_plain)),
            "K5 fault": ("pallas", "pallas", (without_wq_tap0(kernel_gru[0]), kernel_gru[1])),
            "K6 fault": ("pallas", "pallas", (kernel_gru[0], without_wq_tap0(kernel_gru[1])))}
    grads = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        for mp in (False, True):
            for name, (impl, sep, swap) in runs.items():
                cfg = train_config(mixed_precision=mp, warp_impl=impl, sep_conv=sep,
                                   remat=True)
                with swapped_gru(gru_pass, *swap):
                    grads[mp, name] = train_gradients(cfg, tame, batch, STRIDE4)[0]
                torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
    plain = "plain GRU pass"
    _, _, floor, _ = compare_grads(grads[False, "kernels"], grads[False, plain])
    gru_bar = max(1e-4, GRU_E2E_FLOOR_FACTOR * floor[0])
    split16 = {k: STRIDE4_SPLIT_FACTOR * rel_l2(grads[True, "kernels"][k], ref)
               for k, ref in grads[True, plain].items() if ref.norm().item() > 0}
    failed = []
    for got, ref, what in (("kernels", "plain warp", "K1-K3 vs plain warp"),
                           ("K5/K6", plain, "K5/K6 vs plain GRU pass"),
                           ("K5 fault", plain, "planted K5 fault vs plain GRU pass"),
                           ("K6 fault", plain, "planted K6 fault vs plain GRU pass")):
        gru = ref == plain
        for mp, dt in ((False, "fp32"), (True, "bf16")):
            beyond, relaxed, worst, worst_cos = compare_grads(
                grads[mp, got], grads[mp, ref], grads[False, ref] if mp else None,
                gru_bar if gru else 1e-4, split16 if gru and mp else None)
            fault = "fault" in got
            if not fault:
                for k, r, cos, own_err, b in beyond:
                    print(f"  beyond its bar: {k} rel L2 {r:.3e} cosine {cos:.7f} own "
                          f"{own_err} bar {b:.3e}")
            bar_text = (f"bar {BF16_BAR:g}, {len(relaxed)} leaves relaxed"
                        + (f", or {STRIDE4_SPLIT_FACTOR:g} x the split path's distance"
                           if gru else "") if mp else f"bar {gru_bar if gru else 1e-4:.3e}")
            print(f"stride4 end to end training {dt} B={TRAIN_B} at tame weights, {what}: "
                  f"{len(beyond)} of {len(grads[mp, ref])} leaves beyond their bar "
                  f"({bar_text}), worst rel L2 {worst[0]:.3e} ({worst[1]}), worst cosine "
                  f"{worst_cos:.7f}", flush=True)
            if bool(beyond) != fault:
                failed.append(f"{what} {dt}: {len(beyond)} leaves beyond their bar")
    beyond15, _, worst15, _ = compare_grads(grads[True, "kernels"], grads[True, plain],
                                            grads[False, plain])
    print(f"stride4 end to end training: the split path against the plain GRU pass, fp32 "
          f"worst rel L2 {floor[0]:.3e} ({floor[1]}: the floor of the fp32 K5/K6 bar); "
          f"bf16 {len(beyond15)} leaves beyond phase 15's bf16 bar, worst {worst15[0]:.3e} "
          f"({worst15[1]}), printed, not held", flush=True)
    if failed:
        fail("stride4 end to end training: " + "; ".join(failed))


def phase_stride4_kernels(gen):
    """(4) K1-K3 (B=8, N=2, 48x160 maps, C=128) and K5/K6 (the depth pass
    B=8 and the pose pass B*N=16 on 48x160, D=128, Cx=160, both axes),
    bf16 and fp32, against their plain versions at the bars of phases 3, 7
    and 12; in bf16 the kernel, plain, library and bound times (K5/K6 on the
    depth pass). Returns the bf16 timings by kernel (K5/K6 axis 2)."""
    from dro_sfm_torch.ops import gru_pass
    from dro_sfm_torch.ops.tent_warp import (
        warp_diff,
        warp_diff_bwd_coords,
        warp_diff_bwd_coords_plain,
        warp_diff_bwd_feat,
        warp_diff_bwd_feat_plain,
        warp_diff_plain,
    )
    h, w, c = SERVE_H // STRIDE4, SERVE_W // STRIDE4, 128
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        f1, features, coords = k1_inputs(gen, TRAIN_B, VIEWS, h, w, c, dtype, "serving")
        g = torch.randn(TRAIN_B * VIEWS, h * w, c, generator=gen, device="cuda").to(dtype)
        out = warp_diff(f1, features, coords, VIEWS)
        d_feat = warp_diff_bwd_feat(coords, g, h, w, dtype)
        again = warp_diff_bwd_feat(coords, g, h, w, dtype)
        d_co = warp_diff_bwd_coords(features, coords, g)
        torch.cuda.synchronize()
        ref = warp_diff_plain(f1, features, coords, VIEWS)
        ref_feat = warp_diff_bwd_feat_plain(coords, g, h, w, dtype)
        ref_co = warp_diff_bwd_coords_plain(features, coords, g)
        errs = {"K1": (out.float() - ref.float()).abs().max().item(),
                "K2": (d_feat.float() - ref_feat.float()).abs().max().item(),
                "K3": (d_co - ref_co).abs().max().item()}
        tols = {"K1": k1_tolerance(dtype, ref),
                "K2": k2_tolerance(coords, g, h, w, dtype, ref_feat),
                "K3": k3_tolerance(features, coords, g)}
        line = (f"stride4 K1-K3 B={TRAIN_B} N={VIEWS} {h}x{w}x{c} {dt}: " + ", ".join(
            f"{k} max_abs_err {errs[k]:.3e} tol {tols[k]:.3e}" for k in errs)
            + f"; two K2 calls bitwise equal: {torch.equal(d_feat, again)}")
        if any(errs[k] > tols[k] for k in errs) or not torch.equal(d_feat, again) or not all(
                torch.isfinite(t).all() for t in (out, d_feat, d_co)):
            fail(line)
        if dtype == torch.bfloat16:
            k1 = time_k1(f1, features, coords, VIEWS, ref)
            lib_err = k1.pop("library_err")
            k23 = time_k23(features, coords, g, dtype)
            timings.update(K1=k1, K2=k23["K2"], K3=k23["K3"])
            for k in ("K1", "K2", "K3"):
                timings[k]["max_abs_err"] = errs[k]
            line += "".join(
                f" | {k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} library "
                f"{v['library_ms']:.4f} bound {v['bound_ms']:.4f} ({v['bound_by']})"
                for k, v in (("K1", k1), ("K2", k23["K2"]), ("K3", k23["K3"])))
            line += (f" | K1 library err {lib_err:.2e} | K2 by launch: "
                     f"{k2_split(coords, g, h, w, dtype)}")
        print(line, flush=True)
        del f1, features, coords, g, out, d_feat, again, d_co, ref, ref_feat, ref_co
        for what, b in (("depth", TRAIN_B), ("pose", TRAIN_B * VIEWS)):
            for axis in (2, 1):
                inp = gru_inputs(gen, b, h, w, GRU_D, GRU_CX, dtype)
                args = [inp[k] for k in ("h", "x", "wzr", "bzr", "wq", "bq")]
                out = gru_pass.gru_pass_fwd(*args, axis)
                grads = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
                again = gru_pass.gru_pass_bwd(*args, inp["g"], axis)
                torch.cuda.synchronize()
                ref = gru_pass.gru_pass_plain(*args, axis)
                refs = gru_pass.gru_pass_bwd_plain(*args, inp["g"], axis)
                bars = gru_bars(dtype)

                def rel(a, r):
                    return (a.float() - r.float()).abs().max().item() / max(
                        r.float().abs().max().item(), 1e-30)

                errs = {"K5": rel(out, ref)}
                bad = errs["K5"] > bars["fwd"]
                for name, got, want in zip(GRU_GRADS, grads, refs):
                    errs[name] = rel(got, want)
                    bad |= errs[name] > bars["act" if name in ("dh", "dx") else "weight"]
                same = all(torch.equal(a, r) for a, r in zip(grads, again))
                line = (f"stride4 K5/K6 {what} {b}x{h}x{w} D={GRU_D} Cx={GRU_CX} axis {axis} "
                        f"{dt}: " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
                        + f" (bars {bars['fwd']:.1e}, {bars['act']:.1e}, {bars['weight']:.1e})"
                        f"; two K6 calls bitwise equal: {same}")
                if bad or not same or not torch.isfinite(out).all():
                    fail(line)
                if dtype == torch.bfloat16 and what == "depth":
                    r = time_gru(inp, axis, gru_pass, gru_intermediates(inp, axis, gru_pass))
                    for k in r:
                        r[k]["max_abs_err"] = max(errs[n] for n in (
                            ("K5",) if k == "K5" else ("dh", "dx") if k == "K6-input"
                            else GRU_GRADS[2:]))
                        if axis == 2:
                            timings[k] = r[k]
                    line += "".join(f" | {k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f}"
                                    f" library {v['library_ms']:.4f} bound {v['bound_ms']:.4f}"
                                    for k, v in r.items())
                print(line, flush=True)
    return timings


def phase_stride4(counters, gpu):
    """The stride-4 feature net on the card: it12-h-out bf16 at 192x640
    with ``feat_ratio=4`` (maps of 48x160), N=2. (1) serving (B=1 and B=8,
    both GRU paths, `stride4_serving`); (2) the same B=1 request through the
    plain warp, fp32 and bf16, at phase 5's bars; (3) the B=8 training step
    with either GRU path (`stride4_training`) and its gradients against the
    plain versions (`stride4_gradients`); (4) the kernels at the path's
    shapes (`phase_stride4_kernels`); (5) ms a request, ms a step, peak
    memory. Returns the launches of the serving and training runs and the
    kernels' bf16 timings."""
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    start = stride4_net().state_dict()
    gen = torch.Generator().manual_seed(1)
    requests = {b: make_request(gen, b) for b in (1, 8)}
    served, req_ms = stride4_serving(counters, gpu, start, requests)
    phase_end_to_end(DepthPoseNet, stride4_net(state=start), requests, STRIDE4)
    tame = tame_weights(start)
    trained, step_ms, peak = stride4_training(counters, gpu, tame)
    stride4_gradients(tame)
    timings = phase_stride4_kernels(torch.Generator(device="cuda").manual_seed(7))
    print("stride4 summary on " + gpu + ": ms/request " + ", ".join(
        f"{sep} B={b} {v:.2f}" for (sep, b), v in req_ms.items()) + "; ms/step " + ", ".join(
        f"{sep} {v:.2f} (peak {peak[sep]:.0f} MiB)" for sep, v in step_ms.items()), flush=True)
    return {k: served[k] + trained[k] for k in counters}, timings


# --- torch_weights: upstream torch weights on the card, without flax or yacs --

TW_BUILD = ROOT / "build" / "torch_weights"
TW_FRAMES, TW_H, TW_W = 10, 192, 256       # the ScanNet scene: 8 samples with context
TW_BATCH = 2
TW_CONFIG = {"model": {"name": "SupModelMF",
                       "depth_net": {"name": "DepthPoseNet", "version": "it12-h-out"},
                       "params": {"min_depth": 0.2, "max_depth": 20.0, "crop": ""}},
             "datasets": {"augmentation": {"image_shape": [TW_H, TW_W]}}}
TW_BAR = 1e-6                              # converted against directly loaded metrics


def reference_state_dict(state):
    """The reference's names for a `DepthPoseNet` state dict (the inverse of
    `torch_weights.convert_dro_checkpoint`), prefixed ``model.depth_net.``,
    OIHW tensors on the CPU, with the ``num_batches_tracked`` counters."""
    from dro_sfm_torch.convert import to_jax_variables
    variables = to_jax_variables(state)
    params, stats = variables["params"], variables["batch_stats"]
    out = {}

    def conv(dst, node):
        out[f"{dst}.weight"] = torch.from_numpy(node["kernel"]).permute(3, 2, 0, 1)
        if "bias" in node:
            out[f"{dst}.bias"] = torch.from_numpy(node["bias"])

    def bn(dst, p, s):
        for leaf, value in (("weight", p["scale"]), ("bias", p["bias"]),
                            ("running_mean", s["mean"]), ("running_var", s["var"])):
            out[f"{dst}.{leaf}"] = torch.from_numpy(value)
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    for enc in ("fnet", "cnet_depth", "cnet_pose"):
        p, s = params[enc], stats[enc]
        conv(f"{enc}.conv1", p["conv1"])
        bn(f"{enc}.bn1", p["bn1"], s["bn1"])
        for li in (1, 2, 3):
            for bi in (0, 1):
                blk, src = f"layer{li}_block{bi}", f"{enc}.layer{li}.{bi}"
                conv(f"{src}.conv1", p[blk]["conv1"])
                conv(f"{src}.conv2", p[blk]["conv2"])
                bn(f"{src}.bn1", p[blk]["bn1"], s[blk]["bn1"])
                bn(f"{src}.bn2", p[blk]["bn2"], s[blk]["bn2"])
                if "downsample_conv" in p[blk]:
                    conv(f"{src}.downsample.0", p[blk]["downsample_conv"])
                    bn(f"{src}.downsample.1", p[blk]["downsample_bn"], s[blk]["downsample_bn"])
        conv(f"{enc}.upconv1.0", p["upconv1"])
        conv(f"{enc}.upconv1_fusion.0", p["upconv1_fusion"])
        conv(f"{enc}.out_conv", p["out_conv"])
    for dst, (mod, leaf) in (("depth_head.conv1", ("depth_head", "conv1")),
                             ("depth_head.conv2", ("depth_head", "conv2")),
                             ("pose_head.conv1_pose", ("pose_head", "conv1")),
                             ("pose_head.conv2_pose", ("pose_head", "conv2")),
                             ("upmask_net.mask.0", ("upmask_net", "conv1")),
                             ("upmask_net.mask.2", ("upmask_net", "conv2"))):
        conv(dst, params[mod][leaf])
    ref = params["refinement"]
    for kind in ("depth", "pose"):
        block = f"update_block_{kind}"
        cell = ref[block]["cell"]
        for name, node in cell["encoder"].items():
            conv(f"{block}.encoder.{name}", node)
        head = ("depth_head.conv1", "depth_head.conv2") if kind == "depth" else (
            "pose_head.conv1_pose", "pose_head.conv2_pose")
        conv(f"{block}.{head[0]}", cell["head"]["conv1"])
        conv(f"{block}.{head[1]}", cell["head"]["conv2"])
        if kind == "depth":
            conv(f"{block}.mask.0", ref["mask_head"]["mask1"])
            conv(f"{block}.mask.2", ref["mask_head"]["mask2"])
        for sfx in ("1", "2"):
            zr = cell["gru"][f"convzr{sfx}"]
            d = zr["kernel"].shape[-1] // 2
            for gate, part in (("z", slice(0, d)), ("r", slice(d, 2 * d))):
                conv(f"{block}.{kind}_gru.conv{gate}{sfx}",
                     {"kernel": zr["kernel"][..., part], "bias": zr["bias"][part]})
            conv(f"{block}.{kind}_gru.convq{sfx}", cell["gru"][f"convq{sfx}"])
    return {f"model.depth_net.{k}": v.contiguous() for k, v in out.items()}


@contextlib.contextmanager
def importable(modules):
    """``modules`` (name -> module) in ``sys.modules`` for the body only."""
    saved = {k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def save_pickled_as(path, obj_fn, module, name, base=dict):
    """``torch.save(obj_fn(cls))`` where ``cls`` is a ``base`` subclass
    pickled as the global ``module.name``: the module is made importable
    for the write only, so nothing of it is left to read the file with."""
    import types

    class Node(base):
        pass

    Node.__module__, Node.__qualname__, Node.__name__ = module, name, name
    mods = {}
    for i, part in enumerate(module.split(".")):
        mods[".".join(module.split(".")[:i + 1])] = types.ModuleType(part)
    setattr(mods[module], name, Node)
    with importable(mods):
        torch.save(obj_fn(Node), path)


def write_tw_scannet(root):
    """A ScanNet scene of TW_FRAMES rendered TW_H x TW_W views (JPEG, the
    renderer's millimetre depth and camera-to-world poses), listed at every
    frame of which every 5th exists (the reader keeps every 5th). Returns
    the split's number of samples with both neighbours."""
    import numpy as np

    from dro_sfm_torch.utils.image_io import encode_jpeg
    frames, poses, depths, K = render_video(TW_FRAMES, TW_H, TW_W)
    scene = root / "scene0000_00"
    for d in ("color", "depth", "pose", "intrinsic"):
        (scene / d).mkdir(parents=True, exist_ok=True)
    for i, (rgb, pose, depth) in enumerate(zip(frames, poses, depths)):
        (scene / "color" / f"{5 * i:06d}.jpg").write_bytes(encode_jpeg(rgb, quality=95))
        depth_png_bytes(scene / "depth" / f"{5 * i:06d}.png", depth, 1000.0)
        np.savetxt(scene / "pose" / f"{5 * i:06d}.txt", pose)
    K4 = np.eye(4)
    K4[:3, :3] = K
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", K4)
    (root.parent / "split.txt").write_text("".join(
        f"scene0000_00/color {i:06d}.jpg\n" for i in range(5 * TW_FRAMES)))
    return TW_FRAMES - 2


def tw_trunk_states():
    """Random state dicts under torchvision's names: ResNet-18 (conv1,
    layers 1-4, fc) and VGG16's 13 convolutions, seed 4."""
    gen = torch.Generator().manual_seed(4)
    rn = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=gen)}

    def bn(name, c):
        rn[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        rn[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        rn[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        rn[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        rn[f"{name}.num_batches_tracked"] = torch.tensor(0)

    bn("bn1", 64)
    cin = 64
    for li, width in enumerate((64, 128, 256, 512), start=1):
        for bi in (0, 1):
            src = f"layer{li}.{bi}"
            rn[f"{src}.conv1.weight"] = torch.randn(width, cin if bi == 0 else width, 3, 3,
                                                    generator=gen)
            bn(f"{src}.bn1", width)
            rn[f"{src}.conv2.weight"] = torch.randn(width, width, 3, 3, generator=gen)
            bn(f"{src}.bn2", width)
            if bi == 0 and li > 1:
                rn[f"{src}.downsample.0.weight"] = torch.randn(width, cin, 1, 1, generator=gen)
                bn(f"{src}.downsample.1", width)
        cin = width
    rn["fc.weight"], rn["fc.bias"] = torch.randn(1000, 512, generator=gen), torch.zeros(1000)
    vgg, cin = {}, 3
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                         (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        vgg[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen)
        vgg[f"features.{idx}.bias"] = torch.randn(cout, generator=gen)
        cin = cout
    return rn, vgg


def tw_grafts(trainer, percep, rn, vgg):
    """Leaves of the warm-started ``trainer``'s encoders and of its
    perceptual net ``percep`` that differ in any bit from the torchvision
    sources: each encoder's trunk (conv1 replicated over the image pair and
    halved for ``cnet_pose``) and PercepNet's conv0-conv6."""
    import re
    want = {}
    for k, v in rn.items():
        if k.startswith(("layer4", "fc")) or k.endswith("num_batches_tracked"):
            continue
        name = re.sub(r"layer(\d)\.(\d)\.", r"layer\1_block\2.", k).replace(
            "downsample.0.", "downsample_conv.").replace("downsample.1.", "downsample_bn.")
        for enc in ("fnet", "cnet_depth", "cnet_pose"):
            want[f"{enc}.{name}"] = v
    want["cnet_pose.conv1.weight"] = torch.cat([rn["conv1.weight"]] * 2, dim=1) / 2
    want.update({f"conv{i}.{leaf}": vgg[f"features.{idx}.{leaf}"]
                 for i, idx in enumerate((0, 2, 5, 7, 10, 12, 14)) for leaf in ("weight", "bias")})
    got = {**trainer.net.state_dict(), **percep.state_dict()}
    return [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]


def phase_torch_weights(counters, gpu):
    """Upstream torch weights through the port alone (no flax, jax or yacs
    on the card's machine). (1) The port's seed-0 it12-h-out `DepthPoseNet` under
    the reference's names (`reference_state_dict`); (2) saved as the
    reference's ``.ckpt`` (``state_dict``, ``config``, ``epoch``), its config
    pickled as ``yacs.config.CfgNode``; (3) the ``convert_torch_weights
    dro-ckpt`` CLI to an eval-ready ``.ckpt`` (its load check on the card;
    `load_model` bit-equal to the source), then ``eval_reference_ckpt`` on a
    rendered ScanNet scene at 192x256 (B=2) on the card, counts reset just
    before and read just after: K1 48 an eval batch and nothing else; every
    metric within TW_BAR relative of a `Trainer` on the same config whose net
    took the weights straight; (4) ``resnet18`` and ``vgg16`` state dicts of
    random arrays under torchvision's names converted by the CLI, and a
    `Trainer` (SelfSupModelMF with the perceptual term) warm-started from
    them: the grafted leaves bit-equal to the sources; (5) a ``.ckpt`` that
    pickles a foreign global refused. Returns the eval's launches."""
    import importlib.util
    import pickle
    import shutil

    from dro_sfm_torch import torch_weights as tw
    from dro_sfm_torch.inference import load_model
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.models.sfm import make_percep_fn
    from dro_sfm_torch.scripts import convert_torch_weights, eval_reference_ckpt
    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import load_config
    shutil.rmtree(TW_BUILD, ignore_errors=True)
    TW_BUILD.mkdir(parents=True)
    try:
        with contextlib.chdir(TW_BUILD):     # the trainers' ./results
            # (1), (2)
            net = DepthPoseNet(version="it12-h-out", device="cuda",
                               generator=torch.Generator().manual_seed(0))
            source = {k: v.detach().clone() for k, v in net.state_dict().items()}
            ref = TW_BUILD / "indoor_scannet.ckpt"
            sd = reference_state_dict(source)
            save_pickled_as(ref, lambda node: {
                "state_dict": sd, "epoch": 3,
                "config": node({k: node({kk: node(vv) if isinstance(vv, dict) else vv
                                         for kk, vv in v.items()}) for k, v in
                                TW_CONFIG.items()})}, "yacs.config", "CfgNode")
            if importlib.util.find_spec("yacs") is not None:
                fail("torch_weights: yacs is importable here")
            if not isinstance(tw.read_reference_ckpt(str(ref))["config"], tw.ReferenceConfig):
                fail("torch_weights: the config did not come back as ReferenceConfig")
            # (3)
            out = TW_BUILD / "converted" / "indoor_scannet.ckpt"
            t0 = time.perf_counter()
            convert_torch_weights.main(["dro-ckpt", str(ref), str(out)])
            convert_s = time.perf_counter() - t0
            loaded = load_model(str(out)).state_dict()
            differ = [k for k in source if not torch.equal(loaded[k], source[k])]
            if differ:
                fail(f"torch_weights: load_model of the converted .ckpt differs from the "
                     f"source in {len(differ)} tensors, first {differ[0]}")
            n_samples = write_tw_scannet(TW_BUILD / "scannet" / "scans")
            args = [str(ref), "--dataset", "Scannet", "--path",
                    str(TW_BUILD / "scannet" / "scans"), "--split", "split.txt",
                    "--batch-size", str(TW_BATCH), "--out", str(TW_BUILD / "eval.ckpt")]
            for c in counters.values():      # the reference-checkpoint path starts here
                c.reset()
            t0 = time.perf_counter()
            result = eval_reference_ckpt.main(args)
            eval_s = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}   # and ends here
            batches = -(-n_samples // TW_BATCH)
            want = {k: (EVAL_LAUNCHES["K1"] * batches if k == "K1" else 0) for k in counters}
            if launches != want:
                fail(f"torch_weights: eval_reference_ckpt launched {launches} over {batches} "
                     f"batches, want {want}")
            cfg = eval_reference_ckpt.eval_config(str(TW_BUILD / "eval.ckpt"),
                                                  eval_reference_ckpt.parse_args(args))
            direct = Trainer(cfg, device="cuda")
            direct.net.load_state_dict(source, strict=True)
            want_m = direct.test()
            got_m = result["metrics"]
            worst = max((abs(got_m[k] - float(v)) / max(abs(float(v)), 1e-30), k)
                        for k, v in want_m.items() if float(v) != 0 or got_m[k] != 0)
            if set(got_m) != set(want_m) or worst[0] > TW_BAR or not all(
                    math.isfinite(v) for v in got_m.values()):
                fail(f"torch_weights: converted against directly loaded metrics, worst "
                     f"{worst[0]:.3e} ({worst[1]}), bar {TW_BAR:g}")
            print(f"torch_weights: reference .ckpt (CfgNode config, yacs absent) -> CLI "
                  f"dro-ckpt {convert_s:.1f} s (load check and load_model on the card, "
                  f"bit-equal) -> eval_reference_ckpt {eval_s:.1f} s on {n_samples} ScanNet "
                  f"samples {TW_H}x{TW_W} B={TW_BATCH}: K1 {launches['K1']} launches "
                  f"({launches['K1'] // batches}/batch); {len(got_m)} metrics against the "
                  f"directly loaded net's, worst rel {worst[0]:.3e} ({worst[1]}, bar "
                  f"{TW_BAR:g}); abs_rel_pp_gt {got_m['abs_rel_pp_gt']:.4f} on {gpu}",
                  flush=True)
            del net, direct
            # (4)
            rn, vgg = tw_trunk_states()
            paths = {}
            for kind, state in (("resnet18", rn), ("vgg16", vgg)):
                src = TW_BUILD / f"{kind}.pth"
                torch.save(state, src)
                paths[kind] = str(TW_BUILD / f"{kind}.msgpack")
                convert_torch_weights.main([kind, str(src), paths[kind]])
            cfg = load_config(str(SELFSUP_CONFIG), overrides={
                "model": {"depth_net": {"pretrained_encoders": paths["resnet18"]},
                          "percep_net": {"checkpoint_path": paths["vgg16"]},
                          "loss": {"percep_loss_weight": 0.1}},
                "checkpoint": {"filepath": str(TW_BUILD / "ckpt")}})
            trainer = Trainer(cfg, device="cuda")
            percep = make_percep_fn(trainer.model_cfg, device="cuda")
            if percep is None:
                fail("torch_weights: the warm-started config has no perceptual net")
            bad = tw_grafts(trainer, percep, rn, vgg)
            if bad:
                fail(f"torch_weights: {len(bad)} grafted leaves differ from the source, "
                     f"first {bad[0]}")
            print(f"torch_weights: resnet18 and vgg16 state dicts (torchvision's names) -> "
                  f"CLI -> Trainer warm start ({cfg.model.name}, pretrained_encoders, "
                  f"percep_net.checkpoint_path): the three encoders' trunks and PercepNet's "
                  f"7 convolutions bit-equal to the sources", flush=True)
            # (5)
            foreign = TW_BUILD / "foreign.ckpt"
            save_pickled_as(foreign, lambda node: node(state_dict=sd), "foreign.payload",
                            "Payload", collections.OrderedDict)
            try:
                tw.read_reference_ckpt(str(foreign))
                fail("torch_weights: a checkpoint with a foreign global was read")
            except pickle.UnpicklingError as e:
                print(f"torch_weights: foreign global refused: {e}", flush=True)
    finally:
        shutil.rmtree(TW_BUILD, ignore_errors=True)
    return launches


VIDEO_BUILD = ROOT / "build" / "video"
VIDEO_FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "video"
# Simple Profile's walk: 36 frames; the runs take the first 12 (10 windows), for the
# script's time
VIDEO_CLIP, VIDEO_CLIP_FRAMES, VIDEO_RUN_FRAMES = "walk_640x480.mp4", 36, 12
VIDEO_RATES = ("walk_640x480.mp4", "walk_1280x720.mp4")
# Simple Profile and XviD (B-VOPs, four vectors) at both sizes
MPEG4_RATES = (*VIDEO_RATES, "xvid_640x480.avi", "xvid_1280x720.mp4")
# XviD's packed AVI: 36 frames; the runs take the first 12 (10 windows), for the script's time
XVID_CLIP, XVID_CLIP_FRAMES, XVID_RUN_FRAMES = "xvid_640x480.avi", 36, 12
H264_FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "h264"
# Constrained Baseline and High (libx264's defaults) at both sizes
H264_RATES = (*VIDEO_RATES, "high_640x480.mp4", "high_1280x720.mp4")
# libx264's defaults: 24 packets, 23 frames shown (the MP4's edit list); the
# runs take the first 12 (10 windows), for the script's time
H264_CLIP, H264_CLIP_FRAMES, H264_RUN_FRAMES = "high_640x480.mp4", 23, 12


def video_fixtures(folder, library, decoder, rates_of):
    """Every committed video of ``folder`` through the card's host build of
    ``library`` (`hostlib.SOURCES`) and its ``decoder`` class: packets (an
    MP4's H.264 samples as stored, OpenCV's NAL units with 4-byte lengths),
    luma planes and RGB frames in output order, those an MP4's edit list
    trims left out, against the sha256 of OpenCV's (``fixtures.json``),
    each refused stream raising; the median decode ms a frame
    (`VideoReader`, RGB) of the ``rates_of`` clips."""
    import hashlib

    import numpy as np

    from dro_sfm_torch import hostlib
    from dro_sfm_torch.utils.video_io import VideoReader, demux

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    t0 = time.perf_counter()
    fresh = not hostlib.library_path(library).is_file()
    hostlib.build(library)
    print(f"video decoder {library} {'built' if fresh else 'found'} in "
          f"{time.perf_counter() - t0:.1f} s with {hostlib.find_cxx()}", flush=True)
    meta = json.loads((folder / "fixtures.json").read_text())
    for name, entry in meta["files"].items():
        stream = demux(str(folder / name))
        dec = decoder.for_stream(stream)
        got = {"packets": [hashlib.sha256(p).hexdigest() for p in stream.packets()],
               "luma": [], "rgb": []}
        for p in [*stream.packets(), None]:
            for k, (img, y) in dec.output(p, rgb=True, luma=True):
                if stream.shown[k]:
                    got["luma"].append(sha(y))
                    got["rgb"].append(sha(img))
        if len(got["rgb"]) != entry["frames"]:
            fail(f"video: {name} gave {len(got['rgb'])} frames, want {entry['frames']}")
        bad = [k for k in got if got[k] != entry["opencv"][k]]
        if bad or stream.fps != entry["fps"] or dec.stats != entry["stats"]:
            fail(f"video: {name} differs from OpenCV's {bad} (fps {stream.fps}, want "
                 f"{entry['fps']}; stats {dec.stats == entry['stats']})")
    for name, entry in meta["refusals"].items():
        try:
            sum(1 for _ in VideoReader(str(folder / name)))
            fail(f"video: {name} decoded; it should raise naming {entry['raises']!r}")
        except NotImplementedError as e:
            if entry["raises"] not in str(e):
                fail(f"video: {name} raised {e}, want {entry['raises']!r}")
    rates = {}
    for name in rates_of:
        reader = VideoReader(str(folder / name))
        for _ in range(2):                   # the second pass is timed
            reader.decode_ms.clear()
            frames = sum(1 for _ in reader)
        ms = sorted(reader.decode_ms)
        rates[f"{decoder.__name__} {name}"] = (ms[len(ms) // 2], ms[0], ms[-1], frames)
    n = sum(e["frames"] for e in meta["files"].values())
    print(f"video fixtures {folder.name}: {len(meta['files'])} files, {n} frames: packets, luma "
          f"and RGB equal to OpenCV's sha256 (bar 0 levels); {len(meta['refusals'])} refused "
          f"streams raise NotImplementedError naming their tool", flush=True)
    return rates


def video_encode():
    """The host MPEG-4 encoder built with this machine's compiler, then the
    decoded frames of each VIDEO_RATES clip re-encoded to mp4v MP4
    (`VideoWriter`) under VIDEO_BUILD and read back: it fails
    unless each re-decoded frame equals the encoder's reconstruction."""
    import os

    import numpy as np

    from dro_sfm_torch import hostlib
    from dro_sfm_torch.utils import video_io
    from dro_sfm_torch.utils.video_io import VideoReader, VideoWriter
    t0 = time.perf_counter()
    fresh = not hostlib.library_path("mpeg4_encode").is_file()
    hostlib.build("mpeg4_encode")
    info = {}                                # the first processor's fields of /proc/cpuinfo
    for line in open("/proc/cpuinfo"):
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    cpu = (info.get("model name", "unknown") + f" ({info.get('vendor_id')} family "
           f"{info.get('cpu family')} model {info.get('model')})")
    print(f"video encoder {'built' if fresh else 'found'} in {time.perf_counter() - t0:.1f} s "
          f"with {hostlib.find_cxx()}; host CPU {cpu}, {len(os.sched_getaffinity(0))} cores "
          f"usable", flush=True)
    for name in VIDEO_RATES:
        reader = VideoReader(str(VIDEO_FIXTURES / name))
        frames = list(reader)
        path = VIDEO_BUILD / f"encoded_{name}"
        recon = []
        with VideoWriter(str(path), reader.fps) as writer:
            for f in frames:
                writer.write(f)
                recon.append(writer.reconstruction())
        back = list(VideoReader(str(path)))
        exact = sum(bool(np.array_equal(a, b)) for a, b in zip(back, recon))
        psnrs = [psnr_db(a, f) for a, f in zip(back, frames)]
        ms = sorted(writer.encode_ms)
        h, w = frames[0].shape[:2]
        line = (f"video encode {name}: {len(frames)} frames of {w}x{h}, QP {video_io.QP}, GOP "
                f"{video_io.GOP}: median {ms[len(ms) // 2]:.2f} ms a frame (min {ms[0]:.2f}, max "
                f"{ms[-1]:.2f}), host clock; {path.stat().st_size / len(frames):.1f} bytes a "
                f"frame ({path.stat().st_size} bytes); PSNR against its input mean "
                f"{sum(psnrs) / len(psnrs):.2f} dB, min {min(psnrs):.2f} dB; re-decoded "
                f"bit-equal to the reconstruction {exact}/{len(frames)}")
        if len(back) != len(frames) or exact != len(frames):
            fail(line)
        print(line, flush=True)


def plain_windows(ckpt, frames_dir, pattern="*.jpg", count=None):
    """The depths and pose matrices of every 3-frame window of the frames
    ``pattern`` in ``frames_dir`` (name order; the first ``count``, all by
    default) through the net of ``ckpt`` with the plain warp, on the
    card."""
    import numpy as np

    from dro_sfm_torch.data.video import dummy_calibration
    from dro_sfm_torch.inference import load_model_and_config, make_infer_fn
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.scripts.frames import FrameLoader
    served, _ = load_model_and_config(ckpt, "cuda")
    plain = DepthPoseNet(version=served.version, min_depth=served.min_depth,
                         max_depth=served.max_depth, mixed_precision=served.mixed_precision,
                         warp_impl="gather", device="cuda")
    plain.load_state_dict(served.state_dict(), strict=True)
    infer = make_infer_fn(plain, device="cuda")
    load = FrameLoader((SERVE_H, SERVE_W))
    files = sorted(Path(frames_dir).glob(pattern))[:count]
    K = torch.tensor(dummy_calibration(SERVE_W, SERVE_H))
    ref_d, ref_m = [], []
    for i in range(1, len(files) - 1):
        d, m = infer(torch.from_numpy(load(str(files[i])))[None],
                     torch.from_numpy(np.stack([load(str(files[i - 1])),
                                                load(str(files[i + 1]))]))[None], K[None])
        ref_d.append(d[0].cpu().numpy())
        ref_m.append(m[0].cpu().numpy())
    return np.stack(ref_d), np.stack(ref_m)


def video_run(counters, ckpt, out, shape, clip, frames, used):
    """``infer_video`` on ``clip`` (``frames`` long; the windows over its
    first ``used`` frames) without ``--device``, counts reset just before
    and read just after: (result, launches, seconds); it fails unless every
    frame is extracted and each window launches K1 24 and nothing else."""
    from dro_sfm_torch.scripts import infer_video
    for c in counters.values():              # the video path starts here
        c.reset()
    t0 = time.perf_counter()
    result = infer_video.main(["--checkpoint", ckpt, "--input", str(clip), "--output", str(out),
                               "--max-frames", str(used), *shape])
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}   # and ends here
    windows, ext = result["windows"], result["extraction"]
    want = {k: (K1_STEPS_PER_REQUEST * windows if k == "K1" else 0) for k in counters}
    if ext is None or ext["frames"] != frames or windows != used - 2 or launches != want:
        fail(f"video: infer_video on {clip.name} extracted {ext and ext['frames']} frames, ran "
             f"{windows} windows with launches {launches}, want {frames}, {used - 2} and "
             f"{want}")
    return result, launches, seconds


def phase_video(counters, gpu):
    """A video file as infer_video's input (phase 33 of the docstring)."""
    import shutil

    import numpy as np

    from dro_sfm_torch.inference import save_model
    from dro_sfm_torch.scripts import infer_video
    from dro_sfm_torch.training.trainer import model_config_from
    from dro_sfm_torch.utils.video_io import H264Decoder, Mpeg4Decoder
    t_start = time.perf_counter()
    shutil.rmtree(VIDEO_BUILD, ignore_errors=True)
    rates = video_fixtures(VIDEO_FIXTURES, "mpeg4_video", Mpeg4Decoder, MPEG4_RATES)
    rates.update(video_fixtures(H264_FIXTURES, "h264_video", H264Decoder, H264_RATES))

    VIDEO_BUILD.mkdir(parents=True)
    video_encode()
    net = start_weights(model_config_from(trainer_config())).eval()
    net.mixed_precision = False
    ckpt = str(VIDEO_BUILD / "net.pt")
    save_model(net, ckpt)
    net.load_state_dict(tame_weights(net.state_dict()))
    tame = str(VIDEO_BUILD / "tame.pt")
    save_model(net, tame)
    del net
    shape = ["--image-shape", str(SERVE_H), str(SERVE_W)]

    def med(xs):
        xs = sorted(xs)
        return f"median {xs[len(xs) // 2]:.2f} (min {xs[0]:.2f}, max {xs[-1]:.2f})"

    def held_to_plain(tag, clip, frames, used):
        """``infer_video`` on ``clip`` at start_weights, no --device, its
        launches counted (the main path; the plain warp's distance printed
        only: at these weights the eval-mode refinement at 192x640 is
        chaotic, `tame_weights`, and parts from K1 by about 0.1), then at
        tame_weights, counted too, held to the windows through the plain
        warp within 1e-5 (phase apps' bar): (result, launches, seconds,
        chaotic distance, rel L2 by output, launches at tame_weights)."""
        out = VIDEO_BUILD / tag
        res, counted, secs = video_run(counters, ckpt, out, shape, clip, frames, used)
        ref = plain_windows(ckpt, out / "input_frames", count=used)
        far = float(np.linalg.norm(np.load(out / "depths.npy") - ref[0]) / np.linalg.norm(ref[0]))
        tamed_res, counted_t, _ = video_run(counters, tame, VIDEO_BUILD / f"{tag}_tame", shape,
                                            clip, frames, used)
        ref = plain_windows(tame, VIDEO_BUILD / f"{tag}_tame" / "input_frames", count=used)
        rel = {}
        for what, got, want in (("depths", np.load(VIDEO_BUILD / f"{tag}_tame" / "depths.npy"),
                                 ref[0]), ("poses", np.stack(tamed_res["pose_mats"]), ref[1])):
            rel[what] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            if not (rel[what] <= 1e-5 and np.isfinite(got).all()):
                fail(f"video: infer_video on {clip.name} {what} at tame_weights against the "
                     f"plain warp: rel L2 {rel[what]:.3e} (bar 1e-5)")
        return res, counted, secs, far, rel, counted_t

    # 1) Simple Profile (mp4v), 2) XviD's packed AVI (B-VOPs, four vectors),
    # 3) H.264 High: each clip at both weight draws, the windows over its
    # first frames, for the script's time
    runs = {"mp4v": (VIDEO_CLIP, held_to_plain("walk", VIDEO_FIXTURES / VIDEO_CLIP,
                                               VIDEO_CLIP_FRAMES, VIDEO_RUN_FRAMES)),
            "XviD": (XVID_CLIP, held_to_plain("xvid", VIDEO_FIXTURES / XVID_CLIP,
                                              XVID_CLIP_FRAMES, XVID_RUN_FRAMES)),
            "H.264": (H264_CLIP, held_to_plain("h264", H264_FIXTURES / H264_CLIP,
                                               H264_CLIP_FRAMES, H264_RUN_FRAMES))}

    # 4) the CLI on the walk's extracted frames: the same bits
    walk = runs["mp4v"][1][0]
    again = infer_video.main(["--checkpoint", ckpt, "--input",
                              str(VIDEO_BUILD / "walk" / "input_frames"), "--output",
                              str(VIDEO_BUILD / "again"), "--max-frames", str(VIDEO_RUN_FRAMES),
                              *shape])
    if not (np.array_equal(np.load(VIDEO_BUILD / "walk" / "depths.npy"),
                           np.load(VIDEO_BUILD / "again" / "depths.npy"))
            and np.array_equal(np.stack(walk["pose_mats"]), np.stack(again["pose_mats"]))):
        fail("video: infer_video on the extracted frames differs from the run on the video")

    for name, (m, lo, hi, n) in rates.items():
        print(f"video decode {name}: median {m:.2f} ms a frame (min {lo:.2f}, max {hi:.2f}) "
              f"over {n} frames, RGB out, host clock", flush=True)
    for label, (clip, (res, counted, secs, far, rel, counted_t)) in runs.items():
        ext, windows = res["extraction"], res["windows"]
        extract = [d + e for d, e in zip(ext["decode_ms"], ext["encode_ms"])]
        print(f"video infer_video {label} {clip} it12-h-out fp32 {SERVE_H}x{SERVE_W} N=2 B=1: "
              f"{ext['frames']} frames extracted, decode {med(ext['decode_ms'])} ms, JPEG encode "
              f"{med(ext['encode_ms'])} ms, extraction {med(extract)} ms a frame; {windows} "
              f"windows, {med(res['window_ms'][1:])} ms a window after the first "
              f"({res['window_ms'][0]:.2f}); K1 {counted['K1']} launches "
              f"({counted['K1'] // windows}/window), nothing else; against the plain warp at "
              f"tame_weights rel L2 depths {rel['depths']:.3e}, poses {rel['poses']:.3e} (bar "
              f"1e-5; K1 {counted_t['K1']} launches), at start_weights depths {far:.3e} "
              f"(chaotic, printed only); CLI {secs:.1f} s"
              + ("; the run on the extracted frames bit-equal" if label == "mp4v" else ""),
              flush=True)
    print(f"video phase {time.perf_counter() - t_start:.1f} s on {gpu}", flush=True)
    shutil.rmtree(VIDEO_BUILD, ignore_errors=True)
    return {k: sum(run[1][k] for _, run in runs.values()) for k in counters}


PHASES = ("k1", "serving", "e2e", "profile", "k23", "train", "train_e2e", "train_profile",
          "k4", "gru", "serving_pallas", "train_pallas", "train_pallas_e2e",
          "train_pallas_profile", "selfsup", "selfsup_e2e", "selfsup_profile", "tasks",
          "trainer", "selfsup_trainer", "apps", "datasets", "dist_trainer", "nyu", "export",
          "ba", "demo", "spatial", "stride4", "torch_weights", "video")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run after the build (all by "
                             "default; the result lines are printed only for all)")
    only = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on an NVIDIA GPU")
    unknown = set(only) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}; phases are {PHASES}")
    sys.path.insert(0, str(ROOT))

    from dro_sfm_torch import kernels
    from dro_sfm_torch.inference import make_infer_fn
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.ops.tent_warp import warp_diff, warp_diff_plain
    counters = counter_map()
    clock = {"start": time.perf_counter()}

    def phase(name, fn, *args):
        """Run phase ``name`` if asked for, printing its seconds."""
        if name not in only:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    # 1) device
    gpu = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(TF32 off: fp32 runs in fp32)", flush=True)

    # 2) build: every kernel, one nvcc each, all started together
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} {entry[:60]}: {line.strip()}")

    # 3) K1 vs plain
    k1 = phase("k1", phase_k1, warp_diff, warp_diff_plain)

    # 4) serving (its K1 launches are checked there)
    served = phase("serving", phase_serving, DepthPoseNet, make_infer_fn, counters, gpu)
    if served is not None:
        net, requests, serve_launches = served
        if serve_launches == 0:
            fail("the serving path never launched K1")
        state = net.state_dict()
        # 5) end to end, kernel vs plain; 6) profile
        phase("e2e", phase_end_to_end, DepthPoseNet, net, requests)
        phase("profile", profile_request, net, requests, make_infer_fn)
        del net, requests

    # 7) K2/K3 vs plain
    k23 = phase("k23", phase_k23, torch.Generator(device="cuda").manual_seed(1))

    # 8) training (a main path: its K1-K3 launches go into the kernels line)
    trained = phase("train", phase_train, counters, gpu)
    step_ms = None
    if trained is not None:
        launches, step_ms = trained[3], trained[4]
        for name in TRAIN_LAUNCHES:
            if launches[name] == 0:
                fail(f"the training path never launched {name}")
        # 9) training end to end, kernel vs plain warp; 10) profile
        phase("train_e2e", phase_train_end_to_end)
        phase("train_profile", profile_train_step, *trained[:3])
        del trained

    # 11) K4 vs plain, and the K4 path (the entry point tent_warp)
    k4 = phase("k4", phase_k4, torch.Generator(device="cuda").manual_seed(2), counters)

    # 12) K5/K6 vs plain
    gru = phase("gru", phase_gru, torch.Generator(device="cuda").manual_seed(3))

    # 13) serving with sep_conv="pallas" (K1 24 and K5 48 launches a request)
    if "serving_pallas" in only:
        if served is None:
            fail("phase serving_pallas needs phase serving's weights")
        phase("serving_pallas", phase_serving_pallas, DepthPoseNet, make_infer_fn,
              counters, state, gpu)

    # 14) training with sep_conv="pallas" (a main path: K5, K6 launches)
    trained_p = phase("train_pallas", phase_train, counters, gpu, "pallas",
                      TRAIN_LAUNCHES_PALLAS)
    if trained_p is not None:
        launches_p = trained_p[3]
        for name in TRAIN_LAUNCHES_PALLAS:
            if launches_p[name] == 0:
                fail(f"the sep_conv=pallas training path never launched {name}")
        # 15) its gradients against the plain GRU pass; 16) profile
        phase("train_pallas_e2e", phase_train_pallas_end_to_end)
        phase("train_pallas_profile", profile_train_step, *trained_p[:3])
        del trained_p

    # 17) the self-supervised step (a main path: K1-K3 launches go into the
    # kernels line); 18) its profile; 19) its gradients, kernels against
    # plain, either GRU path
    selfsup = phase("selfsup", phase_train, counters, gpu, "split", TRAIN_LAUNCHES,
                    "SelfSupModelMF", TRAIN_STEPS, make_scene_batch)
    selfsup_ms = None
    if selfsup is not None:
        launches_s, selfsup_ms = selfsup[3], selfsup[4]
        for name in TRAIN_LAUNCHES:
            if launches_s[name] == 0:
                fail(f"the self-supervised training path never launched {name}")
        phase("selfsup_profile", profile_train_step, *selfsup[:3])
        del selfsup
        torch.cuda.empty_cache()
    phase("selfsup_e2e", phase_selfsup_end_to_end, counters)

    # 20) the semi-supervised and single-frame task models
    phase("tasks", phase_tasks, counters, gpu)

    # 21) the trainer: fit, resume, the eval CLI, a sep_conv="pallas" epoch;
    # 22) the same, without the fused epoch, on the self-supervised config
    phase("trainer", phase_trainer, counters, gpu, step_ms)
    phase("selfsup_trainer", phase_trainer, counters, gpu, None, SELFSUP_CONFIG, False)

    # 23) a JAX-format checkpoint served (infer_video) and resumed on the card
    phase("apps", phase_apps, counters, gpu)

    # 24) training from dataset files (this slice's path: its launches are
    # checked per step and per eval batch)
    launches_d = phase("datasets", phase_datasets, counters, gpu)
    if launches_d is not None:
        for name in TRAIN_LAUNCHES:
            if launches_d[name] == 0:
                fail(f"the dataset training path never launched {name}")

    # 25) training in several processes (this slice's path: world size 1 on
    # NCCL and two ranks over gloo, their launches checked a step)
    phase("dist_trainer", phase_dist_trainer, counters, gpu)

    # 26) NYU from its HDF5 dumps (this slice's path: the reader against
    # h5py's bytes, the 480x640 recipe's steps and eval batch counted)
    launches_n = phase("nyu", phase_nyu, counters, gpu)
    if launches_n is not None:
        for name in TRAIN_LAUNCHES:
            if launches_n[name] == 0:
                fail(f"the NYU training path never launched {name}")

    # 27) the serving export (this slice's path: K1, and K5 with "pallas",
    # launched from loaded programs)
    if "export" in only:
        if served is None:
            fail("phase export needs phase serving's weights")
        launches_e = phase("export", phase_export, DepthPoseNet, make_infer_fn, counters,
                           state, gpu)
        if launches_e["K1"] == 0 or launches_e["K5"] == 0:
            fail(f"the export path never launched K1 and K5: {launches_e}")

    # 28) bundle adjustment (this slice's path: PyTorch operators, no kernel
    # of its own; infer_video --ba launches K1 24 a window)
    phase("ba", phase_ba, counters, gpu)

    # 29) the demo video (this slice's path: infer_video launches K1 24 a
    # window; the drawing, the colormap and the encoders run on the host)
    launches_v = phase("demo", phase_demo, counters, gpu)
    if launches_v is not None and launches_v["K1"] == 0:
        fail("the demo path never launched K1")

    # 30) the height split (this slice's path: two ranks on this card, their
    # launches counted a step, K1-K3 at the band shapes and K5/K6 on the
    # widened bands against their plain versions)
    split = phase("spatial", phase_spatial, counters, gpu)
    if split is not None:
        for name in TRAIN_LAUNCHES_PALLAS:
            if split[0][name] == 0 or split[2]["self-supervised"][name] == 0:
                fail(f"the height-split path never launched {name}")

    # 31) the stride-4 feature net (this slice's path: serving and training
    # launch K1-K3 and K5/K6 on 48x160 maps, held to their plain versions
    # there)
    stride4 = phase("stride4", phase_stride4, counters, gpu)
    if stride4 is not None:
        for name in TRAIN_LAUNCHES_PALLAS:
            if stride4[0][name] == 0:
                fail(f"the stride-4 path never launched {name}")

    # 32) upstream torch weights without flax or yacs (its evaluation
    # launches K1 48 a batch)
    launches_w = phase("torch_weights", phase_torch_weights, counters, gpu)
    if launches_w is not None and launches_w["K1"] == 0:
        fail("the reference-checkpoint evaluation never launched K1")
    # 33) a video file as infer_video's input (this slice's path: the host
    # decoder against OpenCV's digests, then K1 24 a window)
    launches_video = phase("video", phase_video, counters, gpu)
    if launches_video is not None and launches_video["K1"] == 0:
        fail("the video path never launched K1")
    print(f"all phases: {time.perf_counter() - clock['start']:.1f} s", flush=True)
    if set(only) != set(PHASES):
        print(f"ran phases {only} only: no result line", flush=True)
        return 0

    src = "dro_sfm_torch/csrc/"
    warp = "dro_sfm_tpu/ops/pallas/tent_warp.py:"
    gru_tpu = "dro_sfm_tpu/ops/pallas/gru_pass.py:"
    timed = k23[(8, "bfloat16")]
    gru_timed = gru[("depth", "bfloat16", 2)]
    lines = [
        {"name": "tent_warp_fwd_diff (K1)", "route": "cuda",
         "source": src + "tent_warp_fwd.cu", "replaces": warp + "182",
         "launches": launches_s["K1"] + launches_video["K1"], **k1[(8, "bfloat16")]},
        {"name": "tent_warp_bwd_feat (K2)", "route": "cuda",
         "source": src + "tent_warp_bwd.cu", "replaces": warp + "264",
         "launches": launches_s["K2"], **timed["K2"]},
        {"name": "tent_warp_bwd_coords (K3)", "route": "cuda",
         "source": src + "tent_warp_bwd.cu", "replaces": warp + "205",
         "launches": launches_s["K3"], **timed["K3"]},
        {"name": "tent_warp_fwd (K4)", "route": "cuda",
         "source": src + "tent_warp_fwd.cu", "replaces": warp + "125",
         "launches": k4[1]["K4"], **k4[0]},
        {"name": "gru_pass_fwd (K5)", "route": "cuda",
         "source": src + "gru_pass_fwd.cu", "replaces": gru_tpu + "270",
         "launches": launches_p["K5"], **gru_timed["K5"]},
        {"name": "gru_pass_bwd_input (K6-input)", "route": "cuda",
         "source": src + "gru_pass_bwd.cu", "replaces": gru_tpu + "287",
         "launches": launches_p["K6-input"], **gru_timed["K6-input"]},
        {"name": "gru_pass_bwd_weight (K6-weight)", "route": "cuda",
         "source": src + "gru_pass_bwd.cu", "replaces": gru_tpu + "287",
         "launches": launches_p["K6-weight"], **gru_timed["K6-weight"]},
    ]
    s4_launches, s4_timed = stride4
    for key, name, source, replaces in (
            ("K1", "tent_warp_fwd_diff", "tent_warp_fwd.cu", warp + "182"),
            ("K2", "tent_warp_bwd_feat", "tent_warp_bwd.cu", warp + "264"),
            ("K3", "tent_warp_bwd_coords", "tent_warp_bwd.cu", warp + "205"),
            ("K5", "gru_pass_fwd", "gru_pass_fwd.cu", gru_tpu + "270"),
            ("K6-input", "gru_pass_bwd_input", "gru_pass_bwd.cu", gru_tpu + "287"),
            ("K6-weight", "gru_pass_bwd_weight", "gru_pass_bwd.cu", gru_tpu + "287")):
        lines.append({"name": f"{name} ({key}, stride 4: 48x160 maps)", "route": "cuda",
                      "source": src + source, "replaces": replaces,
                      "launches": s4_launches[key], **s4_timed[key]})
    print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
