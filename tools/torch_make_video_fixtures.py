#!/usr/bin/env python3
"""Write the video fixtures of the port's decoder checks: MPEG-4 Part 2,
H.264 and HEVC.

    python3 tools/torch_make_video_fixtures.py              # all; needs OpenCV with FFmpeg
    python3 tools/torch_make_video_fixtures.py --only h264  # needs cc, libavformat, libx264
    python3 tools/torch_make_video_fixtures.py --only hevc  # needs cc, libavformat, libx265

Renders camera walks with the port's synthetic renderer (``SyntheticDataset``,
three planes): the camera pans and slides sideways, so that motion vectors
at the frame's edges point out of it, and a band at the bottom of every
frame is frozen, so that its macroblocks are not coded. OpenCV's
``cv2.VideoWriter`` (FFmpeg's ``mpeg4`` encoder: Simple Profile, I then 11
P-VOPs) writes them under ``dro_sfm_torch/testdata/video/``:

* ``walk_640x480`` as ``.mp4``, ``.mov`` and ``.avi`` (fourcc ``mp4v``) and
  as ``walk_640x480_xvid.avi`` (``XVID``), 36 frames each (3 GOPs);
* ``odd_200x136.mp4``: a size that is no multiple of 16 (edge macroblocks,
  cropping);
* ``noise_160x128.avi``: 8x8 blocks of uniform noise, new each frame, so
  that TCOEF escapes of all three types occur (checked here);
* ``walk_1280x720.mp4``, 24 frames, for the decode rate.

OpenCV's writer gives FFmpeg's encoder no options, and with its defaults the
encoder never predicts AC coefficients or changes the QP inside a VOP. So
``aic_176x144.avi`` is written by OpenCV's own libavcodec through ``ctypes``
(`encode_mpeg4`, into an AVI of fourcc ``FMP4`` written here) with ``flags
+aic`` and luminance masking: AC prediction, the alternate scans, DQUANT and
AC predictions rescaled to another QP (each checked here). The same route
writes one clip a tool of FFmpeg's encoder (`TOOLS`, 64x48, 4 frames: MPEG
quantisation, B-VOPs, quarter sample, data partitioning, resync markers,
four motion vectors), ``asp_176x144.avi`` with them together (B-VOPs with
direct prediction from four quarter-sample vectors, video packets in
partitioned P-VOPs), and the refusal fixture ``refuse_interlaced.avi``
(`REFUSALS`). The system's libavcodec writes the rest through
`tools/torch_h264_writer.c` (`write_libav`): ``matrices_176x144.avi``
(FFmpeg's ``mpeg4`` with MPEG quantisation under custom matrices, which
have no AVOption), ``bframes_176x144.mp4`` (its B-VOPs in MP4: a ``ctts``
box and an edit list) and XviD's clips from ``libxvid`` (`LIBAV_FILES`, fourcc
``XVID`` in AVI): B-VOPs (``bf`` 2) packed in AVI (XviD's "DivX...p" user
data: FFmpeg decodes a packet's second VOP with the next packet) and
unpacked in MP4, quarter sample, four vectors, MPEG quantisation and GMC
(S-VOPs of three warping points); ``xvid_640x480.avi`` (``bf`` 2 and four
vectors, packed, 36 frames of the walk), the clip ``infer_video`` runs on
the card, and ``xvid_1280x720.mp4`` for the decode rate. XviD's user data
makes FFmpeg run its XviD IDCT (checked here). Two copies of XviD clips
with their user data edited are refusals: one names XviD build 12 and one
only DivX 5.03, builds for which FFmpeg turns on bug workarounds. OpenCV
reads every refusal.

Beside them goes ``fixtures.json``: for every file the sha256 of each raw
packet (``CAP_PROP_FORMAT`` -1), of each luma plane (``CAP_PROP_CONVERT_RGB``
0) and of each RGB frame (``cv2.VideoCapture``'s BGR flipped), the frame
count, the fps, what the port's decoder counted in the stream
(`Mpeg4Decoder.stats`), the OpenCV and libavcodec versions, and the sha256
of the port's own decode of all frames here (luma and RGB), so that another
machine's build of the decoder is held to the same bits without OpenCV.

The H.264 fixtures (`H264_FILES`, under ``dro_sfm_torch/testdata/h264/``
with their own ``fixtures.json``) are the same renders written by libx264
through the system's libavcodec and libavformat (`tools/torch_h264_writer.c`,
compiled into ``build/`` at first use, its encoder flushed so that every
frame is written): the walk at 640x480 as ``.mp4``, ``.mov`` and ``.avi``
(Annex B, fourcc ``H264``), the walk with an IDR picture every 8 frames
as ``.mp4`` and ``.avi`` (the decoder's reset at a later IDR; in the AVI
the SPS and PPS come again before each IDR picture), 200x136 with several
slices and reference
frames (cropping and edge macroblocks), 1280x720 (the decode rate), noise in
4 slices (intra macroblocks in P slices, large levels), noise at QP 1 (the
level_prefix escapes), 16 reference frames with every partition,
constrained intra prediction, the deblocking offsets -3:3 and 3:-3, the
filter off, and the VUI colour matrices OpenCV converts by (BT.709 with
``range=pc``, FCC, SMPTE 240M, BT.2020); then libx264's defaults (High
profile: CABAC, B-pyramid, the 8x8 transform, weighted P, implicit
weighted B, list modification, MMCO) on the walk at 640x480 as ``.mp4``,
``.mov`` and ``.avi`` and at 1280x720, all at 25 fps (the MP4's edit list
trims the last frame in display order: OpenCV yields 23 of 24), with an
IDR picture every 8 frames (reordering across IDR pictures), on a fade
(explicit weights), with temporal direct prediction, cabac_init_idc 1
and 2, noise at QP 1 in 4 CABAC slices, the JVT and custom scaling lists;
and single Main and High tools under CAVLC (B slices, the 8x8 transform,
weighted P) and CABAC alone. The refusal fixtures (`H264_REFUSALS`, 64x48,
6 frames each) are tools the port's decoder refuses: interlace, 4:4:4 and
10-bit; OpenCV reads every one. For an H.264 file ``fixtures.json`` holds the
sha256 of each packet as the file stores it (`sample_form`: OpenCV gives
an MP4's samples in the Annex B form of FFmpeg's ``h264_mp4toannexb``, an
AVI's as they are), of each luma plane and of each RGB frame. OpenCV 5.0.0
converts to RGB with the table of the VUI's matrix_coefficients, and its
luma (``CAP_PROP_CONVERT_RGB`` 0) of a stream of another matrix than
BT.601 is not the decoded plane: the luma of such a fixture is taken from a
copy whose SPS names no matrix (`without_colour_matrix`), the same pictures.

The HEVC fixtures (`HEVC_FILES`, under ``dro_sfm_torch/testdata/hevc/``
with their own ``fixtures.json``) are the same renders written by libx265
through the same writer (``encoder=libx265``): libx265's defaults (Main
profile, CTU 64, wavefronts, AQ with cu_qp_delta, sign hiding, TMVP, weighted
P, 4 B-frames in a pyramid, deblocking and SAO) on the walk at 640x480 as
``.mp4`` (sample entry ``hev1``), ``.mov`` (``tag=hvc1``, as Apple writes)
and ``.avi`` (fourcc ``HEVC``, Annex B) and at 1280x720, at 25 fps (the
MP4's edit list trims the last frame in display order); then, at 64x48 to
320x240, the presets ultrafast and veryslow (AMP, rect, 5 references), an
open GOP (``keyint=8``: CRA pictures with RASL pictures, in MP4 and in an
AVI of fourcc ``H265``), IDR_W_RADL with RADL pictures, 4 slices, no
wavefronts, CTUs of 16 and 32, a size that is no multiple of 8 (the
conformance window), noise at QP 4 (long coeff_abs_level_remaining), the
chroma QP offsets, the deblocking offsets both ways, deblocking and SAO off,
explicit weighted bi-prediction on a fade, the default scaling lists and a
custom list file written here (`hevc_scaling_list`), transform skip,
constrained intra, lossless (cu_transquant_bypass), and the VUI colour
matrices (BT.709 in full range, BT.601 in full range, FCC, SMPTE 240M,
BT.2020). Most small clips carry libx265's MD5 picture hash SEI
(``hash=1``): the tests hold every decoded picture's three planes to it.
OpenCV 5.0.0 converts an HEVC frame by its VUI matrix and range, and its
luma of such a stream is converted too: the luma of a colour fixture is
taken from a copy whose SPS names no matrix and limited range
(`without_hevc_colour`). For an MP4, ``fixtures.json`` holds the sha256 of
the file's samples, each checked here to be OpenCV's packet once put in the
Annex B form of FFmpeg's ``hevc_mp4toannexb`` (`hevc_annexb`: 4-byte start
codes, the ``hvcC``'s NAL units before the first IRAP slice of a packet).
The refusal fixtures (`HEVC_REFUSALS`) are Main 10, 4:2:2, 4:4:4 and field
coding (``interlace=tff``, which OpenCV's swscale cannot convert).
"""
import argparse
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402
from dro_sfm_torch.utils.video_io import (H264Decoder, HevcDecoder, Mpeg4Decoder,  # noqa: E402
                                          VideoReader, demux)

OUT = ROOT / "dro_sfm_torch" / "testdata" / "video"
FPS = 30
# name: (height, width, frames, fourcc, content)
FILES = {
    "walk_640x480.mp4": (480, 640, 36, "mp4v", "walk"),
    "walk_640x480.mov": (480, 640, 36, "mp4v", "walk"),
    "walk_640x480.avi": (480, 640, 36, "mp4v", "walk"),
    "walk_640x480_xvid.avi": (480, 640, 36, "XVID", "walk"),
    "odd_200x136.mp4": (136, 200, 36, "mp4v", "walk"),
    "noise_160x128.avi": (128, 160, 8, "mp4v", "noise"),
    "walk_1280x720.mp4": (720, 1280, 24, "mp4v", "walk"),
}
# FFmpeg's encoder through OpenCV's libavcodec: name: (height, width, frames, content, the
# encoder's options, the decoder's counts that must not be 0)
TOOLS = {
    "mpeg_quant_64x48.avi": (48, 64, 4, "stripes", {"mpeg_quant": "1"}, ["mpeg_quant_vops"]),
    "bframes_64x48.avi": (48, 64, 4, "stripes", {"bf": "2"},
                          ["b_vops", "b_direct_mbs", "b_interpolated_mbs"]),
    "qpel_64x48.avi": (48, 64, 4, "stripes", {"flags": "+qpel"},
                       ["quarter_sample_predictions"]),
    "partitioned_64x48.avi": (48, 64, 4, "stripes", {"data_partitioning": "1"},
                              ["partitioned_vops"]),
    "resync_64x48.avi": (48, 64, 4, "stripes", {"ps": "100"}, ["video_packets"]),
    "mv4_64x48.avi": (48, 64, 4, "blocks", {"flags": "+mv4"}, ["four_mv_mbs"]),
    "aic_176x144.avi": (144, 176, 8, "stripes",
                        {"flags": "+aic", "scplx_mask": "0.9", "tcplx_mask": "0.5", "g": "2"},
                        ["ac_pred_mbs", "dquant_mbs", "ac_rescales"]),
    "asp_176x144.avi": (144, 176, 12, "blocks",
                        {"bf": "2", "flags": "+qpel+mv4", "mpeg_quant": "1", "ps": "400",
                         "data_partitioning": "1", "g": "6", "scplx_mask": "0.5"},
                        ["b_vops", "b_direct_mbs", "four_mv_mbs", "quarter_sample_predictions",
                         "video_packets", "partitioned_vops", "dbquant_mbs"]),
}
# name: (the encoder's options, what the port's NotImplementedError names)
REFUSALS = {
    "refuse_interlaced.avi": ({"flags": "+ildct"}, "interlaced"),
}
# custom matrices (raster order) for FFmpeg's mpeg4 encoder through the system's libavcodec
INTRA_MATRIX = ",".join(str(8 + (r + c) * 2 + (r * c) % 5) for r in range(8) for c in range(8))
INTER_MATRIX = ",".join(str(16 + 3 * r + c) for r in range(8) for c in range(8))
# the system's libavcodec (`write_libav`): name: (height, width, frames given to the encoder,
# content, options, the decoder's counts that must not be 0)
XVID = ["encoder=libxvid", "tag=XVID"]
LIBAV_FILES = {
    "matrices_176x144.avi": (144, 176, 12, "walk", [
        "encoder=mpeg4", "tag=FMP4", "mpeg_quant=1", "bf=1", "intra_matrix=" + INTRA_MATRIX,
        "inter_matrix=" + INTER_MATRIX], ["mpeg_quant_vops", "b_vops"]),
    "bframes_176x144.mp4": (144, 176, 12, "walk", ["encoder=mpeg4", "bf=2"],
                            ["b_vops", "b_direct_mbs", "b_backward_mbs"]),
    "xvid_bf2_176x144.avi": (144, 176, 12, "walk", [*XVID, "bf=2"],
                             ["b_vops", "packed_vops", "b_direct_mbs", "xvid_idct_vops"]),
    "xvid_bf2_176x144.mp4": (144, 176, 12, "walk", ["encoder=libxvid", "bf=2"],
                             ["b_vops", "b_direct_mbs", "xvid_idct_vops"]),
    "xvid_qpel_176x144.avi": (144, 176, 12, "walk", [*XVID, "flags=+qpel"],
                              ["quarter_sample_predictions"]),
    "xvid_mv4_176x144.avi": (144, 176, 12, "blocks", [*XVID, "flags=+mv4"], ["four_mv_mbs"]),
    "xvid_mpeg_quant_176x144.avi": (144, 176, 12, "walk", [*XVID, "mpeg_quant=1"],
                                    ["mpeg_quant_vops"]),
    "xvid_gmc_176x144.avi": (144, 176, 12, "walk", [*XVID, "gmc=1"], ["s_vops", "gmc_mbs"]),
    # FFmpeg's libxvid wrapper does not flush XviD's last B-frames: 38 frames give 36
    "xvid_640x480.avi": (480, 640, 38, "walk", [*XVID, "bf=2", "flags=+mv4", "b=1000k"],
                         ["b_vops", "packed_vops", "four_mv_mbs", "b_direct_mbs"]),
    "xvid_1280x720.mp4": (720, 1280, 26, "walk", ["encoder=libxvid", "bf=2", "flags=+mv4",
                                                   "b=2000k"], ["b_vops", "b_direct_mbs"]),
}
# copies of XviD clips with their user data edited: name: (source, (old, new) bytes, what
# the port's NotImplementedError names)
EDITED_REFUSALS = {
    "refuse_xvid_build12.avi": ("xvid_mv4_176x144.avi", (b"XviD0069", b"XviD0012"),
                                "XviD build 12"),
    "refuse_divx503.avi": ("xvid_bf2_176x144.avi", (b"XviD0069", b"xxxx0069"),
                           "DivX 503 build 1393"),
}
STATIC_ROWS = 1 / 8          # the frozen band at the bottom, a share of the height
LIMIT = 3 << 19              # bytes of the whole folder

H264_OUT = ROOT / "dro_sfm_torch" / "testdata" / "h264"
H264_WRITER = ROOT / "tools" / "torch_h264_writer.c"
BASELINE = "profile=baseline"
HIGH = "profile=high"
# custom scaling lists (x264's cqm4iy, cqm4ic, cqm4py, cqm4pc, cqm8i, cqm8p; zig-zag order)
CQM = ":".join([
    "cqm4iy=" + ",".join(str(6 + 2 * k) for k in range(16)),
    "cqm4ic=" + ",".join(str(10 + k) for k in range(16)),
    "cqm4py=" + ",".join(str(12 + 3 * (k // 4)) for k in range(16)),
    "cqm4pc=" + ",".join(str(16 + (k % 5)) for k in range(16)),
    "cqm8i=" + ",".join(str(8 + k // 2) for k in range(64)),
    "cqm8p=" + ",".join(str(12 + k // 3) for k in range(64))])
# name: (height, width, frames, content, the encoder's options)
H264_FILES = {
    "walk_640x480.mp4": (480, 640, 24, "walk", [BASELINE]),
    "walk_640x480.mov": (480, 640, 24, "walk", [BASELINE]),
    "walk_640x480.avi": (480, 640, 24, "walk", [BASELINE]),
    "idr8_640x480.mp4": (480, 640, 24, "walk", [BASELINE, "x264-params=keyint=8"]),
    "idr8_640x480.avi": (480, 640, 24, "walk", [BASELINE, "x264-params=keyint=8"]),
    "odd_200x136.mp4": (136, 200, 24, "walk",
                        [BASELINE, "x264-params=ref=3:slices=2:partitions=all"]),
    "walk_1280x720.mp4": (720, 1280, 24, "walk", [BASELINE]),
    "noise_slices_160x128.mp4": (128, 160, 8, "noise", [BASELINE, "x264-params=slices=4:qp=8"]),
    "noise_qp1_96x64.mp4": (64, 96, 6, "noise", [BASELINE, "x264-params=qp=1"]),
    "ref16_200x136.mp4": (136, 200, 24, "walk",
                          [BASELINE, "x264-params=ref=16:partitions=all:keyint=30"]),
    "constrained_intra_160x128.mp4": (128, 160, 8, "noise",
                                      [BASELINE, "x264-params=constrained-intra=1:qp=20"]),
    "deblock_m3p3_200x136.mp4": (136, 200, 12, "walk", [BASELINE, "x264-params=deblock=-3,3"]),
    "deblock_p3m3_200x136.mp4": (136, 200, 12, "walk", [BASELINE, "x264-params=deblock=3,-3"]),
    "no_deblock_200x136.mp4": (136, 200, 12, "walk", [BASELINE, "x264-params=no-deblock=1"]),
    "colour_bt709_pc_64x48.mp4": (48, 64, 6, "walk",
                                  [BASELINE, "x264-params=colormatrix=bt709:range=pc"]),
    "colour_fcc_64x48.mp4": (48, 64, 6, "walk", [BASELINE, "x264-params=colormatrix=fcc"]),
    "colour_smpte240m_64x48.mp4": (48, 64, 6, "walk",
                                   [BASELINE, "x264-params=colormatrix=smpte240m"]),
    "colour_bt2020_64x48.mp4": (48, 64, 6, "walk", [BASELINE, "x264-params=colormatrix=bt2020nc"]),
    # libx264 at its defaults: High profile, CABAC, B-pyramid, the 8x8 transform, weighted P
    # and implicit weighted B (at 25 fps the MP4's edit list trims the last frame, as FFmpeg
    # applies it)
    "high_640x480.mp4": (480, 640, 24, "walk", [HIGH]),
    "high_640x480.mov": (480, 640, 24, "walk", [HIGH]),
    "high_640x480.avi": (480, 640, 24, "walk", [HIGH]),
    "high_1280x720.mp4": (720, 1280, 24, "walk", [HIGH]),
    "high_idr8_320x240.mp4": (240, 320, 24, "walk", [HIGH, "x264-params=keyint=8"]),
    "high_fade_176x144.mp4": (144, 176, 30, "fade", [HIGH]),
    "high_temporal_direct_176x144.mp4": (144, 176, 24, "walk", [HIGH, "x264-params=direct=temporal"]),
    "high_cabac_idc1_176x144.mp4": (144, 176, 12, "walk", [HIGH, "x264-params=cabac-idc=1"]),
    "high_cabac_idc2_176x144.mp4": (144, 176, 12, "walk", [HIGH, "x264-params=cabac-idc=2"]),
    "high_noise_qp1_slices_160x128.mp4": (128, 160, 4, "noise", [HIGH, "x264-params=qp=1:slices=4"]),
    "high_cqm_jvt_176x144.mp4": (144, 176, 12, "walk", [HIGH, "x264-params=cqm=jvt"]),
    "high_cqm_custom_176x144.mp4": (144, 176, 12, "walk", [HIGH, "x264-params=" + CQM]),
    # single tools of Main and High with CAVLC (refused before the port decoded them)
    "main_cabac_64x48.mp4": (48, 64, 6, "walk", ["profile=main",
                                                  "x264-params=bframes=0:weightp=0"]),
    "main_bframes_cavlc_64x48.avi": (48, 64, 6, "walk", [
        "profile=main", "x264-params=cabac=0:bframes=2:b-adapt=0:weightp=0"]),
    "high_8x8dct_cavlc_64x48.mp4": (48, 64, 6, "walk", [
        "profile=high", "x264-params=cabac=0:8x8dct=1:bframes=0:weightp=0"]),
    "main_weighted_cavlc_64x48.mp4": (48, 64, 6, "walk", [
        "profile=main", "x264-params=cabac=0:bframes=0:weightp=2"]),
}
# the rate of the fixtures not written at FPS
H264_RATES = {name: 25 for name in H264_FILES if name.startswith("high_640x480") or
              name.startswith(("high_1280x720", "high_idr8"))}
# name: (pixel format, the encoder's options, what the port's NotImplementedError names)
H264_REFUSALS = {
    "refuse_interlaced.mp4": ("yuv420p", ["profile=main",
                                          "x264-params=cabac=0:interlaced=1:bframes=0:weightp=0"],
                              "interlaced"),
    "refuse_444.mp4": ("yuv444p", ["profile=high444", "x264-params=cabac=0:bframes=0:weightp=0"],
                       "chroma format 3"),
    "refuse_10bit.mp4": ("yuv420p10le", ["profile=high10",
                                         "x264-params=cabac=0:bframes=0:weightp=0"],
                         "bit depth 10"),
}
H264_LIMIT = 3 << 19         # bytes of the H.264 folder


HEVC_OUT = ROOT / "dro_sfm_torch" / "testdata" / "hevc"
X265 = "encoder=libx265"


def x265(params=""):
    """libx265 with ``params`` (x265-params) and its MD5 picture hash SEI."""
    return [X265, "x265-params=hash=1" + (":" + params if params else "")]


CUSTOM_LIST = "scaling-list=CUSTOM"   # replaced by the path of `hevc_scaling_list`'s file
# name: (height, width, frames, content, the encoder's options)
HEVC_FILES = {
    # libx265 at its defaults (at 25 fps the MP4's edit list trims the last frame)
    "main_640x480.mp4": (480, 640, 24, "walk", [X265]),
    "main_640x480.mov": (480, 640, 24, "walk", [X265, "tag=hvc1"]),
    "main_640x480.avi": (480, 640, 24, "walk", [X265, "tag=HEVC"]),
    "main_1280x720.mp4": (720, 1280, 24, "walk", [X265]),
    # presets and structures
    "ultrafast_176x144.mp4": (144, 176, 12, "walk", [*x265(), "preset=ultrafast"]),
    "veryslow_176x144.mp4": (144, 176, 12, "walk", [*x265(), "preset=veryslow"]),
    "open_gop_176x144.mp4": (144, 176, 24, "walk", x265("keyint=8")),
    "open_gop_176x144.avi": (144, 176, 24, "walk", [*x265("keyint=8"), "tag=H265"]),
    "radl_176x144.mp4": (144, 176, 24, "walk", x265(
        "keyint=9:min-keyint=9:open-gop=0:radl=2:bframes=2:b-adapt=0:scenecut=0:b-pyramid=0")),
    "slices4_176x144.mp4": (144, 176, 12, "walk", x265("slices=4")),
    "no_wpp_176x144.mp4": (144, 176, 12, "walk", x265("wpp=0")),
    "ctu16_176x144.mp4": (144, 176, 12, "walk", x265("ctu=16")),
    "ctu32_320x240.mp4": (240, 320, 12, "walk", x265("ctu=32")),
    "crop_202x138.mp4": (138, 202, 8, "walk", [X265]),
    "noise_qp4_96x64.mp4": (64, 96, 6, "noise", x265("qp=4")),
    # options
    "chroma_qp_offsets_176x144.mp4": (144, 176, 12, "walk", x265("cbqpoffs=-3:crqpoffs=4")),
    "deblock_m2p3_176x144.mp4": (144, 176, 12, "walk", x265("deblock=-2,3")),
    "deblock_p3m2_176x144.mp4": (144, 176, 12, "walk", x265("deblock=3,-2")),
    "no_deblock_no_sao_176x144.mp4": (144, 176, 12, "walk", x265("no-deblock=1:no-sao=1")),
    "weightb_fade_176x144.mp4": (144, 176, 30, "fade", x265("weightb=1")),
    "scaling_default_176x144.mp4": (144, 176, 12, "walk", x265("scaling-list=default")),
    "scaling_custom_176x144.mp4": (144, 176, 12, "walk", x265(CUSTOM_LIST)),
    "tskip_stripes_176x144.mp4": (144, 176, 8, "stripes", x265("tskip=1:qp=20")),
    "constrained_intra_176x144.mp4": (144, 176, 12, "walk", x265("constrained-intra=1")),
    "lossless_96x64.mp4": (64, 96, 6, "walk", x265("lossless=1")),
    # the VUI colour matrices and range OpenCV converts by
    "colour_bt709_full_64x48.mp4": (48, 64, 6, "walk", x265("colormatrix=bt709:range=full")),
    "colour_bt601_full_64x48.mp4": (48, 64, 6, "walk", x265("range=full")),
    "colour_fcc_64x48.mp4": (48, 64, 6, "walk", x265("colormatrix=fcc")),
    "colour_smpte240m_64x48.mp4": (48, 64, 6, "walk", x265("colormatrix=smpte240m")),
    "colour_bt2020_64x48.mp4": (48, 64, 6, "walk", x265("colormatrix=bt2020nc")),
}
HEVC_RATES = {name: 25 for name in HEVC_FILES if name.startswith("main_")}
# name: (pixel format, the encoder's options, what the port's NotImplementedError names)
HEVC_REFUSALS = {
    "refuse_main10.mp4": ("yuv420p10le", [X265], "bit depth 10"),
    "refuse_422.mp4": ("yuv422p", [X265], "chroma format 2"),
    "refuse_444.mp4": ("yuv444p", [X265], "chroma format 3"),
    "refuse_interlaced.mp4": ("yuv420p", [X265, "x265-params=interlace=tff"], "field coding"),
}
HEVC_LIMIT = 3 << 19         # bytes of the HEVC folder


def walk(h, w, n):
    """``n`` frames (uint8 RGB) of scene 0 seen by a camera that pans by
    0.012 rad a frame while it slides sideways and forward; the bottom
    band of every frame is the first frame's."""
    data = SyntheticDataset(SyntheticConfig(height=h, width=w, num_planes=3, seed=0))
    planes, _ = data._scene(0)
    frames = []
    for i in range(n):
        a = 0.012 * i
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        T[:3, 3] = [0.05 * i, 0.0, 0.02 * i]
        frames.append((data._render(planes, T)[0] * 255).astype(np.uint8))
    band = h - int(round(h * STATIC_ROWS / 16)) * 16
    for f in frames[1:]:
        f[band:] = frames[0][band:]
    return frames


def fade(h, w, n):
    """`walk` fading to a fifth of its brightness: libx264's weighted P
    prediction, list modification and MMCO pay."""
    return [(f * (1 - 0.8 * i / max(n - 1, 1))).astype(np.uint8)
            for i, f in enumerate(walk(h, w, n))]


def noise(h, w, n):
    rng = np.random.default_rng(0)
    return [np.kron(rng.integers(0, 256, (h // 8, w // 8, 3)), np.ones((8, 8, 1))
                    ).astype(np.uint8) for _ in range(n)]


def stripes(h, w, n):
    """Bands of fine horizontal and vertical stripes under a luminance
    ramp, moving down and right: AC prediction pays, and luminance masking
    varies the QP from macroblock to macroblock."""
    yy, xx = np.mgrid[0:h + 4 * n, 0:w + 6 * n]
    pattern = np.where(((xx // 3) % 2 == 0) ^ ((yy // 40) % 2 == 0), 200, 40) * (yy % 80 < 40) \
        + np.where((yy // 3) % 2 == 0, 220, 30) * (yy % 80 >= 40)
    lum = (pattern * (0.15 + 0.85 * xx / xx.shape[1])).astype(np.uint8)
    rgb = np.stack([255 - lum, np.roll(lum, 7, 1), lum], -1)
    return [np.ascontiguousarray(rgb[4 * i:4 * i + h, 6 * i:6 * i + w]) for i in range(n)]


def blocks_moving(h, w, n):
    """A texture cut into 8x8 blocks, each moving its own way: four
    vectors a macroblock pay."""
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.integers(0, 256, (h + 200, w + 200, 3), dtype=np.uint8),
                           (0, 0), 1.5)
    dirs = rng.integers(-3, 4, (h // 8, w // 8, 2))
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        for by in range(h // 8):
            for bx in range(w // 8):
                y0, x0 = 100 + 8 * by + dirs[by, bx, 0] * i, 100 + 8 * bx + dirs[by, bx, 1] * i
                f[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = tex[y0:y0 + 8, x0:x0 + 8]
        frames.append(f)
    return frames


def libavcodec():
    """OpenCV's own libavutil and libavcodec (the wheel's
    ``opencv_python.libs``), their entry points typed."""
    import ctypes
    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    avu = ctypes.CDLL(str(next(libs.glob("libavutil*"))), mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(str(next(libs.glob("libavcodec*"))))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, res, args in [
            (avc.avcodec_find_encoder_by_name, vp, [ctypes.c_char_p]),
            (avc.avcodec_alloc_context3, vp, [vp]), (avc.avcodec_open2, i32, [vp, vp, vp]),
            (avc.avcodec_send_frame, i32, [vp, vp]), (avc.avcodec_receive_packet, i32, [vp, vp]),
            (avc.avcodec_free_context, None, [vp]), (avc.av_packet_alloc, vp, []),
            (avc.av_packet_unref, None, [vp]), (avc.av_packet_free, None, [vp]),
            (avu.av_frame_alloc, vp, []), (avu.av_frame_free, None, [vp]),
            (avu.av_frame_get_buffer, i32, [vp, i32]), (avu.av_frame_make_writable, i32, [vp]),
            (avu.av_opt_set, i32, [vp, ctypes.c_char_p, ctypes.c_char_p, i32])]:
        fn.restype, fn.argtypes = res, args
    return ctypes, avu, avc


def encode_mpeg4(frames, options):
    """The packets of FFmpeg's ``mpeg4`` encoder (OpenCV's libavcodec) for
    uint8 RGB frames, converted to yuv420p by OpenCV, with the encoder's
    ``options`` (AVOptions by name). AVCodecContext's time_base and
    AVFrame's size and format, which have no AVOption, are written at their
    offsets in libavcodec 62 / libavutil 60; the offsets are checked against
    the sizes set through AVOptions."""
    ctypes, avu, avc = libavcodec()
    h, w = frames[0].shape[:2]
    codec = avc.avcodec_find_encoder_by_name(b"mpeg4")
    ctx = avc.avcodec_alloc_context3(codec)
    opts = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", **options}
    for k, v in opts.items():
        if avu.av_opt_set(ctx, k.encode(), v.encode(), 1) != 0:
            raise RuntimeError(f"libavcodec refuses the option {k}={v}")
    ints = (ctypes.c_int * 32).from_address(ctx)
    if (ints[28], ints[29]) != (w, h):          # width, height at bytes 112, 116
        raise RuntimeError("AVCodecContext's layout is not libavcodec 62's")
    ints[21], ints[22] = 1, FPS                 # time_base at byte 84
    if avc.avcodec_open2(ctx, codec, None) != 0:
        raise RuntimeError(f"the mpeg4 encoder does not open with {options}")
    frame, pkt, packets = avu.av_frame_alloc(), avc.av_packet_alloc(), []
    fints = (ctypes.c_int * 32).from_address(frame)
    fints[26], fints[27], fints[29] = w, h, 0    # width, height, format (yuv420p)
    if avu.av_frame_get_buffer(frame, 0) != 0:
        raise RuntimeError("av_frame_get_buffer failed")
    data = (ctypes.c_void_p * 8).from_address(frame)
    lines = (ctypes.c_int * 8).from_address(frame + 64)

    def drain():
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            ptr = ctypes.c_void_p.from_address(pkt + 24).value
            packets.append(ctypes.string_at(ptr, ctypes.c_int.from_address(pkt + 32).value))
            avc.av_packet_unref(pkt)

    for f in frames:
        yuv = cv2.cvtColor(np.ascontiguousarray(f[..., ::-1]), cv2.COLOR_BGR2YUV_I420)
        planes = (yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2),
                  yuv[h + h // 4:].reshape(h // 2, w // 2))
        if avu.av_frame_make_writable(frame) != 0:
            raise RuntimeError("av_frame_make_writable failed")
        for p, plane in enumerate(planes):
            ph, pw = plane.shape
            buf = (ctypes.c_uint8 * (lines[p] * ph)).from_address(data[p])
            np.ctypeslib.as_array(buf).reshape(ph, lines[p])[:, :pw] = plane
        if avc.avcodec_send_frame(ctx, frame) != 0:
            raise RuntimeError("avcodec_send_frame failed")
        drain()
    avc.avcodec_send_frame(ctx, None)
    drain()
    for fn, obj in ((avu.av_frame_free, frame), (avc.av_packet_free, pkt),
                    (avc.avcodec_free_context, ctx)):
        fn(ctypes.byref(ctypes.c_void_p(obj)))
    return packets


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) % 2 else b"")


def write_avi(path, packets, h, w, fourcc=b"FMP4"):
    """An AVI 1.0 file of one video stream of ``packets`` (``00dc`` chunks
    and an ``idx1`` index, I-VOPs flagged as key frames)."""
    big = max(map(len, packets))
    avih = struct.pack("<14I", 1000000 // FPS, 0, 0, 0x10, len(packets), 0, 1, big, w, h,
                       0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, FPS, 0, len(packets),
                                          big, -1, 0) + struct.pack("<4h", 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
    strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
    hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
    movi, index = [b"movi"], []
    for p in packets:
        vop = p.find(b"\0\0\1\xb6")
        key = vop >= 0 and vop + 4 < len(p) and p[vop + 4] >> 6 == 0
        index.append(struct.pack("<4sIII", b"00dc", 0x10 if key else 0,
                                 sum(map(len, movi)), len(p)))
        movi.append(_chunk(b"00dc", p))
    body = b"AVI " + _chunk(b"LIST", hdrl) + _chunk(b"LIST", b"".join(movi)) \
        + _chunk(b"idx1", b"".join(index))
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def capture(path, props=()):
    cap = cv2.VideoCapture(str(path))
    for k, v in props:
        cap.set(k, v)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out, fps


def opencv_digests(path):
    """cv2.VideoCapture's packets, luma planes and RGB frames of ``path``,
    as sha256 lists, and its fps."""
    packets, fps = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    luma, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    bgr, _ = capture(path)
    return {"packets": [sha(p.ravel()) for p in packets],
            "luma": [sha(y if y.ndim == 2 else y[..., 0]) for y in luma],
            "rgb": [sha(f[..., ::-1]) for f in bgr]}, fps


def port_digests(path):
    """The port's decode of ``path`` through `Mpeg4Decoder`, its frames in
    display order (those an MP4's edit list trims left out): the sha256 of
    all its luma planes and of all its RGB frames, the per-frame digests,
    the decoder's counts and the encoder it names."""
    stream = demux(str(path))
    dec = Mpeg4Decoder.for_stream(stream)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    frames = {"packets": [hashlib.sha256(p).hexdigest() for p in stream.packets()],
              "luma": [], "rgb": []}
    for p in [*stream.packets(), None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
                frames["luma"].append(sha(y))
                frames["rgb"].append(sha(img))
    return {"luma_all": luma.hexdigest(), "rgb_all": rgb.hexdigest()}, frames, dec.stats, \
        dec.encoder


def libav_writer() -> str:
    """`tools/torch_h264_writer.c` built against the system's libavformat,
    libavcodec and libavutil into ``build/``, named by the source's hash;
    built in a temporary file and moved into place."""
    digest = hashlib.sha256(H264_WRITER.read_bytes()).hexdigest()[:12]
    out = ROOT / "build" / f"torch_h264_writer_{digest}"
    if not out.is_file():
        out.parent.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out.parent)
        os.close(fd)
        subprocess.run(["cc", "-O2", "-o", tmp, str(H264_WRITER), "-lavformat", "-lavcodec",
                        "-lavutil"], check=True)
        os.replace(tmp, out)
    return str(out)


def write_libav(path, frames, options, pixfmt="yuv420p", fps=FPS):
    """uint8 RGB ``frames`` as a video file at ``path`` (its container by
    extension) from libx264, or the encoder an ``encoder=`` option names,
    with ``options`` (name=value AVOptions, `tools/torch_h264_writer.c`), the
    frames converted to ``pixfmt`` by OpenCV (BT.601, limited range; 4:4:4,
    4:2:2 and 10-bit from the same conversion)."""
    h, w = frames[0].shape[:2]
    raw = []
    for f in frames:
        bgr = np.ascontiguousarray(f[..., ::-1])
        if pixfmt in ("yuv444p", "yuv422p"):
            ycrcb = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
            planes = np.ascontiguousarray(ycrcb[..., [0, 2, 1]].transpose(2, 0, 1))
            if pixfmt == "yuv422p":      # chroma: the mean of each horizontal pair
                chroma = (planes[1:, :, 0::2].astype(int) + planes[1:, :, 1::2] + 1) // 2
                planes = [planes[0], chroma[0].astype(np.uint8), chroma[1].astype(np.uint8)]
            raw.append(b"".join(np.ascontiguousarray(p).tobytes() for p in planes))
        else:
            yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
            raw.append((yuv.astype("<u2") << 2).tobytes() if pixfmt == "yuv420p10le"
                       else yuv.tobytes())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "frames.raw"
        src.write_bytes(b"".join(raw))
        res = subprocess.run([libav_writer(), str(src), str(path), str(w), str(h),
                              str(len(frames)), str(fps), pixfmt, *options],
                             capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{path}: the writer failed: {res.stderr[-2000:]}")


class _Bits:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def u(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self):
        zeros = 0
        while not self.u(1):
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)


def _unescape(nal: bytes):
    """The RBSP of a NAL unit and, for each RBSP byte, its offset in the NAL."""
    rbsp, where, zeros = bytearray(), [], 0
    for i, b in enumerate(nal):
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        rbsp.append(b)
        where.append(i)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(rbsp), where


def without_colour_matrix(data: bytes) -> bytes:
    """An MP4 of a Baseline stream whose ``avcC`` SPS has a VUI colour
    description, its matrix_coefficients set to 2 (unspecified): the same
    pictures, which OpenCV then gives as their decoded luma planes."""
    pos = data.find(b"avcC") + 4
    n = int.from_bytes(data[pos + 6:pos + 8], "big")
    start = pos + 8
    rbsp, where = _unescape(data[start + 1:start + n])
    r = _Bits(rbsp)
    if r.u(8) != 66:
        raise ValueError("not a Baseline SPS")
    r.u(16)
    r.ue()
    r.ue()
    if r.ue() == 0:
        r.ue()
    r.ue()
    r.u(1)
    r.ue()
    r.ue()
    if not r.u(1):
        raise ValueError("not frame_mbs_only")
    r.u(1)
    if r.u(1):
        for _ in range(4):
            r.ue()
    if not r.u(1):
        raise ValueError("no VUI")
    if r.u(1) and r.u(8) == 255:          # aspect_ratio_idc 255: an extended SAR
        r.u(32)
    if r.u(1):
        r.u(1)
    if not r.u(1):
        raise ValueError("no video signal type")
    r.u(4)                                # video_format, video_full_range_flag
    if not r.u(1):
        raise ValueError("no colour description")
    r.u(16)
    byte, bit = divmod(r.pos, 8)
    out = bytearray(data)
    edited = bytearray(rbsp)
    word = int.from_bytes(edited[byte:byte + 2].ljust(2, b"\0"), "big")
    word = (word & ~(0xFF << (8 - bit))) | (2 << (8 - bit))
    edited[byte:byte + 2] = word.to_bytes(2, "big")[:len(edited[byte:byte + 2])]
    for k in range(byte, min(byte + 2, len(rbsp))):
        out[start + 1 + where[k]] = edited[k]
    if _unescape(bytes(out[start + 1:start + n]))[0] != bytes(edited):
        raise ValueError("the edit would change the SPS's emulation prevention")
    return bytes(out)


def avcc(config: bytes):
    """The NAL length size and the parameter sets (SPS then PPS) of an
    ``avcC`` body."""
    size, sets, pos, count = (config[4] & 3) + 1, [], 6, config[5] & 31
    for kind in (7, 8):
        for _ in range(count):
            n = int.from_bytes(config[pos:pos + 2], "big")
            sets.append(bytes(config[pos + 2:pos + 2 + n]))
            pos += 2 + n
        if kind == 7:
            count, pos = config[pos], pos + 1
    return size, sets


def annexb_nals(packet: bytes):
    """The NAL units of an Annex B packet, split at its start codes (a
    CAVLC NAL unit never ends in a zero byte)."""
    return [nal.rstrip(b"\0") for nal in packet.split(b"\0\0\1")[1:]]


def sample_form(packet: bytes) -> bytes:
    """An MP4 sample (4-byte NAL lengths) from FFmpeg's Annex B form of it:
    the packet split at its start codes, the SPS and PPS that
    ``h264_mp4toannexb`` puts before an IDR picture dropped (libavformat's
    MP4 samples of libx264 hold none)."""
    return b"".join(len(nal).to_bytes(4, "big") + nal for nal in annexb_nals(packet)
                    if nal[0] & 31 not in (7, 8))


def opencv_h264_digests(path, colour=False):
    """`opencv_digests` of an H.264 file, an MP4's packets in `sample_form`;
    with ``colour`` the luma planes of `without_colour_matrix`'s copy."""
    cv, fps = opencv_digests(path)
    if Path(path).suffix != ".avi":
        packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
        cv["packets"] = [hashlib.sha256(sample_form(p.tobytes())).hexdigest() for p in packets]
    if colour:
        with tempfile.TemporaryDirectory() as tmp:
            plain = Path(tmp) / Path(path).name
            plain.write_bytes(without_colour_matrix(Path(path).read_bytes()))
            luma, _ = capture(plain, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
        cv["luma"] = [sha(y if y.ndim == 2 else y[..., 0]) for y in luma]
    return cv, fps


def port_h264_digests(path):
    """`port_digests` through `H264Decoder`: the frames in output order,
    those the MP4's edit list trims left out (`Demuxed.shown`)."""
    stream = demux(str(path))
    if stream.config and avcc(stream.config)[0] != 4:
        raise RuntimeError(f"{path}: NAL lengths of other than 4 bytes (`sample_form`)")
    dec = H264Decoder(stream.config)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    frames = {"packets": [hashlib.sha256(p).hexdigest() for p in stream.packets()],
              "luma": [], "rgb": []}
    for p in [*stream.packets(), None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
                frames["luma"].append(sha(y))
                frames["rgb"].append(sha(img))
    return {"luma_all": luma.hexdigest(), "rgb_all": rgb.hexdigest()}, frames, dec.stats, \
        dec.encoder


def hvcc(config: bytes):
    """The NAL length size and the NAL units (VPS, SPS, PPS, SEI, in order)
    of an ``hvcC`` body."""
    size, nals, pos = (config[21] & 3) + 1, [], 23
    for _ in range(config[22]):
        count = int.from_bytes(config[pos + 1:pos + 3], "big")
        pos += 3
        for _ in range(count):
            n = int.from_bytes(config[pos:pos + 2], "big")
            nals.append(bytes(config[pos + 2:pos + 2 + n]))
            pos += 2 + n
    return size, nals


def hevc_annexb(sample: bytes, config: bytes) -> bytes:
    """An MP4 sample in the form FFmpeg's ``hevc_mp4toannexb`` gives it:
    each NAL unit behind a 4-byte start code, the ``hvcC``'s NAL units
    before the first IRAP slice of the packet."""
    size, sets = hvcc(config)
    out, pos, irap_seen = bytearray(), 0, False
    while pos < len(sample):
        n = int.from_bytes(sample[pos:pos + size], "big")
        nal = sample[pos + size:pos + size + n]
        pos += size + n
        irap = 16 <= (nal[0] >> 1) & 63 <= 23
        if irap and not irap_seen:
            out += b"".join(b"\0\0\0\1" + x for x in sets)
        irap_seen |= irap
        out += b"\0\0\0\1" + nal
    return bytes(out)


def hevc_scaling_list(path: Path) -> None:
    """A custom scaling list file as libx265 reads it (HM's format, each
    matrix in the up-right diagonal scan): lists of every size, the 16x16
    and 32x32 DCs, and inter chroma V equal to inter chroma U with its DC,
    which the encoder then codes as predicted from it (7.3.4)."""
    lines = []
    for size, count in ((4, 16), (8, 64), (16, 64), (32, 64)):
        for k, kind in enumerate(("INTRA", "INTER")):
            for c, comp in enumerate(("LUMA", "CHROMAU", "CHROMAV")):
                name = f"{kind}{size}X{size}_{comp}"
                if size == 32 and comp != "LUMA":
                    name = f"{kind}32X32_{comp}_FROM16x16_{comp}"
                cc = 1 if (kind, comp) == ("INTER", "CHROMAV") else c
                vals = [8 + 4 * k + 3 * cc + (i * (5 + cc)) % 13 + size // 4 for i in range(count)]
                lines.append(f"{name} =")
                lines += [",".join(str(v) for v in vals[r:r + 8]) for r in range(0, count, 8)]
                if size >= 16:
                    lines += [f"{kind}{size}X{size}_{comp}_DC =", str(10 + 3 * k + 2 * cc + size // 8)]
    path.write_text("\n".join(lines) + "\n")


def _st_rps(r, idx, sets):
    """One st_ref_pic_set of an SPS (7.3.7): its deltas (negative, then
    positive)."""
    if idx and r.u(1):
        sign, delta = r.u(1), r.ue() + 1
        delta_rps = -delta if sign else delta
        ref = sets[idx - 1]
        neg, pos = [], []
        for j, d in enumerate([*ref, 0]):
            used = r.u(1)
            if used or r.u(1):
                v = (d + delta_rps) if j < len(ref) else delta_rps
                (neg if v < 0 else pos if v > 0 else []).append(v)
        return sorted(neg, reverse=True) + sorted(pos)
    n_neg, n_pos = r.ue(), r.ue()
    out, poc = [], 0
    for _ in range(n_neg):
        poc -= r.ue() + 1
        r.u(1)
        out.append(poc)
    poc = 0
    for _ in range(n_pos):
        poc += r.ue() + 1
        r.u(1)
        out.append(poc)
    return out


def _hevc_colour_bits(rbsp: bytes):
    """The bit offsets in an HEVC SPS's RBSP (past its NAL header) of
    video_full_range_flag and matrix_coeffs (None without a colour
    description)."""
    r = _Bits(rbsp)
    r.u(4)
    sub = r.u(3)
    r.u(1)
    r.u(8), r.u(32), r.u(48), r.u(8)                 # general profile_tier_level
    flags = [(r.u(1), r.u(1)) for _ in range(sub)]
    if sub:
        r.u(2 * (8 - sub))
    for profile, level in flags:
        r.u(88 * profile), r.u(8 * level)
    r.ue()
    if r.ue() == 3:
        r.u(1)
    r.ue(), r.ue()
    if r.u(1):
        for _ in range(4):
            r.ue()
    for _ in range(3):
        r.ue()
    for _ in range(sub + 1 if r.u(1) else 1):
        r.ue(), r.ue(), r.ue()
    for _ in range(6):
        r.ue()
    if r.u(1) and r.u(1):
        raise ValueError("an SPS with scaling lists")
    r.u(2)
    if r.u(1):
        raise ValueError("an SPS with PCM")
    sets = []
    for i in range(r.ue()):
        sets.append(_st_rps(r, i, sets))
    if r.u(1):
        raise ValueError("an SPS with long-term references")
    r.u(2)
    if not r.u(1):
        raise ValueError("no VUI")
    if r.u(1) and r.u(8) == 255:
        r.u(32)
    if r.u(1):
        r.u(1)
    if not r.u(1):
        raise ValueError("no video signal type")
    r.u(3)
    full = r.pos
    r.u(1)
    if not r.u(1):
        return full, None
    r.u(16)
    return full, r.pos


def without_hevc_colour(data: bytes) -> bytes:
    """An MP4 of HEVC whose ``hvcC`` SPS has a VUI video signal type, its
    video_full_range_flag set to 0 and its matrix_coeffs, if any, to 2
    (unspecified): the same pictures, which OpenCV then gives as their
    decoded luma."""
    at = data.find(b"hvcC") + 4
    size, nals = hvcc(data[at:at + 4096])
    sps = next(n for n in nals if (n[0] >> 1) & 63 == 33)
    start = data.find(sps)
    rbsp, where = _unescape(sps[2:])
    full, matrix = _hevc_colour_bits(rbsp)
    bits = list("".join(f"{b:08b}" for b in rbsp))
    bits[full] = "0"
    if matrix is not None:
        bits[matrix:matrix + 8] = list(f"{2:08b}")
    edited = bytes(int("".join(bits[i:i + 8]), 2) for i in range(0, len(bits), 8))
    out = bytearray(data)
    for k in range(len(rbsp)):
        out[start + 2 + where[k]] = edited[k]
    if _unescape(bytes(out[start + 2:start + len(sps)]))[0] != edited:
        raise ValueError("the edit would change the SPS's emulation prevention")
    return bytes(out)


def opencv_hevc_digests(path, colour=False):
    """`opencv_digests` of an HEVC file, an MP4's packets as the port's
    samples (each checked to be OpenCV's packet in `hevc_annexb`'s form);
    with ``colour`` the luma planes of `without_hevc_colour`'s copy."""
    cv, fps = opencv_digests(path)
    if Path(path).suffix != ".avi":
        stream = demux(str(path))
        packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
        if len(packets) != len(stream) or any(
                hevc_annexb(s, stream.config) != p.tobytes() for s, p in zip(stream.packets(), packets)):
            raise RuntimeError(f"{path}: OpenCV's packets are not the samples in Annex B form")
        cv["packets"] = [hashlib.sha256(s).hexdigest() for s in stream.packets()]
    if colour:
        with tempfile.TemporaryDirectory() as tmp:
            plain = Path(tmp) / Path(path).name
            plain.write_bytes(without_hevc_colour(Path(path).read_bytes()))
            luma, _ = capture(plain, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
        cv["luma"] = [sha(y if y.ndim == 2 else y[..., 0]) for y in luma]
    return cv, fps


def port_hevc_digests(path):
    """`port_digests` through `HevcDecoder`."""
    stream = demux(str(path))
    dec = HevcDecoder(stream.config)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    frames = {"packets": [hashlib.sha256(p).hexdigest() for p in stream.packets()],
              "luma": [], "rgb": []}
    for p in [*stream.packets(), None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
                frames["luma"].append(sha(y))
                frames["rgb"].append(sha(img))
    return {"luma_all": luma.hexdigest(), "rgb_all": rgb.hexdigest()}, frames, dec.stats, \
        dec.encoder


def hevc_main() -> None:
    HEVC_OUT.mkdir(parents=True, exist_ok=True)
    build = cv2.getBuildInformation()
    avcodec = re.search(r"avcodec:\s+YES \(([^)]*)\)", build)
    table = {}
    render = {"walk": walk, "noise": noise, "fade": fade, "stripes": stripes}
    with tempfile.TemporaryDirectory() as tmp:
        lists = Path(tmp) / "scaling_list.txt"
        hevc_scaling_list(lists)
        for name, (h, w, n, content, options) in HEVC_FILES.items():
            path = HEVC_OUT / name
            given = [o.replace(CUSTOM_LIST, f"scaling-list={lists}") for o in options]
            write_libav(path, render[content](h, w, n), given, fps=HEVC_RATES.get(name, FPS))
            colour = name.startswith("colour_")
            cv, fps = opencv_hevc_digests(path, colour)
            port, own, stats, encoder = port_hevc_digests(path)
            same = {k: own[k] == cv[k] for k in cv}
            frames = len(cv["rgb"])
            if len(cv["packets"]) != n or not 0 < frames <= n or not all(same.values()):
                raise RuntimeError(f"{name}: OpenCV reads {frames} frames and "
                                   f"{len(cv['packets'])} packets of {n}; port equal: {same}")
            table[name] = {"height": h, "width": w, "packets": n, "frames": frames,
                           "options": options, "fps": fps, "bytes": path.stat().st_size,
                           "encoder": encoder, "colour": colour, "stats": stats, "opencv": cv,
                           "port": port}
            print(f"{name}: {n} packets, {frames} frames {w}x{h}, {path.stat().st_size} bytes, "
                  f"{options}; port equal to OpenCV: {same}; "
                  f"{ {k: v for k, v in stats.items() if v} }")
    refusals = {}
    for name, (pixfmt, options, what) in HEVC_REFUSALS.items():
        path = HEVC_OUT / name
        write_libav(path, walk(48, 64, 6), options, pixfmt)
        read = len(capture(path)[0])
        try:
            sum(1 for _ in VideoReader(str(path)))
            raise RuntimeError(f"the port decodes {name}, which it should refuse")
        except NotImplementedError as e:
            if what not in str(e):
                raise RuntimeError(f"{name}: {e}, want {what!r}")
        refusals[name] = {"pixfmt": pixfmt, "options": options, "raises": what,
                          "opencv_frames": read, "bytes": path.stat().st_size}
        print(f"{name}: {path.stat().st_size} bytes, OpenCV reads {read} frames, the port raises "
              f"NotImplementedError naming {what!r}")
    libs = subprocess.run(["cc", "-E", "-dM", "-include", "libavcodec/version.h", "-include",
                           "libavformat/version.h", "-x", "c", "/dev/null"],
                          capture_output=True, text=True, check=True).stdout
    ver = {k: re.search(rf"#define {k} (\d+)", libs).group(1) for k in
           ("LIBAVCODEC_VERSION_MAJOR", "LIBAVCODEC_VERSION_MINOR", "LIBAVFORMAT_VERSION_MAJOR")}
    meta = {"opencv": cv2.__version__, "libavcodec": avcodec.group(1) if avcodec else None,
            "writer": f"libx265 through libavcodec {ver['LIBAVCODEC_VERSION_MAJOR']}."
                      f"{ver['LIBAVCODEC_VERSION_MINOR']}, libavformat "
                      f"{ver['LIBAVFORMAT_VERSION_MAJOR']}",
            "renderer": "SyntheticConfig(height, width, num_planes=3, seed=0), scene 0",
            "fps": FPS, "files": table, "refusals": refusals}
    (HEVC_OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in HEVC_OUT.iterdir())
    if size > HEVC_LIMIT:
        raise RuntimeError(f"{HEVC_OUT} holds {size} bytes, over {HEVC_LIMIT}")
    print(f"wrote {len(table)} HEVC videos, {len(refusals)} refusals and fixtures.json to "
          f"{HEVC_OUT}: {size / 1024:.0f} KiB")


def h264_main() -> None:
    H264_OUT.mkdir(parents=True, exist_ok=True)
    build = cv2.getBuildInformation()
    avcodec = re.search(r"avcodec:\s+YES \(([^)]*)\)", build)
    table = {}
    render = {"walk": walk, "noise": noise, "fade": fade}
    for name, (h, w, n, content, options) in H264_FILES.items():
        path = H264_OUT / name
        write_libav(path, render[content](h, w, n), options, fps=H264_RATES.get(name, FPS))
        colour = name.startswith("colour_")
        cv, fps = opencv_h264_digests(path, colour)
        port, own, stats, encoder = port_h264_digests(path)
        same = {k: own[k] == cv[k] for k in cv}
        frames = len(cv["rgb"])
        if len(cv["packets"]) != n or not 0 < frames <= n or not all(same.values()):
            raise RuntimeError(f"{name}: OpenCV reads {frames} frames and "
                               f"{len(cv['packets'])} packets of {n}; port equal: {same}")
        table[name] = {"height": h, "width": w, "packets": n, "frames": frames,
                       "options": options, "fps": fps, "bytes": path.stat().st_size,
                       "encoder": encoder, "colour": colour, "stats": stats, "opencv": cv,
                       "port": port}
        print(f"{name}: {n} packets, {frames} frames {w}x{h}, {path.stat().st_size} bytes, "
              f"{options}; port equal to OpenCV: {same}; {stats}")
    refusals = {}
    for name, (pixfmt, options, what) in H264_REFUSALS.items():
        path = H264_OUT / name
        write_libav(path, walk(48, 64, 6), options, pixfmt)
        read = len(capture(path)[0])
        if read != 6:
            raise RuntimeError(f"OpenCV reads {read} frames of {path}")
        try:
            sum(1 for _ in VideoReader(str(path)))
            raise RuntimeError(f"the port decodes {name}, which it should refuse")
        except NotImplementedError as e:
            if what not in str(e):
                raise RuntimeError(f"{name}: {e}, want {what!r}")
        refusals[name] = {"pixfmt": pixfmt, "options": options, "raises": what,
                          "bytes": path.stat().st_size}
        print(f"{name}: {path.stat().st_size} bytes, OpenCV reads 6 frames, the port raises "
              f"NotImplementedError naming {what!r}")
    libs = subprocess.run(["cc", "-E", "-dM", "-include", "libavcodec/version.h", "-include",
                           "libavformat/version.h", "-x", "c", "/dev/null"],
                          capture_output=True, text=True, check=True).stdout
    ver = {k: re.search(rf"#define {k} (\d+)", libs).group(1) for k in
           ("LIBAVCODEC_VERSION_MAJOR", "LIBAVCODEC_VERSION_MINOR", "LIBAVFORMAT_VERSION_MAJOR")}
    meta = {"opencv": cv2.__version__, "libavcodec": avcodec.group(1) if avcodec else None,
            "writer": f"libx264 through libavcodec {ver['LIBAVCODEC_VERSION_MAJOR']}."
                      f"{ver['LIBAVCODEC_VERSION_MINOR']}, libavformat "
                      f"{ver['LIBAVFORMAT_VERSION_MAJOR']}",
            "renderer": "SyntheticConfig(height, width, num_planes=3, seed=0), scene 0",
            "fps": FPS, "files": table, "refusals": refusals}
    (H264_OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in H264_OUT.iterdir())
    if size > H264_LIMIT:
        raise RuntimeError(f"{H264_OUT} holds {size} bytes, over {H264_LIMIT}")
    print(f"wrote {len(table)} H.264 videos, {len(refusals)} refusals and fixtures.json to "
          f"{H264_OUT}: {size / 1024:.0f} KiB")


def refused(path, what):
    """Check that OpenCV reads ``path`` and the port raises naming ``what``;
    OpenCV's frame count."""
    read = len(capture(path)[0])
    if read == 0:
        raise RuntimeError(f"OpenCV reads no frame of {path}")
    try:
        sum(1 for _ in VideoReader(str(path)))
        raise RuntimeError(f"the port decodes {path.name}, which it should refuse")
    except NotImplementedError as e:
        if what not in str(e):
            raise RuntimeError(f"{path.name}: {e}, want {what!r}")
    print(f"{path.name}: {path.stat().st_size} bytes, OpenCV reads {read} frames, the port "
          f"raises NotImplementedError naming {what!r}")
    return read


def mpeg4_entry(path, h, w, n, writer, options, need=()):
    """The ``fixtures.json`` entry of a written MPEG-4 file: OpenCV's and the
    port's digests, which must agree, and the port's counts, of which those
    in ``need`` must not be 0."""
    cv, fps = opencv_digests(path)
    port, own, stats, encoder = port_digests(path)
    same = {k: own[k] == cv[k] for k in cv}
    frames = len(cv["rgb"])
    missing = [k for k in need if not stats[k]]
    print(f"{path.name}: {len(cv['packets'])} packets, {frames} frames {w}x{h}, "
          f"{path.stat().st_size} bytes, {encoder}; port equal to OpenCV: {same}; "
          f"{ {k: v for k, v in stats.items() if v} }")
    if not all(same.values()) or missing or not 0 < frames <= n:
        raise RuntimeError(f"{path.name}: {frames} frames of {n}; none of {missing}")
    return {"height": h, "width": w, "packets": len(cv["packets"]), "frames": frames,
            "writer": writer, "options": options, "fps": fps, "bytes": path.stat().st_size,
            "encoder": encoder, "stats": stats, "opencv": cv, "port": port}


def mpeg4_main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    build = cv2.getBuildInformation()
    avcodec = re.search(r"avcodec:\s+YES \(([^)]*)\)", build)
    render = {"walk": walk, "noise": noise, "stripes": stripes, "blocks": blocks_moving}
    table = {}
    for name, (h, w, n, fourcc, content) in FILES.items():
        path = OUT / name
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), FPS, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter cannot write {path}")
        for f in render[content](h, w, n):
            writer.write(np.ascontiguousarray(f[..., ::-1]))
        writer.release()
        need = ("escape1", "escape2", "escape3") if content == "noise" else ()
        table[name] = mpeg4_entry(path, h, w, n, f"cv2.VideoWriter {fourcc}", {}, need)
        if table[name]["packets"] != n or table[name]["frames"] != n:
            raise RuntimeError(f"{name}: OpenCV reads {table[name]['frames']} frames")
    for name, (h, w, n, content, options, need) in TOOLS.items():
        path = OUT / name
        write_avi(path, encode_mpeg4(render[content](h, w, n), options), h, w)
        table[name] = mpeg4_entry(path, h, w, n, "mpeg4 (OpenCV's libavcodec)", options, need)
    for name, (h, w, n, content, options, need) in LIBAV_FILES.items():
        path = OUT / name
        write_libav(path, render[content](h, w, n), options)
        table[name] = mpeg4_entry(path, h, w, n, "the system's libavcodec", options,
                                  need)
        if table[name]["encoder"].startswith("XviD") and not table[name]["stats"][
                "xvid_idct_vops"]:
            raise RuntimeError(f"{name}: XviD's user data, and not its IDCT")
    refusals = {}
    for name, (options, what) in REFUSALS.items():
        path = OUT / name
        write_avi(path, encode_mpeg4(stripes(48, 64, 4), options), 48, 64)
        refusals[name] = {"options": options, "raises": what, "frames": refused(path, what),
                          "bytes": path.stat().st_size}
    for name, (source, (old, new), what) in EDITED_REFUSALS.items():
        data = (OUT / source).read_bytes()
        if data.count(old) != 1:
            raise RuntimeError(f"{source} holds {old!r} {data.count(old)} times")
        path = OUT / name
        path.write_bytes(data.replace(old, new))
        refusals[name] = {"source": source, "user_data": [old.decode(), new.decode()],
                          "raises": what, "frames": refused(path, what),
                          "bytes": path.stat().st_size}
    reader = VideoReader(str(OUT / "walk_640x480.mp4"))
    assert sum(1 for _ in reader) == FILES["walk_640x480.mp4"][2]
    libs = subprocess.run(["cc", "-E", "-dM", "-include", "libavcodec/version.h", "-x", "c",
                           "/dev/null"], capture_output=True, text=True, check=True).stdout
    ver = {k: re.search(rf"#define {k} (\d+)", libs).group(1) for k in
           ("LIBAVCODEC_VERSION_MAJOR", "LIBAVCODEC_VERSION_MINOR")}
    meta = {"opencv": cv2.__version__, "libavcodec": avcodec.group(1) if avcodec else None,
            "system_libavcodec": f"{ver['LIBAVCODEC_VERSION_MAJOR']}."
                                 f"{ver['LIBAVCODEC_VERSION_MINOR']} with libxvidcore 4",
            "renderer": "SyntheticConfig(height, width, num_planes=3, seed=0), scene 0",
            "fps": FPS, "files": table, "refusals": refusals}
    (OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    if size > LIMIT:
        raise RuntimeError(f"{OUT} holds {size} bytes, over {LIMIT}")
    print(f"wrote {len(table)} videos, {len(refusals)} refusals and fixtures.json to {OUT}: "
          f"{size / 1024:.0f} KiB")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("mpeg4", "h264", "hevc"), default=None,
                        help="write one codec's fixtures (default: all)")
    only = parser.parse_args().only
    if only in (None, "mpeg4"):
        mpeg4_main()
    if only in (None, "h264"):
        h264_main()
    if only in (None, "hevc"):
        hevc_main()


if __name__ == "__main__":
    main()
