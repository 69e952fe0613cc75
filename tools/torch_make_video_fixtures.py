#!/usr/bin/env python3
"""Write the MPEG-4 Part 2 video fixtures of the port's decoder checks.

    python3 tools/torch_make_video_fixtures.py      # needs OpenCV with FFmpeg

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
writes the refusal fixtures ``refuse_*.avi`` (64x48, 4 frames), each a
feature the port's decoder refuses (`REFUSALS`: MPEG quantisation, B-VOPs,
quarter sample, interlace, data partitioning, resync markers, four motion
vectors); OpenCV reads every one of them.

Beside them goes ``fixtures.json``: for every file the sha256 of each raw
packet (``CAP_PROP_FORMAT`` -1), of each luma plane (``CAP_PROP_CONVERT_RGB``
0) and of each RGB frame (``cv2.VideoCapture``'s BGR flipped), the frame
count, the fps, what the port's decoder counted in the stream
(`Mpeg4Decoder.stats`), the OpenCV and libavcodec versions, and the sha256
of the port's own decode of all frames here (luma and RGB), so that another
machine's build of the decoder is held to the same bits without OpenCV.
"""
import hashlib
import json
import re
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402
from dro_sfm_torch.utils.video_io import Mpeg4Decoder, VideoReader, demux  # noqa: E402

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
# name: (the encoder's options, what the port's NotImplementedError names)
REFUSALS = {
    "refuse_mpeg_quant.avi": ({"mpeg_quant": "1"}, "quant_type 1"),
    "refuse_bframes.avi": ({"bf": "2"}, "B-VOPs"),
    "refuse_qpel.avi": ({"flags": "+qpel"}, "quarter_sample"),
    "refuse_interlaced.avi": ({"flags": "+ildct"}, "interlaced"),
    "refuse_partitioned.avi": ({"data_partitioning": "1"}, "data partitioning"),
    "refuse_resync.avi": ({"ps": "100"}, "resync markers"),
    "refuse_mv4.avi": ({"flags": "+mv4"}, "four motion vectors"),
}
AIC = ("aic_176x144.avi", 144, 176, 8,
       {"flags": "+aic", "scplx_mask": "0.9", "tcplx_mask": "0.5", "g": "2"})
STATIC_ROWS = 1 / 8          # the frozen band at the bottom, a share of the height
LIMIT = 1 << 20              # bytes of the whole folder


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
    """The port's decode of ``path``: the sha256 of all its luma planes and
    of all its RGB frames, each list of frames in order, its per-frame
    digests, and the decoder's counts."""
    stream = demux(str(path))
    dec = Mpeg4Decoder(stream.config)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    frames = {"packets": [], "luma": [], "rgb": []}
    for p in stream.packets():
        frames["packets"].append(hashlib.sha256(p).hexdigest())
        if dec.decode(p):
            img, y = dec.frame(rgb=True, luma=True)
            luma.update(y.tobytes())
            rgb.update(img.tobytes())
            frames["luma"].append(sha(y))
            frames["rgb"].append(sha(img))
    return {"luma_all": luma.hexdigest(), "rgb_all": rgb.hexdigest()}, frames, dec.stats, \
        dec.encoder


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    build = cv2.getBuildInformation()
    avcodec = re.search(r"avcodec:\s+YES \(([^)]*)\)", build)
    table = {}
    for name, (h, w, n, fourcc, content) in FILES.items():
        path = OUT / name
        frames = (walk if content == "walk" else noise)(h, w, n)
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), FPS, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter cannot write {path}")
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))
        writer.release()
        cv, fps = opencv_digests(path)
        port, own, stats, encoder = port_digests(path)
        if len(cv["rgb"]) != n or len(cv["packets"]) != n:
            raise RuntimeError(f"{name}: OpenCV reads {len(cv['rgb'])} frames and "
                               f"{len(cv['packets'])} packets of {n}")
        same = {k: own[k] == cv[k] for k in cv}
        table[name] = {"height": h, "width": w, "frames": n, "fourcc": fourcc, "fps": fps,
                       "bytes": path.stat().st_size, "encoder": encoder, "stats": stats,
                       "opencv": cv, "port": port}
        print(f"{name}: {n} frames {w}x{h}, {path.stat().st_size} bytes, {encoder}; port "
              f"equal to OpenCV: {same}; {stats}")
        if content == "noise":
            missing = [k for k in ("escape1", "escape2", "escape3") if not stats[k]]
            if missing:
                raise RuntimeError(f"{name}: no TCOEF {missing} in the stream")
            print(f"{name}: TCOEF escapes of types 1, 2 and 3: {stats['escape1']}, "
                  f"{stats['escape2']}, {stats['escape3']}")
    name, h, w, n, options = AIC
    path = OUT / name
    write_avi(path, encode_mpeg4(stripes(h, w, n), options), h, w)
    cv, fps = opencv_digests(path)
    port, own, stats, encoder = port_digests(path)
    same = {k: own[k] == cv[k] for k in cv}
    table[name] = {"height": h, "width": w, "frames": n, "fourcc": "FMP4", "fps": fps,
                   "bytes": path.stat().st_size, "encoder": encoder, "options": options,
                   "stats": stats, "opencv": cv, "port": port}
    print(f"{name}: {n} frames {w}x{h}, {path.stat().st_size} bytes, {options}; port equal to "
          f"OpenCV: {same}; {stats}")
    missing = [k for k in ("ac_pred_mbs", "dquant_mbs", "ac_rescales") if not stats[k]]
    if missing or len(cv["rgb"]) != n:
        raise RuntimeError(f"{name}: {len(cv['rgb'])} frames; none of {missing}")
    refusals = {}
    for name, (options, what) in REFUSALS.items():
        path = OUT / name
        frames = (blocks_moving if "mv4" in name else stripes)(48, 64, 4)
        write_avi(path, encode_mpeg4(frames, options), 48, 64)
        cap = cv2.VideoCapture(str(path))
        read = 0
        while cap.read()[0]:
            read += 1
        if read != 4:
            raise RuntimeError(f"OpenCV reads {read} frames of {path}")
        try:
            sum(1 for _ in VideoReader(str(path)))
            raise RuntimeError(f"the port decodes {name}, which it should refuse")
        except NotImplementedError as e:
            if what not in str(e):
                raise RuntimeError(f"{name}: {e}, want {what!r}")
        refusals[name] = {"options": options, "raises": what, "bytes": path.stat().st_size}
        print(f"{name}: {path.stat().st_size} bytes, OpenCV reads 4 frames, the port raises "
              f"NotImplementedError naming {what!r}")
    reader = VideoReader(str(OUT / "walk_640x480.mp4"))
    assert sum(1 for _ in reader) == FILES["walk_640x480.mp4"][2]
    meta = {"opencv": cv2.__version__, "libavcodec": avcodec.group(1) if avcodec else None,
            "renderer": "SyntheticConfig(height, width, num_planes=3, seed=0), scene 0",
            "fps": FPS, "files": table, "refusals": refusals}
    (OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    if size > LIMIT:
        raise RuntimeError(f"{OUT} holds {size} bytes, over {LIMIT}")
    print(f"wrote {len(table)} videos and fixtures.json to {OUT}: {size / 1024:.0f} KiB")


if __name__ == "__main__":
    main()
