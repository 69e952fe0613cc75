"""The port's MPEG-4 Part 2 encoder and its containers against OpenCV's
FFmpeg (CPU, no card).

`Mpeg4Encoder` (``csrc/mpeg4_encode.cpp``) codes the fixtures' renderers
(``tools/torch_make_video_fixtures.py``: ``walk``, a panning camera with a
frozen band, ``noise``, new 8x8 noise blocks each frame, and
``blocks_moving``, blocks that move each their own way) over at least two
GOPs at 64x48, 176x144, 200x136 and 640x480:

* (a) its reconstruction equals `Mpeg4Decoder`'s decode of its packets,
  luma and chroma, and OpenCV's luma (``CAP_PROP_CONVERT_RGB`` 0) of its
  ``.mp4``, bit for bit, every frame; so does its RGB, to the decoder's and
  OpenCV's. The decoder's counts show that TCOEF escapes of all three
  types, intra macroblocks in P-VOPs, macroblocks not coded, half-pel
  vectors and vectors reading outside the VOP all occur. FFmpeg runs the
  simple IDCT on these streams (they carry no user data that names another
  encoder), the IDCT the encoder rebuilds with.
* (b) OpenCV reads the ``.mp4``, ``.mov`` and ``.avi`` that `VideoWriter`
  writes with the frame count, rate, size and codec written, at whole and
  fractional rates, and an odd size is cropped to even sides as OpenCV's
  writer crops it; the port's `VideoReader` reads the same frames from all
  three; the MP4's sample table marks the I-VOPs, and the AVI's index too.
* (c) on the same frames as ``cv2.VideoWriter(..., "mp4v")``, the mean PSNR
  of OpenCV's decode against the input is at least OpenCV's own less 1 dB,
  and the packets' bytes at most twice OpenCV's (measured below, `QUALITY`).
* (d) a writer that raises leaves no file behind.
* (e) the four writers write mp4v at the JAX package's paths: here
  `image_grid.write_video` and the ``vis`` turntable; ``infer_video``'s
  ``depth_vis.mp4`` in ``test_torch_infer_video_demo.py`` and
  ``test_torch_infer_cli.py``, ``ingest_capture --preview-video`` in
  ``test_torch_ingest_capture.py``, ``preview_dataset`` in
  ``test_torch_tools.py``, each against the JAX tool's file.
* (f) the decoder's digests of the committed clips (``fixtures.json``)
  still hold after its tables moved to ``csrc/mpeg4_tables.h``:
  ``test_torch_mpeg4.py::test_committed_digests``, and here without OpenCV.
"""
import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.utils import video_io
from dro_sfm_torch.utils.video_io import (Mp4Writer, Mpeg4Decoder, Mpeg4Encoder, VideoReader,
                                          VideoWriter, demux)
from tools.torch_make_video_fixtures import blocks_moving, noise, walk

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "video"
RENDERERS = {"walk": walk, "noise": noise, "blocks_moving": blocks_moving}
# (renderer, height, width, frames): two GOPs and the first VOP of a third
CASES = [("walk", 48, 64, 26), ("walk", 144, 176, 26), ("walk", 136, 200, 26),
         ("walk", 480, 640, 26), ("noise", 144, 176, 26), ("blocks_moving", 144, 176, 26)]


def psnr(a, b) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


def frames_of(name, h, w, n):
    return RENDERERS[name](h, w, n)


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
    info = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS),
            cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT),
            int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little"))
    cap.release()
    return out, info


@pytest.fixture(scope="module")
def encoded():
    """Each case's frames, packets and the encoder's reconstruction
    (planes and RGB) after each frame."""
    out = {}
    for name, h, w, n in CASES:
        frames = frames_of(name, h, w, n)
        enc = Mpeg4Encoder(h, w, 30)
        packets, keys, planes, rgb = [], [], [], []
        for f in frames:
            p, k = enc.encode(f)
            packets.append(p)
            keys.append(k)
            planes.append(enc.reconstruction(planes=True))
            rgb.append(enc.reconstruction())
        out[(name, h, w)] = dict(frames=frames, config=enc.config, packets=packets, keys=keys,
                                 planes=planes, rgb=rgb)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}_{c[2]}x{c[1]}")
def test_reconstruction_equals_the_decoders(encoded, case, tmp_path):
    name, h, w, n = case
    e = encoded[(name, h, w)]
    assert e["keys"] == [i % 12 == 0 for i in range(n)]
    dec = Mpeg4Decoder(e["config"])
    for i, p in enumerate(e["packets"]):
        assert dec.decode(p)
        got = dec.planes()
        assert [x.shape for x in got] == [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
        for plane, want in zip(got, e["planes"][i]):
            assert np.array_equal(plane, want), (i, plane.shape)
        assert np.array_equal(dec.frame(), e["rgb"][i]), i
    path = tmp_path / "v.mp4"
    with VideoWriter(str(path), 30) as writer:
        for f in e["frames"]:
            writer.write(f)
    assert [p for p in demux(str(path)).packets()] == e["packets"]
    luma, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    bgr, _ = capture(path)
    assert len(luma) == len(bgr) == n
    for i in range(n):
        y = luma[i] if luma[i].ndim == 2 else luma[i][..., 0]
        assert np.array_equal(y, e["planes"][i][0]), i                 # the bar: 0 levels
        assert np.array_equal(bgr[i][..., ::-1], e["rgb"][i]), i


def test_the_streams_hold_every_tool(encoded):
    total = dict.fromkeys(Mpeg4Decoder.STATS, 0)
    for e in encoded.values():
        dec = Mpeg4Decoder(e["config"])
        for p in e["packets"]:
            dec.decode(p)
        for k, v in dec.stats.items():
            total[k] += v
        assert dec.encoder == ""                 # no user data: FFmpeg's default IDCT
    for k in ("i_vops", "p_vops", "skipped_mbs", "p_intra_mbs", "escape1", "escape2",
              "escape3", "outside_predictions", "half_pel_predictions", "rounding_vops"):
        assert total[k] > 0, k
    assert total["ac_pred_mbs"] == total["dquant_mbs"] == 0


@pytest.mark.parametrize("ext", [".mp4", ".mov", ".avi"])
@pytest.mark.parametrize("fps,h,w", [(30, 48, 64), (29.97, 49, 67), (12.5, 136, 200)])
def test_opencv_reads_each_container(tmp_path, ext, fps, h, w):
    frames = walk(h, w, 14)
    path = tmp_path / f"v{ext}"
    with VideoWriter(str(path), fps) as writer:
        for f in frames:
            writer.write(f)
    assert path.stat().st_size == writer.bytes_written and not Path(f"{path}.tmp").exists()
    bgr, info = capture(path)
    # OpenCV's own writer drops an odd last row and column
    ref = tmp_path / f"cv{ext}"
    cvw = cv2.VideoWriter(str(ref), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        cvw.write(np.ascontiguousarray(f[..., ::-1]))
    cvw.release()
    _, cv_info = capture(ref)
    assert info == cv_info == (14, pytest.approx(fps, abs=1e-9), w & ~1, h & ~1, b"FMP4")
    reader = VideoReader(str(path))
    got = list(reader)
    assert reader.fps == pytest.approx(fps, abs=1e-9) and len(got) == 14
    assert all(np.array_equal(a, b[..., ::-1]) for a, b in zip(got, bgr))
    data = path.read_bytes()
    if ext == ".avi":
        strh = data.index(b"strh") + 8
        assert data[strh:strh + 8] == b"vidsmp4v"
        idx = data.index(b"idx1")
        flags = [struct.unpack_from("<4sIII", data, idx + 8 + 16 * i)[1] for i in range(14)]
        assert flags == [0x10 if i % 12 == 0 else 0 for i in range(14)]
    else:
        assert data[8:12] == (b"qt  " if ext == ".mov" else b"isom")
        assert b"edts" not in data and b"mp4v" in data
        stss = data.index(b"stss")
        assert struct.unpack_from(">III", data, stss + 8) == (2, 1, 13)


# (renderer, height, width, frames): OpenCV's (mean PSNR dB, packet bytes a
# frame) as measured with OpenCV 5.0.0 (libavcodec 62.28.101), then the
# port's at QP 3, which the test holds (its packets and decode do not depend
# on OpenCV's version)
QUALITY = {("walk", 480, 640, 24): ((38.688, 2949.17), (41.316, 3151.75)),
           ("walk", 144, 176, 24): ((35.069, 621.17), (36.008, 617.125)),
           ("noise", 128, 160, 8): ((35.745, 6519.75), (37.074, 6529.875)),
           ("blocks_moving", 144, 176, 24): ((31.341, 4541.12), (31.723, 4584.333))}


@pytest.mark.parametrize("case", sorted(QUALITY), ids=lambda c: f"{c[0]}_{c[2]}x{c[1]}")
def test_quality_against_opencvs_writer(tmp_path, case):
    name, h, w, n = case
    frames = frames_of(name, h, w, n)
    result = {}
    for who in ("opencv", "port"):
        path = tmp_path / f"{who}.mp4"
        if who == "opencv":
            cvw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
            for f in frames:
                cvw.write(np.ascontiguousarray(f[..., ::-1]))
            cvw.release()
        else:
            with VideoWriter(str(path), 30) as writer:
                for f in frames:
                    writer.write(f)
        bgr, _ = capture(path)
        assert len(bgr) == n
        result[who] = (np.mean([psnr(b[..., ::-1], f) for b, f in zip(bgr, frames)]),
                       sum(len(p) for p in demux(str(path)).packets()) / n)
    assert result["port"][0] >= result["opencv"][0] - 1.0
    assert result["port"][1] <= 2 * result["opencv"][1]
    assert result["port"] == pytest.approx(QUALITY[case][1], abs=1e-3), result


def test_a_writer_that_raises_leaves_no_file(tmp_path):
    frames = walk(48, 64, 3)
    for ext in (".mp4", ".avi"):
        path = tmp_path / f"v{ext}"
        with pytest.raises(ValueError, match="frame of size"):
            with VideoWriter(str(path), 30) as writer:
                writer.write(frames[0])
                writer.write(frames[1][:32])
        assert list(tmp_path.iterdir()) == []
        with pytest.raises(ValueError, match="without frames"):
            VideoWriter(str(path), 30).close()
        assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError, match="mp4v video goes into"):
        VideoWriter(str(tmp_path / "v.mkv"), 30)
    with pytest.raises(ValueError, match="uint8 RGB"):
        with VideoWriter(str(tmp_path / "v.mp4"), 30) as writer:
            writer.write(frames[0].astype(np.float32))
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("shape,fps,what", [((48, 63), 30, "sides are even"),
                                            ((0, 64), 30, "sides are even"),
                                            ((48, 64), 70000.5, "16 bits")])
def test_encoder_refusals(shape, fps, what):
    with pytest.raises(ValueError, match=what):
        Mpeg4Encoder(*shape, fps)
    enc = Mpeg4Encoder(48, 64, 30)
    with pytest.raises(ValueError, match="no frame encoded"):
        enc.reconstruction()
    with pytest.raises(ValueError, match="frame of size"):
        enc.encode(np.zeros((48, 66, 3), np.uint8))


def test_mp4_sample_table_past_4_gib(tmp_path):
    """Chunk offsets past 4 GiB go into co64 (a file that large is not
    written here: the offsets are moved)."""
    mux = Mp4Writer(str(tmp_path / "v.mp4"), 30)
    enc = Mpeg4Encoder(48, 64, 30)
    mux.config = enc.config
    for f in walk(48, 64, 3):
        mux.write_packet(*enc.encode(f), (48, 64))
    mux.offsets = [o + (1 << 32) for o in mux.offsets]
    moov = mux._moov()
    i = moov.index(b"co64")
    assert b"stco" not in moov
    assert list(struct.unpack_from(">I3Q", moov, i + 8)) == [3, *mux.offsets]
    mux.abort()
    assert list(tmp_path.iterdir()) == []


def test_the_writers_write_mp4v_at_the_jax_paths(tmp_path):
    from dro_sfm_torch.scripts import vis
    from dro_sfm_torch.visualization.image_grid import write_video
    from dro_sfm_torch.visualization.pointcloud import write_ply
    frames = walk(48, 64, 4)
    write_video(str(tmp_path / "grid.mp4"), frames, fps=10)
    rng = np.random.default_rng(0)
    write_ply(str(tmp_path / "c.ply"), rng.normal(size=(300, 3)),
              rng.integers(0, 256, (300, 3)).astype(np.uint8))
    vis.main(["--ply", str(tmp_path / "c.ply"), "--output", str(tmp_path / "turn.mp4"),
              "--frames", "3", "--device", "cpu"])
    for name, n in (("grid.mp4", 4), ("turn.mp4", 3)):
        stream = demux(str(tmp_path / name))
        assert stream.codec == "mpeg4" and len(stream) == n
        assert (tmp_path / name).read_bytes()[4:12] == b"ftypisom"
        _, info = capture(tmp_path / name)
        assert info[0] == n and info[4] == b"FMP4"


def test_committed_digests_without_opencv():
    meta = json.loads((FIXTURES / "fixtures.json").read_text())
    for name, entry in meta["files"].items():
        stream = demux(str(FIXTURES / name))
        dec = Mpeg4Decoder.for_stream(stream)
        luma, rgb = hashlib.sha256(), hashlib.sha256()
        for p in [*stream.packets(), None]:
            for k, (img, y) in dec.output(p, rgb=True, luma=True):
                if stream.shown[k]:
                    luma.update(y.tobytes())
                    rgb.update(img.tobytes())
        assert luma.hexdigest() == entry["port"]["luma_all"], name
        assert rgb.hexdigest() == entry["port"]["rgb_all"], name


def test_timebase():
    assert video_io.timebase(30) == (30, 1)
    assert video_io.timebase(29.97) == (2997, 100)
    assert video_io.timebase(12.5) == (25, 2)
    with pytest.raises(ValueError, match="frames a second"):
        video_io.timebase(0)
