"""The port's video input against OpenCV's FFmpeg (CPU, no card).

The committed fixtures (``dro_sfm_torch/testdata/video``, written by
``tools/torch_make_video_fixtures.py``) go through the port's demuxers
(`demux_mp4`, `demux_avi`) and its MPEG-4 Part 2 decoder
(``csrc/mpeg4_video.cpp``) and through ``cv2.VideoCapture``, live:

* every packet equals FFmpeg's (``CAP_PROP_FORMAT`` -1) byte for byte, and
  the rate equals OpenCV's;
* every luma plane equals FFmpeg's (``CAP_PROP_CONVERT_RGB`` 0): bar 0
  levels;
* every RGB frame equals OpenCV's BGR flipped: bar 0 levels;
* the digests in ``fixtures.json`` equal OpenCV's, and the port's own decode
  equals the digests recorded with it.

The fixtures cover P-VOPs with motion vectors out of the frame, skipped
macroblocks, a size that is no multiple of 16, all three TCOEF escapes, AC
prediction with the alternate scans, DQUANT and AC predictions rescaled to
another QP (each counted by the decoder's `stats` and asserted here). What
the port refuses raises `NotImplementedError` naming it: streams of FFmpeg's
own encoder for MPEG quantisation, B-VOPs, quarter sample, interlace, data
partitioning, resync markers and four motion vectors (committed), bit edits
of a fixture's VOL, VO or VOP header for the other tools and an ``av01``
sample entry (H.264's ``avc1`` is decoded: `tests/test_torch_h264.py`), and the first bytes of other containers. Truncated packets
and 200 seeded random byte flips raise `ValueError` (or, where a flip turns
a header into a refused tool, `NotImplementedError`) or decode, and never
take the process down: they run in a subprocess.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.utils import video_io
from dro_sfm_torch.utils.video_io import Mpeg4Decoder, VideoReader, demux

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "video"
META = json.loads((FIXTURES / "fixtures.json").read_text())
NAMES = sorted(META["files"])
REFUSALS = sorted(META["refusals"])


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


@pytest.mark.parametrize("name", NAMES)
def test_packets_equal_ffmpeg(name):
    path = FIXTURES / name
    want, fps = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    stream = demux(str(path))
    got = list(stream.packets())
    assert len(got) == len(want) == META["files"][name]["frames"]
    assert all(g == w.tobytes() for g, w in zip(got, want))
    assert stream.fps == fps == META["files"][name]["fps"]


@pytest.mark.parametrize("name", NAMES)
def test_luma_equals_ffmpeg(name):
    path = FIXTURES / name
    want, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    got = list(VideoReader(str(path)).frames(luma=True))
    assert len(got) == len(want) == META["files"][name]["frames"]
    for g, w in zip(got, want):
        w = w if w.ndim == 2 else w[..., 0]
        assert g.shape == w.shape
        assert int(np.abs(g.astype(int) - w).max()) == 0          # the bar: 0 levels


@pytest.mark.parametrize("name", NAMES)
def test_rgb_equals_opencv(name):
    path = FIXTURES / name
    want, _ = capture(path)
    reader = VideoReader(str(path))
    got = list(reader)
    assert len(got) == len(want) == len(reader.decode_ms)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert int(np.abs(g.astype(int) - w[..., ::-1]).max()) == 0   # the bar: 0 levels


@pytest.mark.parametrize("name", NAMES)
def test_committed_digests(name):
    """fixtures.json against live OpenCV, and the port's decode against the
    digests recorded with it (what the card's host build is held to)."""
    path, entry = FIXTURES / name, META["files"][name]
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    luma, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    bgr, _ = capture(path)
    assert [sha(p.ravel()) for p in packets] == entry["opencv"]["packets"]
    assert [sha(y if y.ndim == 2 else y[..., 0]) for y in luma] == entry["opencv"]["luma"]
    assert [sha(f[..., ::-1]) for f in bgr] == entry["opencv"]["rgb"]
    stream = demux(str(path))
    dec = Mpeg4Decoder(stream.config)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    for p in stream.packets():
        assert dec.decode(p)
        img, y = dec.frame(rgb=True, luma=True)
        luma.update(y.tobytes())
        rgb.update(img.tobytes())
    assert luma.hexdigest() == entry["port"]["luma_all"]
    assert rgb.hexdigest() == entry["port"]["rgb_all"]
    assert dec.stats == entry["stats"] and dec.encoder == entry["encoder"]


def test_fixtures_cover_the_decoder():
    stats = {n: e["stats"] for n, e in META["files"].items()}
    total = {k: sum(s[k] for s in stats.values()) for k in Mpeg4Decoder.STATS}
    for k in ("i_vops", "p_vops", "skipped_mbs", "p_intra_mbs", "ac_pred_mbs", "dquant_mbs",
              "escape1", "escape2", "escape3", "outside_predictions", "half_pel_predictions",
              "rounding_vops", "ac_rescales"):
        assert total[k] > 0, k
    assert stats["noise_160x128.avi"]["escape3"] > 0
    assert all(e["encoder"].startswith("Lavc") for e in META["files"].values())
    size = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert size < 1 << 20


def test_decode_order_and_reference_kept():
    """A P-VOP decodes against the decoder's kept reference: the same
    packets through one decoder give the same frames as VideoReader, and a
    P-VOP first (no reference) fails."""
    stream = demux(str(FIXTURES / "odd_200x136.mp4"))
    dec = Mpeg4Decoder(stream.config)
    frames = []
    for p in stream.packets():
        dec.decode(p)
        frames.append(dec.frame())
    for a, b in zip(frames, VideoReader(str(FIXTURES / "odd_200x136.mp4"))):
        assert np.array_equal(a, b)
    fresh = Mpeg4Decoder(stream.config)
    with pytest.raises(ValueError, match="P-VOP before any I-VOP"):
        fresh.decode(stream.packet(1))


@pytest.mark.parametrize("name", REFUSALS)
def test_refused_encoder_streams(name):
    path = FIXTURES / name
    frames, _ = capture(path)
    assert len(frames) == 4                                   # FFmpeg reads them
    with pytest.raises(NotImplementedError, match=META["refusals"][name]["raises"]):
        list(VideoReader(str(path)))


class Bits:
    def __init__(self, data, pos):
        self.data, self.pos = data, pos

    def read(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def vol_fields(data):
    """The bit offset in ``data`` of each flag of its first VOL header."""
    start = data.find(b"\x00\x00\x01\x20")
    r = Bits(data, 8 * (start + 4))
    r.read(9)
    if r.read(1):
        r.read(7)
    if r.read(4) == 15:
        r.read(16)
    fields = {"vol_control_parameters": r.pos}
    if r.read(1):
        fields["chroma_format"] = r.pos
        r.read(3)
        if r.read(1):
            r.read(79)
    fields["shape"] = r.pos
    r.read(3)
    res = fields["resolution"] = r.read(16)
    r.read(1)
    if r.read(1):
        r.read(max(1, int(np.ceil(np.log2(res)))))
    r.read(29)
    for name in ("interlaced", "obmc_disable", "sprite_enable", "not_8_bit", "quant_type",
                 "complexity_estimation_disable", "resync_marker_disable", "data_partitioned",
                 "scalability"):
        fields[name] = r.pos
        r.read(1)
    return fields


def set_bits(data, pos, n, value):
    out = bytearray(data)
    for i in range(n):
        byte, bit = divmod(pos + i, 8)
        mask = 0x80 >> bit
        out[byte] = (out[byte] | mask) if (value >> (n - 1 - i)) & 1 else (out[byte] & ~mask)
    return bytes(out)


def test_vol_fields_read_the_fixture():
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    f = vol_fields(data)
    for name, want in (("interlaced", 0), ("obmc_disable", 1), ("sprite_enable", 0),
                       ("not_8_bit", 0), ("quant_type", 0), ("complexity_estimation_disable", 1),
                       ("resync_marker_disable", 1), ("data_partitioned", 0), ("scalability", 0)):
        assert Bits(data, f[name]).read(1) == want, name
    assert Bits(data, f["shape"]).read(2) == 0


# (fixture, field of the VOL, bits, value, what the port names)
VOL_EDITS = [
    ("walk_640x480.avi", "shape", 2, 1, "non-rectangular"),
    ("walk_640x480.mp4", "shape", 2, 3, "non-rectangular"),
    ("walk_640x480.avi", "not_8_bit", 1, 1, "not_8_bit"),
    ("walk_640x480.mp4", "not_8_bit", 1, 1, "not_8_bit"),
    ("walk_640x480.avi", "quant_type", 1, 1, "quant_type 1"),
    ("walk_640x480.avi", "interlaced", 1, 1, "interlaced"),
    ("walk_640x480.mov", "interlaced", 1, 1, "interlaced"),
    ("walk_640x480.avi", "sprite_enable", 1, 1, "S-VOPs"),
    ("walk_640x480.avi", "data_partitioned", 1, 1, "data partitioning"),
    ("walk_640x480.avi", "obmc_disable", 1, 0, "OBMC"),
    ("walk_640x480.avi", "complexity_estimation_disable", 1, 0, "complexity estimation"),
    ("walk_640x480.avi", "scalability", 1, 1, "scalability"),
    ("walk_640x480.avi", "chroma_format", 2, 2, "chroma format"),
]


@pytest.mark.parametrize("name,field,n,value,what", VOL_EDITS,
                         ids=[f"{e[0]}-{e[1]}" for e in VOL_EDITS])
def test_vol_edits_are_refused(tmp_path, name, field, n, value, what):
    data = (FIXTURES / name).read_bytes()
    edited = tmp_path / name
    edited.write_bytes(set_bits(data, vol_fields(data)[field], n, value))
    with pytest.raises(NotImplementedError, match=what):
        list(VideoReader(str(edited)))


@pytest.mark.parametrize("kind,what", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_vop_type_edits_are_refused(tmp_path, kind, what):
    data = (FIXTURES / "walk_640x480.mp4").read_bytes()
    pos = data.find(b"\x00\x00\x01\xb6")
    pos = data.find(b"\x00\x00\x01\xb6", pos + 4)          # the first P-VOP
    assert data[pos + 4] >> 6 == 1
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(set_bits(data, 8 * (pos + 4), 2, kind))
    with pytest.raises(NotImplementedError, match=what):
        list(VideoReader(str(edited)))


def test_a_vop_not_coded_gives_no_frame_as_ffmpeg(tmp_path):
    """vop_coded 0 on the third VOP: FFmpeg gives no frame for it and keeps
    its reference; so does the port, and the 35 frames equal OpenCV's."""
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    bits = int(np.ceil(np.log2(vol_fields(data)["resolution"])))
    pos = -1
    for _ in range(3):
        pos = data.find(b"\x00\x00\x01\xb6", pos + 1)
    r = Bits(data, 8 * (pos + 4) + 2)
    while r.read(1):
        pass
    r.read(1 + bits + 1)                                    # marker, time, marker
    assert Bits(data, r.pos).read(1) == 1
    edited = tmp_path / "clip.avi"
    edited.write_bytes(set_bits(data, r.pos, 1, 0))
    want, _ = capture(edited)
    got = list(VideoReader(str(edited)))
    assert len(got) == len(want) == 35
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))


def test_short_video_header_is_refused(tmp_path):
    """A VO start code followed by H.263's short_video_start_marker."""
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    pos = data.find(b"\x00\x00\x01\x00", data.find(b"\x00\x00\x01\xb0"))
    assert data[pos + 4:pos + 8] == b"\x00\x00\x01\x20"          # the VOL follows
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data[:pos + 4] + b"\x00\x00\x80" + data[pos + 7:])
    with pytest.raises(NotImplementedError, match="short video header"):
        list(VideoReader(str(edited)))
    dec = Mpeg4Decoder()
    with pytest.raises(NotImplementedError, match="short video header"):
        dec.decode(b"\x00\x00\x82\x1a\x0f\x00")


@pytest.mark.parametrize("fourcc,what", [(b"av01", "AV1"), (b"hvc1", "H.265"),
                                         (b"s263", "H.263")])
def test_other_sample_entries_are_refused(tmp_path, fourcc, what):
    data = (FIXTURES / "walk_640x480.mp4").read_bytes()
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(data.replace(b"mp4v", fourcc, 1))
    with pytest.raises(NotImplementedError, match=what):
        demux(str(edited))


@pytest.mark.parametrize("fourcc,what", [(b"VP80", "VP8"), (b"DIV3", "MS MPEG-4 v3"),
                                         (b"WMV2", "WMV"), (b"ABCD", "ABCD")])
def test_other_avi_codecs_are_refused(tmp_path, fourcc, what):
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data.replace(b"FMP4", fourcc).replace(b"mp4v", fourcc))
    with pytest.raises(NotImplementedError, match=what):
        demux(str(edited))


@pytest.mark.parametrize("head,what", [
    (b"FLV\x01\x01\x00\x00\x00\x09", "FLV"), (b"\x00\x00\x01\xba\x44", "MPEG program"),
    (b"\x30\x26\xb2\x75\x8e\x66\xcf\x11\xa6\xd9", "ASF"), (b"\x1a\x45\xdf\xa3\x01", "Matroska")])
def test_other_containers_are_refused(tmp_path, head, what):
    path = tmp_path / "clip.bin"
    path.write_bytes(head + bytes(64))
    with pytest.raises(NotImplementedError, match=what):
        demux(str(path))


def test_fragmented_and_edited_mp4(tmp_path):
    data = (FIXTURES / "walk_640x480.mp4").read_bytes()
    path = tmp_path / "clip.mp4"
    path.write_bytes(data.replace(b"\x00\x00\x00\x08free", b"\x00\x00\x00\x08moof", 1))
    with pytest.raises(NotImplementedError, match="fragmented"):
        demux(str(path))
    elst = data.find(b"elst")
    # an edit from a later media time trims the first frame: FFmpeg decodes it and drops it
    path.write_bytes(data[:elst + 16] + (512).to_bytes(4, "big") + data[elst + 20:])
    want, _ = capture(path)
    got = list(VideoReader(str(path)))
    assert len(got) == len(want) == len(VideoReader(str(path))) == 35
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))
    # an edit that ends before a later I-VOP: FFmpeg reads no sample past that I-VOP
    path.write_bytes(data[:elst + 12] + (600).to_bytes(4, "big") + data[elst + 16:])
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    want, _ = capture(path)
    got = list(VideoReader(str(path)))
    assert len(demux(str(path))) == len(packets) == 25 and len(got) == len(want) == 18
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))
    # an edit that reaches past the last sample's start keeps every sample, as FFmpeg does
    path.write_bytes(data[:elst + 12] + (1167).to_bytes(4, "big") + data[elst + 16:])
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    assert len(demux(str(path))) == len(packets) == 36


@pytest.mark.parametrize("data,what", [(b"", "empty"), (b"\x00" * 64, "not a video"),
                                       (b"RIFF\x10\x00\x00\x00AVI LIST", "without"),
                                       (b"\x00\x00\x00\x18ftypisom" + bytes(16), "moov")])
def test_broken_files_raise_value_error(tmp_path, data, what):
    path = tmp_path / "clip.mp4"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=what):
        demux(str(path))


def test_mjpeg_avi_reads_through_the_jpeg_decoder(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(3)]
    path = tmp_path / "clip.avi"
    with video_io.AviWriter(str(path), 10) as w:
        for f in frames:
            w.write(f)
    reader = VideoReader(str(path))
    got = list(reader)
    assert reader.fps == 10 and len(got) == 3
    for g, f in zip(got, frames):
        assert np.array_equal(g, video_io.image_io.decode_jpeg(video_io.image_io.encode_jpeg(f)))
    with pytest.raises(NotImplementedError, match="mpeg4 stream, not MJPEG"):
        video_io.read_avi_mjpeg(str(FIXTURES / "walk_640x480.avi"))
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    assert [p.tobytes() for p in packets] == list(demux(str(path)).packets())


@pytest.mark.parametrize("name", ["walk_640x480.mp4", "walk_640x480.avi"])
def test_fuzzed_containers_raise_or_read(tmp_path, name):
    """200 seeded byte flips in the container's headers (an MP4's moov, an
    AVI's hdrl and index): the port reads the file or raises ValueError or
    NotImplementedError, nothing else."""
    data = (FIXTURES / name).read_bytes()
    heads = [(0, data.find(b"mdat") + 4), (data.find(b"moov") - 4, len(data))] \
        if name.endswith("mp4") else \
        [(0, data.find(b"movi") + 4), (data.find(b"idx1"), len(data))]
    rng = np.random.default_rng(1)
    path, outcomes = tmp_path / name, set()
    for _ in range(200):
        edited = bytearray(data)
        lo, hi = heads[int(rng.integers(0, len(heads)))]
        for _ in range(int(rng.integers(1, 4))):
            edited[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
        path.write_bytes(edited)
        try:
            stream = demux(str(path))
            dec = Mpeg4Decoder(stream.config)
            for p in stream.packets():
                dec.decode(p)
            outcomes.add("read")
        except (ValueError, NotImplementedError) as e:
            outcomes.add(type(e).__name__)
    assert "ValueError" in outcomes


FUZZ = r"""
import json, sys
import numpy as np
from dro_sfm_torch.utils.video_io import Mpeg4Decoder, demux
names, cases, seed = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
streams = [demux(n) for n in names]
packets = [[s.config] + list(s.packets()) for s in streams]
rng = np.random.default_rng(seed)
out = {"ok": 0, "ValueError": 0, "NotImplementedError": 0, "truncated": 0}


def run(seq):
    dec = Mpeg4Decoder()
    try:
        for p in seq:
            if p and dec.decode(p):
                dec.frame(rgb=True, luma=True)
        out["ok"] += 1
    except ValueError:
        out["ValueError"] += 1
    except NotImplementedError:
        out["NotImplementedError"] += 1


for k in range(cases):
    seq = [bytearray(p) for p in packets[k % len(packets)]]
    i = int(rng.integers(0, len(seq)))
    while not seq[i]:
        i = int(rng.integers(0, len(seq)))
    for _ in range(int(rng.integers(1, 5))):
        j = int(rng.integers(0, len(seq[i])))
        seq[i][j] ^= int(rng.integers(1, 256))
    run([bytes(p) for p in seq])
for seq in packets:
    for i in range(len(seq)):
        for frac in (0.1, 0.5, 0.9):
            cut = list(seq)
            cut[i] = seq[i][:int(len(seq[i]) * frac)]
            run(cut)
            out["truncated"] += 1
print(json.dumps(out))
"""


def test_fuzzed_and_truncated_packets_never_crash():
    names = ",".join(str(FIXTURES / n) for n in ("noise_160x128.avi", "aic_176x144.avi",
                                                 "odd_200x136.mp4"))
    res = subprocess.run([sys.executable, "-c", FUZZ, names, "200", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] + out["ValueError"] + out["NotImplementedError"] == 200 + out["truncated"]
    assert out["ValueError"] > 0 and out["truncated"] == 3 * (9 + 9 + 37)
