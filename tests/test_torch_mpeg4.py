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
another QP; and Advanced Simple Profile as FFmpeg's encoder and XviD write
it: B-VOPs (direct, interpolated, backward and forward macroblocks, DBQUANT,
those skipped with their co-located one), packed in AVI and reordered by an
MP4's ``ctts`` and edit list, four vectors, quarter sample, MPEG
quantisation with the default and custom matrices, video packets, data
partitioning, GMC S-VOPs and XviD's IDCT (each counted by the decoder's
`stats` and asserted here). What the port refuses raises
`NotImplementedError` naming it: interlace (a stream of FFmpeg's encoder),
XviD and DivX builds for which FFmpeg turns on bug workarounds (copies of
XviD clips with their user data edited, committed), bit edits of a
fixture's VOL, VO, VOP header or user data for the other tools (RVLC, GMC
of another number of warping points, static sprites, a fourcc that names
XviD without its user data) and an ``av01`` sample entry (H.264's ``avc1``
is decoded: `tests/test_torch_h264.py`), and the first bytes of other
containers. Truncated packets and 200 seeded random byte flips raise
`ValueError` (or, where a flip turns a header into a refused tool,
`NotImplementedError`) or decode, and never take the process down: they run
in a subprocess.
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
    assert len(got) == len(want) == META["files"][name]["packets"]
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
    dec = Mpeg4Decoder.for_stream(stream)
    luma, rgb = hashlib.sha256(), hashlib.sha256()
    frames = 0
    for p in [*stream.packets(), None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                frames += 1
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
    assert frames == entry["frames"]
    assert luma.hexdigest() == entry["port"]["luma_all"]
    assert rgb.hexdigest() == entry["port"]["rgb_all"]
    assert dec.stats == entry["stats"] and dec.encoder == entry["encoder"]


def test_fixtures_cover_the_decoder():
    stats = {n: e["stats"] for n, e in META["files"].items()}
    total = {k: sum(s[k] for s in stats.values()) for k in Mpeg4Decoder.STATS}
    assert set(Mpeg4Decoder.STATS) == set(total)
    for k in Mpeg4Decoder.STATS:
        if k != "not_coded_vops":      # XviD's N-VOPs are replaced by a packed B-VOP
            assert total[k] > 0, k
    assert stats["noise_160x128.avi"]["escape3"] > 0
    encoders = {e["encoder"][:4] for e in META["files"].values()}
    assert encoders == {"Lavc", "XviD"}
    for name, e in META["files"].items():
        # FFmpeg runs its XviD IDCT exactly where the user data names XviD
        vops = sum(e["stats"][k] for k in ("i_vops", "p_vops", "b_vops", "s_vops"))
        assert e["stats"]["xvid_idct_vops"] == (vops if e["encoder"].startswith("XviD") else 0)
    assert stats["xvid_bf2_176x144.avi"]["packed_vops"] > 0
    assert stats["xvid_bf2_176x144.mp4"]["packed_vops"] == 0
    assert stats["xvid_640x480.avi"]["four_mv_mbs"] > 0
    assert stats["asp_176x144.avi"]["dbquant_mbs"] > 0
    size = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert size < 3 << 19


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
    assert len(frames) == META["refusals"][name]["frames"] > 0   # FFmpeg reads them
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
    """The bit offset in ``data`` of each flag of its first VOL header (a
    VOL without quantisation matrices; verid 2's fields and GMC's where the
    VOL has them)."""
    start = data.find(b"\x00\x00\x01\x20")
    r = Bits(data, 8 * (start + 4))
    r.read(9)
    verid = 1
    if r.read(1):
        verid = r.read(4)
        r.read(3)
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
    names = ["interlaced", "obmc_disable", "sprite_enable"]
    for name in names:
        fields[name] = r.pos
        sprite = r.read(1 if verid == 1 or name != "sprite_enable" else 2)
    if sprite == 2:
        fields["sprite_warping_points"] = r.pos
        r.read(6)
        fields["sprite_warping_accuracy"] = r.pos
        r.read(2)
        fields["sprite_brightness_change"] = r.pos
        r.read(1)
    names = ["not_8_bit", "quant_type", *(["quarter_sample"] if verid != 1 else []),
             "complexity_estimation_disable", "resync_marker_disable", "data_partitioned"]
    for name in names:
        fields[name] = r.pos
        r.read(1)
    if Bits(data, fields["data_partitioned"]).read(1):
        fields["reversible_vlc"] = r.pos
        r.read(1)
    if verid != 1:
        fields["newpred_enable"] = r.pos
        fields["reduced_resolution_vop_enable"] = r.pos + 1
        r.read(2)
    fields["scalability"] = r.pos
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
    # quant_type 1 is decoded: "100" reads as MPEG quantisation with the default matrices,
    # and the next flag, complexity_estimation_disable, lands on data_partitioned (0)
    ("walk_640x480.avi", "quant_type", 3, 0b100, "complexity estimation"),
    ("walk_640x480.avi", "interlaced", 1, 1, "interlaced"),
    ("walk_640x480.mov", "interlaced", 1, 1, "interlaced"),
    ("walk_640x480.avi", "sprite_enable", 1, 1, "static sprites"),
    # data partitioning is decoded: "11" reads as it with reversible_vlc 1
    ("walk_640x480.avi", "data_partitioned", 2, 0b11, "RVLC"),
    ("walk_640x480.avi", "obmc_disable", 1, 0, "OBMC"),
    ("walk_640x480.avi", "complexity_estimation_disable", 1, 0, "complexity estimation"),
    ("walk_640x480.avi", "scalability", 1, 1, "scalability"),
    ("walk_640x480.avi", "chroma_format", 2, 2, "chroma format"),
    ("partitioned_64x48.avi", "reversible_vlc", 1, 1, "RVLC"),
    ("xvid_gmc_176x144.avi", "sprite_warping_points", 6, 2, "GMC with 2 warping points"),
    ("xvid_gmc_176x144.avi", "sprite_warping_points", 6, 0, "GMC with 0 warping points"),
    ("xvid_gmc_176x144.avi", "sprite_brightness_change", 1, 1, "brightness_change"),
    ("xvid_gmc_176x144.avi", "sprite_enable", 2, 1, "static sprites"),
    ("xvid_qpel_176x144.avi", "newpred_enable", 1, 1, "newpred"),
    ("xvid_qpel_176x144.avi", "reduced_resolution_vop_enable", 1, 1, "reduced resolution"),
]


@pytest.mark.parametrize("name,field,n,value,what", VOL_EDITS,
                         ids=[f"{e[0]}-{e[1]}" + (f"-{e[3]}" if "points" in e[1] else "")
                              for e in VOL_EDITS])
def test_vol_edits_are_refused(tmp_path, name, field, n, value, what):
    data = (FIXTURES / name).read_bytes()
    edited = tmp_path / name
    edited.write_bytes(set_bits(data, vol_fields(data)[field], n, value))
    with pytest.raises(NotImplementedError, match=what) as e:
        list(VideoReader(str(edited)))
    assert "quant_type" not in str(e.value) and "data partitioning (" not in str(e.value)


@pytest.mark.parametrize("kind,what", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_vop_type_edits_are_refused(tmp_path, kind, what):
    """The first P-VOP made an S-VOP in a VOL without GMC: refused. Made a
    B-VOP: decoded as FFmpeg decodes it, which skips a B-VOP without a
    forward reference (35 frames, equal to OpenCV's)."""
    data = (FIXTURES / "walk_640x480.mp4").read_bytes()
    pos = data.find(b"\x00\x00\x01\xb6")
    pos = data.find(b"\x00\x00\x01\xb6", pos + 4)          # the first P-VOP
    assert data[pos + 4] >> 6 == 1
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(set_bits(data, 8 * (pos + 4), 2, kind))
    if kind == 2:
        want, _ = capture(edited)
        got = list(VideoReader(str(edited)))
        assert len(got) == len(want) == 35
        assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))
        return
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


@pytest.mark.parametrize("name", ["walk_640x480.mp4", "walk_640x480.avi", "xvid_bf2_176x144.mp4",
                                  "xvid_bf2_176x144.avi"])
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
            dec = Mpeg4Decoder.for_stream(stream)
            for p in stream.packets():
                dec.decode(p)
            dec.flush()
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
        if dec.flush():
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


FUZZED = ("noise_160x128.avi", "aic_176x144.avi", "odd_200x136.mp4", "asp_176x144.avi",
          "xvid_bf2_176x144.avi", "xvid_bf2_176x144.mp4", "xvid_gmc_176x144.avi",
          "xvid_qpel_176x144.avi", "matrices_176x144.avi")


def test_fuzzed_and_truncated_packets_never_crash():
    names = ",".join(str(FIXTURES / n) for n in FUZZED)
    res = subprocess.run([sys.executable, "-c", FUZZ, names, "300", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] + out["ValueError"] + out["NotImplementedError"] == 300 + out["truncated"]
    assert out["ValueError"] > 0
    assert out["truncated"] == 3 * sum(META["files"][n]["packets"] + 1 for n in FUZZED)


def test_packed_b_frames_come_out_as_ffmpeg_gives_them():
    """XviD's packed AVI: a packet holding a P-VOP and the B-VOP after it,
    then the B-VOP's packet, then an N-VOP. FFmpeg decodes the second VOP of
    a packet with the next packet, in place of an N-VOP, and gives one frame
    a packet (none for the first), the last at the flush; so does the port,
    in the same display order."""
    stream = demux(str(FIXTURES / "xvid_bf2_176x144.avi"))
    packets = list(stream.packets())
    vops = [p.count(b"\x00\x00\x01\xb6") for p in packets]
    assert vops.count(2) >= 3 and min(len(p) for p in packets) <= 19     # packed, N-VOPs
    dec = Mpeg4Decoder.for_stream(stream)
    made = [dec.decode(p) for p in packets] + [dec.flush()]
    assert made == [0] + [1] * (len(packets) - 1) + [1]
    assert dec.stats["packed_vops"] == vops.count(2) * 2 and dec.stats["b_vops"] > 0
    want, _ = capture(FIXTURES / "xvid_bf2_176x144.avi")
    assert len(want) == sum(made) == META["files"]["xvid_bf2_176x144.avi"]["frames"]


@pytest.mark.parametrize("name", ["bframes_176x144.mp4", "xvid_bf2_176x144.mp4"])
def test_b_vops_in_mp4_come_out_in_display_order(name):
    """B-VOPs in MP4 (FFmpeg's encoder's with a ``ctts`` box and an edit
    list, libxvid's unpacked with an edit list): the packets in decode
    order, the frames in display order, each attributed to its packet, equal
    to OpenCV's."""
    path = FIXTURES / name
    data = path.read_bytes()
    assert b"elst" in data and (b"ctts" in data) == name.startswith("bframes")
    stream = demux(str(path))
    dec = Mpeg4Decoder.for_stream(stream)
    order = [k for p in [*stream.packets(), None] for k, _ in dec.output(p)]
    types = [p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6 for p in stream.packets()]
    # each B-VOP comes out at once, each I- or P-VOP when the next one is decoded
    want_order, waiting = [], None
    for k, t in enumerate(types):
        if t == 2:
            want_order.append(k)
        else:
            want_order += [] if waiting is None else [waiting]
            waiting = k
    assert 2 in types and order == want_order + [waiting] != sorted(order)
    want, _ = capture(path)
    got = list(VideoReader(str(path)))
    assert len(got) == len(want) == META["files"][path.name]["frames"]


@pytest.mark.parametrize("name,old,new,what", [
    ("walk_640x480_xvid.avi", b"Lavc62.28.101", b"xxxx62.28.101", "XviD build 0"),
    ("xvid_bf2_176x144.avi", b"XviD0069", b"XviD0003", "XviD build 3"),
    ("walk_640x480.avi", b"Lavc62.28.101", b"Lavc00.18.100", "libavcodec build 4708"),
])
def test_user_data_edits_that_name_old_builds_are_refused(tmp_path, name, old, new, what):
    """FFmpeg reads the encoder from the user data (and, without one, from an
    AVI's fourcc: XVID implies XviD build 0) and turns on bug workarounds for
    old builds; the port refuses those streams naming the build."""
    data = (FIXTURES / name).read_bytes()
    assert data.count(old) >= 1
    edited = tmp_path / name
    edited.write_bytes(data.replace(old, new))
    assert len(capture(edited)[0]) > 0
    with pytest.raises(NotImplementedError, match=what):
        list(VideoReader(str(edited)))


def test_user_data_removed_decodes_with_the_simple_idct(tmp_path):
    """Lavc's user data removed from an FMP4 AVI: no encoder named, no
    workaround, FFmpeg's simple IDCT, equal to OpenCV; the XviD IDCT would
    differ."""
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data.replace(b"Lavc62.28.101", b"xxxx62.28.101"))
    want, _ = capture(edited, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    got = list(VideoReader(str(edited)).frames(luma=True))
    assert len(got) == len(want) == 36
    assert all(np.array_equal(g, w if w.ndim == 2 else w[..., 0]) for g, w in zip(got, want))
    stream = demux(str(FIXTURES / "xvid_qpel_176x144.avi"))
    assert stream.tag == b"XVID"
    dec = Mpeg4Decoder.for_stream(stream)
    for p in stream.packets():
        dec.decode(p)
    assert dec.encoder == "XviD0069" and dec.stats["xvid_idct_vops"] == len(stream)
