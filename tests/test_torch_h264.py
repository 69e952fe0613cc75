"""The port's H.264 video input against OpenCV's FFmpeg (CPU, no card).

The committed fixtures (``dro_sfm_torch/testdata/h264``, written by libx264
through ``tools/torch_make_video_fixtures.py --only h264``) go through the
port's demuxers (`demux_mp4`, `demux_avi`) and its H.264 decoder
(``csrc/h264_video.cpp``) and through ``cv2.VideoCapture``, live:

* every packet equals FFmpeg's (``CAP_PROP_FORMAT`` -1): an AVI's byte for
  byte; an MP4's NAL unit by NAL unit, since FFmpeg gives its samples in
  the Annex B form of ``h264_mp4toannexb`` (split at the start codes, the
  ``avcC``'s SPS and PPS put before each IDR picture); and the rate equals
  OpenCV's;
* every luma plane equals FFmpeg's (``CAP_PROP_CONVERT_RGB`` 0), bar 0
  levels; for the fixtures of another VUI matrix than BT.601, whose luma
  OpenCV converts, FFmpeg's luma of a copy whose SPS names no matrix
  (`without_colour_matrix`: the same pictures);
* every RGB frame equals OpenCV's BGR flipped, bar 0 levels, the frames in
  OpenCV's order and number: B slices come out in display order, and an
  MP4's edit list trims the frames it does not cover (23 of the 24 of the
  libx264-default walks at 25 fps);
* the digests in ``fixtures.json`` equal OpenCV's, and the port's own decode
  equals the digests recorded with it.

The decoder's `stats` show the fixtures reach every tool it counts (the
Baseline tools; CABAC of every cabac_init_idc, B slices with spatial and
temporal direct prediction, the 8x8 transform and intra 8x8, explicit and
implicit weights, list modification, MMCO, scaling lists, reordered
output); the ``idr8`` fixtures hold three IDR pictures and the walks wrap
frame_num. The refused streams of libx264 (interlace, 4:4:4, 10-bit) raise
`NotImplementedError` naming the tool; the tools libx264 never writes are
streams built here bit by bit (`Stream`): each decodes in FFmpeg (OpenCV
reads it; slice groups aside, which FFmpeg does not implement either) and
raises in the port naming the tool, and the plain ones (one IDR; IDR, P, P,
IDR, P; frame_num and pic_order_cnt_lsb wrapping; MMCO op 1, list
modification, scaling lists without residual) decode equal to FFmpeg.
Broken ``avcC``, SPS, PPS and truncated access units raise `ValueError`;
fuzzed and cut packets, CAVLC and CABAC, P and B, raise or decode, and
never take the process down (a subprocess).
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.utils.video_io import H264Decoder, VideoReader, demux
from tools.torch_make_video_fixtures import annexb_nals, avcc, sample_form, without_colour_matrix

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "h264"
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


def ffmpeg_luma(path, tmp_path):
    """FFmpeg's luma planes of the file: of a copy without its VUI matrix
    where it names one (OpenCV converts the luma of such a stream)."""
    if META["files"][path.name]["colour"]:
        plain = tmp_path / path.name
        plain.write_bytes(without_colour_matrix(path.read_bytes()))
        path = plain
    luma, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    return [y if y.ndim == 2 else y[..., 0] for y in luma]


def sample_nals(sample: bytes, size: int):
    """The NAL units of an MP4 sample, each behind its ``size``-byte length."""
    out, pos = [], 0
    while pos < len(sample):
        n = int.from_bytes(sample[pos:pos + size], "big")
        out.append(sample[pos + size:pos + size + n])
        pos += size + n
    assert pos == len(sample)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_packets_equal_ffmpeg(name):
    """An AVI's packets byte for byte; an MP4's NAL unit by NAL unit: FFmpeg's
    packet split at its start codes is the sample's NAL units, with the
    ``avcC``'s SPS and PPS before the first slice of each IDR picture."""
    path = FIXTURES / name
    want, fps = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    stream = demux(str(path))
    got = list(stream.packets())
    assert stream.codec == "h264"
    assert len(got) == len(want) == META["files"][name]["packets"]
    if not stream.config:
        assert all(g == w.tobytes() for g, w in zip(got, want))
    else:
        size, sets = avcc(stream.config)
        idrs = 0
        for g, w in zip(got, want):
            ours, theirs = sample_nals(g, size), annexb_nals(w.tobytes())
            kinds = [nal[0] & 31 for nal in ours]
            assert 7 not in kinds and 8 not in kinds
            if 5 in kinds:
                at = kinds.index(5)
                ours = ours[:at] + sets + ours[at:]
                idrs += 1
            assert theirs == ours
        assert idrs == META["files"][name]["stats"]["idr_pictures"]
    assert stream.fps == fps == META["files"][name]["fps"]


@pytest.mark.parametrize("name", NAMES)
def test_luma_equals_ffmpeg(name, tmp_path):
    path = FIXTURES / name
    want = ffmpeg_luma(path, tmp_path)
    got = list(VideoReader(str(path)).frames(luma=True))
    assert len(got) == len(want) == META["files"][name]["frames"]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert int(np.abs(g.astype(int) - w).max()) == 0          # the bar: 0 levels


@pytest.mark.parametrize("name", NAMES)
def test_rgb_equals_opencv(name):
    path = FIXTURES / name
    want, _ = capture(path)
    reader = VideoReader(str(path))
    got = list(reader)
    assert len(got) == len(want) == len(reader.decode_ms) == META["files"][name]["frames"]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert int(np.abs(g.astype(int) - w[..., ::-1]).max()) == 0   # the bar: 0 levels


@pytest.mark.parametrize("name", NAMES)
def test_committed_digests(name, tmp_path):
    """fixtures.json against live OpenCV, and the port's decode against the
    digests recorded with it (what the card's host build is held to)."""
    path, entry = FIXTURES / name, META["files"][name]
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    bgr, _ = capture(path)
    form = (lambda p: p.tobytes()) if path.suffix == ".avi" else (
        lambda p: sample_form(p.tobytes()))
    assert [hashlib.sha256(form(p)).hexdigest() for p in packets] == entry["opencv"]["packets"]
    assert [sha(y) for y in ffmpeg_luma(path, tmp_path)] == entry["opencv"]["luma"]
    assert [sha(f[..., ::-1]) for f in bgr] == entry["opencv"]["rgb"]
    stream = demux(str(path))
    assert [hashlib.sha256(p).hexdigest() for p in stream.packets()] == \
        entry["opencv"]["packets"]
    dec = H264Decoder(stream.config)
    luma, rgb, shown = hashlib.sha256(), hashlib.sha256(), 0
    for p in [*stream.packets(), None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
                shown += 1
    assert shown == entry["frames"] == len(VideoReader(str(path)))
    assert luma.hexdigest() == entry["port"]["luma_all"]
    assert rgb.hexdigest() == entry["port"]["rgb_all"]
    assert dec.stats == entry["stats"] and dec.encoder == entry["encoder"]


def test_fixtures_cover_the_decoder():
    stats = {n: e["stats"] for n, e in META["files"].items()}
    total = {k: sum(s[k] for s in stats.values()) for k in H264Decoder.STATS}
    for k in H264Decoder.STATS:
        assert total[k] > 0, k
    assert stats["noise_slices_160x128.mp4"]["p_intra_mbs"] > 0
    assert stats["noise_qp1_96x64.mp4"]["level_escapes"] > 0
    assert stats["ref16_200x136.mp4"]["ref_idx_above_0"] > 0
    assert stats["constrained_intra_160x128.mp4"]["constrained_intra_pictures"] == 8
    assert stats["no_deblock_200x136.mp4"]["bs4_edges"] == 0
    assert stats["idr8_640x480.mp4"]["idr_pictures"] == stats["idr8_640x480.avi"]["idr_pictures"] \
        == 3
    # frame_num wraps: 24 pictures after one IDR, frame_num of 4 bits
    stream = demux(str(FIXTURES / "walk_640x480.mp4"))
    sps = avcc(stream.config)[1][0]
    assert sps[4] >> 6 == 0b11          # seq_parameter_set_id 0, log2_max_frame_num_minus4 0
    assert stats["walk_640x480.mp4"]["idr_pictures"] == 1 and len(stream) > 16
    assert all(e["encoder"].startswith("x264 - core") for e in META["files"].values())
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 3 << 19
    # libx264's defaults: OpenCV yields the 23 frames the MP4's edit list keeps, all 24 of the AVI
    for name in ("high_640x480.mp4", "high_640x480.mov", "high_640x480.avi"):
        entry = META["files"][name]
        assert entry["packets"] == 24 and entry["frames"] == (24 if name.endswith("avi") else 23)
        assert entry["options"] == ["profile=high"]
    high = stats["high_640x480.mp4"]
    for k in ("b_pictures", "cabac_idc0_slices", "spatial_direct_mbs", "bipred_partitions",
              "transform_8x8_mbs", "i8x8_mbs", "explicit_weighted_partitions",
              "implicit_weighted_partitions", "list_modifications", "mmco_ops",
              "reordered_frames"):
        assert high[k] > 0, k
    assert stats["high_temporal_direct_176x144.mp4"]["temporal_direct_mbs"] > 0
    assert stats["high_cabac_idc1_176x144.mp4"]["cabac_idc1_slices"] > 0
    assert stats["high_cabac_idc2_176x144.mp4"]["cabac_idc2_slices"] > 0
    assert stats["high_noise_qp1_slices_160x128.mp4"]["multi_slice_pictures"] == 4
    assert stats["high_fade_176x144.mp4"]["explicit_weighted_partitions"] > 100
    assert stats["high_idr8_320x240.mp4"]["idr_pictures"] == 3
    for name in ("high_cqm_jvt_176x144.mp4", "high_cqm_custom_176x144.mp4"):
        assert stats[name]["scaling_list_pictures"] == META["files"][name]["packets"]
    cavlc = {"main_bframes_cavlc_64x48.avi": "b_pictures", "main_weighted_cavlc_64x48.mp4":
             "explicit_weighted_partitions", "high_8x8dct_cavlc_64x48.mp4": "transform_8x8_mbs"}
    for name, k in cavlc.items():
        assert stats[name][k] > 0 and sum(stats[name][f"cabac_{c}_slices"] for c in
                                          ("i", "idc0", "idc1", "idc2")) == 0, name


@pytest.mark.parametrize("name", ["odd_200x136.mp4", "idr8_640x480.mp4",
                                  "high_idr8_320x240.mp4"])
def test_length_prefixed_and_annexb_decode_alike(name):
    """An MP4's samples with its avcC, and FFmpeg's Annex B form of them
    without it (the SPS and PPS again before each IDR picture), decode to
    the same frames, made ready by the same packets; a decoder without the
    avcC cannot read the samples."""
    path = FIXTURES / name
    stream = demux(str(path))
    packets, _ = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    a, b = H264Decoder(stream.config), H264Decoder()
    for sample, annexb in [*zip(stream.packets(), (p.tobytes() for p in packets)),
                           (None, None)]:
        ready = a.decode(sample) if sample is not None else a.flush()
        assert ready == (b.decode(annexb) if annexb is not None else b.flush())
        for _ in range(ready):
            assert a.next() == b.next()
            assert np.array_equal(a.frame(), b.frame())
            assert all(np.array_equal(x, y) for x, y in zip(a.planes(), b.planes()))
    with pytest.raises(ValueError, match="Annex B start code"):
        H264Decoder().decode(stream.packet(0))


@pytest.mark.parametrize("name", REFUSALS)
def test_refused_encoder_streams(name):
    path = FIXTURES / name
    frames, _ = capture(path)
    assert len(frames) == 6                                   # FFmpeg reads them
    assert META["refusals"][name]["raises"] in ("interlaced", "chroma format 3", "bit depth 10")
    with pytest.raises(NotImplementedError, match=META["refusals"][name]["raises"]):
        list(VideoReader(str(path)))


@pytest.mark.parametrize("fourcc", [b"H264", b"X264", b"AVC1", b"avc1", b"x264"])
def test_avi_fourccs_of_h264(tmp_path, fourcc):
    data = (FIXTURES / "walk_640x480.avi").read_bytes()
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data.replace(b"H264", fourcc))
    stream = demux(str(edited))
    assert stream.codec == "h264" and len(stream) == 24
    assert np.array_equal(next(iter(VideoReader(str(edited)))),
                          next(iter(VideoReader(str(FIXTURES / "walk_640x480.avi")))))


def test_avc3_sample_entry_reads_as_avc1(tmp_path):
    data = (FIXTURES / "odd_200x136.mp4").read_bytes()
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(data.replace(b"avc1", b"avc3", 1))
    want, _ = capture(edited)
    got = list(VideoReader(str(edited)))
    assert len(got) == len(want) == 24
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))


def _box(data: bytes, kind: bytes) -> int:
    """The offset of the one ``kind`` box's body (past its size and type)."""
    at = data.find(kind)
    assert at > 0 and data.find(kind, at + 1) < 0
    return at + 4


@pytest.mark.parametrize("shift,shown", [(0, 23), (1024, 22)], ids=["positive", "negative"])
def test_ctts_version_1(tmp_path, shift, shown):
    """A ``ctts`` of version 1 (signed offsets): the same offsets, or each
    lowered by the first one's, so that the edit list's media time now
    falls on the third frame in display order (a composition time is the
    decode time plus the offset, negative or not); the port shows OpenCV's
    frames of the file."""
    data = bytearray((FIXTURES / "high_640x480.mp4").read_bytes())
    pos = _box(data, b"ctts")
    data[pos] = 1
    count = int.from_bytes(data[pos + 4:pos + 8], "big")
    for i in range(count):
        at = pos + 8 + 8 * i + 4
        off = int.from_bytes(data[at:at + 4], "big", signed=True) - shift
        data[at:at + 4] = off.to_bytes(4, "big", signed=True)
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(bytes(data))
    want, _ = capture(edited)
    reader = VideoReader(str(edited))
    got = list(reader)
    assert len(got) == len(want) == len(reader) == shown
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))


def test_edit_list_of_another_rate_is_refused(tmp_path):
    data = bytearray((FIXTURES / "high_640x480.mp4").read_bytes())
    pos = _box(data, b"elst")
    assert data[pos] == 0 and int.from_bytes(data[pos + 4:pos + 8], "big") == 1
    data[pos + 16:pos + 18] = (2).to_bytes(2, "big")          # media_rate_integer 2
    edited = tmp_path / "clip.mp4"
    edited.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="rate"):
        demux(str(edited))


# ---------------------------------------------------------------- streams built bit by bit

class Stream:
    """An Annex B H.264 stream of 64x48 (4x3 macroblocks) built field by
    field: SPS, PPS, IDR pictures of grey I_16x16 DC macroblocks, P pictures
    of skipped macroblocks, each with the fields a test changes."""

    MBS = 12

    def __init__(self):
        self.bits, self.redundant = [], False

    def u(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, v):
        n = (v + 1).bit_length()
        return self.u(n - 1, 0).u(n, v + 1)

    def se(self, v):
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def nal(self, header: int) -> bytes:
        bits = self.bits + [1]
        bits += [0] * (-len(bits) % 8)
        raw = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
        out, zeros = bytearray(), 0
        for b in raw:                      # emulation prevention
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        self.bits = []
        return b"\0\0\0\1" + bytes([header]) + bytes(out)

    def sps(self, poc_type=2, width_mbs=4, crop_left=0, matrix=None, profile=66, high=(),
            direct_8x8=1):
        self.u(8, profile).u(8, 0xC0 if profile == 66 else 0).u(8, 30).ue(0)
        if profile == 100:
            self.ue(1).ue(0).ue(0).u(1, "lossless" in high).u(1, "scaling" in high)
            if "scaling" in high:
                self.u(8, 0)                # no list present: the fall-back rule
        self.ue(0).ue(poc_type)
        if poc_type == 0:
            self.ue(0)
        elif poc_type == 1:
            self.u(1, 1).se(0).se(0).ue(0)
        self.ue(1).u(1, 0).ue(width_mbs - 1).ue(2).u(1, 1).u(1, direct_8x8)
        self.u(1, crop_left > 0)
        if crop_left:
            self.ue(crop_left).ue(0).ue(0).ue(0)
        self.u(1, matrix is not None)
        if matrix is not None:              # VUI: a colour description only
            self.u(1, 0).u(1, 0).u(1, 1).u(3, 5).u(1, 0).u(1, 1).u(8, 2).u(8, 2).u(8, matrix)
            self.u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0)
        return self.nal(0x67)

    def pps(self, slice_groups=0, redundant=0, bipred=0):
        self.ue(0).ue(0).u(1, 0).u(1, 0).ue(slice_groups)
        if slice_groups:
            self.ue(0).ue(0)                # interleaved, run length 1 a group
        self.ue(0).ue(0).u(1, 0).u(2, bipred).se(0).se(0).se(0).u(1, 1).u(1, 0).u(1, redundant)
        self.redundant = bool(redundant)
        return self.nal(0x68)

    def idr(self, frame_num=0, poc_lsb=None, long_term=0, deblock_idc=0, first_mb=0, mbs=MBS,
            pcm=False, slice_type=7, nal=0x65):
        self.ue(first_mb).ue(slice_type).ue(0).u(4, frame_num)
        if nal == 0x65:
            self.ue(0)
        if poc_lsb is not None:
            self.u(4, poc_lsb)
        if self.redundant:
            self.ue(0)                      # redundant_pic_cnt: the primary picture
        if slice_type in (0, 3, 5, 8):       # P and SP: no override, no list modification
            self.u(1, 0).u(1, 0)
        if nal == 0x65:
            self.u(1, 0).u(1, long_term)
        else:
            self.u(1, 0)
        if slice_type in (3, 8):             # SP: sp_for_switch_flag, slice_qs_delta
            self.se(0).u(1, 0).se(0)
        else:
            self.se(0)
        self.ue(deblock_idc)
        if deblock_idc != 1:
            self.se(0).se(0)
        for k in range(mbs):
            if pcm and k == 0:              # I_PCM: aligned, then 384 samples of 128
                self.ue(25)
                self.u(-len(self.bits) % 8, 0)
                for _ in range(384):
                    self.u(8, 128)
            else:                           # I_16x16_2_0_0 (DC), chroma DC, no residual
                self.ue(3).ue(0).se(0).u(1, 1)
        return self.nal(nal)

    def p(self, frame_num=1, poc_lsb=None, mmco=0, modification=0, nal=0x41):
        self.ue(0).ue(5).ue(0).u(4, frame_num)
        if poc_lsb is not None:
            self.u(4, poc_lsb)
        self.u(1, 0).u(1, modification)
        if modification:                    # abs_diff_pic_num_minus1 0, then the end
            self.ue(0).ue(0).ue(3)
        if nal & 0x60:
            self.u(1, mmco > 0)
            if mmco == 1:                   # mark the picture before unused, then the end
                self.ue(1).ue(0).ue(0)
            elif mmco:                      # the operation alone, then the end
                self.ue(mmco).ue(0)
        self.se(0).ue(0).se(0).se(0).ue(self.MBS)
        return self.nal(nal)

    def b(self, frame_num=2, weights=False, sub8x4=False):
        """A non-reference B picture (POC after the P picture before it) of
        B_Skip macroblocks (spatial direct), or with a first B_8x8 of four
        B_L0_8x4 sub-macroblocks without residual."""
        self.ue(0).ue(6).ue(0).u(4, frame_num)
        self.u(1, 1).u(1, 0).u(1, 0).u(1, 0)     # spatial direct, no override or modification
        if weights:                              # denominators 0, no weight sent
            self.ue(0).ue(0).u(1, 0).u(1, 0).u(1, 0).u(1, 0)
        self.se(0).ue(0).se(0).se(0)
        if sub8x4:                               # B_8x8, sub_mb_type 4 x4, zero mvds, cbp 0
            self.ue(0).ue(22)
            for _ in range(4):
                self.ue(4)
            for _ in range(16):
                self.se(0)
            self.ue(0).ue(self.MBS - 1)
        else:
            self.ue(self.MBS)
        return self.nal(0x01)


def built(case: str):
    """(packets, the tool the port names, ``None`` for a plain stream)."""
    s = Stream()
    head = [s.sps(), s.pps()]
    if case == "plain":
        return [head[0] + head[1] + s.idr(), s.p(1), s.p(2), s.p(3)], None
    if case == "later_idr":
        return [b"".join(head) + s.idr(), s.p(1), s.p(2), s.idr(), s.p(1)], None
    if case == "wrap":                      # frame_num past 15, POC lsb past 15, a later IDR
        return [s.sps(poc_type=0) + head[1] + s.idr(poc_lsb=0)] \
            + [s.p(k % 16, poc_lsb=2 * k % 16) for k in range(1, 20)] \
            + [s.idr(poc_lsb=0), s.p(1, poc_lsb=2)], None
    if case == "poc_type_1":
        return [s.sps(poc_type=1) + head[1] + s.idr(), s.p(1)], "pic_order_cnt_type 1"
    if case == "long_term":
        return [b"".join(head) + s.idr(long_term=1), s.p(1)], "long-term reference"
    if case == "mmco":                      # MMCO op 1 marks the P picture before unused
        return [b"".join(head) + s.idr(), s.p(1), s.p(2, mmco=1), s.p(3)], None
    if case == "list_modification":         # idc 0: the P picture before goes first
        return [b"".join(head) + s.idr(), s.p(1), s.p(2, modification=1)], None
    if case == "b_skip":
        return [b"".join(head) + s.idr(), s.p(1), s.b(2)], None
    if case == "explicit_bipred":
        return [head[0] + s.pps(bipred=1) + s.idr(), s.p(1), s.b(2, weights=True)], \
            "explicit weighted bi-prediction"
    if case == "mmco5":
        return [b"".join(head) + s.idr(), s.p(1), s.p(2, mmco=5)], \
            "memory management control operation 5"
    if case == "b_sub8x8":
        return [b"".join(head) + s.idr(), s.p(1), s.b(2, sub8x4=True)], "smaller than 8x8"
    if case == "direct_8x8_inference_0":
        return [s.sps(direct_8x8=0) + head[1] + s.idr(), s.p(1), s.b(2)], \
            "direct_8x8_inference_flag 0"
    if case == "frame_num_gap":
        return [b"".join(head) + s.idr(), s.p(2)], "gaps in frame_num"
    if case == "deblock_idc_2":
        return [b"".join(head) + s.idr(deblock_idc=2)], "disable_deblocking_filter_idc 2"
    if case == "pcm":
        return [b"".join(head) + s.idr(pcm=True)], "I_PCM"
    if case == "poc_out_of_order":
        return [s.sps(poc_type=0) + head[1] + s.idr(poc_lsb=0), s.p(1, poc_lsb=4),
                s.p(2, poc_lsb=2)], "out of decode order"
    if case == "size_change":
        return [b"".join(head) + s.idr(), s.p(1), s.sps(width_mbs=5) + s.pps() + s.idr(mbs=15)], \
            "size change"
    if case == "crop_left":
        return [s.sps(crop_left=1) + head[1] + s.idr()], "cropping from the left"
    if case == "no_idr_first":
        return [b"".join(head) + s.idr(nal=0x21), s.p(1)], "does not start with an IDR"
    if case == "sp_slice":
        return [b"".join(head) + s.idr(), s.p(1), s.idr(frame_num=2, slice_type=8, nal=0x41)], \
            "SP and SI slices"
    if case == "two_pictures":
        return [b"".join(head) + s.idr() + s.p(1)], "several pictures in one packet"
    if case == "aso":
        return [b"".join(head) + s.idr(first_mb=6, mbs=6) + s.idr(mbs=6)], \
            "arbitrary slice order"
    if case == "fmo":
        return [head[0] + s.pps(slice_groups=1) + s.idr()], "slice groups"
    if case == "redundant":
        return [head[0] + s.pps(redundant=1) + s.idr()], "redundant pictures"
    if case == "ycgco":
        return [s.sps(matrix=8) + head[1] + s.idr()], "matrix_coefficients 8"
    if case == "lossless":
        return [s.sps(profile=100, high=("lossless",)) + head[1] + s.idr()], "lossless"
    if case == "scaling":                   # the SPS's lists by fall-back rule A
        return [s.sps(profile=100, high=("scaling",)) + head[1] + s.idr()], None
    if case == "data_partitioning":
        return [b"".join(head) + s.idr(), b"\0\0\0\1\x22\x80"], "data partitioning"
    raise KeyError(case)


# Tools that libx264 never writes, and tools that no fixture above reaches;
# FFmpeg decodes each built stream.
BUILT = ["poc_type_1", "long_term", "frame_num_gap", "deblock_idc_2", "pcm", "poc_out_of_order",
         "size_change", "crop_left", "no_idr_first", "sp_slice", "two_pictures", "aso", "fmo",
         "redundant", "ycgco", "lossless", "data_partitioning", "explicit_bipred", "mmco5",
         "b_sub8x8", "direct_8x8_inference_0"]
FFMPEG_SKIPS = {"fmo"}                      # FFmpeg does not implement slice groups either


@pytest.mark.parametrize("case,idrs", [("plain", 1), ("later_idr", 2), ("wrap", 2), ("mmco", 1),
                                       ("list_modification", 1), ("scaling", 1), ("b_skip", 1)])
def test_a_built_stream_decodes_as_ffmpeg(tmp_path, case, idrs):
    packets, _ = built(case)
    path = tmp_path / f"{case}.h264"
    path.write_bytes(b"".join(packets))
    want, _ = capture(path)
    dec, got = H264Decoder(), []
    for i, p in enumerate(packets):
        assert dec.decode(p) == 1                 # no reordering: each picture at once
        assert dec.next() == i
        got.append(dec.frame())
    assert dec.flush() == 0
    assert len(got) == len(want) == len(packets)
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))
    assert dec.stats["idr_pictures"] == idrs
    assert dec.stats["p_pictures"] + dec.stats["b_pictures"] == len(packets) - idrs
    assert dec.stats["b_pictures"] == (case == "b_skip")
    assert dec.stats["skipped_mbs"] == (len(packets) - idrs) * Stream.MBS
    assert dec.stats["i16x16_mbs"] == idrs * Stream.MBS
    assert dec.stats["mmco_ops"] == (case == "mmco")
    assert dec.stats["list_modifications"] == (case == "list_modification")
    assert dec.stats["scaling_list_pictures"] == (case == "scaling")


@pytest.mark.parametrize("case", BUILT)
def test_built_streams_of_other_tools_are_refused(tmp_path, case):
    packets, what = built(case)
    if case not in FFMPEG_SKIPS:            # a stream FFmpeg decodes, not a broken one
        path = tmp_path / f"{case}.h264"
        path.write_bytes(b"".join(packets))
        assert capture(path)[0], "FFmpeg decodes no frame of it"
    dec = H264Decoder()
    with pytest.raises(NotImplementedError, match=what):
        for p in packets:
            dec.decode(p)


# ---------------------------------------------------------------- broken input

@pytest.mark.parametrize("edit,what", [
    (lambda c: b"\x00" + c[1:], "not version 1"),
    (lambda c: c[:5], "not version 1"),
    (lambda c: c[:4] + bytes([c[4] & 0xFC | 2]) + c[5:], "NAL length size of 3"),
    (lambda c: c[:12], "truncated avcC"),
    (lambda c: c[:8] + bytes([c[8] | 0x80]) + c[9:], "forbidden_zero_bit"),
], ids=["version", "short", "length_size", "cut", "forbidden_bit"])
def test_broken_avcc_raises_value_error(edit, what):
    config = demux(str(FIXTURES / "odd_200x136.mp4")).config
    with pytest.raises(ValueError, match=what):
        H264Decoder(edit(config))


@pytest.mark.parametrize("case,what", [
    ("sps_cut", "truncated H.264"), ("pps_cut", "truncated H.264"),
    ("pps_of_missing_sps", "missing SPS"), ("slice_of_missing_pps", "missing PPS"),
    ("slice_cut", "macroblocks|truncated"), ("p_first", "IDR"),
    ("forbidden_bit", "forbidden_zero_bit"), ("no_start_code", "start code"),
], ids=lambda x: x if isinstance(x, str) and " " not in x and "|" not in x else "")
def test_broken_parameter_sets_and_access_units_raise(case, what):
    s = Stream()
    sps, pps, idr = s.sps(), s.pps(), s.idr()
    packets = {
        "sps_cut": [sps[:7] + pps + idr],
        "pps_cut": [sps + pps[:6] + idr],
        "pps_of_missing_sps": [pps + idr],
        "slice_of_missing_pps": [idr],
        "slice_cut": [sps + pps + idr[:len(idr) // 2]],
        "p_first": [sps + pps + s.p(1)],
        "forbidden_bit": [sps + pps + idr[:4] + bytes([idr[4] | 0x80]) + idr[5:]],
        "no_start_code": [b"\x65\x88\x84"],
    }[case]
    dec = H264Decoder()
    with pytest.raises((ValueError, NotImplementedError), match=what) as err:
        for p in packets:
            dec.decode(p)
    assert err.type is (NotImplementedError if case == "p_first" else ValueError)


def test_a_failed_access_unit_leaves_the_last_frame():
    """A truncated P picture raises and is not output: the decoder keeps the
    frame and references it had, and the next access unit decodes on them."""
    stream = demux(str(FIXTURES / "odd_200x136.mp4"))
    dec, ref = H264Decoder(stream.config), H264Decoder(stream.config)
    for p in list(stream.packets())[:3]:
        for _ in dec.output(p):
            pass
        for _ in ref.output(p):
            pass
    before = dec.frame()
    with pytest.raises(ValueError):
        dec.decode(stream.packet(3)[:len(stream.packet(3)) // 2])
    assert np.array_equal(dec.frame(), before)
    for i, p in enumerate(list(stream.packets())[3:6]):
        assert dec.decode(p) == ref.decode(p) == 1
        assert dec.next() == ref.next() + 1 == 4 + i   # the failed call counts as a packet
        assert np.array_equal(dec.frame(), ref.frame())


FUZZ = r"""
import json, sys
import numpy as np
from dro_sfm_torch.utils.video_io import H264Decoder, demux
names, cases, seed = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
streams = [demux(n) for n in names]
packets = [(s.config, list(s.packets())) for s in streams]
rng = np.random.default_rng(seed)
out = {"ok": 0, "ValueError": 0, "NotImplementedError": 0, "truncated": 0}


def run(config, seq):
    try:
        dec = H264Decoder(config)
        for p in [*seq, None]:
            if p is None or p:
                for _ in dec.output(p, rgb=True, luma=True):
                    pass
        out["ok"] += 1
    except ValueError:
        out["ValueError"] += 1
    except NotImplementedError:
        out["NotImplementedError"] += 1


for k in range(cases):
    config, seq = packets[k % len(packets)]
    seq = [bytearray(p) for p in seq]
    config = bytearray(config)
    target = seq[int(rng.integers(0, len(seq)))] if rng.random() < 0.9 or not config else config
    for _ in range(int(rng.integers(1, 5))):
        j = int(rng.integers(0, len(target)))
        target[j] ^= int(rng.integers(1, 256))
    run(bytes(config), [bytes(p) for p in seq])
for config, seq in packets:
    for i in range(len(seq)):
        for frac in (0.1, 0.5, 0.9):
            cut = list(seq)
            cut[i] = seq[i][:int(len(seq[i]) * frac)]
            run(config, cut)
            out["truncated"] += 1
print(json.dumps(out))
"""


def test_fuzzed_and_truncated_packets_never_crash():
    """CAVLC and CABAC, P and B packets, the 8x8 transform and weighted
    prediction among them."""
    names = ",".join(str(FIXTURES / n) for n in (
        "noise_qp1_96x64.mp4", "odd_200x136.mp4", "colour_fcc_64x48.mp4",
        "high_cabac_idc1_176x144.mp4", "main_bframes_cavlc_64x48.avi",
        "high_noise_qp1_slices_160x128.mp4"))
    res = subprocess.run([sys.executable, "-c", FUZZ, names, "300", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] + out["ValueError"] + out["NotImplementedError"] == 300 + out["truncated"]
    assert out["ValueError"] > 0 and out["truncated"] == 3 * (6 + 24 + 6 + 12 + 6 + 4)
