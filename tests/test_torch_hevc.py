"""The port's HEVC video input against OpenCV's FFmpeg (CPU, no card).

The committed fixtures (``dro_sfm_torch/testdata/hevc``, written by libx265
through ``tools/torch_make_video_fixtures.py --only hevc``) go through the
port's demuxers (`demux_mp4`, `demux_avi`) and its HEVC decoder
(``csrc/hevc_video.cpp``) and through ``cv2.VideoCapture``, live:

* every packet equals FFmpeg's (``CAP_PROP_FORMAT`` -1): an AVI's byte for
  byte; an MP4's in the Annex B form of ``hevc_mp4toannexb`` (4-byte start
  codes, the ``hvcC``'s VPS, SPS, PPS and SEI before the first IRAP slice of
  a packet); and the rate equals OpenCV's;
* every luma plane equals FFmpeg's (``CAP_PROP_CONVERT_RGB`` 0), bar 0
  levels; for the fixtures of another VUI matrix or full range, whose luma
  OpenCV converts, FFmpeg's luma of a copy whose SPS names neither
  (`without_hevc_colour`: the same pictures);
* every RGB frame equals OpenCV's BGR flipped, bar 0 levels, in OpenCV's
  order and number (B pictures in POC order, the MP4's edit list trimming
  the last frame of libx265's 25 fps walks);
* every picture of a clip written with ``hash=1`` equals, all three planes,
  the MD5 of libx265's decoded picture hash SEI in its packet (parsed here):
  an oracle independent of FFmpeg that covers chroma;
* the digests in ``fixtures.json`` equal OpenCV's, and the port's own decode
  equals the digests recorded with it.

The decoder's `stats` show the fixtures reach every tool it counts.
``tests/test_torch_hevc_streams.py`` holds the refusals, the built streams,
the broken and fuzzed input.
"""
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.utils.video_io import HevcDecoder, VideoReader, demux
from tools.torch_make_video_fixtures import _unescape, hevc_annexb, hvcc, without_hevc_colour

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "hevc"
META = json.loads((FIXTURES / "fixtures.json").read_text())
NAMES = sorted(META["files"])
HASHED = sorted(n for n, e in META["files"].items()
                if any("hash=1" in o for o in e["options"]))


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
    """FFmpeg's luma planes of the file: of a copy without its VUI colour
    where it names one (OpenCV converts the luma of such a stream)."""
    if META["files"][path.name]["colour"]:
        plain = tmp_path / path.name
        plain.write_bytes(without_hevc_colour(path.read_bytes()))
        path = plain
    luma, _ = capture(path, [(cv2.CAP_PROP_CONVERT_RGB, 0)])
    return [y if y.ndim == 2 else y[..., 0] for y in luma]


@pytest.mark.parametrize("name", NAMES)
def test_packets_equal_ffmpeg(name):
    path = FIXTURES / name
    want, fps = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    stream = demux(str(path))
    got = list(stream.packets())
    assert stream.codec == "hevc"
    assert len(got) == len(want) == META["files"][name]["packets"]
    if stream.config:
        assert hvcc(stream.config)[0] == 4
        got = [hevc_annexb(g, stream.config) for g in got]
    assert all(g == w.tobytes() for g, w in zip(got, want))
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
    stream = demux(str(path))
    samples = list(stream.packets())
    if stream.config:
        assert [hevc_annexb(s, stream.config) for s in samples] == [p.tobytes() for p in packets]
    else:
        assert samples == [p.tobytes() for p in packets]
    assert [hashlib.sha256(s).hexdigest() for s in samples] == entry["opencv"]["packets"]
    assert [sha(y) for y in ffmpeg_luma(path, tmp_path)] == entry["opencv"]["luma"]
    assert [sha(f[..., ::-1]) for f in bgr] == entry["opencv"]["rgb"]
    dec = HevcDecoder(stream.config)
    luma, rgb, shown = hashlib.sha256(), hashlib.sha256(), 0
    for p in [*samples, None]:
        for k, (img, y) in dec.output(p, rgb=True, luma=True):
            if stream.shown[k]:
                luma.update(y.tobytes())
                rgb.update(img.tobytes())
                shown += 1
    assert shown == entry["frames"] == len(VideoReader(str(path)))
    assert luma.hexdigest() == entry["port"]["luma_all"]
    assert rgb.hexdigest() == entry["port"]["rgb_all"]
    assert dec.stats == entry["stats"] and dec.encoder == entry["encoder"]


def picture_md5s(stream, packet):
    """The MD5s (Y, U, V) of the decoded picture hash SEI (payload 132,
    hash_type 0) in a packet's suffix SEI, parsed here."""
    if stream.config:
        size, nals, pos = hvcc(stream.config)[0], [], 0
        while pos < len(packet):
            n = int.from_bytes(packet[pos:pos + size], "big")
            nals.append(packet[pos + size:pos + size + n])
            pos += size + n
    else:
        nals = packet.split(b"\0\0\1")[1:]
    for nal in nals:
        if (nal[0] >> 1) & 63 != 40:
            continue
        r, i = _unescape(nal[2:])[0], 0
        while i < len(r) and r[i] != 0x80:
            kind = size = 0
            while r[i] == 255:
                kind, i = kind + 255, i + 1
            kind, i = kind + r[i], i + 1
            while r[i] == 255:
                size, i = size + 255, i + 1
            size, i = size + r[i], i + 1
            if kind == 132:
                assert r[i] == 0                                  # hash_type: MD5
                return [r[i + 1 + 16 * c:i + 17 + 16 * c] for c in range(3)]
            i += size
    return None


@pytest.mark.parametrize("name", HASHED)
def test_every_picture_equals_the_encoders_md5(name):
    """libx265's MD5 of each reconstructed picture (decode order, in its
    packet) against the port's planes of that picture, output in POC order:
    every picture, not only those the edit list shows."""
    stream = demux(str(FIXTURES / name))
    dec = HevcDecoder(stream.config)
    checked = 0
    for p in [*stream.packets(), None]:
        for _ in range(dec.decode(p) if p is not None else dec.flush()):
            k = dec.next()
            want = picture_md5s(stream, stream.packet(k))
            assert [hashlib.md5(x.tobytes()).digest() for x in dec.planes()] == want
            checked += 1
    assert checked == META["files"][name]["packets"]


def test_fixtures_cover_the_decoder():
    stats = {n: e["stats"] for n, e in META["files"].items()}
    for k in HevcDecoder.STATS:
        if k not in ("rasl_skipped", "list_modifications", "not_output_pictures"):
            assert sum(s[k] for s in stats.values()) > 0, k
    # libx265 never writes list modification or pic_output_flag; a stream
    # starting at a CRA skips its RASL pictures, and pictures of
    # pic_output_flag 0 are held in tests/test_torch_hevc_streams.py
    for k in ("list_modifications", "not_output_pictures"):
        assert sum(s[k] for s in stats.values()) == 0, k
    assert all(e["encoder"].startswith("x265 (build 199)") for e in META["files"].values())
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 3 << 19
    for name in ("main_640x480.mp4", "main_640x480.mov", "main_640x480.avi"):
        entry = META["files"][name]
        assert entry["packets"] == 24 and entry["frames"] == (24 if name.endswith("avi") else 23)
        assert entry["width"] == 640 and entry["options"][0] == "encoder=libx265"
    main = stats["main_640x480.mp4"]
    for k in ("b_pictures", "wpp_pictures", "qp_delta_cus", "sign_hidden", "temporal_candidates",
              "sao_edge", "explicit_weighted_pus", "bipred_pus", "reordered_frames",
              "strong_smoothing"):
        assert main[k] > 0, k
    assert stats["main_640x480.mp4"]["wpp_pictures"] == 24
    assert stats["no_wpp_176x144.mp4"]["wpp_pictures"] == 0
    assert stats["ultrafast_176x144.mp4"]["sao_edge"] + stats["ultrafast_176x144.mp4"]["sao_band"] == 0
    assert stats["ultrafast_176x144.mp4"]["sign_hidden"] == 0
    assert stats["veryslow_176x144.mp4"]["amp_pus"] > 0
    for name in ("open_gop_176x144.mp4", "open_gop_176x144.avi"):
        assert stats[name]["cra_pictures"] >= 2 and stats[name]["rasl_pictures"] > 0
    assert stats["radl_176x144.mp4"]["radl_pictures"] > 0
    assert stats["radl_176x144.mp4"]["idr_pictures"] >= 2
    assert stats["slices4_176x144.mp4"]["multi_slice_pictures"] == 12
    assert stats["crop_202x138.mp4"]["cropped_pictures"] == 8
    assert stats["noise_qp4_96x64.mp4"]["long_levels"] > 0
    assert stats["chroma_qp_offsets_176x144.mp4"]["chroma_qp_offset_slices"] == 12
    for name in ("deblock_m2p3_176x144.mp4", "deblock_p3m2_176x144.mp4"):
        assert stats[name]["deblock_offset_slices"] == 12
    off = stats["no_deblock_no_sao_176x144.mp4"]
    assert off["deblock_off_slices"] == 12 and off["sao_band"] + off["sao_edge"] == 0
    assert stats["weightb_fade_176x144.mp4"]["explicit_weighted_pus"] > 0
    assert stats["weightb_fade_176x144.mp4"]["b_pictures"] > 0
    for name in ("scaling_default_176x144.mp4", "scaling_custom_176x144.mp4"):
        assert stats[name]["scaling_list_pictures"] == 12
    assert stats["tskip_stripes_176x144.mp4"]["transform_skip_blocks"] > 0
    assert stats["constrained_intra_176x144.mp4"]["constrained_intra_pictures"] == 12
    assert stats["lossless_96x64.mp4"]["bypass_cus"] > 0
    assert META["files"]["main_1280x720.mp4"]["frames"] == 23
