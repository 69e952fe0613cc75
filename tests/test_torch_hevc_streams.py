"""The port's HEVC decoder on streams other than the committed clips as they
are (CPU, no card): `tests/test_torch_hevc.py` holds the clips themselves.

* An MP4's length-prefixed samples with its ``hvcC`` and FFmpeg's Annex B
  form of them without it decode alike, frame for frame.
* The AVI fourccs FFmpeg reads as HEVC (``HEVC``, ``H265``, ``HVC1``,
  ``HEV1``, any case) decode as the committed AVI; ``X265``, which OpenCV
  does not read, is refused.
* A stream cut at a CRA picture (the open-GOP clip from its second IRAP
  picture, the parameter sets put before it, written by the port's
  `AviWriter`): its RASL pictures are skipped and the rest equal OpenCV's.
* libx265's default clip with pic_output_flag written into its slice
  headers, every third picture hidden: the others output as before.
* libx265's refused streams (Main 10, 4:2:2, 4:4:4, field coding) raise
  `NotImplementedError` naming the tool, and so do parameter sets and slice
  headers built here bit by bit (`Writer`) for the tools libx265 does not
  write: tiles, PCM, long-term references in the SPS or a slice, a
  nuh_layer_id above 0, a VPS of two layers, the range extensions,
  dependent slice segments, a stream that starts with a trailing picture.
* A broken ``hvcC``, VPS, SPS or PPS, a slice of a missing PPS and a
  truncated access unit raise `ValueError`; fuzzed and cut packets raise or
  decode and never take the process down (a subprocess).
"""
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.utils.video_io import AviWriter, HevcDecoder, VideoReader, demux
from tools.torch_make_video_fixtures import _unescape

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "dro_sfm_torch" / "testdata" / "hevc"
META = json.loads((FIXTURES / "fixtures.json").read_text())
REFUSALS = sorted(META["refusals"])


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
    cap.release()
    return out


@pytest.mark.parametrize("name", ["main_640x480.mp4", "open_gop_176x144.mp4",
                                  "slices4_176x144.mp4", "crop_202x138.mp4"])
def test_length_prefixed_and_annexb_decode_alike(name):
    path = FIXTURES / name
    stream = demux(str(path))
    packets = capture(path, [(cv2.CAP_PROP_FORMAT, -1)])
    a, b = HevcDecoder(stream.config), HevcDecoder()
    for sample, annexb in [*zip(stream.packets(), (p.tobytes() for p in packets)),
                           (None, None)]:
        ready = a.decode(sample) if sample is not None else a.flush()
        assert ready == (b.decode(annexb) if annexb is not None else b.flush())
        for _ in range(ready):
            assert a.next() == b.next()
            assert np.array_equal(a.frame(), b.frame())
            assert all(np.array_equal(x, y) for x, y in zip(a.planes(), b.planes()))
    with pytest.raises(ValueError):
        HevcDecoder().decode(stream.packet(0))


@pytest.mark.parametrize("name", REFUSALS)
def test_refused_encoder_streams(name):
    path = FIXTURES / name
    entry = META["refusals"][name]
    assert len(capture(path)) == entry["opencv_frames"] == 6           # FFmpeg reads them
    with pytest.raises(NotImplementedError, match=entry["raises"]):
        list(VideoReader(str(path)))


@pytest.mark.parametrize("fourcc", [b"HEVC", b"H265", b"HVC1", b"HEV1", b"hevc", b"h265"])
def test_avi_fourccs_of_hevc(tmp_path, fourcc):
    data = (FIXTURES / "main_640x480.avi").read_bytes()
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data.replace(b"HEVC", fourcc))
    stream = demux(str(edited))
    assert stream.codec == "hevc" and len(stream) == 24
    assert len(capture(edited)) == 24
    assert np.array_equal(next(iter(VideoReader(str(edited)))),
                          next(iter(VideoReader(str(FIXTURES / "main_640x480.avi")))))


def test_x265_fourcc_is_refused(tmp_path):
    data = (FIXTURES / "main_640x480.avi").read_bytes()
    edited = tmp_path / "clip.avi"
    edited.write_bytes(data.replace(b"HEVC", b"X265"))
    assert capture(edited) == []
    with pytest.raises(NotImplementedError, match="H.265"):
        demux(str(edited))


def annexb_nals(packet: bytes):
    return [nal.rstrip(b"\0") for nal in packet.split(b"\0\0\1")[1:]]


def test_a_stream_from_a_cra_picture_skips_its_rasl_pictures(tmp_path):
    src = demux(str(FIXTURES / "open_gop_176x144.avi"))
    packets = list(src.packets())
    kinds = [[(n[0] >> 1) & 63 for n in annexb_nals(p)] for p in packets]
    cra = [i for i, k in enumerate(kinds) if 21 in k][1]
    sets = b"".join(b"\0\0\0\1" + n for n in annexb_nals(packets[0])
                    if (n[0] >> 1) & 63 in (32, 33, 34))
    path = tmp_path / "cra.avi"
    with AviWriter(str(path), 30, fourcc=b"H265") as out:
        for i, p in enumerate(packets[cra:]):
            out.write_packet((sets + p) if i == 0 else p, i == 0, (144, 176))
    want = capture(path)
    reader = VideoReader(str(path))
    got = list(reader)
    assert 0 < len(got) == len(want) < len(packets) - cra
    assert all(np.array_equal(g, w[..., ::-1]) for g, w in zip(got, want))
    dec = HevcDecoder()
    for p in [*demux(str(path)).packets(), None]:
        for _ in dec.output(p):
            pass
    assert dec.stats["rasl_skipped"] == len(packets) - cra - len(got) > 0


def escape(rbsp: bytes) -> bytes:
    """A NAL unit's payload from its RBSP: emulation prevention added."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def with_output_flags(packets, shown):
    """The access units with ``output_flag_present_flag`` and 7
    ``num_extra_slice_header_bits`` set in every PPS, and in every slice
    header after ``slice_pic_parameter_set_id`` the 7 reserved bits and
    ``pic_output_flag`` (``shown[k]`` for packet k): 8 bits, so the header
    grows by a byte and the slice data (entry points, alignment) stays as it
    was. Each picture must be one slice."""
    out = []
    for k, packet in enumerate(packets):
        au = b""
        for unit in annexb_nals(packet):
            kind = (unit[0] >> 1) & 63
            if kind == 34 or kind < 32:
                bits = "".join(f"{b:08b}" for b in _unescape(unit[2:])[0])
                pos = 0
                if kind < 32:
                    assert bits[0] == "1"                      # first_slice_segment_in_pic
                    pos = 2 if 16 <= kind <= 23 else 1          # no_output_of_prior_pics
                def skip_ue(pos):
                    return pos + 2 * (bits.index("1", pos) - pos) + 1

                pos = skip_ue(pos)                              # the PPS id
                if kind == 34:                                  # the SPS id, dependent slices
                    pos = skip_ue(pos) + 1
                    assert bits[pos:pos + 4] == "0000"
                    bits = bits[:pos] + "1111" + bits[pos + 4:]
                else:                                           # slice_type after the 7
                    bits = bits[:pos] + "1010101" + bits[pos:]
                    pos = skip_ue(pos + 7)
                    bits = bits[:pos] + str(int(shown[k])) + bits[pos:]
                rbsp = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
                unit = unit[:2] + escape(rbsp)
            au += b"\0\0\0\1" + unit
        out.append(au)
    return out


def test_pictures_of_pic_output_flag_0_are_decoded_and_not_output(tmp_path):
    """libx265 never sets output_flag_present_flag: its default clip with
    the flag written into every slice header, every third picture in
    decode order hidden. The hidden pictures are still references: the
    frames that stay equal the clip's own and OpenCV's of the edited file."""
    src = demux(str(FIXTURES / "main_640x480.avi"))
    packets = list(src.packets())
    shown = [k % 3 != 1 for k in range(len(packets))]
    path = tmp_path / "hidden.avi"
    with AviWriter(str(path), 25, fourcc=b"HEVC") as out:
        for k, p in enumerate(with_output_flags(packets, shown)):
            out.write_packet(p, k == 0, (480, 640))
    want = capture(path)
    dec = HevcDecoder()
    got = {}
    for p in [*demux(str(path)).packets(), None]:
        for k, (img, _) in dec.output(p, rgb=True, luma=True):
            got[k] = img
    assert sorted(got) == [k for k in range(len(packets)) if shown[k]]
    assert dec.stats["not_output_pictures"] == shown.count(False) == 8
    assert len(want) == len(got)
    full = HevcDecoder()
    whole = {k: img for p in [*packets, None] for k, (img, _) in full.output(p, rgb=True,
                                                                              luma=True)}
    order = sorted(got, key=list(whole).index)                  # output (POC) order
    for k, w in zip(order, want):
        assert np.array_equal(got[k], w[..., ::-1]) and np.array_equal(got[k], whole[k])


# ---------------------------------------------------------------- streams built bit by bit

class Writer:
    """An RBSP written field by field."""

    def __init__(self):
        self.bits = []

    def u(self, n, v=0):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, v=0):
        v += 1
        return self.u(v.bit_length() - 1).u(v.bit_length(), v)

    def se(self, v=0):
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        bits = self.bits + [1]
        bits += [0] * (-len(bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def nal(kind: int, w: Writer, layer: int = 0) -> bytes:
    """An Annex B NAL unit of type ``kind`` (emulation prevention added)."""
    return b"\0\0\0\1" + bytes([kind << 1 | layer >> 5, (layer & 31) << 3 | 1]) + escape(w.rbsp())


def ptl(w: Writer):
    """profile_tier_level of Main, level 3, no sub-layers."""
    w.u(2).u(1).u(5, 1).u(32, 0x60000000).u(4, 0b1001).u(43).u(1).u(8, 90)


def vps(layers=1, reserved=0xFFFF):
    w = Writer().u(4).u(1, 1).u(1, 1).u(6, layers - 1).u(3).u(1, 1).u(16, reserved)
    ptl(w)
    w.u(1, 1).ue(0).ue(0).ue(0).u(6).ue(0).u(1).u(1)
    return nal(32, w)


def sps(pcm=False, lt_sps=0, lt_present=False, range_ext=False):
    """64x64 of 16x16 CTBs and 8x8 CUs, no SAO, no AMP, no VUI."""
    w = Writer().u(4).u(3).u(1, 1)
    ptl(w)
    w.ue(0).ue(1).ue(64).ue(64).u(1).ue(0).ue(0).ue(4).u(1, 1).ue(0).ue(0).ue(0)
    w.ue(0).ue(1).ue(0).ue(2).ue(0).ue(0).u(1).u(1).u(1).u(1, pcm)
    if pcm:
        w.u(4, 7).u(4, 7).ue(0).ue(0).u(1)
    w.ue(0).u(1, lt_present or lt_sps > 0)
    if lt_present or lt_sps:
        w.ue(lt_sps)
        for _ in range(lt_sps):
            w.u(8, 4).u(1, 1)
    w.u(1).u(1).u(1).u(1, range_ext)
    if range_ext:
        w.u(1, 1).u(1).u(1).u(1).u(4).u(9)
    return nal(33, w)


def pps(tiles=False, dependent=False):
    w = Writer().ue(0).ue(0).u(1, dependent).u(1).u(3).u(1).u(1).ue(0).ue(0).se(0)
    w.u(1).u(1).u(1).se(0).se(0).u(1).u(1).u(1).u(1).u(1, tiles)
    if tiles:
        w.ue(1).ue(0).u(1, 1).u(1, 1)
    w.u(1).u(1).u(1).u(1).u(1).ue(0).u(1).u(1)
    return nal(34, w)


def slice_header(kind=19, first=True, lt_pics=0, dependent=False):
    """The header of an I slice (its data left out): an IDR or, for another
    kind, a POC and an empty short-term RPS, with ``lt_pics`` long-term
    pictures."""
    w = Writer().u(1, first)
    if 16 <= kind <= 23:
        w.u(1)
    w.ue(0)
    if not first:
        w.u(1, dependent).u(4, 1)
    if not dependent:
        w.ue(2)
        if kind not in (19, 20):
            w.u(8, 4).u(1).ue(0).ue(0)
            if lt_pics >= 0:
                w.ue(lt_pics)
        w.se(0)
    return nal(kind, w)


BUILT = {
    "tiles": ([vps(), sps(), pps(tiles=True)], "tiles"),
    "pcm": ([vps(), sps(pcm=True)], "PCM"),
    "long_term_sps": ([vps(), sps(lt_sps=1)], "long-term"),
    "long_term_slice": ([vps(), sps(lt_present=True), pps(), slice_header(21, lt_pics=1)],
                        "long-term"),
    "layer_1": ([vps(), sps(), pps(), nal(33, Writer().u(8), layer=1)], "nuh_layer_id 1"),
    "two_layers": ([vps(layers=2)], "several layers"),
    "range_extensions": ([vps(), sps(range_ext=True)], "range extensions"),
    "dependent_slice": ([vps(), sps(), pps(dependent=True),
                         slice_header(first=False, dependent=True)], "dependent slice"),
    "trailing_first": ([vps(), sps(), pps(), slice_header(1, lt_pics=-1)], "IRAP"),
}


@pytest.mark.parametrize("case", sorted(BUILT))
def test_built_streams_of_other_tools_are_refused(case):
    nals, what = BUILT[case]
    with pytest.raises(NotImplementedError, match=what):
        HevcDecoder().decode(b"".join(nals))


@pytest.mark.parametrize("edit,what", [
    (lambda c: b"\x00" + c[1:], "not version 1"),
    (lambda c: c[:20], "not version 1"),
    (lambda c: c[:21] + bytes([c[21] & 0xFC | 2]) + c[22:], "NAL length size of 3"),
    (lambda c: c[:40], "truncated hvcC"),
    (lambda c: c[:28] + bytes([c[28] | 0x80]) + c[29:], "forbidden_zero_bit"),
], ids=["version", "short", "length_size", "cut", "forbidden_bit"])
def test_broken_hvcc_raises_value_error(edit, what):
    config = demux(str(FIXTURES / "crop_202x138.mp4")).config
    with pytest.raises(ValueError, match=what):
        HevcDecoder(edit(config))


@pytest.mark.parametrize("case,what", [
    ("vps_reserved", "0xffff"), ("sps_cut", "truncated HEVC"), ("pps_cut", "truncated HEVC"),
    ("slice_of_missing_pps", "missing PPS"), ("pps_of_missing_sps", "missing SPS"),
    ("forbidden_bit", "forbidden_zero_bit"), ("no_start_code", "start code"),
    ("access_unit_cut", "truncated|CTBs|CABAC"),
])
def test_broken_parameter_sets_and_access_units_raise(case, what):
    s, p = sps(), pps()
    idr = demux(str(FIXTURES / "main_640x480.avi")).packet(0)
    packets = {
        "vps_reserved": [vps(reserved=0)],
        "sps_cut": [vps() + s[:len(s) // 2]],
        "pps_cut": [vps() + s + p[:8]],
        "slice_of_missing_pps": [vps() + s + slice_header()],
        "pps_of_missing_sps": [vps() + p + slice_header()],
        "forbidden_bit": [s[:4] + bytes([s[4] | 0x80]) + s[5:]],
        "no_start_code": [b"\x40\x01\x0c"],
        "access_unit_cut": [idr[:len(idr) * 2 // 3]],
    }[case]
    dec = HevcDecoder()
    with pytest.raises(ValueError, match=what):
        for packet in packets:
            dec.decode(packet)


FUZZ = r"""
import json, sys
import numpy as np
from dro_sfm_torch.utils.video_io import HevcDecoder, demux
names, cases, seed = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
streams = [demux(n) for n in names]
packets = [(s.config, list(s.packets())) for s in streams]
rng = np.random.default_rng(seed)
out = {"ok": 0, "ValueError": 0, "NotImplementedError": 0, "truncated": 0}


def run(config, seq):
    try:
        dec = HevcDecoder(config)
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
    """Intra, P and B pictures, wavefronts and slices, lossless, transform
    skip and scaling lists among them."""
    names = ["noise_qp4_96x64.mp4", "lossless_96x64.mp4", "slices4_176x144.mp4",
             "tskip_stripes_176x144.mp4", "scaling_custom_176x144.mp4", "open_gop_176x144.avi"]
    res = subprocess.run([sys.executable, "-c", FUZZ, ",".join(str(FIXTURES / n) for n in names),
                          "300", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] + out["ValueError"] + out["NotImplementedError"] == 300 + out["truncated"]
    assert out["ValueError"] > 0
    assert out["truncated"] == 3 * sum(META["files"][n]["packets"] for n in names)
