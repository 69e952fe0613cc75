"""Video and animation files without OpenCV, FFmpeg or Pillow: MPEG-4 Part 2
(``mp4v``) video written to MP4, MOV and AVI and read from them, H.264
Constrained Baseline, Main and High video read from them, MJPEG AVI written
and read, and GIF89a written.

The card's machine has no video codec the port may use, so it writes and
reads these files itself, on the host:

* `VideoWriter`: what ``cv2.VideoWriter(path, VideoWriter_fourcc(*"mp4v"),
  fps, (w, h))`` writes, the container told by the extension as OpenCV
  tells it (``.mp4``, ``.m4v`` and ``.mov`` an ISO BMFF file, ``.avi`` an
  AVI), the frames cropped to even sides as OpenCV crops them. The video is
  MPEG-4 Part 2 Simple Profile from `Mpeg4Encoder` (``csrc/mpeg4_encode.cpp``,
  built by `dro_sfm_torch.hostlib`): an I-VOP every 12 frames and P-VOPs
  between them at a fixed QP, each VOP rebuilt as the decoder rebuilds it.
  `Mp4Writer` muxes ``ftyp``, ``mdat`` and a ``moov`` of one video track
  whose ``mp4v`` sample entry's ``esds`` holds the VOL (object type 0x20),
  with ``stts``, ``stss``, ``stsc``, ``stsz`` and ``stco`` (``co64`` past 4
  GiB) and no edit list; in an AVI each I-VOP carries the VOS, VO and VOL
  headers before it, as FFmpeg writes them without a global header.
* `AviWriter`: an AVI 1.0 file (RIFF ``AVI ``) of one ``vids`` stream:
  ``avih``, ``strh``, ``strf`` (a BITMAPINFOHEADER), one ``00dc`` chunk a
  frame in the ``movi`` list and an ``idx1`` index (keyframe flags on the
  JPEG frames and the I-VOPs). Its frames are baseline JPEGs from the host
  codec (`image_io.encode_jpeg`, the bytes of ``cv2.imencode``), or
  MPEG-4 packets (fourcc ``mp4v``) given by `VideoWriter`. A frame that would
  take the RIFF past 1 GiB (AVI 1.0's limit) raises before it is written.
  Every writer writes its file beside its path and moves it into place at
  `close`; a writer left by an exception removes its file, so that no broken
  file is left.
* `read_avi_mjpeg`: the frames (uint8 RGB) and rate of an MJPEG AVI.
* `VideoReader`: the frames of a video file as
  ``cv2.VideoCapture`` reads them (uint8 RGB, in output order), as FFmpeg
  demuxes and decodes them. `demux` tells the container by its first bytes:
  `demux_mp4` reads an ISO BMFF file's first video track (its ``mp4v``
  sample entry's ``esds`` VOL or its ``avc1``/``avc3`` sample entry's
  ``avcC``, its samples from ``stsz``, ``stsc``, ``stco``/``co64``,
  ``stts``, and ``ctts`` and the edit list for the frames it shows),
  `demux_avi` the ``##dc``/``##db`` chunks of
  an AVI's first video stream across its RIFF ``AVI `` and ``AVIX``
  segments; each packet equals FFmpeg's byte for byte (an MP4's H.264
  samples NAL unit by NAL unit: FFmpeg gives them in Annex B form).
  `Mpeg4Decoder` decodes MPEG-4 Part 2 Simple Profile
  video in the host library ``csrc/mpeg4_video.cpp``, bit-equal to FFmpeg's
  luma and to OpenCV's RGB on the streams FFmpeg's ``mpeg4`` encoder and
  `Mpeg4Encoder` write; `H264Decoder` decodes H.264 Constrained Baseline,
  Main and High, 8-bit 4:2:0 progressive (CAVLC and CABAC I, P and B
  slices, the 8x8 transform, weighted prediction, scaling lists, output
  reordered in POC order) in ``csrc/h264_video.cpp``, bit-equal to FFmpeg's
  luma and to OpenCV's RGB on libx264's streams (both
  libraries built by `dro_sfm_torch.hostlib`); MJPEG AVI frames go through
  the JPEG decoder (libjpeg's upsampling, not FFmpeg's). Other codecs and
  containers, and tools beyond those profiles, raise `NotImplementedError`
  naming them; a broken file raises `ValueError`, and no frame is ever
  skipped.
* `write_gif`: GIF89a with a NETSCAPE loop extension and, before each frame,
  a graphic control extension holding its duration (in hundredths of a
  second, ``int(ms / 10)`` as Pillow writes it). Each frame's palette
  comes from `median_cut` (no dither), which keeps the colours of a frame
  of at most 256 exactly. The LZW codes are packed by ``gif_lzw`` of the host codec.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dro_sfm_torch.utils import image_io

AVI_LIMIT = 1 << 30            # AVI 1.0: a RIFF of at most 1 GiB
GOP = 12                       # an I-VOP every GOP frames, as FFmpeg's under cv2.VideoWriter
QP = 3                         # the fixed quantiser: FFmpeg's floor, where OpenCV's writer runs
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) % 2 else b"")


def _rate(fps: float) -> Tuple[int, int]:
    """(scale, rate) of the stream header: ``rate / scale`` frames a second."""
    if fps <= 0:
        raise ValueError(f"a video of {fps} frames a second")
    if float(fps).is_integer():
        return 1, int(fps)
    return 1000, int(round(fps * 1000))


def timebase(fps: float) -> Tuple[int, int]:
    """(resolution, increment) of an MPEG-4 stream at ``fps`` frames a
    second: the VOL's vop_time_increment_resolution and the ticks a frame,
    ``fps = resolution / increment`` (an MP4's timescale and sample delta)."""
    scale, rate = _rate(fps)
    g = math.gcd(scale, rate)
    if rate // g > 65535:
        raise ValueError(f"{fps} frames a second: an MPEG-4 time base of {rate // g}/"
                         f"{scale // g} (the resolution is 16 bits)")
    return rate // g, scale // g


class AviWriter:
    """Write a video stream of frames of one size to an AVI at ``path``:
    uint8 RGB frames [H,W,3] as MJPEG through `write` (``quality`` is the
    JPEG quality), or, with ``fourcc`` ``b"mp4v"``, the packets that
    `VideoWriter` gives `write_packet`. ``encode_ms`` holds each frame's
    encode milliseconds (host clock) and `bytes_written` the file's size so
    far."""

    def __init__(self, path: str, fps: float, quality: int = 95, fourcc: bytes = b"MJPG"):
        self.path, self.fps, self.quality = str(path), float(fps), int(quality)
        self.fourcc = fourcc
        self.scale, self.rate = _rate(self.fps)
        self.tmp = self.path + ".tmp"
        self.file = open(self.tmp, "wb")
        self.size = None                     # (height, width) of the first frame
        self.index: List[Tuple[int, int, bool]] = []   # (offset from "movi", length, key)
        self.movi_bytes = 4                  # the "movi" fourcc
        self.max_frame = 0
        self.encode_ms: List[float] = []
        header = self._headers(0, 0, 0)
        self.header_bytes = len(header)
        self.file.write(header)

    def _headers(self, h: int, w: int, frames: int) -> bytes:
        usec = int(round(1e6 / self.fps))
        avih = struct.pack("<14I", usec, 0, 0, _AVIF_HASINDEX, frames, 0, 1, self.max_frame,
                           w, h, 0, 0, 0, 0)
        strh = (b"vids" + self.fourcc
                + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, self.scale, self.rate, 0, frames,
                              self.max_frame, -1, 0)
                + struct.pack("<4h", 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, self.fourcc, w * h * 3, 0, 0, 0, 0)
        strl = b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf)) + b"strl" \
            + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl = b"hdrl" + _chunk(b"avih", avih) + strl
        riff_size = 4 + 8 + len(hdrl) + 8 + self.movi_bytes + 8 + 16 * frames
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI "
                + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
                + b"LIST" + struct.pack("<I", self.movi_bytes) + b"movi")

    @property
    def bytes_written(self) -> int:
        return self.header_bytes - 4 + self.movi_bytes + 8 + 16 * len(self.index)

    def write(self, frame: np.ndarray) -> None:
        if self.fourcc != b"MJPG":
            raise ValueError(f"{self.path}: frames of a {self.fourcc.decode()} AVI come from "
                             f"VideoWriter")
        frame = _check_frame(frame, "AviWriter")
        t0 = time.perf_counter()
        data = image_io.encode_jpeg(frame, self.quality)
        self.encode_ms.append(1e3 * (time.perf_counter() - t0))
        self.write_packet(data, True, frame.shape[:2])

    def write_packet(self, data: bytes, key: bool, size: Tuple[int, int]) -> None:
        """One frame's packet, a keyframe or not, of a frame of ``size``."""
        if self.size is None:
            self.size = tuple(size)
        elif tuple(size) != self.size:
            raise ValueError(f"frame of size {tuple(size)} in a video of {self.size}")
        chunk = _chunk(b"00dc", data)
        # the RIFF after this frame, its index entry and the index header
        if self.bytes_written + len(chunk) + 16 - 8 > AVI_LIMIT:
            raise ValueError(f"{self.path}: frame {len(self.index)} would take the AVI past "
                             f"its 1 GiB limit (AVI 1.0); write a shorter or smaller video")
        self.file.write(chunk)
        self.index.append((self.movi_bytes, len(data), bool(key)))
        self.movi_bytes += len(chunk)
        self.max_frame = max(self.max_frame, len(data))

    def close(self) -> None:
        """Write the index and the final headers, and move the file into place."""
        if self.file is None:
            return
        if not self.index:
            self.abort()
            raise ValueError(f"{self.path}: a video without frames")
        self.file.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        self.file.write(b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME if key else 0,
                                             off, n) for off, n, key in self.index))
        self.file.seek(0)
        self.file.write(self._headers(*self.size, len(self.index)))
        self.file.close()
        self.file = None
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        """Close and remove the unfinished file."""
        if self.file is not None:
            self.file.close()
            self.file = None
            os.unlink(self.tmp)

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.close()
        else:
            self.abort()


def _check_frame(frame, who: str) -> np.ndarray:
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"{who} takes uint8 RGB [H,W,3], not {frame.dtype} {frame.shape}")
    return frame


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descriptor_bytes(tag: int, *parts: bytes) -> bytes:
    """An MPEG-4 descriptor with its size in 4 bytes, as FFmpeg writes it."""
    body = b"".join(parts)
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Writer:
    """Mux MPEG-4 Part 2 packets into an ISO BMFF file at ``path``: ``brand``
    ``b"isom"`` for MP4 and M4V, ``b"qt  "`` for QuickTime MOV. The samples
    go into ``mdat`` as they come (behind a ``wide`` box that makes room for
    a 64-bit ``mdat`` header); `close` writes the ``moov`` after it, with
    ``config`` (the encoder's VOL) in the ``esds``. ``bytes_written`` is the
    file's size so far."""

    def __init__(self, path: str, fps: float, brand: bytes = b"isom"):
        self.path, self.fps = str(path), float(fps)
        self.res, self.inc = timebase(self.fps)
        self.config = b""
        self.tmp = self.path + ".tmp"
        self.file = open(self.tmp, "wb")
        compat = b"qt  " if brand == b"qt  " else b"isomiso2mp41"
        ftyp = _box(b"ftyp", brand, struct.pack(">I", 0x200), compat)
        self.mdat = len(ftyp)
        self.file.write(ftyp + _box(b"wide") + struct.pack(">I4s", 0, b"mdat"))
        self.bytes_written = self.mdat + 16
        self.size = None
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.keys: List[int] = []

    def write_packet(self, data: bytes, key: bool, size: Tuple[int, int]) -> None:
        if self.size is None:
            self.size = tuple(size)
        elif tuple(size) != self.size:
            raise ValueError(f"frame of size {tuple(size)} in a video of {self.size}")
        if key:
            self.keys.append(len(self.sizes) + 1)
        self.offsets.append(self.bytes_written)
        self.sizes.append(len(data))
        self.file.write(data)
        self.bytes_written += len(data)

    def _moov(self) -> bytes:
        h, w = self.size
        n, big = len(self.sizes), self.offsets[-1] >= 1 << 32
        duration = n * self.inc                              # in the track's timescale
        movie = int(round(duration * 1000 / self.res))      # in the movie's (ms)
        largest = max(self.sizes)                            # bits a second, average and peak
        avg = min(int(sum(self.sizes) * 8 * self.res / duration), 0xFFFFFFFF)
        peak = max(min(int(largest * 8 * self.fps), 0xFFFFFFFF), avg)
        esds = _full_box(b"esds", 0, 0, _descriptor_bytes(
            3, struct.pack(">HB", 1, 0),
            _descriptor_bytes(4, struct.pack(">BB", 0x20, 0x11),     # MPEG-4 Visual, video
                              min(largest, 0xFFFFFF).to_bytes(3, "big"),
                              struct.pack(">II", peak, avg), _descriptor_bytes(5, self.config)),
            _descriptor_bytes(6, b"\x02")))
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1), bytes(32),
                    struct.pack(">Hh", 0x18, -1), esds)
        stbl = _box(b"stbl",
                    _full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v),
                    _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.inc)),
                    _full_box(b"stss", 0, 0, struct.pack(f">I{len(self.keys)}I", len(self.keys),
                                                         *self.keys)),
                    _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
                    _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes)),
                    _full_box(b"co64" if big else b"stco", 0, 0,
                              struct.pack(f">I{n}{'Q' if big else 'I'}", n, *self.offsets)))
        minf = _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
                    _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                            _full_box(b"url ", 0, 1))), stbl)
        mdia = _box(b"mdia",
                    _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.res, duration,
                                                         0x55C4, 0)),        # language "und"
                    _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                              b"VideoHandler\0"), minf)
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII8xhhhH", 0, 0, 1, 0, movie, 0, 0, 0,
                                                    0), _MATRIX, struct.pack(">II", w << 16,
                                                                             h << 16))
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH10x", 0, 0, 1000, movie, 0x10000,
                                                    0x100), _MATRIX, bytes(24),
                         struct.pack(">I", 2))
        return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))

    def close(self) -> None:
        """Finish ``mdat``, write ``moov`` and move the file into place."""
        if self.file is None:
            return
        if not self.sizes:
            self.abort()
            raise ValueError(f"{self.path}: a video without frames")
        payload = self.bytes_written - self.mdat - 16
        if payload + 8 < 1 << 32:                    # wide, then a 32-bit mdat header
            self.file.seek(self.mdat + 8)
            self.file.write(struct.pack(">I", payload + 8))
        else:                                        # a 64-bit mdat header over both
            self.file.seek(self.mdat)
            self.file.write(struct.pack(">I4sQ", 1, b"mdat", payload + 16))
        self.file.seek(0, os.SEEK_END)
        moov = self._moov()
        self.file.write(moov)
        self.bytes_written += len(moov)
        self.file.close()
        self.file = None
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        """Close and remove the unfinished file."""
        if self.file is not None:
            self.file.close()
            self.file = None
            os.unlink(self.tmp)


class VideoWriter:
    """Write uint8 RGB frames [H,W,3] of one size as ``mp4v`` video, as
    ``cv2.VideoWriter(path, VideoWriter_fourcc(*"mp4v"), fps, (W, H))``
    does: ``.mp4``, ``.m4v`` and ``.mov`` give ISO BMFF (`Mp4Writer`),
    ``.avi`` an AVI (`AviWriter`, fourcc ``mp4v``); an odd last row or
    column is dropped, as OpenCV drops it. `Mpeg4Encoder` codes an I-VOP
    every `GOP` frames at quantiser `QP`. ``encode_ms`` holds each frame's
    encode milliseconds (host clock), `bytes_written` the file's size so
    far, and `reconstruction` the last frame as a reader will decode it.
    The file is written beside ``path`` and moved into place by `close`; a
    writer left by an exception removes it."""

    CONTAINERS = {".mp4": b"isom", ".m4v": b"isom", ".mov": b"qt  ", ".avi": None}

    def __init__(self, path: str, fps: float):
        self.path, self.fps = str(path), float(fps)
        brand = self.container(self.path)
        self.mux = AviWriter(self.path, self.fps, fourcc=b"mp4v") if brand is None \
            else Mp4Writer(self.path, self.fps, brand)
        self.encoder = None
        self.size = None
        self.encode_ms: List[float] = []

    @classmethod
    def container(cls, path: str):
        """The ISO BMFF brand of ``path``'s extension, None for an AVI; an
        extension OpenCV's mp4v writer does not take raises ValueError."""
        ext = os.path.splitext(str(path))[1].lower()
        if ext not in cls.CONTAINERS:
            raise ValueError(f"{path}: mp4v video goes into {', '.join(cls.CONTAINERS)} files")
        return cls.CONTAINERS[ext]

    @property
    def bytes_written(self) -> int:
        return self.mux.bytes_written

    def write(self, frame: np.ndarray) -> None:
        frame = _check_frame(frame, "VideoWriter")
        if self.encoder is None:
            self.size = frame.shape[:2]
            self.encoder = Mpeg4Encoder(frame.shape[0] & ~1, frame.shape[1] & ~1, self.fps)
            self.mux.config = self.encoder.config
        elif frame.shape[:2] != self.size:
            raise ValueError(f"frame of size {frame.shape[:2]} in a video of {self.size}")
        h, w = self.encoder.shape
        t0 = time.perf_counter()
        packet, key = self.encoder.encode(frame[:h, :w])
        if key and isinstance(self.mux, AviWriter):      # no global header in an AVI
            packet = self.encoder.config + packet
        self.encode_ms.append(1e3 * (time.perf_counter() - t0))
        self.mux.write_packet(packet, key, (h, w))

    def reconstruction(self, planes: bool = False):
        """The last frame as `Mpeg4Decoder` and FFmpeg decode it: uint8 RGB
        [h,w,3], or with ``planes`` the planes (Y, U, V)."""
        return self.encoder.reconstruction(planes)

    def close(self) -> None:
        """Finish the container and move the file into place."""
        if self.encoder is None:
            self.mux.abort()
            raise ValueError(f"{self.path}: a video without frames")
        self.mux.close()
        self.encoder.close()

    def abort(self) -> None:
        self.mux.abort()
        if self.encoder is not None:
            self.encoder.close()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.close()
        else:
            self.abort()


def _riff_chunks(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        fourcc, size = struct.unpack_from("<4sI", data, pos)
        if pos + 8 + size > end:
            raise ValueError(f"truncated AVI chunk {fourcc!r}")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


# ------------------------------------------------------------ video input

# fourccs of MPEG-4 Part 2 and of H.264 video in AVI (strf's compression or
# strh's handler, upper-cased)
MPEG4_FOURCCS = (b"FMP4", b"MP4V", b"XVID", b"DIVX", b"DX50")
H264_FOURCCS = (b"H264", b"X264", b"AVC1")
_OTHER_CODECS = {b"HEV1": "H.265", b"HVC1": "H.265", b"HEVC": "H.265", b"DIV3": "MS MPEG-4 v3",
                 b"MP43": "MS MPEG-4 v3", b"MP42": "MS MPEG-4 v2", b"WMV1": "WMV",
                 b"WMV2": "WMV", b"WMV3": "WMV", b"AV01": "AV1", b"VP80": "VP8",
                 b"VP09": "VP9", b"S263": "H.263", b"H263": "H.263", b"MJPA": "Motion JPEG"}
# the first bytes of containers that the port does not read
_OTHER_CONTAINERS = ((b"FLV", "FLV"), (b"\x00\x00\x01\xba", "MPEG program stream"),
                     (b"\x00\x00\x01\xb3", "MPEG video elementary stream"),
                     (b"\x30\x26\xb2\x75\x8e\x66\xcf\x11", "ASF (WMV)"),
                     (b"\x1a\x45\xdf\xa3", "Matroska/WebM"), (b"OggS", "Ogg"))
_BMFF_TOP = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"uuid")


def _other_codec(fourcc: bytes, path: str):
    name = _OTHER_CODECS.get(fourcc.upper(), None)
    what = f"{name} ({fourcc.decode(errors='replace')!r})" if name else \
        f"the codec {fourcc.decode(errors='replace')!r}"
    return NotImplementedError(f"{path}: {what} video; the port decodes MPEG-4 Part 2 "
                               f"(mp4v), H.264 Constrained Baseline (avc1, avc3, H264) and "
                               f"MJPEG only (ROADMAP C)")


class Demuxed:
    """One video stream of a file: ``codec`` ("mpeg4", "h264" or "mjpeg"),
    the decoder configuration ``config`` (the VOL of an MP4's ``esds`` or
    the body of its ``avcC``, else empty), ``fps``, its packets in decode
    order as (offset, size) in the file, read by `packet`, and ``shown``:
    whether each packet's frame is output (an MP4's edit list trims the
    frames whose composition time it does not cover; every packet is still
    decoded, as a trimmed frame may be a reference), and ``tag``, the
    fourcc the container gives the codec (an AVI's biCompression, an MP4's
    sample entry), which FFmpeg's MPEG-4 decoder reads as a hint of the
    encoder."""

    def __init__(self, path, data, codec, config, spans, fps, shown=None, tag=b""):
        self.path, self.data, self.codec = path, data, codec
        self.config, self.spans, self.fps = config, spans, fps
        self.shown = [True] * len(spans) if shown is None else shown
        self.tag = bytes(tag)

    def __len__(self) -> int:
        return len(self.spans)

    def packet(self, i: int) -> bytes:
        off, n = self.spans[i]
        return self.data[off:off + n]

    def packets(self):
        return (self.packet(i) for i in range(len(self.spans)))


def _u32(data, pos):
    return struct.unpack_from(">I", data, pos)[0]


def _boxes(data, start: int, end: int, path: str):
    """(kind, body start, end) of the ISO BMFF boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError(f"{path}: truncated MP4 box {kind!r}")
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"{path}: truncated MP4 box {kind!r}")
        yield kind, pos + head, pos + size
        pos += size


def _child(data, start, end, kind, path):
    for k, s, e in _boxes(data, start, end, path):
        if k == kind:
            return s, e
    return None


def _need(data, start, end, kind, path):
    found = _child(data, start, end, kind, path)
    if found is None:
        raise ValueError(f"{path}: MP4 without a {kind.decode()} box")
    return found


def _descriptor(data, pos, end, path):
    """(tag, body start, body end) of the MPEG-4 descriptor at pos."""
    if pos + 2 > end:
        raise ValueError(f"{path}: truncated esds descriptor")
    tag, size, pos = data[pos], 0, pos + 1
    for _ in range(4):
        if pos >= end:
            raise ValueError(f"{path}: truncated esds descriptor")
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    if pos + size > end:
        raise ValueError(f"{path}: truncated esds descriptor")
    return tag, pos, pos + size


def _esds_config(data, start, end, path) -> bytes:
    """The DecoderSpecificInfo (the VOS, VO and VOL headers) of an esds."""
    tag, s, e = _descriptor(data, start + 4, end, path)
    if tag != 3:
        raise ValueError(f"{path}: esds without an ES descriptor")
    flags = data[s + 2]
    s += 3 + (2 if flags & 0x80 else 0)
    if flags & 0x40:
        s += 1 + data[s]
    s += 2 if flags & 0x20 else 0
    tag, s, e = _descriptor(data, s, e, path)
    if tag != 4:
        raise ValueError(f"{path}: esds without a decoder configuration")
    if data[s] != 0x20:
        raise NotImplementedError(f"{path}: an mp4v track of object type 0x{data[s]:02x} "
                                  f"(not MPEG-4 Visual); the port decodes MPEG-4 Part 2 "
                                  f"only (ROADMAP C)")
    s += 13
    while s < e:
        tag, ds, de = _descriptor(data, s, e, path)
        if tag == 5:
            return bytes(data[ds:de])
        s = de
    raise ValueError(f"{path}: esds without a decoder-specific configuration (VOL)")


def _full_box_table(data, s, e, fmt, path, what):
    """The entries of a full box holding a 32-bit count and records of
    struct ``fmt``."""
    n = _u32(data, s + 4)
    size = struct.calcsize(fmt)
    if s + 8 + n * size > e:
        raise ValueError(f"{path}: truncated {what} box")
    return [struct.unpack_from(fmt, data, s + 8 + i * size) for i in range(n)]


def demux_mp4(path: str, data) -> Demuxed:
    """The first video track of an ISO BMFF file (MP4, MOV, M4V): its
    ``mp4v`` sample entry's VOL or its ``avc1``/``avc3`` sample entry's
    ``avcC``, its samples from ``stsz``, ``stsc``, ``stco``/``co64`` and
    ``stts``, and the frames its edit list shows (`_edit_list`). A
    fragmented file raises."""
    moov = None
    for kind, s, e in _boxes(data, 0, len(data), path):
        if kind == b"moof":
            raise NotImplementedError(f"{path}: a fragmented MP4 (moof); the port reads "
                                      f"whole-file sample tables only (ROADMAP C)")
        if kind == b"moov":
            moov = (s, e)
    if moov is None:
        raise ValueError(f"{path}: an MP4 without a moov box")
    if _child(data, *moov, b"mvex", path) is not None:
        raise NotImplementedError(f"{path}: a fragmented MP4 (mvex); the port reads "
                                  f"whole-file sample tables only (ROADMAP C)")
    mvhd = _need(data, *moov, b"mvhd", path)
    movie_scale = _u32(data, mvhd[0] + (20 if data[mvhd[0]] == 1 else 12))
    for kind, ts, te in _boxes(data, *moov, path):
        if kind != b"trak":
            continue
        mdia = _need(data, ts, te, b"mdia", path)
        hdlr = _need(data, *mdia, b"hdlr", path)
        if data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        mdhd = _need(data, *mdia, b"mdhd", path)
        scale = _u32(data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))
        stbl = _need(data, *_need(data, *mdia, b"minf", path), b"stbl", path)
        ss, se = _need(data, *stbl, b"stsd", path)
        if _u32(data, ss + 4) != 1:
            raise NotImplementedError(f"{path}: a video track of {_u32(data, ss + 4)} "
                                      f"sample descriptions (ROADMAP C)")
        size, fourcc = struct.unpack_from(">I4s", data, ss + 8)
        if ss + 8 + size > se or size < 86:
            raise ValueError(f"{path}: truncated stsd box")
        if fourcc == b"mp4v":
            codec = "mpeg4"
            config = _esds_config(data, *_need(data, ss + 8 + 86, ss + 8 + size, b"esds", path),
                                  path)
        elif fourcc in (b"avc1", b"avc3"):
            codec = "h264"
            avcc = _need(data, ss + 8 + 86, ss + 8 + size, b"avcC", path)
            config = bytes(data[avcc[0]:avcc[1]])
        else:
            raise _other_codec(fourcc, path)
        s, e = _need(data, *stbl, b"stsz", path)
        fixed, count = struct.unpack_from(">II", data, s + 4)
        if count > len(data):
            raise ValueError(f"{path}: {count} samples in a file of {len(data)} bytes")
        if fixed:
            sizes = [fixed] * count
        else:
            if s + 12 + 4 * count > e:
                raise ValueError(f"{path}: truncated stsz box")
            sizes = list(struct.unpack_from(f">{count}I", data, s + 12))
        stsc = _full_box_table(data, *_need(data, *stbl, b"stsc", path), ">III", path, "stsc")
        co = _child(data, *stbl, b"stco", path)
        offsets = [o for (o,) in (_full_box_table(data, *co, ">I", path, "stco") if co else
                                  _full_box_table(data, *_need(data, *stbl, b"co64", path),
                                                  ">Q", path, "co64"))]
        stts = _full_box_table(data, *_need(data, *stbl, b"stts", path), ">II", path, "stts")
        spans = []
        for i, chunk in enumerate(offsets):
            per = None
            for first, n, _ in stsc:
                if first - 1 <= i:
                    per = n
            if per is None:
                raise ValueError(f"{path}: chunk {i + 1} before the first stsc entry")
            for _ in range(per):
                if len(spans) == count:
                    break
                spans.append((chunk, sizes[len(spans)]))
                chunk += spans[-1][1]
        if len(spans) != count or any(o + n > len(data) for o, n in spans):
            raise ValueError(f"{path}: its sample table points past the file or misses "
                             f"samples ({len(spans)} of {count})")
        times, t = [], 0
        for n, delta in stts:
            for _ in range(min(n, count - len(times))):
                times.append(t)
                t += delta
        if len(times) < count:
            raise ValueError(f"{path}: stts times {len(times)} of {count} samples")
        fps = scale * count / t if t else 0.0
        shown = _edit_list(data, ts, te, stbl, times, scale, movie_scale, path)
        return Demuxed(path, data, codec, config, spans[:len(shown)], fps, shown, fourcc)
    raise ValueError(f"{path}: an MP4 without a video track")


def _edit_list(data, ts, te, stbl, times, scale, movie_scale, path):
    """Whether each sample's frame is shown, as FFmpeg's mov demuxer applies
    the track's edit list: with one edit from media time m lasting d (empty
    edits only shift the timeline), a frame is output when its composition
    time (its ``stts`` time plus its ``ctts`` offset, version 0 or 1: signed)
    lies in [m, m + d). FFmpeg reads no sample after the first key frame
    whose composition time plus duration reaches m + d (the second such one
    when there is a ``ctts``: B pictures may follow), so the list ends
    there. Several edits, a rate other than 1, and an edit that starts past
    a later key frame (FFmpeg then skips the samples before it) raise
    `NotImplementedError`."""
    count = len(times)
    offsets = [0] * count
    ctts = _child(data, *stbl, b"ctts", path)
    if ctts is not None:
        k = 0
        for n, off in _full_box_table(data, *ctts, ">Ii", path, "ctts"):
            for _ in range(min(n, count - k)):
                offsets[k] = off
                k += 1
        if k < count:
            raise ValueError(f"{path}: ctts offsets for {k} of {count} samples")
    edts = _child(data, ts, te, b"edts", path)
    elst = _child(data, *edts, b"elst", path) if edts else None
    if elst is None:
        return [True] * count
    v1 = data[elst[0]] == 1
    edits = _full_box_table(data, *elst, ">QqHH" if v1 else ">IiHH", path, "elst")
    edits = [ed for ed in edits if ed[1] != -1]          # empty edits: a delay
    if len(edits) > 1 or any(ed[2:] != (1, 0) for ed in edits):
        raise NotImplementedError(
            f"{path}: an MP4 edit list {edits} that repeats the video or changes its rate; "
            f"the port applies one edit of rate 1 only (ROADMAP C)")
    if not edits:
        return [True] * count
    duration, start = edits[0][0], edits[0][1]
    end = start + (duration * scale + movie_scale // 2) // movie_scale if duration and \
        movie_scale else None
    cts = [t + o for t, o in zip(times, offsets)]
    stss = _child(data, *stbl, b"stss", path)
    keys = sorted({n - 1 for (n,) in _full_box_table(data, *stss, ">I", path, "stss")}) \
        if stss is not None else list(range(count))
    if any(k > 0 and times[k] <= start for k in keys):
        raise NotImplementedError(
            f"{path}: an MP4 edit list that starts past a later key frame (FFmpeg does not "
            f"read the samples before it); the port applies an edit that starts in the "
            f"first key frame's group only (ROADMAP C)")
    keep = count
    if end is not None:                  # a sample's duration; the last one's is the edit's
        durations = [b - a for a, b in zip(times, times[1:])] + [end - start]
        past = [k for k in keys if k < count and cts[k] + durations[k] >= end]
        wait = 1 if ctts is not None else 0
        if len(past) > wait:
            keep = past[wait] + 1
    return [start <= c and (end is None or c < end) for c in cts[:keep]]


def _movi_packets(data, start: int, end: int, ids):
    """(offset, size) of the non-empty chunks ``ids`` of a ``movi`` list, in
    file order, the ``rec `` lists inside it included."""
    for fourcc, pos, n in _riff_chunks(data, start, end):
        if fourcc in ids and n:
            yield pos, n
        elif fourcc == b"LIST" and data[pos:pos + 4] == b"rec ":
            yield from _movi_packets(data, pos + 4, pos + n, ids)


def demux_avi(path: str, data) -> Demuxed:
    """The first video stream of an AVI (RIFF ``AVI `` and the OpenDML
    ``AVIX`` segments after it): its packets are the ``##dc``/``##db``
    chunks of ``movi`` in file order (empty ones skipped), MPEG-4 Part 2
    (`MPEG4_FOURCCS`), H.264 in Annex B (`H264_FOURCCS`) or MJPEG."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    stream, codec, fps, spans, index, tag = None, None, None, [], 0, b""
    pos = 0
    while pos + 12 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if data[pos:pos + 4] != b"RIFF" or data[pos + 8:pos + 12] not in (b"AVI ", b"AVIX"):
            break
        end = min(len(data), pos + 8 + size)
        for fourcc, cpos, n in _riff_chunks(data, pos + 12, end):
            if fourcc != b"LIST":
                continue
            kind = data[cpos:cpos + 4]
            if kind == b"hdrl":
                for sub, spos, sn in _riff_chunks(data, cpos + 4, cpos + n):
                    if sub != b"LIST" or data[spos:spos + 4] != b"strl":
                        continue
                    if stream is None:
                        strh = strf = None
                        for s2, p2, n2 in _riff_chunks(data, spos + 4, spos + sn):
                            if s2 == b"strh" and n2 >= 32:
                                strh = p2
                            elif s2 == b"strf" and n2 >= 20:
                                strf = p2
                        if strh is not None and data[strh:strh + 4] == b"vids":
                            handler = bytes(data[strh + 4:strh + 8])
                            comp = bytes(data[strf + 16:strf + 20]) if strf else handler
                            tags = (comp.upper(), handler.upper())
                            if any(t in MPEG4_FOURCCS for t in tags):
                                codec = "mpeg4"
                            elif any(t in H264_FOURCCS for t in tags):
                                codec = "h264"
                            elif b"MJPG" in tags:
                                codec = "mjpeg"
                            else:
                                raise _other_codec(comp if comp.strip(b"\0 ") else handler,
                                                   path)
                            scale, rate = struct.unpack_from("<2I", data, strh + 20)
                            fps = rate / scale if scale else 0.0
                            stream, tag = index, comp
                    index += 1
            elif kind == b"movi" and stream is not None:
                ids = (b"%02ddc" % stream, b"%02ddb" % stream)
                spans.extend(_movi_packets(data, cpos + 4, cpos + n, ids))
        pos = pos + 8 + size + (size & 1)
    if stream is None:
        raise ValueError(f"{path}: an AVI without a video stream header")
    return Demuxed(path, data, codec, b"", spans, fps, tag=tag)


def demux(path: str) -> Demuxed:
    """The video stream of the file at ``path``, its container told by its
    first bytes (as FFmpeg probes it): AVI, or ISO BMFF (MP4, MOV, M4V).
    Other containers raise `NotImplementedError`, a file that is none of
    them `ValueError`."""
    import mmap
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: an empty file")
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    head = data[:12]
    read = demux_avi if head[:4] == b"RIFF" and head[8:12] == b"AVI " else \
        demux_mp4 if head[4:8] in _BMFF_TOP else None
    if read is not None:
        try:
            return read(path, data)
        except (struct.error, IndexError) as e:        # a field past its box or chunk
            raise ValueError(f"{path}: a broken {read.__name__[6:].upper()} file ({e})") from e
    for magic, name in _OTHER_CONTAINERS:
        if head.startswith(magic):
            raise NotImplementedError(f"{path}: a {name} file; the port reads MP4/MOV and "
                                      f"AVI only (ROADMAP C)")
    raise ValueError(f"{path}: not a video file the port knows (AVI, MP4, MOV)")


@functools.lru_cache(maxsize=None)
def _decoder_lib(name: str, prefix: str) -> ctypes.CDLL:
    """The host video decoder ``name`` (`hostlib.SOURCES`), built at first
    use, its entry points ``<prefix>_*`` typed."""
    from dro_sfm_torch import hostlib
    lib = ctypes.CDLL(str(hostlib.build(name)))
    handle, size, err = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    i32p = ctypes.POINTER(ctypes.c_int)
    fn = {k: getattr(lib, f"{prefix}_{k}") for k in ("new", "free", "decode", "flush", "next",
                                                    "info", "frame", "stats", "planes")}
    fn["new"].argtypes, fn["new"].restype = [], handle
    fn["free"].argtypes, fn["free"].restype = [handle], None
    fn["decode"].argtypes = [handle, ctypes.c_char_p, size, err, size]
    fn["flush"].argtypes = [handle, err, size]
    fn["next"].argtypes = [handle, ctypes.POINTER(ctypes.c_int64)]
    fn["info"].argtypes = [handle, i32p, i32p, err, size]
    fn["frame"].argtypes = [handle, ctypes.c_void_p, ctypes.c_void_p, err, size]
    fn["stats"].argtypes = [handle, ctypes.c_void_p, ctypes.c_int]
    fn["planes"].argtypes = [handle, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, err, size]
    for k in ("decode", "flush", "next", "info", "frame", "stats", "planes"):
        fn[k].restype = ctypes.c_int
    lib.fn = fn
    return lib


class _HostVideoDecoder:
    """A host video decoder (`_decoder_lib`): `decode` takes the packets in
    decode order and returns how many frames each made ready for output
    (none, one or several: a decoder that reorders holds pictures back),
    `flush` makes ready the frames still held at the end of the stream;
    `next` takes the next ready frame in output order, which `frame` and
    `planes` then read. The decoder keeps its references between calls;
    `output` does the three for one packet."""

    LIB = PREFIX = ""
    STATS: Tuple[str, ...] = ()

    def __init__(self, what: str):
        self.lib, self.what = _decoder_lib(self.LIB, self.PREFIX), what
        self.fn = self.lib.fn
        self.handle = self.fn["new"]()

    @classmethod
    def for_stream(cls, stream: "Demuxed") -> "_HostVideoDecoder":
        """A decoder of the demuxed ``stream``, its configuration read."""
        return cls(stream.config, stream.path)

    def configure(self, config: bytes) -> None:
        """Read the stream's configuration (an MP4's VOL or ``avcC`` body),
        which is not a packet."""
        fn = getattr(self.lib, f"{self.PREFIX}_config")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                       ctypes.c_size_t]
        fn.restype = ctypes.c_int
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        image_io._check(fn(self.handle, bytes(config), len(config), err, image_io._ERR_LEN), err,
                        self.what)

    def decode(self, packet: bytes) -> int:
        """Decode one packet; the number of frames it made ready."""
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        code = self.fn["decode"](self.handle, bytes(packet), len(packet), err, image_io._ERR_LEN)
        image_io._check(min(code, 0), err, self.what)
        return code

    def flush(self) -> int:
        """The end of the stream: the number of frames it made ready."""
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        code = self.fn["flush"](self.handle, err, image_io._ERR_LEN)
        image_io._check(min(code, 0), err, self.what)
        return code

    def next(self) -> int:
        """Take the next ready frame: the index (0, 1, ...) of the `decode`
        call whose packet holds it."""
        packet = ctypes.c_int64()
        if self.fn["next"](self.handle, ctypes.byref(packet)) != 0:
            raise ValueError(f"{self.what}: no frame ready for output")
        return packet.value

    def output(self, packet: Optional[bytes] = None, rgb: bool = True, luma: bool = False):
        """Decode ``packet`` (`flush` when it is None) and give each frame it
        made ready, in output order, as (the index of its packet, `frame`)."""
        for _ in range(self.decode(packet) if packet is not None else self.flush()):
            yield self.next(), self.frame(rgb=rgb, luma=luma)

    @property
    def shape(self) -> Tuple[int, int]:
        h, w = ctypes.c_int(), ctypes.c_int()
        self.fn["info"](self.handle, ctypes.byref(h), ctypes.byref(w), None, 0)
        return h.value, w.value

    @property
    def encoder(self) -> str:
        """The user data that names the encoder, if any."""
        h, w = ctypes.c_int(), ctypes.c_int()
        buf = ctypes.create_string_buffer(64)
        self.fn["info"](self.handle, ctypes.byref(h), ctypes.byref(w), buf, 64)
        return buf.value.decode(errors="replace")

    @property
    def stats(self) -> dict:
        """What the decoded pictures held, by `STATS` name."""
        out = np.zeros(len(self.STATS), np.int64)
        self.fn["stats"](self.handle, out.ctypes.data, len(out))
        return dict(zip(self.STATS, out.tolist()))

    def frame(self, rgb: bool = True, luma: bool = False):
        """The frame taken last: uint8 RGB [H,W,3] as ``cv2.VideoCapture``
        gives it (flipped to RGB), its luma plane [H,W], or both as a pair."""
        h, w = self.shape
        out_rgb = np.empty((h, w, 3), np.uint8) if rgb else None
        out_y = np.empty((h, w), np.uint8) if luma else None
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        image_io._check(self.fn["frame"](
            self.handle, None if out_rgb is None else out_rgb.ctypes.data,
            None if out_y is None else out_y.ctypes.data, err, image_io._ERR_LEN), err,
            self.what)
        return (out_rgb, out_y) if rgb and luma else out_rgb if rgb else out_y

    def planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The planes of the frame taken last: Y [H,W], U and V
        [(H+1)/2,(W+1)/2]."""
        h, w = self.shape
        out = (np.empty((h, w), np.uint8), np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8),
               np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8))
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        image_io._check(self.fn["planes"](self.handle, *(o.ctypes.data for o in out), err,
                                          image_io._ERR_LEN), err, self.what)
        return out

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.fn["free"](self.handle)
            self.handle = None

    def __del__(self):
        self.close()


class Mpeg4Decoder(_HostVideoDecoder):
    """MPEG-4 Part 2 video, Simple and Advanced Simple Profile
    (``csrc/mpeg4_video.cpp``); ``config`` holds headers to read first (an
    MP4's VOL), ``tag`` the container's fourcc (`Demuxed.tag`). A stream
    with B-VOPs gives its frames in display order, one packet behind, and
    `flush` the last. `encoder` is the user data that names the encoder
    ("Lavc62.28.101", "XviD0069"); `stats` (`STATS`) counts I- and P-VOPs,
    macroblocks by type, TCOEF escapes by type, predictions read partly
    outside the VOP (unrestricted vectors), half-pel predictions, VOPs with
    rounding_type 1, AC predictions rescaled to another QP; B-VOPs, B
    macroblocks by mode (direct, interpolated, backward, forward, skipped
    with their co-located one), DBQUANT macroblocks, four-vector
    macroblocks, quarter-sample predictions, VOPs under MPEG quantisation,
    video packets after a VOP's first, data-partitioned VOPs, VOPs decoded
    from the rest of a packed packet, VOPs not coded, VOPs through the XviD
    IDCT; GMC S-VOPs, macroblocks predicted by the global motion."""

    LIB, PREFIX = "mpeg4_video", "m4v"
    STATS = ("i_vops", "p_vops", "intra_mbs", "inter_mbs", "skipped_mbs", "p_intra_mbs",
             "ac_pred_mbs", "dquant_mbs", "escape1", "escape2", "escape3",
             "outside_predictions", "half_pel_predictions", "rounding_vops", "ac_rescales",
             "b_vops", "b_direct_mbs", "b_interpolated_mbs", "b_backward_mbs", "b_forward_mbs",
             "b_skipped_mbs", "dbquant_mbs", "four_mv_mbs", "quarter_sample_predictions",
             "mpeg_quant_vops", "video_packets", "partitioned_vops", "packed_vops",
             "not_coded_vops", "xvid_idct_vops", "s_vops", "gmc_mbs")

    def __init__(self, config: bytes = b"", what: str = "MPEG-4", tag: bytes = b""):
        super().__init__(what)
        if len(tag) == 4:
            fn = self.lib.m4v_tag
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_char_p], None
            fn(self.handle, bytes(tag).upper())
        if config:
            self.configure(config)

    @classmethod
    def for_stream(cls, stream: "Demuxed") -> "Mpeg4Decoder":
        return cls(stream.config, stream.path, stream.tag)


class H264Decoder(_HostVideoDecoder):
    """H.264 video of the Constrained Baseline, Main and High profiles, 8-bit
    4:2:0 progressive (``csrc/h264_video.cpp``): each packet is one access
    unit; ``config`` is an MP4's ``avcC`` body (the NAL length size and the
    SPS and PPS), without which packets are Annex B. Frames come out in POC
    order as FFmpeg gives them: a packet of a stream with B slices may make
    none, one or several frames ready, and `flush` gives the last ones.
    `encoder` is the SEI user data that names the encoder ("x264 - core
    164 r3095 baee400"); `stats` counts (`STATS`) IDR pictures, pictures
    with P slices, slices, pictures of several slices, I_NxN of 4x4,
    I_16x16, intra macroblocks of P slices, inter, skipped and P_8x8
    macroblocks, sub-partitions below 8x8, partitions with ref_idx above 0,
    macroblocks with a nonzero mb_qp_delta, level codes with level_prefix
    14 or more, luma predictions at a fractional position, predictions read
    partly outside the picture, luma edge segments filtered with bS 4 and
    with bS 1-3, slices with deblocking offsets and with the filter off,
    pictures with constrained intra prediction, cropped pictures; pictures
    with B slices, CABAC I slices and CABAC P and B slices by
    cabac_init_idc, macroblocks of spatial and of temporal direct
    prediction, bi-predicted partitions, macroblocks of the 8x8 transform,
    I_NxN of intra 8x8, partitions of explicit weights and of implicit
    weights other than 32/32, reference list modifications, MMCO
    operations, pictures under scaling lists, frames output after a frame
    decoded later."""

    LIB, PREFIX = "h264_video", "h264"
    STATS = ("idr_pictures", "p_pictures", "slices", "multi_slice_pictures", "i4x4_mbs",
             "i16x16_mbs", "p_intra_mbs", "inter_mbs", "skipped_mbs", "p8x8_mbs",
             "small_partitions", "ref_idx_above_0", "qp_delta_mbs", "level_escapes",
             "fractional_predictions", "outside_predictions", "bs4_edges", "bs1_3_edges",
             "deblock_offset_slices", "deblock_off_slices", "constrained_intra_pictures",
             "cropped_pictures", "b_pictures", "cabac_i_slices", "cabac_idc0_slices",
             "cabac_idc1_slices", "cabac_idc2_slices", "spatial_direct_mbs",
             "temporal_direct_mbs", "bipred_partitions", "transform_8x8_mbs", "i8x8_mbs",
             "explicit_weighted_partitions", "implicit_weighted_partitions",
             "list_modifications", "mmco_ops", "scaling_list_pictures", "reordered_frames")

    def __init__(self, config: bytes = b"", what: str = "H.264"):
        super().__init__(what)
        if config:
            self.configure(config)


@functools.lru_cache(maxsize=None)
def _mpeg4_encoder() -> ctypes.CDLL:
    """The host MPEG-4 encoder, built at first use, its entry points typed."""
    from dro_sfm_torch import hostlib
    lib = ctypes.CDLL(str(hostlib.build("mpeg4_encode")))
    handle, size, err, ptr = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_void_p
    i32 = ctypes.c_int
    lib.m4e_new.argtypes = [i32, i32, i32, i32, i32, i32, err, size]
    lib.m4e_new.restype = handle
    lib.m4e_free.argtypes = [handle]
    lib.m4e_free.restype = None
    lib.m4e_config.argtypes = [handle, ptr]
    lib.m4e_config.restype = size
    lib.m4e_encode.argtypes = [handle, ptr, size, ctypes.POINTER(size), ctypes.POINTER(i32),
                               err, size]
    lib.m4e_encode.restype = i32
    lib.m4e_packet.argtypes = [handle, ptr]
    lib.m4e_packet.restype = None
    lib.m4e_recon.argtypes = [handle, ptr, ptr, ptr, ptr]
    lib.m4e_recon.restype = i32
    return lib


class Mpeg4Encoder:
    """MPEG-4 Part 2 Simple Profile video of ``height`` x ``width`` (both
    even) at ``fps`` (``csrc/mpeg4_encode.cpp``): `encode` takes uint8 RGB
    frames [H,W,3] in order and gives each one's packet (one VOP) and
    whether it is an I-VOP (every `GOP` frames, quantiser `QP`); ``config`` holds the VOS,
    VO and VOL headers; `reconstruction` is the last frame as the decoder
    rebuilds it, bit for bit."""

    def __init__(self, height: int, width: int, fps: float):
        self.lib, self.handle = _mpeg4_encoder(), None
        self.shape = (int(height), int(width))
        res, inc = timebase(fps)
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        self.handle = self.lib.m4e_new(self.shape[1], self.shape[0], res, inc, GOP, QP,
                                       err, image_io._ERR_LEN)
        if not self.handle:
            raise ValueError(f"MPEG-4 encoder: {err.value.decode(errors='replace')}")
        buf = ctypes.create_string_buffer(self.lib.m4e_config(self.handle, None))
        self.lib.m4e_config(self.handle, buf)
        self.config = buf.raw

    def encode(self, frame: np.ndarray) -> Tuple[bytes, bool]:
        frame = _check_frame(frame, "Mpeg4Encoder")
        if frame.shape[:2] != self.shape:
            raise ValueError(f"frame of size {frame.shape[:2]} for an encoder of {self.shape}")
        if frame.strides[1:] != (3, 1) or frame.strides[0] < 0:
            frame = np.ascontiguousarray(frame)
        size, key = ctypes.c_size_t(), ctypes.c_int()
        err = ctypes.create_string_buffer(image_io._ERR_LEN)
        image_io._check(self.lib.m4e_encode(self.handle, frame.ctypes.data, frame.strides[0],
                                            ctypes.byref(size), ctypes.byref(key), err,
                                            image_io._ERR_LEN), err, "MPEG-4 encoder")
        out = ctypes.create_string_buffer(size.value)
        self.lib.m4e_packet(self.handle, out)
        return out.raw, bool(key.value)

    def reconstruction(self, planes: bool = False):
        """The last encoded frame as decoded: uint8 RGB [H,W,3] (the
        decoder's conversion), or with ``planes`` (Y [H,W], U, V [H/2,W/2])."""
        h, w = self.shape
        if planes:
            out = (np.empty((h, w), np.uint8), np.empty((h // 2, w // 2), np.uint8),
                   np.empty((h // 2, w // 2), np.uint8))
            ptrs = (None, *(o.ctypes.data for o in out))
        else:
            out = np.empty((h, w, 3), np.uint8)
            ptrs = (out.ctypes.data, None, None, None)
        if self.lib.m4e_recon(self.handle, *ptrs) != 0:
            raise ValueError("MPEG-4 encoder: no frame encoded yet")
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.m4e_free(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


class VideoReader:
    """The frames of a video file in output order, as ``cv2.VideoCapture``
    gives them (`demux`): MPEG-4 Part 2 through `Mpeg4Decoder`, H.264
    through `H264Decoder` (display order: B slices reordered), MJPEG AVI
    through the JPEG decoder; the frames an MP4's edit list trims are
    decoded and not given (`Demuxed.shown`). Iterating gives uint8 RGB
    [H,W,3]; with ``luma`` the luma planes [H,W] (MPEG-4 and H.264). ``fps``
    is the stream's rate, ``len`` the number of frames iteration gives and
    ``decode_ms`` each given frame's decode milliseconds (host clock: the
    packets decoded since the frame before it, their reads included). A
    packet that fails to decode raises; none is skipped."""

    DECODERS = {"mpeg4": Mpeg4Decoder, "h264": H264Decoder}

    def __init__(self, path: str):
        self.path = str(path)
        self.stream = demux(self.path)
        self.fps = self.stream.fps
        self.decode_ms: List[float] = []

    def __len__(self) -> int:
        return sum(self.stream.shown)

    def __iter__(self):
        return self.frames()

    def frames(self, luma: bool = False):
        s = self.stream
        if s.codec == "mjpeg":
            if luma:
                raise ValueError(f"{self.path}: luma planes of MPEG-4 and H.264 video only")
            for i in range(len(s)):
                t0 = time.perf_counter()
                img = image_io.decode_jpeg(s.packet(i), self.path)
                self.decode_ms.append(1e3 * (time.perf_counter() - t0))
                yield img
            return
        dec = self.DECODERS[s.codec].for_stream(s)
        spent = 0.0
        try:
            for i in range(len(s) + 1):
                t0 = time.perf_counter()
                ready = dec.decode(s.packet(i)) if i < len(s) else dec.flush()
                for _ in range(ready):
                    if not s.shown[dec.next()]:
                        continue
                    img = dec.frame(rgb=not luma, luma=luma)
                    now = time.perf_counter()
                    self.decode_ms.append(1e3 * (spent + now - t0))
                    spent = 0.0
                    yield img
                    t0 = time.perf_counter()
                spent += time.perf_counter() - t0
        finally:
            dec.close()


def read_avi_mjpeg(path: str) -> Tuple[List[np.ndarray], float]:
    """The frames of an MJPEG AVI as uint8 RGB [H,W,3] (the port's JPEG
    decoder) and its frames a second."""
    reader = VideoReader(path)
    if reader.stream.codec != "mjpeg":
        raise NotImplementedError(f"{path}: a {reader.stream.codec} stream, not MJPEG")
    return list(reader), reader.fps


def median_cut(rgb: np.ndarray, colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Median-cut quantization of uint8 RGB [H,W,3]: (indices [H,W] uint8,
    palette [K,3] uint8), K <= ``colors``. The box holding the most pixels
    that can still be split is cut at its weighted median along its longest
    side, until there are ``colors`` boxes or each holds one colour; each
    box's colour is the mean of its pixels, rounded, and each pixel takes
    its box's colour (no dither). An image of at most ``colors`` colours
    keeps them exactly."""
    flat = rgb.reshape(-1, 3)
    packed = (flat[:, 0].astype(np.int32) << 16) | (flat[:, 1].astype(np.int32) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    cols = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
    boxes = [np.arange(len(uniq))]
    while len(boxes) < colors:
        weights = [counts[b].sum() if len(b) > 1 else -1 for b in boxes]
        k = int(np.argmax(weights))
        if weights[k] < 0:
            break
        box = boxes[k]
        c = cols[box]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = box[np.argsort(c[:, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0))
        cut = min(max(cut + 1, 1), len(order) - 1)
        boxes[k:k + 1] = [order[:cut], order[cut:]]
    palette = np.empty((len(boxes), 3), np.uint8)
    label = np.empty(len(uniq), np.int64)
    for i, box in enumerate(boxes):
        w = counts[box].astype(np.float64)
        palette[i] = np.floor((cols[box] * w[:, None]).sum(axis=0) / w.sum() + 0.5)
        label[box] = i
    return label[inverse].reshape(rgb.shape[:2]).astype(np.uint8), palette


def _lzw(indices: np.ndarray, min_bits: int) -> bytes:
    lib = image_io._codec()
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    err = ctypes.create_string_buffer(image_io._ERR_LEN)
    written = ctypes.c_size_t()
    cap = idx.size * 2 + 64
    out = np.empty(cap, np.uint8)
    image_io._check(lib.gif_lzw(idx.ctypes.data, idx.size, min_bits, out.ctypes.data, cap,
                                ctypes.byref(written), err, image_io._ERR_LEN), err, "GIF")
    return out[:written.value].tobytes()


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: float = 100,
              loop: int = 0) -> int:
    """Animated GIF of uint8 RGB frames [H,W,3] of one size, each shown
    ``duration_ms``, looping ``loop`` times (0: for ever). Returns the
    number of frames."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError(f"no frames for {path}")
    h, w = frames[0].shape[:2]
    if h > 65535 or w > 65535:
        raise ValueError(f"a GIF of {h}x{w}")
    delay = int(duration_ms / 10)
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"GIF frames are uint8 [{h},{w},3], not {f.dtype} {f.shape}")
        indices, palette = median_cut(f)
        bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out.append(b"\x21\xf9\x04" + struct.pack("<BHBB", 0, delay, 0, 0))
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1)))
        out.append(table.tobytes())
        min_bits = max(2, bits)
        out.append(bytes([min_bits]) + _lzw(indices, min_bits))
    out.append(b"\x3b")
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(b"".join(out))
    os.replace(tmp, path)
    return len(frames)
