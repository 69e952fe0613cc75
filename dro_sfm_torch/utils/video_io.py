"""Video and animation files without OpenCV or Pillow: MJPEG AVI and GIF89a.

The card's machine has no video encoder the port may use, so it writes the
two containers itself, on the host:

* `AviWriter`: an AVI 1.0 file (RIFF ``AVI ``) of one ``vids`` stream in
  ``MJPG``: ``avih``, ``strh``, ``strf`` (a BITMAPINFOHEADER), one ``00dc``
  chunk a frame in the ``movi`` list and an ``idx1`` index. Each frame is a
  baseline JPEG from the host codec (`image_io.encode_jpeg`, the bytes of
  ``cv2.imencode``). The file is written beside its path and moved into
  place by `close`; a frame that would take the RIFF past 1 GiB (AVI 1.0's
  limit) raises before it is written, and a writer left by an exception
  removes its file, so that no broken file is left.
* `read_avi_mjpeg`: the frames (uint8 RGB) and rate of such a file.
* `write_gif`: GIF89a with a NETSCAPE loop extension and, before each frame,
  a graphic control extension holding its duration (in hundredths of a
  second, ``int(ms / 10)`` as Pillow writes it). Each frame's palette
  comes from `median_cut` (no dither), which keeps the colours of a frame
  of at most 256 exactly. The LZW codes are packed by ``gif_lzw`` of the host codec.
"""
from __future__ import annotations

import ctypes
import os
import struct
import time
from typing import List, Sequence, Tuple

import numpy as np

from dro_sfm_torch.utils import image_io

AVI_LIMIT = 1 << 30            # AVI 1.0: a RIFF of at most 1 GiB
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


class AviWriter:
    """Write uint8 RGB frames [H,W,3] of one size to an MJPEG AVI at
    ``path``; ``quality`` is the JPEG quality. ``encode_ms`` holds each
    frame's encode milliseconds (host clock) and `bytes_written` the
    file's size so far."""

    def __init__(self, path: str, fps: float, quality: int = 95):
        self.path, self.fps, self.quality = str(path), float(fps), int(quality)
        self.scale, self.rate = _rate(self.fps)
        self.tmp = self.path + ".tmp"
        self.file = open(self.tmp, "wb")
        self.size = None                     # (height, width) of the first frame
        self.index: List[Tuple[int, int]] = []   # (offset from "movi", length)
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
        strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, self.scale, self.rate, 0,
                                          frames, self.max_frame, -1, 0)
                + struct.pack("<4h", 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
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
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"AviWriter takes uint8 RGB [H,W,3], not {frame.dtype} "
                             f"{frame.shape}")
        if self.size is None:
            self.size = frame.shape[:2]
        elif frame.shape[:2] != self.size:
            raise ValueError(f"frame of size {frame.shape[:2]} in a video of {self.size}")
        t0 = time.perf_counter()
        data = image_io.encode_jpeg(frame, self.quality)
        self.encode_ms.append(1e3 * (time.perf_counter() - t0))
        chunk = _chunk(b"00dc", data)
        # the RIFF after this frame, its index entry and the index header
        if self.bytes_written + len(chunk) + 16 - 8 > AVI_LIMIT:
            raise ValueError(f"{self.path}: frame {len(self.index)} would take the AVI past "
                             f"its 1 GiB limit (AVI 1.0); write a shorter or smaller video")
        self.file.write(chunk)
        self.index.append((self.movi_bytes, len(data)))
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
        self.file.write(b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, off, n)
                                 for off, n in self.index))
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


def _riff_chunks(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        fourcc, size = struct.unpack_from("<4sI", data, pos)
        if pos + 8 + size > end:
            raise ValueError(f"truncated AVI chunk {fourcc!r}")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def avi_frames(path: str) -> Tuple[List[bytes], float]:
    """The JPEG bytes of each frame of an MJPEG AVI and its frames a
    second."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    frames, fps = [], None
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    for fourcc, pos, n in _riff_chunks(data, 12, end):
        if fourcc != b"LIST":
            continue
        kind = data[pos:pos + 4]
        for sub, spos, sn in _riff_chunks(data, pos + 4, pos + n):
            if kind == b"hdrl" and sub == b"LIST" and data[spos:spos + 4] == b"strl":
                for s2, p2, _ in _riff_chunks(data, spos + 4, spos + sn):
                    if s2 == b"strh":
                        handler = data[p2 + 4:p2 + 8]
                        if data[p2:p2 + 4] != b"vids" or handler.upper() != b"MJPG":
                            raise NotImplementedError(
                                f"{path}: stream {data[p2:p2 + 8]!r}; the port reads MJPEG "
                                f"AVI only (ROADMAP C)")
                        scale, rate = struct.unpack_from("<2I", data, p2 + 20)
                        fps = rate / scale
            elif kind == b"movi" and sub[2:] == b"dc":
                frames.append(data[spos:spos + sn])
    if fps is None:
        raise ValueError(f"{path}: an AVI without its stream header")
    return frames, fps


def read_avi_mjpeg(path: str) -> Tuple[List[np.ndarray], float]:
    """The frames of an MJPEG AVI as uint8 RGB [H,W,3] (the port's JPEG
    decoder) and its frames a second."""
    frames, fps = avi_frames(path)
    return [image_io.decode_jpeg(f, path) for f in frames], fps


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
