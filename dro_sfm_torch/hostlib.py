"""Build the port's host C++ libraries (the image codec, the MPEG-4 video
decoder and encoder and the H.264 and HEVC video decoders).

``csrc/image_codec.cpp``, ``csrc/mpeg4_video.cpp``, ``csrc/mpeg4_encode.cpp``,
``csrc/h264_video.cpp`` and ``csrc/hevc_video.cpp`` are plain C++ with a C
interface; the two MPEG-4 sources include ``csrc/mpeg4_tables.h``, the H.264
decoder its CABAC engine ``csrc/h264_cabac.h`` and tables
``csrc/h264_tables.h``, the HEVC decoder the same engine and its own tables
``csrc/hevc_tables.h``, and the video decoders share the RGB conversion of
``csrc/yuv_rgb.h``. Each is compiled with the host C++ compiler (``$CXX``, else
``c++`` or ``g++``) into a shared library at first use, under
``build/host`` beside the package (listed in ``.gitignore``); its user
loads it with ``ctypes`` (`dro_sfm_torch.utils.image_io`,
`dro_sfm_torch.utils.video_io`), which releases the interpreter lock for
the length of each call. The library's name carries a hash of the
source, the headers of ``csrc`` and the flags; it is written to a temporary file and moved into
place, so that processes building it at the same time do not collide.
Nothing is built when a module is imported, and a missing compiler or a
failed build raises: the port has no Python decoder to fall back on.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"image_codec": CSRC / "image_codec.cpp", "mpeg4_video": CSRC / "mpeg4_video.cpp",
           "mpeg4_encode": CSRC / "mpeg4_encode.cpp", "h264_video": CSRC / "h264_video.cpp",
           "hevc_video": CSRC / "hevc_video.cpp"}
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found ($CXX, c++ or g++): the image codec and "
                       "the video codec of dro_sfm_torch are built from csrc/*.cpp at "
                       "first use")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return CSRC.parents[1] / "build" / "host" / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """The library of ``name``, compiled first unless it exists."""
    out = library_path(name)
    if out.is_file():
        return out
    cxx = find_cxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCES[name])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {name} failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out
