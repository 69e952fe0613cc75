"""Build and load the port's hand-written CUDA kernels.

Each source under ``dro_sfm_torch/csrc/`` has a plain C entry point. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library at first
use and loaded with ``ctypes``. Nothing is built when a module is imported:
the CPU tests import every module on machines without ``nvcc``.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``) unless ``DRO_SFM_TORCH_BUILD_DIR`` names another. Library
names carry a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt.

Beside the build: `LaunchCounter` (each wrapper counts its launches),
`entry` (a typed C entry point), `launch` (call one on the current stream
and raise on a CUDA error), `on_device` (the device rule of every wrapper:
the kernel for CUDA tensors, the plain version for CPU tensors) and
`sm_count` (a card's SMs, for the launch plans).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"tent_warp_fwd": CSRC / "tent_warp_fwd.cu",
           "tent_warp_bwd": CSRC / "tent_warp_bwd.cu",
           "gru_pass_fwd": CSRC / "gru_pass_fwd.cu",
           "gru_pass_bwd": CSRC / "gru_pass_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("DRO_SFM_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def find_nvcc() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of dro_sfm_torch are "
                       "built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, library path, temporary output) or None."""
    out = library_path(name)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def _finish_build(name: str, started) -> str:
    """Wait for a started build, move its library into place, return
    nvcc's log."""
    if started is None:
        return ""
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: List[str] | None = None) -> Dict[str, str]:
    """Build the named kernels (all by default), one nvcc each, all started
    together. Returns nvcc's output (register and spill report) by name."""
    names = list(SOURCES) if names is None else names
    with _lock:
        procs = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(library_path(name))))
    return lib


class LaunchCounter:
    """Number of times a wrapper launched its kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


def entry(library: str, name: str, argtypes):
    """The C entry point ``name`` of kernel library ``library``, typed
    (pointers and the stream as ``c_void_p``, so they are not cut to 32
    bits)."""
    fn = getattr(load(library), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def launch(fn, device, *args) -> None:
    """Call entry point ``fn`` with ``args`` and the current stream of
    ``device``; raise if the launch returned a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(name: str, device: torch.device, kernel, plain):
    """Kernel for CUDA tensors, plain version for CPU tensors, else raise."""
    if device.type == "cuda":
        return kernel()
    if device.type == "cpu":
        return plain()
    raise ValueError(f"{name} has no path for device {device}")
