#!/usr/bin/env python3
"""Write the HDF5 fixtures of the port's HDF5 reader and NYU checks.

    python3 tools/torch_make_hdf5_fixtures.py      # needs h5py

Writes with h5py under ``dro_sfm_torch/testdata/hdf5/``:

* one small file per layout and filter that `dro_sfm_torch.utils.hdf5`
  reads: ``compact.h5``, ``contiguous.h5``, ``chunked.h5`` (edge chunks
  that overhang the shape), ``gzip.h5``, ``gzip_shuffle.h5``,
  ``unwritten.h5`` (chunks never written and an unallocated contiguous
  dataset: the fill value) and ``latest.h5`` (``libver="latest"``:
  superblock 3, version 2 object headers, link messages, layout version 4
  with a fixed array and a single-chunk index), with seeded values of the
  types u1, i2, u2, f4, f8 and big-endian f4;
* one NYU session at the ``train_nyu_mf_gt`` recipe's 480x640,
  ``nyu/session_0000/0000{0,1,2}.h5``, each with ``rgb`` [3,480,640] uint8
  and ``depth`` [480,640] float32 (metres rounded to millimetres): three
  views of scene 0 of the port's synthetic renderer (``SyntheticConfig(
  height=480, width=640, num_planes=3, num_context=2)``). Frame 0 holds
  ``rgb`` contiguous and ``depth`` gzip + shuffle in 60x80 chunks; frame 1
  both gzip-chunked in chunks that overhang the frame; frame 2 is written
  with ``libver="latest"``, both gzip-chunked;
* ``fixtures.json``: for each file and dataset its shape, dtype (numpy's
  ``dtype.str``), layout class (0 compact, 1 contiguous, 2 chunked), filters
  and the sha256 of its values in C order, so that a machine
  without h5py (``chip_smoke.py`` phase ``nyu``) holds the reader to h5py's
  bytes.
"""
import hashlib
import json
import sys
from pathlib import Path

import h5py
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402

OUT = ROOT / "dro_sfm_torch" / "testdata" / "hdf5"
RENDER = {"height": 480, "width": 640, "num_planes": 3, "num_context": 2, "seed": 0}
SESSION = "nyu/session_0000"


def compact(f, name, data):
    """A dataset in the compact layout (h5py's high-level API has no
    switch for it)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), space,
                         dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def small_files(rng):
    def values(shape, dtype):
        return (rng.standard_normal(shape) * 1000).astype(dtype)

    with h5py.File(OUT / "compact.h5", "w") as f:
        compact(f, "i2", values((4, 5), "<i2"))
        compact(f, "u1", values((17,), "u1"))
    with h5py.File(OUT / "contiguous.h5", "w") as f:
        f["f8"] = values((7, 5), "<f8")
        f.create_group("group")["f4_be"] = values((3, 4, 5), ">f4")
    with h5py.File(OUT / "chunked.h5", "w") as f:
        f.create_dataset("u2", data=values((37, 23), "<u2"), chunks=(8, 8))
    with h5py.File(OUT / "gzip.h5", "w") as f:
        f.create_dataset("f4", data=values((3, 11, 13), "<f4"), chunks=(2, 5, 6),
                         compression="gzip")
    with h5py.File(OUT / "gzip_shuffle.h5", "w") as f:
        f.create_dataset("i2", data=values((50, 30), "<i2"), chunks=(16, 16),
                         compression="gzip", shuffle=True)
    with h5py.File(OUT / "unwritten.h5", "w") as f:
        part = f.create_dataset("i4", shape=(25, 25), dtype="<i4", chunks=(10, 10),
                                fillvalue=7)
        part[:10, :10] = values((10, 10), "<i4")
        f.create_dataset("f8", shape=(6, 4), dtype="<f8")
    with h5py.File(OUT / "latest.h5", "w", libver="latest") as f:
        compact(f, "u1", values((9, 3), "u1"))
        f["f8"] = values((7, 5), "<f8")
        f.create_dataset("f4_be", data=values((3, 11, 13), ">f4"), chunks=(2, 5, 6),
                         compression="gzip", shuffle=True)
        f.create_dataset("u2", data=values((12, 9), "<u2"), chunks=(12, 9),
                         compression="gzip")


def nyu_session():
    data = SyntheticDataset(SyntheticConfig(**RENDER))
    planes, poses = data._scene(0)
    out = OUT / SESSION
    out.mkdir(parents=True, exist_ok=True)
    gzip = {"compression": "gzip", "compression_opts": 9}
    for i, pose in enumerate(poses):
        image, depth = data._render(planes, pose)
        rgb = np.ascontiguousarray(np.transpose((image * 255).astype(np.uint8), (2, 0, 1)))
        depth = (np.round(depth[..., 0] * 1000) / 1000).astype(np.float32)
        path = out / f"{i:05d}.h5"
        with h5py.File(path, "w", libver="latest" if i == 2 else "earliest") as f:
            if i == 0:
                f["rgb"] = rgb
                f.create_dataset("depth", data=depth, chunks=(60, 80), shuffle=True, **gzip)
            elif i == 1:
                f.create_dataset("rgb", data=rgb, chunks=(3, 100, 150), **gzip)
                f.create_dataset("depth", data=depth, chunks=(100, 150), **gzip)
            else:
                f.create_dataset("rgb", data=rgb, chunks=True, **gzip)
                f.create_dataset("depth", data=depth, chunks=True, shuffle=True, **gzip)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    small_files(np.random.default_rng(0))
    nyu_session()
    table = {}
    for path in sorted(OUT.rglob("*.h5")):
        entries = {}
        with h5py.File(path, "r") as f:
            def add(name, obj):
                if isinstance(obj, h5py.Dataset):
                    a = np.ascontiguousarray(obj[()])
                    entries[name] = {"shape": list(a.shape), "dtype": a.dtype.str,
                                     "layout": obj.id.get_create_plist().get_layout(),
                                     "filters": ["shuffle"] * obj.shuffle
                                     + [obj.compression] * bool(obj.compression),
                                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            f.visititems(add)
        table[str(path.relative_to(OUT))] = entries
    meta = {"h5py": h5py.__version__, "hdf5": h5py.version.hdf5_version,
            "render": RENDER, "nyu_session": SESSION,
            "layouts": {"0": "compact", "1": "contiguous", "2": "chunked"}, "files": table}
    (OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {len(table)} HDF5 files and fixtures.json to {OUT}: {size} bytes")


if __name__ == "__main__":
    main()
