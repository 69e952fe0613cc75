"""The port's HDF5 reader (`dro_sfm_torch.utils.hdf5`) against h5py (CPU).

Files are written with h5py in ``tmp_path`` in every layout (compact,
contiguous, chunked), filter pipeline (none, gzip, gzip + shuffle), dtype
(u1, i2, u2, f4, f8, big-endian f4), rank 1-3 with chunks that leave
partial edge chunks, and with ``libver`` "earliest" (superblock 0, symbol
tables, layout version 3) and "latest" (superblock 3, version 2 object
headers, link messages, layout version 4). Every array must equal h5py's bit
for bit, dtype and shape included. The committed fixtures
(``dro_sfm_torch/testdata/hdf5``, written by
``tools/torch_make_hdf5_fixtures.py``) must match their ``fixtures.json``,
and what the reader does not decode must raise `NotImplementedError`.
"""
import hashlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from dro_sfm_torch.utils.hdf5 import open_h5

FIXTURES = Path(__file__).resolve().parents[1] / "dro_sfm_torch" / "testdata" / "hdf5"
SHAPES = {1: (37,), 2: (13, 9), 3: (3, 11, 13)}
LAYOUTS = ["compact", "contiguous", "chunked", "chunked-gzip", "chunked-gzip-shuffle"]
DTYPES = ["u1", "<i2", "<u2", "<f4", "<f8", ">f4"]


def values(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1000).astype(dtype)


def write(path, data, layout, libver):
    with h5py.File(path, "w", libver=libver) as f:
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            ds = h5py.h5d.create(f.id, b"data", h5py.h5t.py_create(data.dtype),
                                 h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        elif layout == "contiguous":
            f["data"] = data
        else:
            chunks = tuple(s // 2 + 1 for s in data.shape)       # partial edge chunks
            f.create_dataset("data", data=data, chunks=chunks,
                             compression="gzip" if "gzip" in layout else None,
                             shuffle="shuffle" in layout)
        f.create_group("group")["small"] = data.ravel()[:5]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_reader_equals_h5py(tmp_path, layout, dtype, rank, libver):
    path = tmp_path / "x.h5"
    data = values(SHAPES[rank], dtype)
    write(path, data, layout, libver)
    with h5py.File(path, "r") as f:
        ref = {k: f[k][()] for k in ("data", "group/small")}
    got = open_h5(path)
    assert sorted(got) == ["data", "group/small"]
    for k, want in ref.items():
        a = got[k]
        assert a.dtype == want.dtype and a.shape == want.shape, k
        assert a.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_fill_values_and_unwritten_chunks(tmp_path, libver):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as f:
        part = f.create_dataset("part", shape=(25, 25), dtype="<i4", chunks=(10, 10),
                                fillvalue=7)
        part[10:20, 10:20] = values((10, 10), "<i4")
        f.create_dataset("empty", shape=(6, 4), dtype="<f8", fillvalue=2.5)
        f.create_dataset("zeros", shape=(5,), dtype="<u2")
    got = open_h5(path)
    with h5py.File(path, "r") as f:
        for k in ("part", "empty", "zeros"):
            assert got[k].tobytes() == f[k][()].tobytes(), k


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_early_allocation(tmp_path, libver):
    """Chunks allocated when the dataset is made: with "latest" and no
    filter, HDF5 indexes them implicitly (layout version 4, index type 2)."""
    path = tmp_path / "x.h5"
    data = values((60, 50), "<f4")
    with h5py.File(path, "w", libver=libver) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        ds = h5py.h5d.create(f.id, b"x", h5py.h5t.py_create(data.dtype),
                             h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    assert open_h5(path)["x"].tobytes() == data.tobytes()


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_many_datasets_and_chunks(tmp_path, libver):
    """Multi-level B-trees (earliest) and a larger fixed array (latest)."""
    path = tmp_path / "x.h5"
    big = values((90, 70), "<f4")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("big", data=big, chunks=(4, 4) if libver == "earliest" else (9, 10))
        if libver == "earliest":
            for i in range(120):
                f[f"v{i:03d}"] = np.full(3, i, "<i2")
    got = open_h5(path)
    assert got["big"].tobytes() == big.tobytes()
    if libver == "earliest":
        assert len(got) == 121 and got["v117"].tolist() == [117] * 3


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "fixtures.json").read_text())
                                        ["files"]))
def test_committed_fixtures(name):
    entries = json.loads((FIXTURES / "fixtures.json").read_text())["files"][name]
    got = open_h5(FIXTURES / name)
    assert sorted(got) == sorted(entries)
    for k, e in entries.items():
        a = got[k]
        assert a.dtype.str == e["dtype"] and list(a.shape) == e["shape"], k
        assert hashlib.sha256(a.tobytes()).hexdigest() == e["sha256"], k
    with h5py.File(FIXTURES / name, "r") as f:
        for k in entries:
            assert got[k].tobytes() == f[k][()].tobytes(), k


def test_nyu_fixture_session_layouts():
    """The 480x640 session holds a contiguous and a gzip-chunked frame."""
    meta = json.loads((FIXTURES / "fixtures.json").read_text())
    session = {k: v for k, v in meta["files"].items() if k.startswith(meta["nyu_session"])}
    assert len(session) == 3
    layouts = {v["rgb"]["layout"] for v in session.values()}
    assert {1, 2} <= layouts
    for v in session.values():
        assert v["rgb"]["shape"] == [3, 480, 640] and v["rgb"]["dtype"] == "|u1"
        assert v["depth"]["shape"] == [480, 640] and v["depth"]["dtype"] == "<f4"
    size = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert size < 2 * 1024 * 1024


UNSUPPORTED = {
    "fletcher32": (lambda f, d: f.create_dataset("x", data=d, chunks=(4, 4), fletcher32=True),
                   "Fletcher32"),
    "compound": (lambda f, d: f.create_dataset(
        "x", data=np.zeros(3, dtype=[("a", "<i4"), ("b", "<f4")])), "compound"),
    "vlen string": (lambda f, d: f.create_dataset("x", data=["ab", "cde"],
                                                  dtype=h5py.string_dtype()),
                    "variable-length"),
    "scale-offset": (lambda f, d: f.create_dataset("x", data=d, chunks=(4, 4),
                                                   scaleoffset=2), "scale-offset"),
}


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_raises(tmp_path, case, libver):
    """Each unsupported feature raises on the dataset that has it; the
    file still opens and its other datasets read."""
    make, match = UNSUPPORTED[case]
    path = tmp_path / "x.h5"
    d = values((9, 7), "<f4")
    with h5py.File(path, "w", libver=libver) as f:
        make(f, d)
        f["ok"] = d
    got = open_h5(path)
    assert got["ok"].tobytes() == d.tobytes()
    with pytest.raises(NotImplementedError, match=match):
        got["x"]


@pytest.mark.parametrize("case, match", [
    ("dense links", "fractal heap"),
    ("paged fixed array", "paged fixed array"),
    ("extensible array", "extensible array"),
    ("v2 B-tree index", "version 2 B-tree"),
])
def test_latest_features_it_refuses(tmp_path, case, match):
    path = tmp_path / "x.h5"
    d = values((60, 50), "<f4")
    with h5py.File(path, "w", libver="latest") as f:
        if case == "dense links":
            for i in range(20):
                f[f"v{i}"] = d[:2]
        elif case == "paged fixed array":
            f.create_dataset("x", data=d, chunks=(1, 2))
        elif case == "extensible array":
            f.create_dataset("x", data=d, chunks=(8, 8), maxshape=(None, 50))
        else:
            f.create_dataset("x", data=d, chunks=(8, 8), maxshape=(None, None))
    with pytest.raises(NotImplementedError, match=match):
        open_h5(path)["x"]


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"not an hdf5 file" * 100)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        open_h5(path)
