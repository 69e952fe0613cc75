"""The port's NYU reader against the JAX package's, on the same HDF5 tree (CPU).

The tree is `tests/test_datasets.py`'s NYU fixture: two sessions of four
``.h5`` files written by h5py, ``rgb`` [3,48,64] uint8 noise and ``depth``
[48,64] float32. The JAX reader opens them with h5py, the port with its own
reader (`dro_sfm_torch.utils.hdf5`). ``NYU`` and ``NYUtest`` go through each
package's ``setup_dataset`` from the same config, in validation mode and in
training mode at the files' own shape with colour jitter on; every key of
every sample must be equal bit for bit (the float jitter copies OpenCV's
float vector arithmetic). At another shape (32x48) both resize the float
frames, the JAX package with OpenCV and the port with `resize_linear_f32`,
and every key is still equal bit for bit.
"""
import os

import h5py
import numpy as np
import pytest

from dro_sfm_tpu.data import setup_dataset as jax_setup
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch.data import setup_dataset
from dro_sfm_torch.data.nyu import NYU_K, NYUDataset, read_h5_sample
from dro_sfm_torch.utils.config import load_config

H, W = 48, 64
JITTER = [0.2, 0.2, 0.2, 0.05]


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu") / "nyu"
    for sess in ("bathroom_0001", "bedroom_0002"):
        d = root / sess
        os.makedirs(d, exist_ok=True)
        for i in range(4):
            rng = np.random.default_rng(i)
            with h5py.File(d / f"{i:05d}.h5", "w") as f:
                f["rgb"] = rng.integers(0, 255, size=(3, H, W)).astype(np.uint8)
                f["depth"] = np.full((H, W), 2.0 + i, dtype=np.float32)
    return str(root)


def build(setup, load, root, name, mode, shape=(H, W)):
    key = "train" if mode == "train" else "validation"
    section = {"dataset": [name], "path": [root], "split": [""],
               "depth_type": ["groundtruth"], "back_context": 1, "forward_context": 1}
    cfg = load(overrides={"datasets": {
        "augmentation": {"image_shape": list(shape), "jittering": JITTER}, key: section}})
    ds = setup(cfg.datasets[key], cfg.datasets.augmentation, mode)
    return ds if mode == "train" else ds[0]


@pytest.mark.parametrize("mode", ["train", "validation"])
@pytest.mark.parametrize("name", ["NYU", "NYUtest"])
def test_reader_matches_jax(nyu_tree, name, mode):
    ours = build(setup_dataset, load_config, nyu_tree, name, mode)
    ref = build(jax_setup, jax_load_config, nyu_tree, name, mode)
    assert len(ours) == len(ref) == 4
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b), (i, sorted(a), sorted(b))
        assert a["rgb"].shape == (H, W, 3) and a["rgb"].dtype == np.float32
        assert a["rgb_context"].shape == (2, H, W, 3)
        for key in b:
            x, y = a[key], b[key]
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (i, key)
                assert np.array_equal(x, y), (i, key, np.abs(x.astype(float) - y).max())
            else:
                assert x == y, (i, key)


def test_samples_order_and_intrinsics(nyu_tree):
    ds = NYUDataset(nyu_tree, mode="validation", back_context=1, forward_context=1)
    s = ds[0]
    assert s["filename"] == "bathroom_0001_00001"
    np.testing.assert_array_equal(s["intrinsics"], NYU_K)
    assert float(s["depth"].max()) == 3.0                  # frame 1 of the session
    image, depth = read_h5_sample(os.path.join(nyu_tree, "bedroom_0002", "00003.h5"))
    with h5py.File(os.path.join(nyu_tree, "bedroom_0002", "00003.h5"), "r") as f:
        want = np.transpose(f["rgb"][()], (1, 2, 0)).astype(np.float32) / 255.0
    assert np.array_equal(image, want) and depth.shape == (H, W, 1)


@pytest.mark.parametrize("mode", ["train", "validation"])
def test_other_shape_matches_jax(nyu_tree, mode):
    ours = build(setup_dataset, load_config, nyu_tree, "NYU", mode, shape=(32, 48))
    ref = build(jax_setup, jax_load_config, nyu_tree, "NYU", mode, shape=(32, 48))
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b) and a["rgb"].shape == (32, 48, 3)
        for key, y in b.items():
            if isinstance(y, np.ndarray):
                assert a[key].dtype == y.dtype and np.array_equal(a[key], y), (i, key)
            else:
                assert a[key] == y, (i, key)


@pytest.mark.parametrize("shape", [(48, 64), (480, 640)])
def test_float_jitter_equals_jax(shape):
    """NYU's float images take the float jitter: at a width that is a
    multiple of 16 (the recipes') it equals the JAX package's (OpenCV's
    float conversions) bit for bit."""
    from dro_sfm_tpu.data.transforms import _jitter_once as jax_jitter
    from dro_sfm_torch.data.transforms import _jitter_once
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(*shape, 3)).astype(np.float32)
    img[::3] = np.round(img[::3] * 8) / 8             # ties between channels
    for factors in [(1.1, 0.9, 1.2, 0.05), (0.8, 1.2, 0.8, -0.05), (1.0, 1.0, 1.0, 0.0)]:
        assert np.array_equal(_jitter_once(img, *factors), jax_jitter(img, *factors)), factors


def test_nyu_and_export_imports_leave_out_h5py():
    """The NYU reader, the HDF5 reader and the export modules import none
    of what the card's machine lacks (h5py among them) and nothing of JAX."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys, dro_sfm_torch.data.nyu, dro_sfm_torch.utils.hdf5, "
            "dro_sfm_torch.export_serving, dro_sfm_torch.scripts.export, "
            "dro_sfm_torch.scripts.bench_serving\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('h5py', 'jax', 'jaxlib', 'flax', 'dro_sfm_tpu', 'yaml', 'cv2', 'PIL')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
