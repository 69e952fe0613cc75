"""The port's data pipeline against the JAX package's (CPU).

Synthetic scenes, transforms and the loader. Bars: depth, poses,
intrinsics and the pre-jitter originals bit for bit; jittered images within
1e-5 absolute (the port computes the grey image and the HSV round trip in
numpy, the JAX package with OpenCV; both in float32, one or two ulps apart
per step); the loader's batch order, ``valid`` masks, epoch reshuffle and
shards exactly.
"""
import cv2
import numpy as np
import pytest

from dro_sfm_tpu import data as jdata
from dro_sfm_tpu.data.base import sample_rng as jax_sample_rng
from dro_sfm_tpu.data.loader import DataLoader as JaxLoader
from dro_sfm_tpu.data.transforms import _jitter_once as jax_jitter_once
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch import data as tdata
from dro_sfm_torch.data.base import sample_rng, validate_sample
from dro_sfm_torch.data.loader import DataLoader, device_prefetch, to_device
from dro_sfm_torch.data.transforms import (
    _jitter_once,
    eval_transform,
    hsv_to_rgb,
    rgb_to_gray,
    rgb_to_hsv,
)
from dro_sfm_torch.utils.config import load_config

EXACT = ("depth", "pose_context", "intrinsics", "rgb_original", "rgb_context_original")
SHAPE = (32, 48)


def config(load, mode_split="train", name="Synthetic"):
    return load(overrides={"datasets": {
        "augmentation": {"image_shape": str(SHAPE)},
        mode_split: {"dataset": [name], "path": ["3"], "split": ["5"],
                     "back_context": 1, "forward_context": 1}}})


def datasets(mode, name="Synthetic"):
    section = "train" if mode == "train" else "validation"
    ours = tdata.setup_dataset(config(load_config, section, name).datasets[section],
                               config(load_config, section, name).datasets.augmentation, mode)
    ref_cfg = config(jax_load_config, section, name)
    ref = jdata.setup_dataset(ref_cfg.datasets[section], ref_cfg.datasets.augmentation, mode)
    return (ours, ref) if mode == "train" else (ours[0], ref[0])


def images():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(37, 53, 3)).astype(np.float32)
    img[0, :4] = 0.5                       # grey: zero chroma
    img[1, :4] = [0.2, 0.2, 0.7]           # ties between channels
    img[2, :4] = 0.0
    img[3, :4] = 1.0
    img[4, :4] = [1.0, 0.0, 0.0]
    img[5, :4] = [0.3, 0.9, 0.9]
    return img


def test_gray_and_hsv_match_opencv():
    img = images()
    np.testing.assert_allclose(rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY),
                               atol=1e-6, rtol=0)
    hsv = rgb_to_hsv(img)
    ref = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(hsv[..., 1:], ref[..., 1:], atol=1e-6, rtol=0)
    np.testing.assert_allclose(hsv[..., 0], ref[..., 0], atol=1e-5 * 360, rtol=0)
    assert hsv[..., 0].min() >= 0 and hsv[..., 0].max() < 360
    for shift in (0.0, 0.05 * 360, -0.05 * 360 % 360, 359.9):
        h = ref.copy()
        h[..., 0] = (h[..., 0] + shift) % 360.0
        np.testing.assert_allclose(hsv_to_rgb(h), cv2.cvtColor(h, cv2.COLOR_HSV2RGB),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("factors", [(1.1, 0.9, 1.2, 0.03), (0.85, 1.15, 0.8, -0.05),
                                     (1.0, 1.0, 1.0, 0.0)])
def test_jitter_matches_jax(factors):
    img = images()
    np.testing.assert_allclose(_jitter_once(img, *factors), jax_jitter_once(img, *factors),
                               atol=1e-5, rtol=0)


def test_sample_rng_matches_jax():
    class D:
        epoch = 3
    a = sample_rng(D(), "jitter", 7).uniform(size=4)
    np.testing.assert_array_equal(a, jax_sample_rng(D(), "jitter", 7).uniform(size=4))


@pytest.mark.parametrize("name", ["Synthetic", "SyntheticMulti"])
@pytest.mark.parametrize("mode", ["train", "validation"])
def test_synthetic_samples_match_jax(mode, name):
    ours, ref = datasets(mode, name)
    assert len(ours) == len(ref) == 5
    for epoch in (0, 1):
        ours.epoch = ref.epoch = epoch
        for idx in (0, 4):
            a, b = ours[idx], ref[idx]
            validate_sample(a)
            assert sorted(a) == sorted(b)
            assert a["filename"] == b["filename"] and a["idx"] == b["idx"]
            assert a["rgb"].shape == (*SHAPE, 3) and a["rgb_context"].shape == (2, *SHAPE, 3)
            for k in EXACT:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("rgb", "rgb_context"):
                assert a[k].dtype == np.float32
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)
            if mode == "validation":
                np.testing.assert_array_equal(a["rgb"], b["rgb"])


def test_jitter_changes_with_epoch():
    ours, _ = datasets("train")
    ours.epoch = 0
    a = ours[1]["rgb"]
    ours.epoch = 1
    assert not np.array_equal(a, ours[1]["rgb"])


def test_not_ported_inputs_raise():
    rng = np.random.default_rng(0)
    sample = {"rgb": rng.uniform(0, 1, (16, 24, 3)).astype(np.float32),
              "rgb_context": rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32),
              "intrinsics": np.eye(3, dtype=np.float32)}
    got = eval_transform(dict(sample), SHAPE)             # float images resize as in JAX
    want = jdata.transforms.eval_transform(dict(sample), SHAPE)
    for k in ("rgb", "rgb_context", "intrinsics"):
        np.testing.assert_allclose(got[k], want[k], atol=2.0 ** -24, rtol=0, err_msg=k)
    u8 = {"rgb": np.zeros((*SHAPE, 3), np.uint8),
          "rgb_context": np.zeros((1, *SHAPE, 3), np.uint8)}
    assert eval_transform(u8, SHAPE)["rgb"].dtype == np.float32
    cfg = load_config(overrides={"datasets": {"train": {"dataset": ["NoSuchSet"]}}})
    with pytest.raises(KeyError, match="NoSuchSet.*NYU.*Synthetic.*SyntheticMulti"):
        tdata.setup_dataset(cfg.datasets.train, cfg.datasets.augmentation, "train")


class Indexed:
    """A dataset whose sample is its index (the loader's order, bare)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {"idx": int(idx), "filename": str(idx),
                "rgb": np.full((2, 2, 3), idx, np.float32)}


def batches(loader_cls, n, **kw):
    loader = loader_cls(Indexed(n), **kw)
    out = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        out.append([(b["idx"].tolist(), b["valid"].tolist(), b["rgb"][:, 0, 0, 0].tolist())
                    for b in loader])
        assert len(out[-1]) == len(loader)
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, drop_last=True),
    dict(batch_size=3, shuffle=False, drop_last=False),
    dict(batch_size=2, shuffle=True, drop_last=True, num_shards=2, shard_id=1, seed=5),
    dict(batch_size=2, shuffle=False, drop_last=False, num_shards=3, shard_id=2),
    dict(batch_size=4, shuffle=True, drop_last=False, num_shards=2, shard_id=0),
])
def test_loader_matches_jax(kw):
    ours, ref = batches(DataLoader, 11, num_workers=2, **kw), batches(JaxLoader, 11, **kw)
    assert ours == ref
    if kw["shuffle"]:
        assert ours[0] != ours[1]                        # reshuffled every epoch
    if not kw["drop_last"]:
        assert any(not all(v) for _, v, _ in ours[0])    # a padded tail


def test_loader_shards_cover_every_sample_once():
    seen = []
    for shard in range(3):
        loader = DataLoader(Indexed(10), 2, shuffle=True, drop_last=False,
                            num_shards=3, shard_id=shard)
        for b in loader:
            seen += [i for i, v in zip(b["idx"].tolist(), b["valid"]) if v]
    assert sorted(seen) == list(range(10))


def test_loader_raises_a_worker_error():
    class Broken(Indexed):
        def __getitem__(self, idx):
            if idx == 5:
                raise ValueError("bad sample")
            return super().__getitem__(idx)

    with pytest.raises(ValueError, match="bad sample"):
        list(DataLoader(Broken(8), 2, num_workers=2))


def test_make_loader_and_prefetch():
    cfg = config(load_config)
    ds = tdata.setup_dataset(cfg.datasets.train, cfg.datasets.augmentation, "train")
    loader = tdata.make_loader(ds, 2, "train", num_workers=2)
    assert (loader.num_shards, loader.shard_id, loader.shuffle, loader.drop_last) == \
        (1, 0, True, True)
    import torch
    placed = list(device_prefetch(loader, lambda b: to_device(
        b, torch.device("cpu"), ("rgb", "depth", "pose_context")), depth=2))
    assert len(placed) == len(loader) == 2
    batch, arrays = placed[0]
    assert arrays["rgb"].dtype == torch.float32 and arrays["rgb"].shape == (2, *SHAPE, 3)
    np.testing.assert_array_equal(arrays["depth"].numpy(), batch["depth"])
