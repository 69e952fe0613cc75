"""The port's depth images against the JAX package (CPU): ``save.depth.rgb``
and ``.viz``, `WandbLogger.log_depth_images` and ``infer --save viz``.

`save_depth` with every flag on writes the files the JAX package writes:
the npz and the uint16 png as before, and the ``_rgb`` and ``_viz`` PNGs
that decode (the port's reader) equal to OpenCV's decode of the JAX files,
for the valid samples only, with the inverse depth given on the host or as
a tensor. With a stand-in ``wandb`` module the arrays the port passes to
``wandb.Image`` equal the JAX logger's, and the step and keys too. ``infer
--save viz`` writes ``<name>_viz.png``: the frame over the colormapped
inverse depth; its top half equals the JAX CLI's (OpenCV's decode), its
bottom half equals the JAX package's `viz_inv_depth` of the port's own
depth (``--save npz``) bit for bit, and the JAX CLI's own bottom half,
whose depth differs from the port's by rounding (1e-4 relative), at all
but 2% of its pixels. Tolerance: none, but for that share.
"""
import importlib.util
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from dro_sfm_tpu import loggers as jloggers
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_tpu.utils.depth import viz_inv_depth as jax_viz
from dro_sfm_tpu.utils.save import save_depth as jax_save_depth
from dro_sfm_torch import loggers as tloggers
from dro_sfm_torch.scripts import infer
from dro_sfm_torch.utils.config import load_config
from dro_sfm_torch.utils.image_io import read_png
from dro_sfm_torch.utils.save import save_depth
from tests.test_torch_infer_cli import scene  # noqa: F401  (the checkpoint and frames)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch_and_output():
    rng = np.random.default_rng(0)
    batch = {"filename": ["scene/000001", "scene/000002", "scene/000003"],
             "rgb": rng.uniform(size=(3, 16, 20, 3)).astype(np.float32),
             "intrinsics": np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3)),
             "valid": np.array([True, False, True])}
    inv = rng.uniform(0.1, 0.5, size=(3, 16, 20, 1)).astype(np.float32)
    inv[0, :3] = 0.0
    return batch, {"inv_depth_pp": inv}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_depth_images_match_jax(tmp_path, as_tensor):
    batch, output = batch_and_output()
    flags = {"rgb": True, "viz": True, "npz": True, "png": True}
    jcfg = jax_load_config(overrides={"save": {"folder": str(tmp_path / "j"), "depth": flags}})
    tcfg = load_config(overrides={"save": {"folder": str(tmp_path / "t"), "depth": flags}})
    jax_save_depth(batch, output, jcfg.save)
    tout = {"inv_depth_pp": torch.from_numpy(output["inv_depth_pp"])} if as_tensor else output
    save_depth(batch, tout, tcfg.save)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 8
    for name in names:
        j, t = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
        if name.endswith("_rgb.png") or name.endswith("_viz.png"):
            assert np.array_equal(read_png(t), cv2.imread(j, cv2.IMREAD_COLOR)[..., ::-1])
        elif name.endswith(".png"):
            assert np.array_equal(read_png(t)[..., 0], cv2.imread(j, cv2.IMREAD_ANYDEPTH))
        else:
            a, b = np.load(t), np.load(j)
            assert all(np.array_equal(a[k], b[k]) for k in ("depth", "intrinsics"))


class FakeWandb(types.ModuleType):
    """A stand-in for ``wandb``: records what is logged."""

    def __init__(self):
        super().__init__("wandb")
        self.logged = []

    def init(self, **kwargs):
        return types.SimpleNamespace(config=types.SimpleNamespace(update=lambda *a, **k: None),
                                     finish=lambda: None)

    def Image(self, array):  # noqa: N802 (wandb's name)
        return ("image", np.array(array))

    def log(self, data, step=None):
        self.logged.append((data, step))


def test_log_depth_images_matches_jax(monkeypatch):
    batch, output = batch_and_output()
    logged = {}
    for name, module, out in (("jax", jloggers, output),
                              ("port", tloggers,
                               {"inv_depth_pp": torch.from_numpy(output["inv_depth_pp"])})):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        logger = module.WandbLogger(name="run")
        logger.log_depth_images("val", batch, out, step=7)
        logged[name] = fake.logged
    (jdata, jstep), = logged["jax"]
    (tdata, tstep), = logged["port"]
    assert jstep == tstep == 7 and sorted(jdata) == sorted(tdata) == ["val-inv_depth", "val-rgb"]
    for key in jdata:
        assert tdata[key][1].dtype == jdata[key][1].dtype
        assert np.array_equal(tdata[key][1], jdata[key][1])


def jax_cli(path, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_infer_cli", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    module.main()


def test_infer_save_viz(scene, tmp_path, monkeypatch):  # noqa: F811
    common = ["--checkpoint", scene["ckpt"], "--input", scene["frames"]]
    written = infer.main(common + ["--output", str(tmp_path / "t"), "--save", "viz",
                                   "--device", "cpu"])
    infer.main(common + ["--output", str(tmp_path / "n"), "--device", "cpu"])
    jax_cli(os.path.join(REPO, "scripts", "infer.py"),
            common + ["--output", str(tmp_path / "j"), "--save", "viz"], monkeypatch)
    assert len(written) == len(os.listdir(scene["frames"])) == 5
    for path in written:
        name = os.path.basename(path)
        got = read_png(path)
        want = cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_COLOR)[..., ::-1]
        h = got.shape[0] // 2
        assert got.shape == want.shape and np.array_equal(got[:h], want[:h])
        depth = np.load(str(tmp_path / "n" / name.replace("_viz.png", ".npz")))["depth"]
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0)
        assert np.array_equal(got[h:], (jax_viz(inv) * 255).astype(np.uint8))
        assert (got[h:] != want[h:]).any(-1).mean() <= 0.02
