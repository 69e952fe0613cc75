"""The port's copies of the torch-weight maps and writers
(`dro_sfm_torch/torch_weights.py`, `scripts/convert_torch_weights.py`)
against `tools/convert_torch_weights.py` (CPU, no download).

Trees are compared leaf by leaf (keys, dtype, shape, bits); files byte for
byte. The inputs: `tests/test_convert_weights.py:_TorchTrunk`'s state dict
(torchvision's ResNet-18 names), random arrays under VGG16's names, and a
reference-named DRO state dict made by inverting the map on seed-0
`fill_variables` of the JAX `DepthPoseNet` (`tests/_torch_reference_ckpt.py`).
The JAX tool reads its input with ``torch.load``'s defaults, which cannot
read a config pickled as ``yacs.config.CfgNode`` without yacs (absent
here and on the card), so it reads a fixture whose config is a plain dict;
the port reads that fixture and the same one written with a ``CfgNode``
config, and must give the same tree, config and files from both.
"""
import importlib.machinery
import json
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_torch import torch_weights as tw
from dro_sfm_torch.scripts import convert_torch_weights as cli
from tests._torch_reference_ckpt import (
    reference_state_dict,
    write_foreign_ckpt,
    write_reference_ckpt,
)
from tests.test_convert_weights import _TorchTrunk
from tests.test_torch_modules import fill_variables
from tools import convert_torch_weights as tool

VERSION = "it4-h-out-seq2"
H, W = 48, 64
CONFIG = {"model": {"name": "SupModelMF",
                    "depth_net": {"name": "DepthPoseNet", "version": VERSION},
                    "params": {"min_depth": 0.2, "max_depth": 20.0, "crop": ""}},
          "datasets": {"augmentation": {"image_shape": [H, W]}}}
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256))


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            assert np.array_equal(g, w), f"{path}/{k}"


def trunk_state():
    torch.manual_seed(0)
    net = _TorchTrunk()
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return net.state_dict()


def vgg_state():
    rng = np.random.default_rng(1)
    sd = {}
    for idx, cin, cout in VGG_CONVS:
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(size=(cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(size=(cout,)).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def dro_variables():
    jnet = JaxNet(version=VERSION, warp_impl="gather")
    x = (jnp.zeros((1, H, W, 3)), jnp.zeros((1, 2, H, W, 3)), jnp.eye(3)[None])
    return fill_variables(lambda k: jnet.init(k, *x, train=False))


@pytest.fixture(scope="module")
def dro_files(tmp_path_factory, dro_variables):
    """The reference-named state dict, and checkpoints of it with a plain
    and a CfgNode config."""
    root = tmp_path_factory.mktemp("dro")
    sd = reference_state_dict(dro_variables)
    plain, yacs = str(root / "plain.ckpt"), str(root / "yacs.ckpt")
    write_reference_ckpt(plain, sd, CONFIG, epoch=3, yacs=False)
    write_reference_ckpt(yacs, sd, CONFIG, epoch=3, yacs=True)
    return sd, plain, yacs


@pytest.mark.parametrize("num_images", [1, 2])
def test_resnet18_tree_equals_the_tool(num_images):
    sd = {k: v.numpy() for k, v in trunk_state().items()}
    assert_trees_equal(tw.convert_resnet18_encoder(sd, num_images),
                       tool.convert_resnet18_encoder(sd, num_images))


def test_vgg16_tree_equals_the_tool():
    sd = {k: v.numpy() for k, v in vgg_state().items()}
    assert_trees_equal(tw.convert_vgg16_percep(sd), tool.convert_vgg16_percep(sd))


def test_dro_tree_equals_the_tool_and_inverts(dro_files, dro_variables):
    sd = dro_files[0]
    got = tw.convert_dro_checkpoint(sd)
    assert_trees_equal(got, tool.convert_dro_checkpoint(sd))
    # the map inverts the test's inverse: the seed-0 variables come back
    assert_trees_equal(got, jax_tree_numpy(dro_variables))


def jax_tree_numpy(tree):
    return {k: jax_tree_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_reference_ckpt_reads_the_yacs_config(dro_files):
    """The ``CfgNode`` fixture gives the plain fixture's state dict and
    config; its nodes are plain dicts."""
    sd, plain, yacs_ckpt = dro_files
    a, b = tw.read_reference_ckpt(plain), tw.read_reference_ckpt(yacs_ckpt)
    assert tw.reference_config(b) == tw.reference_config(a) == CONFIG
    assert isinstance(b["config"], dict) and isinstance(b["config"]["model"], dict)
    assert type(b["config"]).__name__ == "ReferenceConfig"
    assert tw.reference_epoch(b) == 3
    sa, sb = tw.state_arrays(a), tw.state_arrays(b)
    assert set(sa) == set(sb) == set(sd)
    for k in sd:
        assert np.array_equal(sa[k], sb[k]) and np.array_equal(sb[k], sd[k]), k
    # no yacs is installed, and the fixture took its stand-in away again (an oracle test
    # file run earlier in this process may have left tests/reference_shim.py's sentinel,
    # whose CfgNode is not the fixture's)
    assert importlib.machinery.PathFinder.find_spec("yacs") is None
    node = getattr(sys.modules.get("yacs.config"), "CfgNode", None)
    assert node is None or node.__module__ != "yacs.config"
    with pytest.raises(pickle.UnpicklingError):
        torch.load(yacs_ckpt, weights_only=True)


def test_reference_ckpt_refuses_a_foreign_global(tmp_path):
    path = str(tmp_path / "foreign.ckpt")
    write_foreign_ckpt(path)
    with pytest.raises(pickle.UnpicklingError, match="foreign.payload.Payload"):
        tw.read_reference_ckpt(path)


def test_torch_state_reader_is_weights_only(tmp_path, dro_files):
    path = str(tmp_path / "trunk.pth")
    torch.save(trunk_state(), path)
    sd = tw.state_arrays(tw.read_torch_state(path))
    assert all(np.array_equal(sd[k], v.numpy()) for k, v in trunk_state().items())
    with pytest.raises(pickle.UnpicklingError):
        tw.read_torch_state(dro_files[2])


@pytest.mark.parametrize("kind", ["resnet18", "vgg16", "dro-ckpt"])
def test_cli_msgpack_bytes_equal_flax(tmp_path, kind, dro_files, capsys):
    """The CLI's ``.msgpack`` equals ``flax.serialization.msgpack_serialize``
    of the tool's tree, and its load check runs on the CPU."""
    if kind == "dro-ckpt":
        src, yacs_src = dro_files[1], dro_files[2]
        sd = tw.state_arrays(torch.load(src))
        want = tool.convert_dro_checkpoint(sd)
    else:
        src = yacs_src = str(tmp_path / f"{kind}.pth")
        state = trunk_state() if kind == "resnet18" else vgg_state()
        torch.save(state, src)
        sd = {k: v.numpy() for k, v in state.items()}
        want = (tool.convert_resnet18_encoder(sd) if kind == "resnet18"
                else tool.convert_vgg16_percep(sd))
    expected = serialization.msgpack_serialize(want)
    for i, path in enumerate((src, yacs_src)):
        dst = str(tmp_path / f"out{i}.msgpack")
        cli.main([kind, path, dst, "--device", "cpu"])
        with open(dst, "rb") as f:
            assert f.read() == expected
    assert "load check on cpu" in capsys.readouterr().out


def test_eval_ready_ckpt_equals_the_tool(tmp_path, dro_files, capsys):
    """``dro-ckpt`` to ``.ckpt``: the bytes equal `emit_framework_ckpt`'s
    (flax msgpack of params, batch_stats, an empty opt_state and step 0),
    the sidecars equal as parsed JSON, from either fixture; `load_model`
    takes it on the CPU."""
    _, plain, yacs = dro_files
    raw = torch.load(plain)
    sd = tw.state_arrays(raw)
    jax_dst = str(tmp_path / "jax.ckpt")
    tool.emit_framework_ckpt(tool.convert_dro_checkpoint(sd), jax_dst, raw["config"],
                             epoch=raw["epoch"])
    with open(jax_dst, "rb") as f:
        want = f.read()
    with open(jax_dst + ".json") as f:
        want_meta = json.load(f)
    assert want_meta["config"]["model"]["depth_net"]["version"] == VERSION
    for name, src in (("plain", plain), ("yacs", yacs)):
        dst = str(tmp_path / f"{name}.ckpt")
        cli.main(["dro-ckpt", src, dst, "--device", "cpu"])
        with open(dst, "rb") as f:
            assert f.read() == want, name
        with open(dst + ".json") as f:
            assert json.load(f) == want_meta, name
    assert f"load_model: DepthPoseNet {VERSION}" in capsys.readouterr().out


def test_cli_refuses_missing_cuda(tmp_path, dro_files):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the CLI would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["dro-ckpt", dro_files[2], str(tmp_path / "x.ckpt")])
