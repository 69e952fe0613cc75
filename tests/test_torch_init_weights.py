"""Warm starts of the port against the JAX package's (CPU).

Mirrors `tests/test_init_weights.py`: the converted ResNet-18 trunk grafted
onto the three encoders (conv1 replicated and halved for the pose encoder's
image pair), nonsense rejected, partial loads with a skipped shape and with
a prefix remap. Every result of the port's functions, carried into the
port by `from_jax_variables`, is bit-equal to the JAX function's result on
the same input. Then the trainer: ``model.depth_net.pretrained_encoders``
and ``model.checkpoint_path`` (a file the JAX package wrote) warm-start the
net, in the JAX order; and ``model.percep_net.checkpoint_path``: the
perceptual net loads a VGG16 tree the JAX package wrote, strictly, and its
distance is within 1e-5 (absolute, on distances of order 1) of the JAX
``PercepNet``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
from dro_sfm_tpu.training import init_weights as jiw
from dro_sfm_torch.convert import from_jax_variables, to_jax_variables
from dro_sfm_torch.losses.photometric import PhotometricLossConfig
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from dro_sfm_torch.models.sfm import SfmModelConfig, make_percep_fn
from dro_sfm_torch.training import init_weights as tiw
from tests.test_init_weights import _trunk_tree
from tests.test_torch_modules import fill_variables

torch.set_num_threads(2)
VERSION = "it2-seq2-h-out"


@pytest.fixture(scope="module")
def small_vars():
    """The variables of the JAX net, shaped without running its init."""
    net = JaxNet(version=VERSION)
    zeros = jnp.zeros((1, 32, 48, 3), jnp.float32)
    v = fill_variables(lambda k: net.init(k, zeros, jnp.zeros((1, 2, 32, 48, 3)),
                                          jnp.eye(3)[None], train=False))
    return jax.tree.map(np.asarray, serialization.to_state_dict(v))


def assert_same_after_conversion(got, want):
    got, want = from_jax_variables(got), from_jax_variables(want)
    assert got.keys() == want.keys()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


def write_msgpack(path, tree):
    path.write_bytes(serialization.msgpack_serialize(jax.tree.map(np.asarray, tree)))
    return str(path)


def test_graft_pretrained_encoders(small_vars):
    trunk, sd = _trunk_tree()
    out = tiw.graft_pretrained_encoders(small_vars, trunk, verbose=False)
    assert_same_after_conversion(out, jiw.graft_pretrained_encoders(
        small_vars, trunk, verbose=False))
    w_src = np.transpose(sd["conv1.weight"], (2, 3, 1, 0))
    pose_k = out["params"]["cnet_pose"]["conv1"]["kernel"]
    np.testing.assert_array_equal(pose_k[:, :, :3], w_src / 2)
    np.testing.assert_array_equal(out["params"]["fnet"]["conv1"]["kernel"], w_src)
    np.testing.assert_array_equal(out["params"]["fnet"]["out_conv"]["kernel"],
                                  small_vars["params"]["fnet"]["out_conv"]["kernel"])


def test_graft_rejects_nonsense(small_vars):
    with pytest.raises(ValueError, match="matched nothing"):
        tiw.graft_pretrained_encoders(
            small_vars, {"params": {"nope": {"kernel": np.zeros((1,))}},
                         "batch_stats": {}}, verbose=False)


def test_partial_network_load(tmp_path, small_vars):
    donor = jax.tree.map(lambda x: np.asarray(x) * 0 + 7.0, small_vars)
    payload = {"payload": {"params": donor["params"], "batch_stats": donor["batch_stats"]}}
    payload["payload"]["params"]["depth_head"]["conv1"]["kernel"] = \
        np.zeros((1, 1, 1, 1), np.float32)
    path = write_msgpack(tmp_path / "donor.msgpack", payload)
    out = tiw.load_partial_network(small_vars, path, verbose=False)
    assert_same_after_conversion(out, jiw.load_partial_network(small_vars, path,
                                                               verbose=False))
    np.testing.assert_array_equal(out["params"]["fnet"]["conv1"]["kernel"], 7.0)
    np.testing.assert_array_equal(out["params"]["depth_head"]["conv1"]["kernel"],
                                  small_vars["params"]["depth_head"]["conv1"]["kernel"])


def test_partial_load_with_remap(tmp_path, small_vars):
    fnet = jax.tree.map(lambda x: np.asarray(x) * 0 + 3.0, small_vars["params"]["fnet"])
    path = write_msgpack(tmp_path / "prefixed.msgpack",
                         {"params": {"model": {"depth_net": {"fnet": fnet}}},
                          "batch_stats": {}})
    remap = {"model/depth_net": ""}
    out = tiw.load_partial_network(small_vars, path, remap=remap, verbose=False)
    assert_same_after_conversion(out, jiw.load_partial_network(
        small_vars, path, remap=remap, verbose=False))
    np.testing.assert_array_equal(out["params"]["fnet"]["conv1"]["kernel"], 3.0)
    with pytest.raises(ValueError, match="matched nothing"):
        tiw.load_partial_network(small_vars, path, verbose=False)


def test_partial_load_takes_a_port_checkpoint(tmp_path, small_vars):
    """A checkpoint of the port (a zip file) is adopted like the JAX one."""
    from dro_sfm_torch.training.checkpoint import save_checkpoint
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    net = DepthPoseNet(version=VERSION, device="cpu", generator=torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "port.ckpt"),
                    create_train_state(net, make_optimizer(net), device="cpu"), epoch=0)
    out = tiw.load_partial_network(small_vars, str(tmp_path / "port.ckpt"), verbose=False)
    want = net.state_dict()
    got = from_jax_variables(out)
    assert all(torch.equal(got[k], want[k]) for k in want if "num_batches" not in k)


def test_trainer_warm_starts_from_both_config_keys(tmp_path, capsys):
    """pretrained_encoders first, then the partial load of checkpoint_path
    (which wins where both write): the JAX trainer's order."""
    from dro_sfm_torch.training.trainer import Trainer
    from tests.test_torch_trainer import tiny_config
    fresh = Trainer(tiny_config(tmp_path / "a"), device="cpu").net.state_dict()
    trunk, _ = _trunk_tree()
    trunk_path = write_msgpack(tmp_path / "r18.msgpack", trunk)
    donor = to_jax_variables(fresh)
    donor["params"]["fnet"]["conv1"]["kernel"] = donor["params"]["fnet"]["conv1"]["kernel"] * 0 + 5
    donor["params"]["depth_head"] = jax.tree.map(lambda x: x * 0 - 1.0,
                                                 donor["params"]["depth_head"])
    donor_path = write_msgpack(tmp_path / "donor.ckpt", {
        "params": {"fnet": {"conv1": donor["params"]["fnet"]["conv1"]},
                   "depth_head": donor["params"]["depth_head"]}, "batch_stats": {}})
    trainer = Trainer(tiny_config(tmp_path / "b", model={
        "checkpoint_path": donor_path,
        "depth_net": {"pretrained_encoders": trunk_path}}), device="cpu")
    out = capsys.readouterr().out
    assert out.index("pretrained encoders: grafted") < out.index("partial load from")
    want = from_jax_variables(jiw.load_partial_network(
        jiw.graft_pretrained_encoders(to_jax_variables(fresh), trunk, verbose=False),
        donor_path, verbose=False))
    got = trainer.net.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if "num_batches" not in k)
    assert float(got["fnet.conv1.weight"].max()) == 5.0
    assert not torch.equal(got["cnet_pose.conv1.weight"], fresh["cnet_pose.conv1.weight"])


def test_percep_net_reads_a_jax_vgg16_tree(tmp_path):
    rng = np.random.default_rng(4)
    im1 = rng.uniform(size=(2, 40, 56, 3)).astype(np.float32)
    im2 = rng.uniform(size=(2, 40, 56, 3)).astype(np.float32)
    jnet = JaxPercepNet()
    pvars = fill_variables(lambda k: jnet.init(k, jnp.asarray(im1), jnp.asarray(im2)), seed=1)
    path = write_msgpack(tmp_path / "vgg16.msgpack", serialization.to_state_dict(pvars))
    cfg = SfmModelConfig(name="SelfSupModelMF", percep_pretrained=path,
                         photometric=PhotometricLossConfig(percep_loss_weight=0.1))
    tnet = make_percep_fn(cfg, device="cpu")
    want = from_jax_variables(jax.tree.map(np.asarray, pvars))
    assert all(torch.equal(v, want[k]) for k, v in tnet.state_dict().items())
    ref = np.asarray(jnet.apply(pvars, jnp.asarray(im1), jnp.asarray(im2)))
    got = tnet(torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
