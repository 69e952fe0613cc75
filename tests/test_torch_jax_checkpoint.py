"""Checkpoints written by the JAX package, read by the port (fp32, CPU).

The JAX package makes ``SupModelMF`` at ``it2-seq2-h-out`` (64x96) from
`fill_variables` weights, takes one update of its optimizer (Adam behind the
global-norm clip, as `configs/train_synthetic_192x640.yaml` sets it) with
seeded gradients and writes the state with its own ``save_checkpoint``.
The port must

* load it strictly through `load_model` and `load_checkpoint`, with a state
  dict bit-equal to `from_jax_variables` of the JAX tree, and serve it
  within 1e-4 (relative L2, fp32) of the JAX ``load_model`` and
  ``make_infer_fn``;
* migrate the legacy layout (``mask1``/``mask2`` under the update cell);
* resume it: Adam's moments bit-equal to the transposed ``mu``/``nu``, the
  step and each parameter's Adam count equal to the file's (one more step
  in both packages: `test_torch_jax_resume.py`);
* where the optimizer's layout differs (no clip; an empty ``opt_state``),
  restore the weights and the step only and print the JAX package's note;
* evaluate it with the eval CLI (``--device cpu``), as the trainer
  evaluates the same weights loaded directly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_tpu.inference import load_model as jax_load_model
from dro_sfm_tpu.inference import make_infer_fn as jax_make_infer_fn
from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.inference import load_model, load_model_and_config, make_infer_fn
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.scripts import eval as eval_cli
from dro_sfm_torch.training.checkpoint import LAYOUT_NOTE, load_checkpoint
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from tests.test_torch_modules import fill_variables
from tests.test_torch_train_step import make_batch

torch.set_num_threads(4)
VERSION = "it2-seq2-h-out"
H, W = 64, 96                               # test_torch_train_step.make_batch's
CFG = dict(name="SupModelMF", version=VERSION, min_depth=0.2, max_depth=20.0,
           flip_lr_prob=0.0, mixed_precision=False, warp_impl="gather",
           sep_conv="split", remat=False)
STEPS_PER_EPOCH = 2


def config(tmp, clip=1.0):
    evaluation = {"dataset": ["Synthetic"], "path": ["7"], "split": ["2"],
                  "batch_size": 2, "num_workers": 1}
    return jax_load_config(overrides={
        "checkpoint": {"filepath": str(tmp / "ckpt")},
        "save": {"folder": str(tmp / "save")},
        "model": {"name": "SupModelMF", "optimizer": {"clip_grad_norm": clip},
                  "depth_net": {"version": VERSION},
                  "loss": {"flip_lr_prob": 0.0},
                  "params": {"min_depth": 0.2, "max_depth": 20.0, "crop": ""}},
        "datasets": {"augmentation": {"image_shape": (H, W)},
                     "validation": evaluation}})


def jax_state(cfg, batch):
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler, STEPS_PER_EPOCH)
    state = j_create_state(jnet, jax.random.PRNGKey(0), None, tx, init_variables=variables)
    return jcfg, jnet, state


def saved_trees(state):
    return jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": serialization.to_state_dict(state.opt_state)})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One update of the JAX package's optimizer with seeded gradients,
    saved by its ``save_checkpoint`` (epoch 3)."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    cfg = config(tmp)
    _, _, state = jax_state(cfg, make_batch())
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), state.params)
    state = jax.jit(lambda s, g: s.apply_gradients(g))(state, grads)
    path = str(tmp / "jax.ckpt")
    jax_save_checkpoint(path, state, epoch=3, config=cfg.to_dict())
    return {"path": path, "cfg": cfg, "saved": saved_trees(state)}


def port_state(cfg, seed=5):
    tcfg = tsfm.SfmModelConfig(**{**CFG, "warp_impl": "pallas"})
    net = tcfg.build_net(device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(net, cfg.model.optimizer, cfg.model.scheduler, STEPS_PER_EPOCH)
    return tcfg, create_train_state(net, opt, device="cpu")


def assert_state_dict_equal(got, want):
    assert got.keys() == want.keys()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


def test_load_model_is_strict_and_bit_equal(trained):
    net, cfg = load_model_and_config(trained["path"], device="cpu")
    assert (net.version, net.min_depth, net.max_depth) == (VERSION, 0.2, 20.0)
    assert (net.mixed_precision, net.warp_impl, net.sep_conv) == (False, "pallas", "split")
    assert tuple(cfg.datasets.augmentation.image_shape) == (H, W)
    want = from_jax_variables(trained["saved"])
    assert_state_dict_equal(net.state_dict(), want)
    assert_state_dict_equal(load_model(trained["path"], device="cpu").state_dict(), want)
    payload = load_checkpoint(trained["path"])["payload"]
    assert_state_dict_equal(from_jax_variables(payload), want)


def test_served_outputs_match_the_jax_package(trained):
    jnet, variables, _ = jax_load_model(trained["path"])
    batch = make_batch(seed=1)
    args = [batch["rgb"][:1], batch["rgb_context"][:1], batch["intrinsics"][:1]]
    depth_ref, mats_ref = jax_make_infer_fn(jnet)(variables, *map(jnp.asarray, args))
    depth, mats = make_infer_fn(load_model(trained["path"], device="cpu"), device="cpu")(*args)
    for got, want in ((depth[0], depth_ref), (mats[0], mats_ref)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert got.shape == want.shape and rel <= 1e-4, rel


def test_legacy_mask_layout_is_migrated(trained, tmp_path):
    """Before the mask head was hoisted, its convs sat under the depth
    update cell, in the params and in every optimizer moment."""
    raw = serialization.msgpack_restore(open(trained["path"], "rb").read())

    def to_legacy(tree):
        if isinstance(tree, dict):
            ref = tree.get("refinement")
            if isinstance(ref, dict) and "mask_head" in ref:
                ref["update_block_depth"]["cell"].update(ref.pop("mask_head"))
            for v in tree.values():
                to_legacy(v)

    to_legacy(raw)
    assert "mask1" in raw["params"]["refinement"]["update_block_depth"]["cell"]
    path = str(tmp_path / "legacy.ckpt")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(raw))
    _, state = port_state(trained["cfg"])
    load_checkpoint(path, state)
    assert_state_dict_equal(state.net.state_dict(), from_jax_variables(trained["saved"]))
    assert state.optimizer.torch_optimizer.state          # the moments migrated too


def test_resume_restores_adam_moments_and_step(trained):
    cfg = trained["cfg"]
    _, state = port_state(cfg)
    restored = load_checkpoint(trained["path"], state)
    assert restored["meta"]["epoch"] == 3 and state.step == 1
    assert_state_dict_equal(state.net.state_dict(), from_jax_variables(trained["saved"]))
    adam = trained["saved"]["opt_state"]["1"]["inner_states"]["depth"]["inner_state"]["0"]
    stats = trained["saved"]["batch_stats"]
    opt_state = state.optimizer.torch_optimizer.state
    for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
        want = from_jax_variables({"params": tree, "batch_stats": stats})
        for name, p in state.net.named_parameters():
            assert torch.equal(opt_state[p][key], want[name]), (key, name)
            assert float(opt_state[p]["step"]) == float(adam["count"]) == 1.0


@pytest.mark.parametrize("case", ["no_clip", "empty_opt_state"])
def test_other_optimizer_layout_restores_weights_and_step(trained, tmp_path, capsys, case):
    path = trained["path"]
    cfg = trained["cfg"]
    if case == "no_clip":
        cfg = config(tmp_path, clip=0.0)
    else:
        raw = serialization.msgpack_restore(open(path, "rb").read())
        raw["opt_state"] = serialization.to_state_dict(())
        path = str(tmp_path / "weights_only.ckpt")
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(raw))
    _, state = port_state(cfg)
    load_checkpoint(path, state)
    assert LAYOUT_NOTE in capsys.readouterr().out
    assert state.step == 1 and not state.optimizer.torch_optimizer.state
    assert_state_dict_equal(state.net.state_dict(), from_jax_variables(trained["saved"]))


def test_eval_cli_reads_the_jax_checkpoint(trained, capsys):
    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import ConfigNode, prepare_config
    metrics = eval_cli.main(["--checkpoint", trained["path"], "--device", "cpu"])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    meta = json.load(open(trained["path"] + ".json"))
    trainer = Trainer(prepare_config(ConfigNode(meta["config"])), device="cpu")
    trainer.net.load_state_dict(from_jax_variables(trained["saved"]), strict=True)
    direct = trainer.validate()
    assert metrics["abs_rel_pp_gt"] == direct["abs_rel_pp_gt"]

