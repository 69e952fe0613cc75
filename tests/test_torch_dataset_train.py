"""Training and evaluation from dataset files, against the JAX package (fp32, CPU).

The slice as a whole at a small size. A ScanNet-layout tree of JPEG frames
(48x64, millimetre depth at 24x32) and a KITTI-layout tree of PNG frames with
16-bit ground truth (`tests/test_torch_datasets.py` writes both) feed:

* one ``SupModelMF`` training step at ``it8-h-out`` (Adam, flip off) on a
  B=2 batch of the port's ``Scannet`` reader (resized to 32x48, jittered),
  and the JAX package's step on its own reader's batch, from the same
  weights (`from_jax_variables`): the batches equal bit for bit, the loss
  and its terms within 1e-4 relative;
* one evaluation step on a B=2 batch of ``ScannetTest`` (images at 32x48,
  ground truth at 48x64): the metrics within 1e-4;
* `Trainer.fit` for one step and one validation on the KITTI tree through
  ``setup_dataset``, from the config's own initialisation: finite loss and
  metrics, a checkpoint written.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.data import collate as jax_collate
from dro_sfm_tpu.data import setup_dataset as jax_setup
from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.metrics import MetricsConfig as JaxMetricsConfig
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.training.step import make_eval_step as jax_make_eval_step
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.data import collate, setup_dataset
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.metrics import MetricsConfig
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_eval_step, make_train_step
from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config
from tests.test_torch_datasets import kitti_tree, scannet_tree
from tests.test_torch_modules import fill_variables
from tests.test_torch_train_step import key_with_flip

torch.set_num_threads(4)
SHAPE = (32, 48)
CFG = dict(name="SupModelMF", version="it8-h-out", min_depth=0.2, max_depth=10.0,
           flip_lr_prob=0.5, mixed_precision=False, warp_impl="gather",
           sep_conv="split", remat=False)
METRICS = dict(crop="", min_depth=0.2, max_depth=10.0)
KEYS = ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")


def batches(root, mode, name, split):
    key = "train" if mode == "train" else "validation"
    section = {"dataset": [name], "path": [root], "split": [split],
               "depth_type": ["groundtruth"], "back_context": 1, "forward_context": 1}
    aug = {"image_shape": list(SHAPE), "jittering": [0.2, 0.2, 0.2, 0.05]}
    out = []
    for setup, load, stack in ((setup_dataset, load_config, collate),
                               (jax_setup, jax_load_config, jax_collate)):
        cfg = load(overrides={"datasets": {"augmentation": aug, key: section}})
        ds = setup(cfg.datasets[key], cfg.datasets.augmentation, mode)
        ds = ds if mode == "train" else ds[0]
        batch = stack([ds[i] for i in range(2)])
        out.append({k: batch[k] for k in KEYS})
    ours, ref = out
    for k in KEYS:
        assert np.array_equal(ours[k], ref[k]), k
    return ours, ref


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    root = scannet_tree(tmp_path_factory.mktemp("scannet"))
    train, jtrain = batches(root, "train", "Scannet", "train_split.txt")
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(jtrain[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    return root, train, jtrain, jcfg, jnet, variables


def port_net(variables):
    tcfg = tsfm.SfmModelConfig(**{**CFG, "warp_impl": "pallas"})
    net = tcfg.build_net(device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return tcfg, net


def test_train_step_on_scannet_files_matches_jax(scannet):
    _, batch, jbatch, jcfg, jnet, variables = scannet
    assert batch["rgb"].shape == (2, *SHAPE, 3) and batch["depth"].shape == (2, *SHAPE, 1)
    cfg = load_config()
    key = key_with_flip(False, fold=0)
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    jstate = j_create_state(jnet, key, None, tx, init_variables=variables)
    _, jmetrics = j_make_train_step(jcfg, jnet)(
        jstate, {k: jnp.asarray(v) for k, v in jbatch.items()}, key)

    tcfg, net = port_net(variables)
    opt = make_optimizer(net, cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    state = create_train_state(net, opt, device="cpu")
    state, metrics = make_train_step(tcfg, net, opt, device="cpu")(state, batch, None,
                                                                   do_flip=False)
    assert state.step == 1
    for name in ("loss", "depth_loss", "pose_loss"):
        got, want = float(metrics[name]), float(jmetrics[name])
        assert np.isfinite(got) and got > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)


def test_eval_step_on_scannet_files_matches_jax(scannet):
    root, _, _, jcfg, jnet, variables = scannet
    batch, jbatch = batches(root, "validation", "ScannetTest", "tuples.txt")
    assert batch["rgb"].shape == (2, *SHAPE, 3) and batch["depth"].shape == (2, 48, 64, 1)
    ref = jax_make_eval_step(jcfg, jnet, JaxMetricsConfig(**METRICS))(
        variables, {k: jnp.asarray(v) for k, v in jbatch.items()})
    tcfg, net = port_net(variables)
    out = make_eval_step(tcfg, net, MetricsConfig(**METRICS), device="cpu")(batch)
    got, want = out["metrics"].numpy(), np.asarray(ref["metrics"])
    assert got.shape == want.shape == (4, 2, 9) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_trainer_fits_a_kitti_tree(tmp_path):
    root = kitti_tree(tmp_path)
    section = {"dataset": ["KITTI"], "path": [root], "split": ["split.txt"],
               "depth_type": ["groundtruth"], "back_context": 1, "forward_context": 1,
               "batch_size": 4, "num_workers": 2}
    evaluation = {**section, "back_context": 0, "batch_size": 2}
    cfg = load_config(overrides={
        "arch": {"max_epochs": 1},
        "checkpoint": {"filepath": str(tmp_path / "ckpt")},
        "save": {"folder": str(tmp_path / "save")},
        "model": {"name": "SupModelMF", "depth_net": {"version": "it4-h-out",
                                                      "mixed_precision": False},
                  "params": {"crop": "garg", "min_depth": 0.2, "max_depth": 80.0}},
        "datasets": {"augmentation": {"image_shape": list(SHAPE)}, "train": section,
                     "validation": evaluation, "test": evaluation}})
    trainer = Trainer(cfg, device="cpu")
    assert len(trainer.train_loader) == 1
    metrics = trainer.fit()
    assert trainer.state.step == 1
    assert np.isfinite(metrics["avg_train-loss"]) and np.isfinite(metrics["abs_rel_pp_gt"])
    assert list((tmp_path / "ckpt").rglob("*.ckpt"))
