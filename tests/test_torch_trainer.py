"""The port's trainer and CLIs on the CPU (``device="cpu"``).

``SupModelMF`` at ``it4-h-out``, 32x48, synthetic scenes: an epoch that
trains, validates and writes its top-k checkpoint; a resume into the next
epoch that ends bit for bit where an uninterrupted run ends; the SIGTERM
emergency checkpoint; the padded evaluation tail; the train CLI in a
subprocess and the eval CLI on its checkpoint; depth files as ``save.depth``
asks; what is refused raises (spatial shards that do not divide the world
size, an unknown dataset), and the rgb and viz images. Warm starts from the
JAX package's files are held in `test_torch_init_weights.py`.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dro_sfm_torch.data import make_loader
from dro_sfm_torch.scripts import eval as eval_cli
from dro_sfm_torch.scripts import train as train_cli
from dro_sfm_torch.training.metrics import DEPTH_METRIC_NAMES
from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TINY_YAML = """\
name: 'tiny'
arch:
    max_epochs: {epochs}
checkpoint:
    filepath: '{ckpt}'
    save_top_k: 2
model:
    name: 'SupModelMF'
    depth_net:
        name: 'DepthPoseNet'
        version: 'it4-h-out'
        mixed_precision: False
    loss:
        flip_lr_prob: 0.5
    params:
        min_depth: 0.2
        max_depth: 20.0
save:
    folder: '{save}'
    depth:
        png: False
        rgb: False
        viz: False
datasets:
    augmentation:
        image_shape: (32, 48)
    train:
        batch_size: 2
        num_workers: 2
        dataset: ['Synthetic']
        path: ['0']
        split: ['4']
    validation:
        batch_size: 2
        num_workers: 2
        dataset: ['Synthetic']
        path: ['7']
        split: ['3']
        back_context: 1
        forward_context: 1
    test:
        batch_size: 2
        num_workers: 2
        dataset: ['Synthetic']
        path: ['7']
        split: ['3']
        back_context: 1
        forward_context: 1
"""


def tiny_yaml(tmp_path, name="tiny.yaml", epochs=1):
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / name
    path.write_text(TINY_YAML.format(epochs=epochs, ckpt=tmp_path / "ckpt",
                                     save=tmp_path / "save"))
    return path


def tiny_config(tmp_path, epochs=1, **overrides):
    return load_config(str(tiny_yaml(tmp_path, epochs=epochs)), overrides)


def state_of(trainer):
    moments = trainer.optimizer.torch_optimizer.state
    return ({k: v.clone() for k, v in trainer.net.state_dict().items()},
            [{k: v.clone() for k, v in moments[p].items()} for p in trainer.net.parameters()],
            trainer.state.step)


def assert_same(a, b):
    assert a[2] == b[2]
    assert not [k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1]) for k in x)


def ckpts(trainer):
    return sorted(Path(trainer.checkpointer.dirpath).glob("*.ckpt"))


def test_fit_resume_matches_an_uninterrupted_run(tmp_path):
    straight = Trainer(tiny_config(tmp_path / "a", epochs=2), device="cpu")
    metrics = straight.fit()
    assert straight.state.step == 4 and straight.current_epoch == 1
    assert np.isfinite(metrics["avg_train-loss"]) and metrics["train_frames_per_sec"] > 0
    assert all(np.isfinite(metrics[f"{m}{mode}"]) for m in DEPTH_METRIC_NAMES
               for mode in ("", "_pp", "_gt", "_pp_gt"))
    assert "abs_rel_pp_gt-0" in metrics

    first = Trainer(tiny_config(tmp_path / "b", epochs=1), device="cpu")
    first.fit()
    (path,) = ckpts(first)
    assert path.name.startswith("epoch=00_abs_rel_pp_gt=")
    meta = json.loads(Path(str(path) + ".json").read_text())
    assert (meta["epoch"], meta["step"], meta["config"]["name"]) == (0, 2, "tiny")
    resumed = Trainer(tiny_config(tmp_path / "b", epochs=2), resume=str(path), device="cpu")
    assert resumed.current_epoch == 1 and resumed.state.step == 2
    assert_same(state_of(resumed), state_of(first))
    resumed.fit()
    assert_same(state_of(resumed), state_of(straight))
    assert len(ckpts(resumed)) == 2


def test_sigterm_saves_an_emergency_checkpoint(tmp_path):
    trainer = Trainer(tiny_config(tmp_path, epochs=2), device="cpu")
    step = trainer.train_step

    def step_then_sigterm(*args, **kwargs):
        out = step(*args, **kwargs)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    assert trainer.fit() == {}
    assert signal.getsignal(signal.SIGTERM) is before
    path = Path(trainer.checkpointer.dirpath) / "preempt_epoch=00.ckpt"
    assert [p.name for p in ckpts(trainer)] == [path.name]
    assert trainer.state.step == 1
    resumed = Trainer(tiny_config(tmp_path, epochs=2), resume=str(path), device="cpu")
    assert resumed.current_epoch == 0 and resumed.state.step == 1   # re-runs epoch 0
    assert_same(state_of(resumed), state_of(trainer))


def test_validation_counts_the_padded_tail_once(tmp_path):
    trainer = Trainer(tiny_config(tmp_path), device="cpu")
    ds = trainer.val_datasets[0]
    padded = trainer.validate(make_loader(ds, 2, "validation", num_workers=1))
    single = trainer.validate(make_loader(ds, 1, "validation", num_workers=1))
    for mode in ("", "_pp", "_gt", "_pp_gt"):
        for m in DEPTH_METRIC_NAMES:
            np.testing.assert_allclose(padded[m + mode], single[m + mode], rtol=1e-5,
                                       atol=1e-7, err_msg=m + mode)


def test_train_cli_then_eval_cli(tmp_path, capsys):
    cfg = tiny_yaml(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "dro_sfm_torch.scripts.train", str(cfg),
                          "--device", "cpu", "--seed", "3"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    trained = json.loads(out[out.rindex("\n{") + 1:])
    (path,) = sorted((tmp_path / "ckpt").glob("*.ckpt"))
    assert json.loads(Path(str(path) + ".json").read_text())["config"]["arch"]["seed"] == 3

    evaluated = eval_cli.main(["--checkpoint", str(path), "--device", "cpu"])
    assert evaluated["abs_rel_pp_gt"] == trained["abs_rel_pp_gt"]
    assert evaluated["abs_rel_pp_gt"] == pytest.approx(float(
        path.name.split("=")[-1][:-len(".ckpt")]), abs=5e-4)
    assert len(list((tmp_path / "save").glob("*_depth.npz"))) == 3
    depth = np.load(next((tmp_path / "save").glob("*_depth.npz")))
    assert depth["depth"].shape == (32, 48) and depth["intrinsics"].shape == (3, 3)


def test_train_cli_profiles_the_first_steps(tmp_path):
    train_cli.main([str(tiny_yaml(tmp_path)), "--device", "cpu",
                    "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("overrides, error, match", [
    ({"arch": {"spatial_shards": 2}}, ValueError, "must divide the world size 1"),
    ({"datasets": {"train": {"dataset": ["NoSuchSet"]}}}, KeyError, "NoSuchSet"),
])
def test_not_ported_raises(tmp_path, overrides, error, match):
    with pytest.raises(error, match=match):
        Trainer(tiny_config(tmp_path, **overrides), device="cpu")


def test_png_artifacts_and_missing_card_raise(tmp_path):
    """``save.depth.png`` writes uint16 depth pngs (depth * 256) beside the
    npz files; ``rgb`` and ``viz`` write the image and the colormapped
    inverse depth of each sample (``viz_inv_depth`` of the npz's depth)."""
    from dro_sfm_torch.utils.depth import viz_inv_depth
    from dro_sfm_torch.utils.image_io import read_png
    trainer = Trainer(tiny_config(tmp_path, save={"depth": {"png": True}}), device="cpu")
    trainer.test(save_artifacts=True)
    pngs = sorted((tmp_path / "save").glob("*_depth.png"))
    assert len(pngs) == 3
    for png in pngs:
        depth = np.load(str(png)[:-len(".png")] + ".npz")["depth"]
        assert np.array_equal(read_png(str(png))[..., 0], (depth * 256.0).astype(np.uint16))
    trainer = Trainer(tiny_config(tmp_path, save={"depth": {"rgb": True, "viz": True}}),
                      device="cpu")
    trainer.test(save_artifacts=True)
    for png in pngs:
        stem = str(png)[:-len("_depth.png")]
        depth = np.load(stem + "_depth.npz")["depth"]
        rgb, viz = read_png(stem + "_rgb.png"), read_png(stem + "_viz.png")
        assert rgb.shape == viz.shape == (*depth.shape[:2], 3) and rgb.dtype == np.uint8
        inv = np.where(depth > 0, 1.0 / depth, 0.0)
        want = (viz_inv_depth(inv) * 255).astype(np.uint8)
        assert np.abs(viz.astype(int) - want).max() <= 1   # the npz holds 1 / inv
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main([str(tiny_yaml(tmp_path))])
