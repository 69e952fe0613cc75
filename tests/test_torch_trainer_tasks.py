"""The port's trainer on the self-supervised and single-frame configs, on
the CPU (``device="cpu"``).

``configs/train_synthetic_selfsup.yaml`` (``SelfSupModelMF``) and
``configs/overfit_synthetic_single_frame.yaml`` (``SupModel``: separate
depth and pose nets with their own rates), each through the port's config
reader and cut to a tiny run: ``it4-h-out``, 32x64 images, 4 training
scenes in batches of 2, 2 epochs, one validation batch. Each fit gives
finite losses and metrics; a run resumed after epoch 0 ends where the
uninterrupted run ends, bit for bit; the single-frame trainer reports the
pose group's rate.
"""
import numpy as np
import pytest
import torch

from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config
from tests.test_torch_trainer import ROOT, assert_same, ckpts, state_of

torch.set_num_threads(1)
CONFIGS = {"selfsup": "train_synthetic_selfsup.yaml",
           "single_frame": "overfit_synthetic_single_frame.yaml"}


def tiny(tmp_path, which, epochs=2, **extra):
    """The config ``which`` cut to the tiny run, its files under ``tmp_path``."""
    evaluation = {"dataset": ["Synthetic"], "path": ["7"], "split": ["2"],
                  "batch_size": 2, "num_workers": 1}
    overrides = {
        "arch": {"max_epochs": epochs},
        "checkpoint": {"filepath": str(tmp_path / "ckpt")},
        "model": {"depth_net": {"version": "it4-h-out"}},
        "datasets": {"augmentation": {"image_shape": (32, 64)},
                     "train": {"split": ["4"], "repeat": [1], "batch_size": 2,
                               "num_workers": 1},
                     "validation": evaluation, "test": evaluation}}
    for section, values in extra.items():
        overrides[section] = {**overrides.get(section, {}), **values}
    return load_config(str(ROOT / "configs" / CONFIGS[which]), overrides)


class Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step=None):
        self.metrics.append(dict(metrics))

    def log_depth_images(self, *args, **kwargs):
        pass


def losses_of(trainer):
    step, losses = trainer.train_step, []

    def recording(*args, **kwargs):
        state, metrics = step(*args, **kwargs)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recording
    return losses


@pytest.mark.parametrize("which", list(CONFIGS))
def test_fit_and_resume(tmp_path, which):
    straight = Trainer(tiny(tmp_path / "a", which), device="cpu")
    assert straight.model_cfg.name == {"selfsup": "SelfSupModelMF",
                                       "single_frame": "SupModel"}[which]
    straight.logger = Recorder()
    losses = losses_of(straight)
    metrics = straight.fit()
    assert len(losses) == 4 and all(np.isfinite(losses)), losses
    assert all(np.isfinite(v) for v in metrics.values())
    assert straight.state.step == 4

    rates = [m for m in straight.logger.metrics if "learning_rate" in m]
    assert rates
    if which == "single_frame":        # the pose group's own rate (0.0005)
        groups = straight.optimizer.torch_optimizer.param_groups
        assert [g["lr"] for g in groups] == [0.0002, 0.0005]
        assert all(m["learning_rate_pose"] == 0.0005 for m in rates)
    else:
        assert all("learning_rate_pose" not in m for m in rates)

    first = Trainer(tiny(tmp_path / "b", which, epochs=1), device="cpu")
    first.fit()
    (path,) = ckpts(first)
    resumed = Trainer(tiny(tmp_path / "b", which), resume=str(path), device="cpu")
    assert resumed.current_epoch == 1 and resumed.state.step == 2
    assert_same(state_of(resumed), state_of(first))
    resumed.fit()
    assert_same(state_of(resumed), state_of(straight))

