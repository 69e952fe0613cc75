"""The port's `Trainer` with ``arch.spatial_shards: 2`` on two spawned gloo
ranks (CPU): the counterpart of `tests/test_spatial.py:test_trainer_spatial_smoke`.

``configs/overfit_synthetic.yaml`` cut to ``it4-h-out`` at 32x48 (16 rows
a rank, 2 at stride 8 and 1 at stride 16), one epoch of 2 steps of 2
samples, validated on 3 samples (the second batch padded). The ranks'
validation metrics equal those of a one-process `Trainer` that resumes the
split run's checkpoint, and every sample counts once (the all-samples check
raises otherwise); the resumed net equals the ranks' bit for bit; rank 0
alone writes the checkpoint and the code archive. The bars:
the pose metrics 1e-5 relative; the depth metrics 2e-3 relative and the
thresholded a1-a3 1e-3 absolute, since the bands' forward sums in another
order and the 4 refinement steps of this net amplify it: on these weights
the depth metrics part by up to 7e-4 relative and a1-a3 by 2 pixels of
4,608 (4.3e-4), the pose metrics not at all. An evaluation batch
of one sample is split by height and its depth gathered to the whole image.
The refusals: S that does not divide the world size, H/8 that does not
divide by S, and a single-frame task below its height rule (H >= 32 S).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from dro_sfm_torch.training.metrics import POSE_METRIC_NAMES
from dro_sfm_torch.training.trainer import Trainer
from dro_sfm_torch.utils.config import load_config
from tests._torch_dist import load, run_ranks
from tests._torch_spatial import split_trainer_rank
from tests.test_torch_dist_train import trainer_overrides

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "overfit_synthetic.yaml"


def split_overrides(shards=2):
    """`trainer_overrides` with 4 training scenes and ``shards``."""
    over = trainer_overrides(1)
    over["arch"] = {**over["arch"], "spatial_shards": shards}
    over["datasets"]["train"] = {**over["datasets"]["train"], "split": ["4"]}
    return over


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    out = tmp_path_factory.mktemp("split_fit")
    run_ranks(split_trainer_rank, 2, out, str(CONFIG), split_overrides(), str(out))
    return out, load(out, 2)


def test_split_trainer_validates_as_one_process(fitted):
    out, ranks = fitted
    assert [r["step"] for r in ranks] == [2, 2]
    (ckpt,) = ranks[0]["saved"]
    assert ranks[1]["saved"] == []
    # rank 0 alone archives the code (ranks sharing a folder raced on the file)
    assert [r["code"] for r in ranks] == [True, False]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
    cfg = load_config(str(CONFIG), {**split_overrides(1),
                                    "checkpoint": {"filepath": str(out / "one")}})
    trainer = Trainer(cfg, resume=ckpt, device="cpu")      # resumes in one process
    for k, v in trainer.net.state_dict().items():
        assert torch.equal(v, ranks[0]["state"][k]), k
    single = trainer.validate()
    for r in ranks:
        for k, v in single.items():
            assert r["metrics"][k] == ranks[0]["metrics"][k], k
            if k.startswith(POSE_METRIC_NAMES):
                bar = {"rtol": 1e-5, "atol": 1e-7}
            elif k.startswith(("a1", "a2", "a3")):
                bar = {"rtol": 0.0, "atol": 1e-3}
            else:
                bar = {"rtol": 2e-3, "atol": 0.0}
            np.testing.assert_allclose(r["metrics"][k], v, err_msg=k, **bar)
        assert np.isfinite(r["metrics"]["avg_train-loss"])


def test_an_eval_batch_of_one_is_split_by_height(fitted):
    _, ranks = fitted
    for r in ranks:
        assert r["placed"]["rgb"] == (1, 16, 48, 3)
        assert r["placed"]["rgb_context"] == (1, 2, 16, 48, 3)
        assert r["placed"]["depth"] == (1, 32, 48, 1)          # the ground truth whole
        assert r["eval"]["inv_depth"].shape == (1, 32, 48, 1)
        assert r["eval"]["metrics"].shape == (4, 1, 9)
    for k, v in ranks[0]["eval"].items():
        assert torch.equal(ranks[1]["eval"][k], v), k


@pytest.mark.parametrize("overrides, error, match", [
    (split_overrides(), ValueError, "must divide the world size 1"),
    ({**split_overrides(), "datasets": {"augmentation": {"image_shape": (40, 48)}}},
     ValueError, "H/8 must divide by"),
    ({**split_overrides(), "model": {"name": "SupModel"}}, ValueError,
     "at least 4 rows at stride 8"),
])
def test_split_refusals(tmp_path, overrides, error, match):
    cfg = load_config(str(CONFIG), {**overrides, "checkpoint": {"filepath": str(tmp_path)}})
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")
