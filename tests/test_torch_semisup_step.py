"""The port's semi-supervised training step against the JAX package (fp32,
CPU).

``SemiSupModelMFPose`` at ``it8-h-out``, 64x96, B=2, N=2, the flip off:
``(1 - w)`` times the photometric loss plus ``w`` times the supervised loss
(``w`` = ``supervised_loss_weight``, 0.9), with the setup, the
photometric settings and the bars of `tests/test_torch_selfsup_step.py`
(which says why the ``mean`` reduction without the automask). With ``w``
at 1 the photometric term is left out, and its originals are not read.
"""
import numpy as np
import torch

from tests.test_torch_selfsup_step import task_gradients_match_jax

torch.set_num_threads(4)


def test_semisup_gradients_match_jax():
    metrics, grads = task_gradients_match_jax("SemiSupModelMFPose", flip=False)
    assert set(metrics) == {"photometric_loss", "smoothness_loss", "depth_loss",
                            "pose_loss", "all_loss"}
    assert all(np.isfinite(g).all() for g in grads.values())


def test_semisup_at_weight_one_is_supervised():
    from dro_sfm_torch.models.sfm import SfmModelConfig
    cfg = SfmModelConfig(name="SemiSupModelMFPose", supervised_loss_weight=1.0)
    assert not cfg.uses_photometric
    assert cfg.batch_keys == ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")
