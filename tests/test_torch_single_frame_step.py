"""The port's single-frame self-supervised step and the zero-loss
``SfmModelMF`` step against the JAX package (fp32, CPU).

``SelfSupModel`` (`SingleFrameNet`: separate depth and pose ResNets) at
64x96, B=2, N=2, the flip on, with the setup, the photometric settings and
the bars of `tests/test_torch_selfsup_step.py`; the single-frame loss
weights its four scales uniformly (gamma 1.0, normalised) and the
smoothness decay gives the finest scale full weight. The train-mode
encoders, which take the 5e-2 bar, are ``depth_net.encoder`` and
``pose_net.encoder``.

``SfmModelMF`` has a zero loss: in the JAX package a constant, whose
gradients are zero; in the port a zero that depends on the outputs, so that
``backward`` runs and gives zero gradients (a constant has no graph). One
training step then leaves every parameter as it was (Adam's first update of
a zero gradient is zero) and moves the BatchNorm statistics.
"""
import jax.numpy as jnp
import numpy as np
import torch

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_selfsup_step import task_batch, task_gradients_match_jax

torch.set_num_threads(4)


def test_single_frame_selfsup_gradients_match_jax():
    metrics, grads = task_gradients_match_jax(
        "SelfSupModel", flip=True, encoders=("depth_net.encoder.", "pose_net.encoder."))
    assert set(metrics) == {"photometric_loss", "smoothness_loss"}
    assert {k.split(".")[0] for k in grads} == {"depth_net", "pose_net"}


def test_sfm_model_step_gives_zero_gradients():
    batch = task_batch()
    jloss, jmetrics = jsfm.compute_loss(
        jsfm.SfmModelConfig(name="SfmModelMF"),
        {"inv_depths": jnp.ones((2, 2, 8, 8, 1)), "pose_vecs": jnp.zeros((2, 2, 2, 6))},
        {"intrinsics": jnp.asarray(batch["intrinsics"])})
    assert float(jloss) == 0.0 and jmetrics == {}

    cfg = tsfm.SfmModelConfig(name="SfmModelMF", version="it4-h-out", warp_impl="pallas",
                              remat=False)
    assert cfg.batch_keys == ("rgb", "rgb_context", "intrinsics")
    net = cfg.build_net(device="cpu")
    opt = make_optimizer(net, steps_per_epoch=10)
    state = create_train_state(net, opt, device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    state, metrics = make_train_step(cfg, net, opt, device="cpu")(
        state, batch, None, do_flip=True)
    assert float(metrics["loss"]) == 0.0 and set(metrics) == {"loss"}
    after = net.state_dict()
    for k, p in net.named_parameters():
        assert p.grad is not None and not p.grad.any(), k
        assert torch.equal(after[k], before[k]), k
    stats = [k for k in after if k.endswith("running_mean")]
    assert stats and all(not torch.equal(after[k], before[k]) for k in stats)
    assert np.isfinite(float(metrics["loss"]))


def test_sfm_model_zero_loss_ignores_non_finite_outputs():
    # JAX's zero is a constant; the port's must stay a zero with zero
    # gradients when an output holds an inf or a NaN.
    inv_depths = torch.ones(2, 2, 8, 8, 1)
    inv_depths[0, 1, 3, 4, 0] = float("inf")
    pose_vecs = torch.zeros(2, 2, 2, 6)
    pose_vecs[1, 0, 1, 2] = float("nan")
    inv_depths.requires_grad_(True)
    pose_vecs.requires_grad_(True)
    loss, metrics = tsfm.compute_loss(tsfm.SfmModelConfig(name="SfmModelMF"),
                                      {"inv_depths": inv_depths, "pose_vecs": pose_vecs},
                                      {"intrinsics": torch.eye(3).expand(2, 3, 3)})
    loss.backward()
    assert float(loss) == 0.0 and metrics == {}
    assert torch.equal(inv_depths.grad, torch.zeros_like(inv_depths))
    assert torch.equal(pose_vecs.grad, torch.zeros_like(pose_vecs))
