"""The port's evaluation step against the JAX package's (fp32, CPU).

``SupModelMF`` at ``it4-h-out`` (one outer iteration of 4 depth and 4 pose
steps), 64x96, B=2, N=2, on a batch of the synthetic validation scenes
(real ground truth), weights from `fill_variables` carried over by
`from_jax_variables`. JAX runs ``warp_impl="gather"`` (as in
`test_torch_train_step.py`); the port ``"pallas"``, whose CPU path is K1's
plain version. Bar: 1e-4 on the metrics [4,B,9] (relative, and absolute
for metrics near 0), on ``depth_pp`` (relative) and on the pose matrices
(absolute) -- the networks agree to 1e-4 (`test_torch_depth_pose_net.py`)
and the metrics are smooth in them except a1-a3, which count pixels on
either side of a threshold (1e-4 of a fraction is far below one pixel of
6144, so they must agree exactly or to one pixel's rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.data import SyntheticConfig as JaxSyntheticConfig
from dro_sfm_tpu.data import SyntheticDataset as JaxSyntheticDataset
from dro_sfm_tpu.data import collate as jax_collate
from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.metrics import MetricsConfig as JaxMetricsConfig
from dro_sfm_tpu.training.step import make_eval_step as jax_make_eval_step
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.training.metrics import MetricsConfig
from dro_sfm_torch.training.step import make_eval_step
from tests.test_torch_modules import fill_variables

torch.set_num_threads(1)
B, H, W = 2, 64, 96
CFG = dict(name="SupModelMF", version="it4-h-out", min_depth=0.2, max_depth=20.0,
           mixed_precision=False, warp_impl="gather", sep_conv="split", remat=False)
METRICS = dict(crop="garg", min_depth=0.2, max_depth=20.0)


@pytest.fixture(scope="module")
def setup():
    ds = JaxSyntheticDataset(JaxSyntheticConfig(num_scenes=B, height=H, width=W, seed=7),
                             mode="validation")
    batch = {k: v for k, v in jax_collate([ds[i] for i in range(B)]).items()
             if k in ("rgb", "rgb_context", "intrinsics", "depth", "pose_context")}
    jcfg = jsfm.SfmModelConfig(**CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    ref = jax_make_eval_step(jcfg, jnet, JaxMetricsConfig(**METRICS))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = tsfm.SfmModelConfig(**{**CFG, "warp_impl": "pallas"})
    net = tcfg.build_net(device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return batch, {k: np.asarray(v) for k, v in ref.items()}, tcfg, net


def test_eval_step_matches_jax(setup):
    batch, ref, tcfg, net = setup
    out = make_eval_step(tcfg, net, MetricsConfig(**METRICS), device="cpu")(batch)
    got = {k: v.numpy() for k, v in out.items()}
    assert got["metrics"].shape == ref["metrics"].shape == (4, B, 9)
    assert got["pose"].shape == (B, 2, 4, 4) and got["depth_pp"].shape == (B, H, W, 1)
    for k in ("inv_depth", "inv_depth_pp", "depth_pp"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=0, err_msg=k)
    np.testing.assert_allclose(got["pose"], ref["pose"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=1e-4, atol=1e-4)
    # Flip fusion did something, and every mode is a different number.
    assert not np.allclose(got["inv_depth"], got["inv_depth_pp"])
    assert len({float(m[0, 0]) for m in got["metrics"]}) == 4


@pytest.mark.parametrize("mode", [True, False])
def test_eval_step_leaves_the_mode(setup, mode):
    batch, _, tcfg, net = setup
    net.train(mode)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = make_eval_step(tcfg, net, MetricsConfig(**METRICS), device="cpu")(batch)
    assert net.training is mode
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in before.items())
    assert not out["depth_pp"].requires_grad
    net.eval()


def test_eval_step_without_ground_truth(setup):
    batch, ref, tcfg, net = setup
    step = make_eval_step(tcfg, net, MetricsConfig(**METRICS), device="cpu")
    out = step({k: batch[k] for k in ("rgb", "rgb_context", "intrinsics")})
    assert out["metrics"] is None
    np.testing.assert_allclose(out["depth_pp"].numpy(), ref["depth_pp"], rtol=1e-4)
