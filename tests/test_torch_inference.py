"""The port's serving function against the JAX package's (fp32, CPU).

`dro_sfm_torch.inference.make_infer_fn` is the batched serving signature of
`dro_sfm_tpu.export_serving.build_serving_fn`; at B=1 it also answers what
`dro_sfm_tpu.inference.make_infer_fn` answers. Same network, weights and
tolerance as `test_torch_depth_pose_net.py`; depth is 1/inv-depth, so its
bar is relative (1e-4 per element).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.export_serving import build_serving_fn
from dro_sfm_tpu.inference import make_infer_fn as jax_make_infer_fn
from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.inference import load_model, make_infer_fn, save_model
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
from tests.test_torch_depth_pose_net import VERSION, make_inputs
from tests.test_torch_modules import fill_variables

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(1)
    inputs = make_inputs(rng, b=2)
    jnet = JaxNet(version=VERSION, warp_impl="gather", sep_conv="split")
    variables = fill_variables(lambda k: jnet.init(
        k, *map(jnp.asarray, inputs), train=False))
    tnet = DepthPoseNet(version=VERSION, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    return jnet, variables, tnet, inputs


def check(depth, mats, depth_ref, mats_ref):
    depth, mats = depth.numpy(), mats.numpy()
    assert depth.shape == np.shape(depth_ref) and mats.shape == np.shape(mats_ref)
    np.testing.assert_allclose(depth, np.asarray(depth_ref), rtol=1e-4, atol=0)
    np.testing.assert_allclose(mats, np.asarray(mats_ref), atol=1e-5, rtol=0)


def test_batched_serving_matches_build_serving_fn(served):
    jnet, variables, tnet, inputs = served
    depth_ref, mats_ref = build_serving_fn(jnet, variables)(
        *map(jnp.asarray, inputs))
    depth, mats = make_infer_fn(tnet, device="cpu")(*inputs)
    assert depth.shape == (2, 64, 96) and mats.shape == (2, 2, 4, 4)
    check(depth, mats, depth_ref, mats_ref)


def test_single_request_matches_make_infer_fn(served):
    jnet, variables, tnet, inputs = served
    one = [x[:1] for x in inputs]
    depth_ref, mats_ref = jax_make_infer_fn(jnet)(
        variables, *map(jnp.asarray, one))                 # [H,W], [N,4,4]
    depth, mats = make_infer_fn(tnet, device="cpu")(*one)
    check(depth[0], mats[0], depth_ref, mats_ref)


def test_checkpoint_roundtrip(served, tmp_path):
    _, _, tnet, inputs = served
    path = tmp_path / "net.pt"
    save_model(tnet, str(path))
    loaded = load_model(str(path), device="cpu")
    assert loaded.version == VERSION and not loaded.mixed_precision
    one = [x[:1] for x in inputs]
    a = make_infer_fn(tnet, device="cpu")(*one)
    b = make_infer_fn(loaded, device="cpu")(*one)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_load_model_refuses_missing_cuda(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: load_model would run there")
    path = tmp_path / "net.pt"
    save_model(served[2], str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(str(path))
