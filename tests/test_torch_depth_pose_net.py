"""The port's DepthPoseNet as a whole against the JAX network (fp32, CPU).

``it8-h-out`` (2 outer iterations of 4 depth and 4 pose steps) at 64x96,
B=1, N=2. The JAX net runs with ``warp_impl="gather"``: off the TPU its
``"pallas"`` setting turns into the matmul sampler with bf16 weights, which
is not an fp32 reference. The weights come from `fill_variables` through
`from_jax_variables` with a strict load. Tolerance: 1e-4 relative (L2 over
the tensor) and 1e-4 absolute per element on inverse depth and pose, inside
the 1e-3 bar of the converted reference network; the fp32 sums run in
another order through some hundred convolutions and 16 recurrent steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.inference import make_infer_fn
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet, VersionSpec
from tests.test_torch_modules import fill_variables

torch.set_num_threads(4)
VERSION = "it8-h-out"
B, N, H, W = 1, 2, 64, 96


def make_inputs(rng, b=B):
    K = np.array([[W / 2, 0, (W - 1) / 2], [0, W / 2, (H - 1) / 2],
                  [0, 0, 1.0]], np.float32)
    return (rng.uniform(size=(b, H, W, 3)).astype(np.float32),
            rng.uniform(size=(b, N, H, W, 3)).astype(np.float32),
            np.broadcast_to(K, (b, 3, 3)).copy())


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    inputs = make_inputs(rng)
    jnet = JaxNet(version=VERSION, warp_impl="gather", sep_conv="split")
    variables = fill_variables(lambda k: jnet.init(
        k, *map(jnp.asarray, inputs), train=False))
    tnet = DepthPoseNet(version=VERSION, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    return jnet, variables, tnet, inputs


def assert_close(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape
    assert np.all(np.isfinite(got))
    rel = np.linalg.norm(got - expected) / np.linalg.norm(expected)
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=0)


def test_version_parse():
    s = VersionSpec.parse("it12-h-out")
    assert (s.total_iters, s.seq_len, s.outer_iters, s.hidden_dim) == (12, 4, 3, 128)
    assert s.out_normalize and not s.inter_sup and s.num_predictions == 4
    s2 = VersionSpec.parse("it8-seq2-inter")
    assert (s2.seq_len, s2.outer_iters, s2.hidden_dim) == (2, 4, 64)
    assert s2.inter_sup and s2.num_predictions == 9


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(nets, last_only):
    jnet, variables, tnet, inputs = nets
    expected = jnet.apply(variables, *map(jnp.asarray, inputs), train=False,
                          last_only=last_only)
    with torch.inference_mode():
        got = tnet(*map(torch.from_numpy, inputs), last_only=last_only)
    p = 1 if last_only else tnet.spec.num_predictions
    assert got["inv_depths"].shape == (p, B, H, W, 1)
    assert got["pose_vecs"].shape == (B, N, tnet.spec.num_predictions, 6)
    assert_close(got["inv_depths"], expected["inv_depths"])
    assert_close(got["pose_vecs"], expected["pose_vecs"])
    # the refinement moved the estimate: the comparison is not of the init only
    inv = np.asarray(expected["inv_depths"])
    if not last_only:
        assert np.abs(inv[-1] - inv[0]).max() > 1e-2


def test_pallas_and_gather_agree_on_cpu(nets):
    """``warp_impl`` takes the JAX names; on CPU tensors all run the plain
    version, so the outputs are identical."""
    _, _, tnet, inputs = nets
    gather = DepthPoseNet(version=VERSION, warp_impl="gather", device="cpu")
    gather.load_state_dict(tnet.state_dict(), strict=True)
    with torch.inference_mode():
        a = tnet(*map(torch.from_numpy, inputs), last_only=True)
        b = gather(*map(torch.from_numpy, inputs), last_only=True)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_mixed_precision_dtypes(nets):
    """bf16 convs, fp32 geometry: the outputs are fp32 and finite, near the
    fp32 net (bf16 keeps 8 bits: 5e-2 relative over the whole tensor)."""
    _, _, tnet, inputs = nets
    mp = DepthPoseNet(version=VERSION, mixed_precision=True, device="cpu")
    mp.load_state_dict(tnet.state_dict(), strict=True)
    with torch.inference_mode():
        ref = tnet(*map(torch.from_numpy, inputs), last_only=True)
        out = mp(*map(torch.from_numpy, inputs), last_only=True)
    for k in out:
        assert out[k].dtype == torch.float32 and torch.isfinite(out[k]).all()
        rel = (out[k] - ref[k]).norm() / ref[k].norm()
        assert rel < 5e-2, (k, float(rel))


def test_entry_points_refuse_missing_cuda(nets):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the entry points would run there")
    _, _, tnet, _ = nets
    with pytest.raises(RuntimeError, match="CUDA"):
        make_infer_fn(tnet)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_infer_fn(tnet, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DepthPoseNet(version="it4-h-out")
