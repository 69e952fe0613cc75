"""The port's `PercepNet` against the JAX package's (fp32, CPU).

The flax variables are shaped with ``jax.eval_shape`` and filled from a
seeded numpy generator (`fill_variables`), carried into the port by
`from_jax_variables` with a strict load; both nets see the same numpy
images, with the 224x224 resize. Tolerance: the distance map within 1e-5
absolute and relative (seven fp32 convolutions summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models.percep import PercepNet
from tests.test_torch_modules import fill_variables

torch.set_num_threads(2)


def nets(resize):
    jnet = JaxPercepNet(resize=resize)
    dummy = jnp.zeros((1, 32, 48, 3), jnp.float32)
    variables = fill_variables(lambda k: jnet.init(k, dummy, dummy), seed=5)
    tnet = PercepNet(resize=resize, device="cpu")
    tnet.load_state_dict(from_jax_variables(variables), strict=True)
    return jnet, variables, tnet


@pytest.mark.parametrize("resize, shape", [(True, (2, 40, 56, 3)), (False, (1, 32, 48, 3))],
                         ids=["resize224", "no_resize"])
def test_distance_map_matches_jax(resize, shape):
    rng = np.random.default_rng(6)
    a = rng.uniform(size=shape).astype(np.float32)
    b = rng.uniform(size=shape).astype(np.float32)
    jnet, variables, tnet = nets(resize)
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(a), jnp.asarray(b)))
    got = tnet(torch.from_numpy(a), torch.from_numpy(b))
    hw = (224, 224) if resize else shape[1:3]
    assert got.shape == (shape[0], *hw, 1) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_frozen_net_passes_the_gradient_to_the_images():
    _, _, tnet = nets(False)
    assert not any(p.requires_grad for p in tnet.parameters())
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(size=(1, 32, 48, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(1, 32, 48, 3)).astype(np.float32))
    b.requires_grad_()
    tnet(a, b).mean().backward()
    assert b.grad is not None and b.grad.abs().sum() > 0
    assert torch.equal(tnet(a, a), torch.zeros_like(tnet(a, a)))
