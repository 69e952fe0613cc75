"""The port's supervised training step with ``sep_conv="pallas"`` against the
JAX package (fp32, CPU).

The setting of `tests/test_torch_train_step.py` (SupModelMF it8-h-out,
64x96, B=2, N=2, weights from `fill_variables`), with the port's GRU passes
going through `gru_sep1d_pass` (on CPU tensors `gru_pass_plain` forward and
`gru_pass_bwd_plain` backward, the plain versions of K5 and K6). The JAX
side runs ``sep_conv="conv"``: off the TPU its ``"pallas"`` is the conv path
(`dro_sfm_tpu/models/update.py:150-152`) and the JAX `DepthPoseNet` has no
``pallas_interpret``; in fp32 the two are the same math. Bars: those of
`tests/test_torch_train_step.py` (gradients per leaf, one Adam step of the
config-default optimizer), for the reasons stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.models import sfm as jsfm
from dro_sfm_tpu.training.state import create_train_state as j_create_state
from dro_sfm_tpu.training.state import make_optimizer as j_make_optimizer
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_tpu.utils.config import load_config
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.models import sfm as tsfm
from dro_sfm_torch.ops.gru_pass import K5_COUNTER, K6I_COUNTER, K6W_COUNTER
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_modules import fill_variables
from tests.test_torch_train_step import (
    CFG,
    LR,
    assert_grads_close,
    jax_grads_as_port,
    key_with_flip,
    make_batch,
    tbatch,
)

torch.set_num_threads(4)
JAX_CFG = {**CFG, "sep_conv": "conv"}
PORT_CFG = {**CFG, "warp_impl": "pallas", "sep_conv": "pallas"}


@pytest.fixture(scope="module")
def setup():
    batch = make_batch()
    jcfg = jsfm.SfmModelConfig(**JAX_CFG)
    jnet = jcfg.build_net()
    variables = fill_variables(lambda k: jnet.init(
        k, *(jnp.asarray(batch[n]) for n in ("rgb", "rgb_context", "intrinsics")),
        train=False))
    return batch, jcfg, jnet, variables, tsfm.SfmModelConfig(**PORT_CFG)


def port_net(tcfg, variables):
    net = tcfg.build_net(device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net


def test_train_gradients_match_jax(setup):
    batch, jcfg, jnet, variables, tcfg = setup
    key = key_with_flip(False)

    def loss_fn(params):
        loss, (_, metrics, _) = jsfm.forward_and_loss(
            jcfg, jnet, {"params": params, "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    for c in (K5_COUNTER, K6I_COUNTER, K6W_COUNTER):
        c.reset()
    tnet = port_net(tcfg, variables)
    loss, _ = tsfm.forward_and_loss(tcfg, tnet, tbatch(batch), None, do_flip=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    assert_grads_close(got, jax_grads_as_port(jgrads, variables["batch_stats"]))
    # the CPU path runs the plain versions: no kernel launched
    assert (K5_COUNTER.launches, K6I_COUNTER.launches, K6W_COUNTER.launches) == (0, 0, 0)


def test_one_adam_step_matches_jax(setup):
    """`make_train_step` with ``sep_conv="pallas"`` against JAX's step: the
    parameters and BatchNorm statistics after one step of the config-default
    Adam (the bars of `tests/test_torch_train_step.py`)."""
    batch, jcfg, jnet, variables, tcfg = setup
    cfg = load_config()
    key = key_with_flip(True, fold=0)
    tx = j_make_optimizer(cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    jstate = j_create_state(jnet, key, None, tx, init_variables=variables)
    jstate, jmetrics = j_make_train_step(jcfg, jnet)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tnet = port_net(tcfg, variables)
    opt = make_optimizer(tnet, cfg.model.optimizer, cfg.model.scheduler,
                         steps_per_epoch=1000)
    state = create_train_state(tnet, opt, device="cpu")
    before = {k: p.detach().clone().numpy() for k, p in tnet.named_parameters()}
    state, metrics = make_train_step(tcfg, tnet, opt, device="cpu")(
        state, batch, None, do_flip=True)
    grads = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    want = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for k, v in tnet.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got, exp = v.numpy(), want[k].numpy()
        if k in before:
            assert np.abs(got - before[k]).max() > 0.5 * LR, k
            err = np.abs(got - exp)
            assert err.max() <= 2.0 * LR + 1e-6, k
            flipped = err > 0.05 * LR
            assert np.all(np.abs(grads[k][flipped]) <= 5e-2 * np.linalg.norm(grads[k])), k
        else:
            np.testing.assert_allclose(got, exp, atol=1e-4, rtol=1e-4, err_msg=k)
