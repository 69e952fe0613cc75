"""One training step after resuming a checkpoint of the JAX package (fp32, CPU).

The JAX package trains ``SupModelMF`` at ``it2-seq2-h-out`` on the batch of
`test_torch_train_step.py` (64x96, B=2, flip off; Adam behind the
global-norm clip) for one step from `fill_variables` weights, saves the
state with its own ``save_checkpoint`` and takes a second step. The port
resumes the file (its moments are held bit for bit in
`test_torch_jax_checkpoint.py`) and takes the second step; it must agree
within `test_torch_train_step.py`'s bars: the loss 1e-5 relative; each
parameter within 0.05 lr, and within 2 lr where the gradient lies within
its 5e-2 bar of zero (there Adam's update may take the other sign);
BatchNorm statistics 1e-4. (The two packages' fp32 losses agree closely
at these weights: 3.0e-7 relative at 48x64 with B=1, 2.0e-7 at 64x96 with
B=2; the test keeps `test_torch_train_step.py`'s batch of two.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from dro_sfm_tpu.training.step import make_train_step as j_make_train_step
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.training.checkpoint import load_checkpoint
from dro_sfm_torch.training.step import make_train_step
from tests.test_torch_jax_checkpoint import (
    assert_state_dict_equal,
    config,
    jax_state,
    port_state,
    saved_trees,
)
from tests.test_torch_train_step import make_batch

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_resume")
    cfg = config(tmp)
    batch = make_batch()
    jcfg, jnet, state = jax_state(cfg, batch)
    step = j_make_train_step(jcfg, jnet)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, _ = step(state, jbatch, jax.random.PRNGKey(0))
    path = str(tmp / "jax.ckpt")
    jax_save_checkpoint(path, state, epoch=3, config=cfg.to_dict())
    saved = saved_trees(state)
    after, metrics = step(state, jbatch, jax.random.PRNGKey(0))
    after = jax.tree.map(np.asarray, {"params": after.params,
                                      "batch_stats": after.batch_stats})
    return {"path": path, "cfg": cfg, "batch": batch, "saved": saved, "after": after,
            "loss": float(metrics["loss"])}


def test_resume_restores_adam_and_matches_the_next_jax_step(trained):
    cfg, batch = trained["cfg"], trained["batch"]
    tcfg, state = port_state(cfg)
    restored = load_checkpoint(trained["path"], state)
    assert restored["meta"]["epoch"] == 3 and state.step == 1
    assert_state_dict_equal(state.net.state_dict(), from_jax_variables(trained["saved"]))
    assert len(state.optimizer.torch_optimizer.state) == len(list(state.net.parameters()))

    lr = state.optimizer.schedules[0](state.step)
    step = make_train_step(tcfg, state.net, state.optimizer, device="cpu")
    before = {k: p.detach().clone() for k, p in state.net.named_parameters()}
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                          do_flip=False)
    grads = {k: p.grad for k, p in state.net.named_parameters()}
    np.testing.assert_allclose(float(metrics["loss"]), trained["loss"], rtol=1e-5)
    want = from_jax_variables(trained["after"])
    for k, v in state.net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in before:
            assert not torch.equal(v, before[k]), k                  # the step moved it
            err = (v - want[k]).abs()
            assert err.max() <= 2.0 * lr + 1e-6, k
            # off by more than 0.05 lr only where the gradient lies within
            # the gradient bar of zero, as in test_torch_train_step.py
            g = grads[k]
            assert bool((g[err > 0.05 * lr].abs() <= 5e-2 * g.norm()).all()), k
        else:
            torch.testing.assert_close(v, want[k], atol=1e-4, rtol=1e-4)
