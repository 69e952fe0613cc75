"""The port's checkpoints (CPU): round trip, bit-exact resume, top-k
management, and the serving file's build settings.

Resume is held bit for bit: one training step from the saved state and one
from the state restored into a net and optimizer built afresh (other
weights, step 0) give equal parameters, BatchNorm statistics and Adam
moments, with a schedule that changes the rate every step and the global
norm clip on.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dro_sfm_torch.inference import _META, load_model, save_model
from dro_sfm_torch.models.sfm import SfmModelConfig
from dro_sfm_torch.training.checkpoint import (
    FORMAT,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from dro_sfm_torch.training.state import create_train_state, make_optimizer
from dro_sfm_torch.training.step import make_train_step

torch.set_num_threads(1)
H, W = 32, 48
CFG = SfmModelConfig(name="SupModelMF", version="it4-h-out", min_depth=0.2, max_depth=20.0,
                     flip_lr_prob=0.5, warp_impl="pallas", remat=False)
OPT = SimpleNamespace(name="Adam", depth={"lr": 1e-3, "weight_decay": 0.0},
                      clip_grad_norm=0.5)
SCHED = SimpleNamespace(name="StepLR", step_size=1, gamma=0.5)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[W * 0.8, 0, (W - 1) / 2], [0, W * 0.8, (H - 1) / 2], [0, 0, 1]],
                 np.float32)
    return {"rgb": rng.uniform(size=(1, H, W, 3)).astype(np.float32),
            "rgb_context": rng.uniform(size=(1, 2, H, W, 3)).astype(np.float32),
            "intrinsics": K[None],
            "depth": rng.uniform(1.0, 15.0, size=(1, H, W, 1)).astype(np.float32),
            "pose_context": np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))}


def state_at(seed):
    net = CFG.build_net(device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(net, OPT, SCHED, steps_per_epoch=1)
    return create_train_state(net, opt, device="cpu")


def snapshot(state):
    moments = state.optimizer.torch_optimizer.state
    return ({k: v.clone() for k, v in state.net.state_dict().items()},
            [{k: v.clone() for k, v in moments[p].items()}
             for p in state.net.parameters()], state.step)


def assert_same(a, b):
    (sd_a, m_a, step_a), (sd_b, m_b, step_b) = a, b
    assert step_a == step_b
    assert sd_a.keys() == sd_b.keys()
    bad = [k for k in sd_a if not torch.equal(sd_a[k], sd_b[k])]
    assert not bad, bad[:5]
    assert all(torch.equal(x[k], y[k]) for x, y in zip(m_a, m_b) for k in x)


def test_resume_is_bit_exact(tmp_path):
    data = batch()
    state = state_at(0)
    step = make_train_step(CFG, state.net, state.optimizer, device="cpu")
    for flip in (False, True):
        state, _ = step(state, data, None, do_flip=flip)
    path = str(tmp_path / "a.ckpt")
    save_checkpoint(path, state, epoch=3, config={"name": "x"})
    saved = snapshot(state)
    state, metrics = step(state, data, None, do_flip=True)
    after = snapshot(state)

    other = state_at(1)
    restored = load_checkpoint(path, other)
    assert restored["meta"] == {"format": FORMAT, "epoch": 3, "step": 2,
                                "config": {"name": "x"}}
    assert_same(snapshot(other), saved)
    step2 = make_train_step(CFG, other.net, other.optimizer, device="cpu")
    other, metrics2 = step2(other, data, None, do_flip=True)
    assert torch.equal(metrics["loss"], metrics2["loss"])
    assert_same(snapshot(other), after)
    assert [g["lr"] for g in other.optimizer.torch_optimizer.param_groups] == [1e-3 * 0.5 ** 2]


def test_foreign_files_raise(tmp_path):
    """A file that is not a zip is read as the JAX package's flax msgpack
    (`test_torch_jax_checkpoint.py`); one that is neither raises, as does a
    zip file that is not the port's checkpoint."""
    flax = tmp_path / "jax.ckpt"
    flax.write_bytes(b"\x84\xa6params\x80")               # a truncated msgpack map
    with pytest.raises(ValueError, match="truncated msgpack"):
        load_checkpoint(str(flax))
    (tmp_path / "jax.ckpt.json").write_text(json.dumps({"epoch": 0, "step": 1}))
    with pytest.raises(ValueError, match="truncated msgpack"):
        load_checkpoint(str(flax))
    flax.write_bytes(b"\x92\x01\x02")                    # msgpack, but a list
    with pytest.raises(ValueError, match="holds a map"):
        load_checkpoint(str(flax))
    other = tmp_path / "other.pt"
    torch.save({"state_dict": {}}, other)
    with pytest.raises(ValueError, match="not a checkpoint of dro_sfm_torch"):
        load_checkpoint(str(other))


def tiny_state():
    net = torch.nn.Linear(2, 2)
    return create_train_state(net, make_optimizer(net), device="cpu")


@pytest.mark.parametrize("monitor, values, kept", [
    ("abs_rel_pp_gt", [0.5, 0.3, 0.4, 0.6, 0.1], [0.1, 0.3]),     # auto: min
    ("a1_pp_gt", [0.5, 0.3, 0.7, 0.6, 0.1], [0.7, 0.6]),           # auto: max
])
def test_checkpoint_manager_keeps_top_k(tmp_path, monitor, values, kept):
    mirror = tmp_path / "mirror"
    manager = CheckpointManager(str(tmp_path / "ckpt"), monitor=monitor, save_top_k=2,
                                save_code=False, sync_url=f"file://{mirror}")
    assert manager.mode == ("max" if monitor.startswith("a1") else "min")
    state = tiny_state()
    for epoch, v in enumerate(values):
        manager.check_and_save(state, epoch, {monitor: v})
    assert manager.check_and_save(state, 9, {"other": 1.0}) is None
    names = sorted(p.name for p in (tmp_path / "ckpt").glob("*.ckpt"))
    want = sorted(f"epoch={values.index(v):02d}_{monitor}={v:.3f}.ckpt" for v in kept)
    assert names == want
    assert sorted(p.name for p in mirror.glob("*.ckpt")) == want
    for name in names:
        assert load_checkpoint(str(tmp_path / "ckpt" / name))["meta"]["format"] == FORMAT


def test_serving_file_keeps_the_build_settings(tmp_path):
    net = SfmModelConfig(version="it4-h-out", warp_impl="gather", sep_conv="pallas",
                         remat=True).build_net(device="cpu")
    path = str(tmp_path / "net.pt")
    save_model(net, path)
    loaded = load_model(path, device="cpu")
    assert (loaded.warp_impl, loaded.sep_conv, loaded.remat) == ("gather", "pallas", True)
    assert loaded.refinement.update_block_depth.warp_impl == "gather"
    assert loaded.refinement.remat is True
    assert {m.conv_impl for m in loaded.modules() if hasattr(m, "conv_impl")} == {"pallas"}
    assert all(torch.equal(v, loaded.state_dict()[k]) for k, v in net.state_dict().items())
    # A file written before these keys were saved loads with the defaults.
    old = torch.load(path, weights_only=True)
    for k in ("warp_impl", "sep_conv", "remat"):
        del old[k]
    torch.save(old, path)
    loaded = load_model(path, device="cpu")
    assert (loaded.warp_impl, loaded.sep_conv, loaded.remat) == ("pallas", "split", True)
    assert set(_META) >= {"version", "warp_impl", "sep_conv", "remat"}
