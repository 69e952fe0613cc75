"""The port's msgpack reader and writer against flax's (CPU).

`dro_sfm_torch.utils.msgpack.unpackb` must give back, bit for bit and with
the same dtypes, the trees that ``flax.serialization.msgpack_serialize``
writes (fp32, int32, int64, bool, bf16 arrays, numpy scalars, Python
scalars, tuples as ``{"0": ...}`` maps, empty maps, a whole checkpoint of
the JAX package with an Adam state), chunked leaves included; `packb` must
give flax's bytes. No tolerance: the comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dro_sfm_torch.utils import msgpack as mp


def trees():
    rng = np.random.default_rng(0)
    return {
        "arrays": {"params": {"conv": {
            "kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
            "bias": np.zeros(8, np.float32)}},
            "i32": np.arange(-3, 4, dtype=np.int32),
            "i64": np.asarray(12345678901, np.int64),
            "mask": np.array([[True, False], [False, True]]),
            "f64": rng.normal(size=(2, 3)),
            "u8": rng.integers(0, 256, (5,), dtype=np.uint8),
            "empty": np.zeros((0, 4), np.float32)},
        "bf16": {"w": np.asarray(jnp.asarray(rng.normal(size=(4, 5)), jnp.bfloat16)),
                 "s": jnp.bfloat16(1.5)},
        "scalars": {"f32": np.float32(0.25), "i32": np.int32(-7), "b": np.bool_(True),
                    "step": 3, "big": 2 ** 40, "neg": -100000, "negsmall": -5,
                    "x": 0.1, "none": None, "t": True, "f": False},
        "strings": {"short": "a", "long": "x" * 40, "longer": "y" * 300, "bytes": b"\x00\x01",
                    "many": {str(i): i for i in range(20)}, "list": [1, 2.5, "z", [3]]},
        "tuples": serialization.to_state_dict(
            {"opt_state": (np.ones(2, np.float32), (np.int32(4), {})), "empty": ()}),
    }


def assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
        return
    if isinstance(got, torch.Tensor):          # bf16: flax gives ml_dtypes.bfloat16
        assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16"
        assert got.shape == np.shape(want), path
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
        assert got.flags.writeable, path
    else:
        assert got == want, path


@pytest.mark.parametrize("name", sorted(trees()))
def test_reads_flax_trees_bit_for_bit(name):
    tree = trees()[name]
    data = serialization.msgpack_serialize(tree)
    assert_same(mp.unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("name", sorted(n for n in trees() if n != "bf16"))
def test_writer_gives_flax_bytes(name):
    tree = trees()[name]
    assert mp.packb(tree) == serialization.msgpack_serialize(tree)


def test_chunked_leaves(monkeypatch):
    """Leaves over MAX_CHUNK_SIZE bytes are written as chunk maps (made
    small here) and read back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(10, 7)).astype(np.float32),
            "nested": {"v": np.arange(50, dtype=np.int64), "small": np.ones(3, np.float32)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_same(mp.unpackb(data), serialization.msgpack_restore(data))
    assert mp.packb(tree) == data


def test_reads_a_jax_checkpoint(tmp_path):
    """A whole checkpoint of the JAX package: params, batch statistics, an
    Adam state behind the global-norm clip, the step."""
    import optax

    from dro_sfm_tpu.training.checkpoint import save_checkpoint
    rng = np.random.default_rng(3)
    params = {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                       "bias": np.zeros(4, np.float32)}}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))

    class State:
        step = 7
        batch_stats = {"bn": {"mean": np.ones(4, np.float32)}}

    State.params = params
    State.opt_state = tx.init(params)
    path = str(tmp_path / "x.ckpt")
    save_checkpoint(path, State(), epoch=1)
    data = open(path, "rb").read()
    assert_same(mp.unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("data, match", [
    (serialization.msgpack_serialize({"c": 1 + 2j}), "complex"),
    (b"\x84\xa6params\x80", "truncated"),
    (b"\x01\x02", "after"),
    (b"\xc1", "0xc1"),
    (b"\xd4\x07\x00", "ext type 7"),
])
def test_rejects_what_it_does_not_read(data, match):
    with pytest.raises(mp.MsgpackError, match=match):
        mp.unpackb(data)
