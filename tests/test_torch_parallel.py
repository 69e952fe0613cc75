"""The port's process group, collectives, cross-process BatchNorm and
launcher on the CPU (gloo), against the JAX package.

Two spawned ranks (`tests/_torch_dist.py`) run the collectives; the JAX
functions of `dro_sfm_tpu/parallel/collectives.py` run in this process on
the pooled inputs (``jax.process_count`` and ``process_allgather`` stand in
for the other process: a first call of each rank records its payload, the
second is given all of them). Bars: `reduce_dict`,
`all_reduce_metric_sums` and `any_process_flag` equal to JAX's exactly;
a rank that lost a sample makes every rank raise; a flag raised by rank 1
alone stops both ranks at the same step; `all_reduce_sum` is the exact sum
forward and backward (two fp32 addends).

BatchNorm: two ranks of 2 samples each against flax's ``nn.BatchNorm(
momentum=0.9, epsilon=1e-5)`` in train mode on all 4: the output and the
running statistics within 1e-6 relative (of the largest element), the input
gradient and the summed parameter gradients within 1e-5.

The launcher: its arguments, two ranks of a small program under it and
under ``torchrun`` (gloo, TCP on localhost), and a failing rank ending the
run with its exit code; `wait_all` returning the code of the rank that
ended first when two ranks end 0.1 s apart.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.parallel import collectives as jcoll
from dro_sfm_torch import parallel
from dro_sfm_torch.parallel.mesh import local_device, maybe_init_distributed
from dro_sfm_torch.scripts import launch_multihost
from tests._torch_dist import (
    batchnorm_rank,
    collective_inputs,
    collectives_rank,
    load,
    run_ranks,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


def pooled_jax(monkeypatch, fn, per_rank_args):
    """``fn(*args)`` of every rank, as the JAX package's processes would
    return it: a first pass records each rank's allgather payload, a second
    hands all of them to each rank. AssertionErrors come back as values."""
    from jax.experimental import multihost_utils
    world = len(per_rank_args)
    payloads = []

    def record(x):
        payloads.append(np.asarray(x))
        return np.stack([np.asarray(x)] * world)

    def call(args):
        try:
            return fn(*args)
        except AssertionError as e:
            return e

    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(multihost_utils, "process_allgather", record)
    for args in per_rank_args:
        call(args)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda x: np.stack(payloads))
    return [call(args) for args in per_rank_args]


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    run_ranks(collectives_rank, WORLD, out, str(out))
    return load(out, WORLD)


def test_reduce_dict_equals_jax(collective_results, monkeypatch):
    inputs = [collective_inputs(r) for r in range(WORLD)]
    want = pooled_jax(monkeypatch, jcoll.reduce_dict, [(i["dict"],) for i in inputs])
    assert [r["reduce_dict"] for r in collective_results] == want


def test_all_reduce_metric_sums_equals_jax(collective_results, monkeypatch):
    inputs = [collective_inputs(r) for r in range(WORLD)]
    total = sum(i["count"] for i in inputs)
    want = pooled_jax(monkeypatch, jcoll.all_reduce_metric_sums,
                      [(i["sums"], i["count"], total) for i in inputs])
    for got, (sums, count) in zip(collective_results, want):
        assert got["metric_sums"][1] == count == total
        np.testing.assert_array_equal(got["metric_sums"][0], sums)


def test_a_missing_sample_trips_the_check_on_every_rank(collective_results, monkeypatch):
    inputs = [collective_inputs(r) for r in range(WORLD)]
    total = sum(i["count"] for i in inputs)
    want = pooled_jax(monkeypatch, jcoll.all_reduce_metric_sums,
                      [(i["sums"], i["count"] - (r == 1), total)
                       for r, i in enumerate(inputs)])
    assert all(isinstance(e, AssertionError) for e in want)
    for got in collective_results:
        assert got["missing_sample"] == (f"distributed eval saw {total - 1} samples, "
                                         f"expected {total}")


@pytest.mark.parametrize("flags", ["00", "01", "10", "11"])
def test_any_process_flag_equals_jax(collective_results, monkeypatch, flags):
    want = pooled_jax(monkeypatch, jcoll.any_process_flag, [(f == "1",) for f in flags])
    assert [r["flags"][flags] for r in collective_results] == want == [flags != "00"] * WORLD


def test_a_flag_on_one_rank_stops_both_at_the_same_step(collective_results):
    assert [r["stop_step"] for r in collective_results] == [3, 3]


def test_broadcast_flag_takes_rank0s(collective_results):
    assert [r["broadcast"] for r in collective_results] == [[True, False]] * WORLD


def test_all_reduce_sum_forward_and_backward(collective_results):
    inputs = [collective_inputs(r) for r in range(WORLD)]
    x = inputs[0]["x"] + inputs[1]["x"]
    w = inputs[0]["w"] + inputs[1]["w"]
    for got in collective_results:
        np.testing.assert_array_equal(got["all_reduce_sum"], x)
        np.testing.assert_array_equal(got["all_reduce_sum_grad"], w)


def test_device_collectives(collective_results):
    for got in collective_results:
        assert all(np.all(p == 0.0) for p in got["broadcast_tensors"])
        assert all(np.all(g == 1.5) for g in got["average_gradients"])
        assert got["average_metrics"] == {"loss": 0.5, "b": 1.0}


def test_average_loss_and_metrics_equals_jax():
    outputs = [{"loss": 1.0, "a1": 0.25}, {"loss": 3.5, "a1": 0.5}, {"loss": 2.0}]
    assert parallel.average_loss_and_metrics(outputs) == \
        jcoll.average_loss_and_metrics(outputs)
    assert parallel.average_loss_and_metrics([]) == {}


def test_one_process_needs_no_group():
    assert not parallel.is_distributed()
    assert (parallel.process_count(), parallel.process_index(), parallel.is_rank0()) == (1, 0, True)
    assert parallel.reduce_dict({"a": 1}) == {"a": 1.0}
    assert parallel.any_process_flag(True) and not parallel.any_process_flag(False)
    assert parallel.broadcast_flag(True)
    x = torch.ones(3)
    assert parallel.all_reduce_sum(x) is x
    assert parallel.all_reduce_metric_sums(np.ones(3), 4)[1] == 4
    with pytest.raises(RuntimeError, match="saw 4 samples, expected 5"):
        parallel.all_reduce_metric_sums(np.ones(3), 4, expected_total=5)


def test_init_is_a_no_op_without_the_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert local_device("cpu") == torch.device("cpu")
    assert not maybe_init_distributed(torch.device("cpu"))
    assert not parallel.is_distributed()


def test_local_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        local_device()


# -- BatchNorm across processes ------------------------------------------------

def test_cross_process_batchnorm_matches_flax(tmp_path):
    rng = np.random.default_rng(4)
    b, h, w, c = 4, 6, 10, 16
    x = (rng.normal(size=(b, h, w, c)) * 2.0 + 1.0).astype(np.float32)
    weights = rng.normal(size=(b, h, w, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def loss(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return (y * weights).sum(), (y, upd["batch_stats"])

    (_, (y, upd)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})

    def nchw(a):
        return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))

    inputs = {"x": nchw(x), "w": nchw(weights),
              "params": {"weight": scale, "bias": bias, "running_mean": mean0,
                         "running_var": var0}}
    run_ranks(batchnorm_rank, WORLD, tmp_path, inputs, str(tmp_path))
    ranks = load(tmp_path, WORLD)

    def close(got, want, bar):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=bar, atol=bar * np.abs(want).max())

    close(np.concatenate([r["y"] for r in ranks]), nchw(np.asarray(y)), 1e-6)
    close(np.concatenate([r["x_grad"] for r in ranks]), nchw(np.asarray(gx)), 1e-5)
    close(sum(r["weight_grad"] for r in ranks), gp["scale"], 1e-5)
    close(sum(r["bias_grad"] for r in ranks), gp["bias"], 1e-5)
    for r in ranks:
        close(r["running_mean"], upd["mean"], 1e-6)
        close(r["running_var"], upd["var"], 1e-6)


# -- the launcher --------------------------------------------------------------

PROGRAM = textwrap.dedent("""\
    import sys, torch
    from dro_sfm_torch.parallel import (local_device, maybe_init_distributed,
                                        process_count, process_index)
    from dro_sfm_torch.parallel.collectives import all_reduce_sum
    joined = maybe_init_distributed(local_device("cpu"))
    rank = process_index()
    if rank == 1 and sys.argv[2] == "fail":
        sys.exit(3)
    total = all_reduce_sum(torch.tensor([rank + 1.0]))
    with open(f"{sys.argv[1]}/rank{rank}.txt", "w") as f:
        f.write(f"{joined} {process_count()} {total.item()}")
    torch.distributed.destroy_process_group()
    """)


def test_launcher_arguments():
    args = launch_multihost.parse_args(["--nprocs", "3", "--backend", "gloo", "--",
                                        "-m", "dro_sfm_torch.scripts.train", "x.yaml"])
    assert (args.nprocs, args.backend, args.port) == (3, "gloo", 0)
    assert args.command == ["-m", "dro_sfm_torch.scripts.train", "x.yaml"]
    env = launch_multihost.rank_env(2, 3, 1234, "gloo")
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK", "DRO_SFM_DIST_BACKEND")} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1234", "RANK": "2",
        "WORLD_SIZE": "3", "LOCAL_RANK": "2", "DRO_SFM_DIST_BACKEND": "gloo"}
    with pytest.raises(SystemExit):
        launch_multihost.parse_args(["--nprocs", "2"])


def run_program(tmp_path, launcher, outcome):
    script = tmp_path / "program.py"
    script.write_text(PROGRAM)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", *launcher, str(script), str(tmp_path),
                           outcome], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("launcher", [
    ["dro_sfm_torch.scripts.launch_multihost", "--nprocs", "2", "--backend", "gloo", "--"],
    ["torch.distributed.run", "--standalone", "--nproc-per-node", "2"],
], ids=["launch_multihost", "torchrun"])
def test_two_ranks_under_the_launcher(tmp_path, launcher):
    res = run_program(tmp_path, launcher, "ok")
    assert res.returncode == 0, res.stderr[-3000:]
    for rank in range(2):
        assert (tmp_path / f"rank{rank}.txt").read_text() == "True 2 3.0"


def test_the_launcher_ends_with_a_failing_rank(tmp_path):
    res = run_program(tmp_path, ["dro_sfm_torch.scripts.launch_multihost", "--nprocs",
                                 "2", "--backend", "gloo", "--"], "fail")
    assert res.returncode == 3, res.stderr[-3000:]
    assert not list(tmp_path.glob("rank*.txt"))


# A child that exits with code argv[1]: at the wall-clock time argv[3], or,
# given a pid in argv[2], 0.1 s after that process has ended.
EXIT_AFTER = ("import os, select, sys, time\n"
              "if int(sys.argv[2]):\n"
              "    select.select([os.pidfd_open(int(sys.argv[2]))], [], [])\n"
              "    time.sleep(0.1)\n"
              "else:\n"
              "    time.sleep(max(0.0, float(sys.argv[3]) - time.time()))\n"
              "sys.exit(int(sys.argv[1]))")


@pytest.mark.parametrize("codes,first,want", [
    ((7, 5), 1, 5),                   # rank 1 fails first, rank 0 0.1 s later
    ((9, 6), 0, 9),                   # rank 0 fails first
    ((0, 4), 0, 4),                   # a rank ending with 0 does not end the wait
    ((0, 0), 0, 0),
], ids=["second_rank_first", "first_rank_first", "success_then_failure", "both_succeed"])
def test_wait_all_returns_the_rank_that_ended_first(codes, first, want):
    """The two ranks end in a known order 0.1 s apart (the later one waits
    for the first's exit): the launcher returns the code of the one that
    ended first, not the first in rank order."""
    procs = [None, None]
    start = time.time() + 2.0                    # past both children's start-up
    procs[first] = subprocess.Popen([sys.executable, "-c", EXIT_AFTER, str(codes[first]), "0",
                                     str(start)])
    procs[1 - first] = subprocess.Popen([sys.executable, "-c", EXIT_AFTER,
                                         str(codes[1 - first]), str(procs[first].pid), "0"])
    try:
        assert launch_multihost.wait_all(procs) == want
    finally:
        launch_multihost.stop(procs)
