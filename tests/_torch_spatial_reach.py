"""Where the height split's gradient leaves lie against fp32's own reach (CPU,
spawned gloo ranks): the numbers that `tests/test_torch_spatial_tasks.py`
and `tests/test_torch_spatial_ops.py` quote for their bars.

    JAX_PLATFORMS=cpu python -m tests._torch_spatial_reach step SelfSupModelMF --world 4
    JAX_PLATFORMS=cpu python -m tests._torch_spatial_reach step SelfSupModel
    JAX_PLATFORMS=cpu python -m tests._torch_spatial_reach op photometric_percep --shards 4
    JAX_PLATFORMS=cpu python -m tests._torch_spatial_reach op pose_resnet --shards 4

``step``: the task's step of `tests/test_torch_spatial_tasks.py` on
D = world / 2 x S = 2 ranks against the port in one process, beside the
one-process step on the samples reordered and, for the single-frame nets,
one process and the split against the step in fp64; the worst leaves.
``op``: an operator case of `tests/test_torch_spatial_ops.py` at S bands:
the whole port and the bands against JAX, and both against the whole port in
fp64, each input gradient's relative L2; then the bands against the whole
port with oneDNN's CPU convolutions off (PyTorch's own), which shows whether
oneDNN's choice of algorithm at the bands' shapes moves them.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch


def rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).norm() / b.norm()).item()


def step(task, world):
    from dro_sfm_torch.convert import from_jax_variables
    from tests._torch_dist import flip_generator_for, load, port_step, run_ranks
    from tests._torch_spatial import tasks_rank
    from tests.test_torch_dist_train import global_batch
    from tests.test_torch_selfsup_step import SMOOTH_LOSS, task_batch
    from tests.test_torch_spatial_tasks import leaf_reach, setup_case
    batch = global_batch(task_batch) if world == 4 else task_batch(0)
    _, _, variables, tcfg = setup_case(task, SMOOTH_LOSS)
    sd = from_jax_variables(variables)
    single = port_step(tcfg, sd, {k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_generator_for(True))
    out = tempfile.mkdtemp()
    run_ranks(tasks_rank, world, out, {"spatial": 2, "cases": {"c": {
        "kind": "step", "tcfg": tcfg, "state_dict": sd, "batch": batch, "flip": True}}}, out)
    split = load(out, world)[0]["c"]["grads"]
    shutil.rmtree(out)
    reach = leaf_reach(tcfg, sd, batch, single)
    what = "fp64" if tcfg.single_frame else "reordered"
    rows = sorted(((rel(split[k], g), reach[k], k) for k, g in single[1].items()
                   if g.norm() > 0), reverse=True)[:6]
    for r in rows:
        print(f"{task}: split vs one process {r[0]:.3e}, one process vs {what} {r[1]:.3e}  {r[2]}")


def _ops_rank(rank, world, mkldnn, cases, out_dir):
    from tests._torch_spatial import ops_rank
    torch.backends.mkldnn.enabled = mkldnn
    ops_rank(rank, world, cases, out_dir)


def op(name, shards):
    from dro_sfm_torch.models.layers import Conv2d
    from tests import _torch_spatial
    from tests._torch_dist import load, run_ranks
    from tests._torch_spatial import ops_rank, run_op
    from tests.test_torch_spatial_ops import NAMES, assemble, make_case
    rng = np.random.default_rng(shards)
    made = {n: make_case(n, shards, rng) for n in NAMES}   # the fixture's draws, in order
    case, (_, jgrads, _) = made[name]
    out = tempfile.mkdtemp()
    run_ranks(ops_rank, shards, out, {name: case}, out)
    y, grads, _, _ = assemble(case, load(out, shards), name, shards)
    shutil.rmtree(out)
    wy, whole, _, _ = run_op(case)
    out = tempfile.mkdtemp()
    run_ranks(_ops_rank, shards, out, False, {name: case}, out)
    _, plain, _, _ = assemble(case, load(out, shards), name, shards)
    shutil.rmtree(out)
    torch.backends.mkldnn.enabled = False
    _, plain_whole, _, _ = run_op(case)
    torch.backends.mkldnn.enabled = True
    build_op = _torch_spatial.build_op

    def build_op_fp64(c):                  # every convolution computing in fp64
        module, fwd = build_op(c)
        for m in [] if module is None else module.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = torch.float64
        return module, fwd

    _torch_spatial.build_op = build_op_fp64
    torch.set_default_dtype(torch.float64)
    wide = {**case, "w": case["w"].astype(np.float64),
            "inputs": {k: v.astype(np.float64) for k, v in case["inputs"].items()},
            "state": {k: v.astype(np.float64) if v.dtype == np.float32 else v
                      for k, v in case["state"].items()}}
    ey, exact, _, _ = run_op(wide)
    print(f"{name} at S={shards}, output against fp64: whole port {rel(wy, ey):.3e}, "
          f"bands {rel(y, ey):.3e}")
    for k in whole:
        print(f"{name} at S={shards}, d{k}: whole port vs JAX {rel(whole[k], jgrads[k]):.3e}, "
              f"bands vs JAX {rel(grads[k], jgrads[k]):.3e}; against fp64: whole port "
              f"{rel(whole[k], exact[k]):.3e}, bands {rel(grads[k], exact[k]):.3e}; bands vs "
              f"whole port with oneDNN {rel(grads[k], whole[k]):.3e}, without "
              f"{rel(plain[k], plain_whole[k]):.3e}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kind", choices=("step", "op"))
    parser.add_argument("name")
    parser.add_argument("--world", type=int, default=2, help="step: 2 or 4 ranks")
    parser.add_argument("--shards", type=int, default=2, help="op: 2 or 4 bands")
    args = parser.parse_args()
    torch.set_num_threads(2)
    if args.kind == "step":
        step(args.name, args.world)
    else:
        op(args.name, args.shards)


if __name__ == "__main__":
    main()
