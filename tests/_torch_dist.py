"""Ranks of a gloo process group in spawned processes, for the port's
multi-process tests (on the CPU; nothing here imports JAX).

`run_ranks(fn, world, tmp_path, *args)` starts ``world`` processes with the
spawn method. Each joins a gloo group through a `FileStore` under
``tmp_path`` (no TCP port, so parallel test workers never race for one),
calls ``fn(rank, world, *args)`` and leaves the group. The ranks write their
results under ``tmp_path`` and the caller compares them. A rank that raises,
or that still runs after ``timeout`` seconds, fails the caller.

The rank functions of `tests/test_torch_parallel.py` and
`tests/test_torch_dist_train.py` live here, so that a spawned process
imports torch and the port only.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import signal
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

THREADS = 2                       # torch threads in each rank
# Seconds a group of ranks may take: a hang detector, well above a group's
# run while the suite's other workers load the machine (a two-rank `Trainer`
# fit took 121 s under six workers of spawned ranks).
TIMEOUT = 300


def _entry(fn, rank, world, store_path, args):
    torch.set_num_threads(THREADS)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT - 20))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=TIMEOUT):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks."""
    ctx = multiprocessing.get_context("spawn")
    store = Path(tmp_path) / f"store_{uuid.uuid4().hex}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(store), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks {hung} still ran after {timeout} s"
    assert codes == [0] * world, f"ranks' exit codes {codes}"


def save(out_dir, rank, result):
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def load(out_dir, world):
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- collectives ---------------------------------------------------------------

METRIC_K = 39                     # 4 modes x 9 depth metrics, 3 pose sums


def collective_inputs(rank):
    """Rank ``rank``'s inputs to the host reductions."""
    rng = np.random.default_rng(10 + rank)
    return {"dict": {"loss": float(rng.normal()), "abs_rel": float(rng.uniform()),
                     "a1": float(rng.uniform())},
            "sums": rng.normal(size=METRIC_K) * 10.0 ** rng.integers(-3, 3, METRIC_K),
            "count": int(rng.integers(3, 9)),
            "x": rng.normal(size=(3, 5)).astype(np.float32),
            "w": rng.normal(size=(3, 5)).astype(np.float32)}


def collectives_rank(rank, world, out_dir):
    from dro_sfm_torch import parallel
    inp = collective_inputs(rank)
    counts = [collective_inputs(r)["count"] for r in range(world)]
    out = {"reduce_dict": parallel.reduce_dict(inp["dict"]),
           "metric_sums": parallel.all_reduce_metric_sums(inp["sums"], inp["count"],
                                                          expected_total=sum(counts))}
    # A shard that lost a sample: every rank must raise.
    try:
        parallel.all_reduce_metric_sums(inp["sums"], inp["count"] - (rank == 1),
                                        expected_total=sum(counts))
        out["missing_sample"] = None
    except RuntimeError as e:
        out["missing_sample"] = str(e)
    out["flags"] = {f"{a}{b}": parallel.any_process_flag((a, b)[rank])
                    for a in (0, 1) for b in (0, 1)}
    out["broadcast"] = [parallel.broadcast_flag(rank == 0), parallel.broadcast_flag(rank == 1)]
    # A preemption flag raised by rank 1 alone at step 3, agreed every step.
    stop = None
    for step in range(10):
        if parallel.any_process_flag(rank == 1 and step >= 3):
            stop = step
            break
    out["stop_step"] = stop

    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = parallel.all_reduce_sum(x)
    (y * torch.from_numpy(inp["w"])).sum().backward()
    out["all_reduce_sum"] = y.detach().numpy()
    out["all_reduce_sum_grad"] = x.grad.numpy()

    lin = torch.nn.Linear(5, 2)
    with torch.no_grad():
        for p in lin.parameters():
            p.fill_(float(rank))
    parallel.broadcast_tensors(list(lin.parameters()))
    out["broadcast_tensors"] = [p.detach().clone().numpy() for p in lin.parameters()]
    for p in lin.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    parallel.average_gradients(lin.parameters())
    out["average_gradients"] = [p.grad.numpy() for p in lin.parameters()]
    out["average_metrics"] = {k: float(v) for k, v in parallel.average_metrics(
        {"loss": torch.tensor(float(rank)), "b": torch.tensor(2.0 * rank)}).items()}
    save(out_dir, rank, out)


# -- BatchNorm -----------------------------------------------------------------

def batchnorm_rank(rank, world, inputs, out_dir):
    """The port's train-mode BatchNorm on this rank's rows of ``inputs``."""
    from dro_sfm_torch.models.layers import BatchNorm2d
    x_all, w_all, params = inputs["x"], inputs["w"], inputs["params"]
    per = x_all.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    bn = BatchNorm2d(x_all.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=False)
    x = torch.from_numpy(x_all[rows]).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(w_all[rows])).sum().backward()
    save(out_dir, rank, {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
                         "weight_grad": bn.weight.grad.numpy(),
                         "bias_grad": bn.bias.grad.numpy(),
                         "running_mean": bn.running_mean.numpy(),
                         "running_var": bn.running_var.numpy()})


# -- the training step -----------------------------------------------------------

def flip_generator_for(flip: bool) -> torch.Generator:
    """A generator whose first flip draw (probability 0.5) is ``flip``."""
    from dro_sfm_torch.models.sfm import draw_flip
    for seed in range(100):
        if draw_flip(torch.Generator().manual_seed(seed), 0.5) == flip:
            return torch.Generator().manual_seed(seed)
    raise AssertionError("no seed")


def port_step(tcfg, state_dict, batch, generator, do_flip=None):
    """One `make_train_step` step of the port on the CPU from ``state_dict``
    with the config-default Adam: (metrics, gradients before the update,
    the net's state after it)."""
    from dro_sfm_torch.training.state import create_train_state, make_optimizer
    from dro_sfm_torch.training.step import make_train_step
    from dro_sfm_torch.utils.config import load_config
    net = tcfg.build_net(device="cpu")
    net.load_state_dict(state_dict, strict=True)
    cfg = load_config()
    opt = make_optimizer(net, cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    state = create_train_state(net, opt, device="cpu")
    grads = {}
    update = opt.step

    def step_keeping_grads(count):
        grads.update({k: p.grad.detach().clone() for k, p in net.named_parameters()})
        update(count)

    opt.step = step_keeping_grads
    _, metrics = make_train_step(tcfg, net, opt, device="cpu")(state, batch, generator,
                                                                do_flip=do_flip)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in net.state_dict().items()})


def train_step_rank(rank, world, job, out_dir):
    """The port's step on this rank's shard of ``job["batch"]``; rank 0
    draws the flip ``job["flip"]`` and the others the opposite, so the
    step must take rank 0's."""
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    per = batch["rgb"].shape[0] // world
    shard = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    flip = job["flip"] if rank == 0 else not job["flip"]
    metrics, grads, after = port_step(job["tcfg"], job["state_dict"], shard,
                                      flip_generator_for(flip))
    save(out_dir, rank, {"metrics": metrics, "grads": grads, "after": after})


# -- the Trainer ---------------------------------------------------------------------

def trainer_rank(rank, world, cfg_path, overrides, out_dir, preempt_rank):
    """`Trainer.fit` on the CPU of the config at ``cfg_path`` with
    ``overrides`` and this rank's own checkpoint folder; with
    ``preempt_rank`` set, that rank alone gets SIGTERM after its first
    step. Then a validation whose shard on rank 1 loses a sample."""
    from dro_sfm_torch.training.trainer import Trainer
    from dro_sfm_torch.utils.config import load_config
    ckpt_dir = Path(out_dir) / f"ckpt_rank{rank}"
    cfg = load_config(str(cfg_path), {**overrides,
                                      "checkpoint": {"filepath": str(ckpt_dir)}})
    trainer = Trainer(cfg, device="cpu")
    step = trainer.train_step

    def step_then_sigterm(*args, **kwargs):
        out = step(*args, **kwargs)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    if rank == preempt_rank:
        trainer.train_step = step_then_sigterm
    metrics = trainer.fit()
    out = {"metrics": metrics, "step": trainer.state.step,
           "files": sorted(p.name for p in ckpt_dir.glob("*.ckpt")),
           "saved": [p for _, p in trainer.checkpointer.saved]}

    class LosesASample:
        """The validation loader with rank 1's first genuine sample dropped."""

        def __init__(self, loader):
            self.loader, self.dataset = loader, loader.dataset

        def __len__(self):
            return len(self.loader)

        def __iter__(self):
            for i, batch in enumerate(self.loader):
                if rank == 1 and i == 0:
                    batch["valid"] = batch["valid"].copy()
                    batch["valid"][0] = False
                yield batch

    try:
        trainer.validate(LosesASample(trainer.val_loaders[0]))
        out["missing_sample"] = None
    except RuntimeError as e:
        out["missing_sample"] = str(e)
    save(out_dir, rank, out)


# -- bundle adjustment ---------------------------------------------------------------

def ba_rank(rank, world, arrays, out_dir):
    """The edge-split dense BA on this rank: the normal equations, the
    LM-guarded optimizer and a two-stage schedule over the default group,
    and the refusal of an edge count that does not split."""
    from dro_sfm_torch.ba import dense_ba
    problem = dense_ba.BAProblem(*(torch.from_numpy(a) for a in arrays))
    H, b = dense_ba.make_sharded_accumulate(None, stride=2, robust_c=0.25)(problem)
    cost = dense_ba.make_sharded_cost(None, stride=2, robust_c=0.25)(problem)
    poses, sigmas = dense_ba.make_sharded_optimizer(None, stride=2, iters=6)(problem)
    sched = dense_ba.optimize_dense_ba_scheduled(problem, stages=((2, 0.5, 2, 0.15),
                                                                  (1, 0.25, 3, 0.1)),
                                                 stride=2, group=dist.group.WORLD)
    odd = problem._replace(edges_i=problem.edges_i[:-1], edges_j=problem.edges_j[:-1])
    try:
        dense_ba.make_sharded_optimizer(None, stride=2, iters=1)(odd)
        refused = None
    except ValueError as e:
        refused = str(e)
    save(out_dir, rank, {"H": H, "b": b, "cost": cost, "poses": poses, "sigmas": sigmas,
                         "sched": sched, "refused": refused})
