"""Run a command in several local processes, one rank of a process group
each: the port's counterpart of `scripts/launch_multihost.py`.

    python -m dro_sfm_torch.scripts.launch_multihost --nprocs 2 -- \\
        -m dro_sfm_torch.scripts.train configs/train_synthetic_192x640.yaml
    python -m dro_sfm_torch.scripts.launch_multihost --nprocs 2 --backend gloo -- \\
        -m dro_sfm_torch.scripts.train configs/overfit_synthetic.yaml --device cpu

Each process gets the variables that `torch.distributed.run` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), so ``torchrun --nproc-per-node 2 -m
dro_sfm_torch.scripts.train ...`` works as well. ``--backend`` sets the
processes' backend: by default NCCL on the cards and gloo on the CPU; two
processes on one card need ``gloo``, since NCCL refuses two ranks on one
device. SIGTERM is passed on to every process (each saves its emergency
checkpoint). When a process fails, the others are stopped (they would wait
for it in their next sum) and the launcher exits with that process's code.
"""
from __future__ import annotations

import argparse
import os
import selectors
import signal
import socket
import subprocess
import sys
import time

from dro_sfm_torch.parallel.mesh import BACKEND_ENV


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="run a command in N local ranks of a "
                                            "torch.distributed process group")
    p.add_argument("--nprocs", type=int, default=2, help="number of processes")
    p.add_argument("--port", type=int, default=0,
                   help="MASTER_PORT (0: a free port)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="the processes' backend (default: NCCL on the cards, gloo on "
                        "the CPU); gloo for several processes on one card")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- then the Python arguments, e.g. -m dro_sfm_torch.scripts.train")
    args = p.parse_args(argv)
    args.command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not args.command:
        p.error("no command (usage: ... -- -m dro_sfm_torch.scripts.train cfg.yaml)")
    return args


def rank_env(rank: int, nprocs: int, port: int, backend=None) -> dict:
    """The environment of process ``rank``."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "RANK": str(rank), "WORLD_SIZE": str(nprocs), "LOCAL_RANK": str(rank),
           "LOCAL_WORLD_SIZE": str(nprocs)}
    if backend:
        env[BACKEND_ENV] = backend
    return env


def stop(procs, grace: float = 30.0) -> None:
    """Terminate the processes still running, and kill those that outlive
    ``grace`` seconds."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def wait_all(procs) -> int:
    """0 when every process exits with 0; else, as soon as one fails, the
    code of the process that ended first (128 + N for a process ended by
    signal N). The launcher blocks on a pidfd a process (Linux 5.3+), so it
    wakes at each exit and tells the first of two close ends from the
    second; ends seen at one wake count in rank order."""
    fds = [os.pidfd_open(p.pid) for p in procs]
    try:
        with selectors.DefaultSelector() as sel:
            for rank, fd in enumerate(fds):
                sel.register(fd, selectors.EVENT_READ, rank)
            left = len(procs)
            while left:
                for rank in sorted(key.data for key, _ in sel.select()):
                    code = procs[rank].wait()
                    sel.unregister(fds[rank])
                    left -= 1
                    if code != 0:
                        return code if code > 0 else 128 - code
        return 0
    finally:
        for fd in fds:
            os.close(fd)


def main(argv=None) -> int:
    args = parse_args(argv)
    port = args.port or free_port()
    procs = []

    def pass_on(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = signal.signal(signal.SIGTERM, pass_on)
    try:
        for rank in range(args.nprocs):
            procs.append(subprocess.Popen([sys.executable, "-u", *args.command],
                                          env=rank_env(rank, args.nprocs, port, args.backend)))
            print(f"launched rank {rank} (pid {procs[-1].pid}) of {args.nprocs}, "
                  f"127.0.0.1:{port}", flush=True)
        return wait_all(procs)
    finally:
        stop(procs)
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(main())
