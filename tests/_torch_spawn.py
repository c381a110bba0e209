"""Run a worker script as 4 gloo ranks of the CPU, for the port's
multi-rank tests.

    procs = spawn(worker, workdir)
    outs = join(procs, workdir)

Each rank runs ``python WORKER RANK WORLD WORKDIR`` on one torch thread,
logging to ``WORKDIR/log_RANK.txt`` (a full pipe would stall a rank
inside a collective), and writes ``WORKDIR/out_RANK.pt``; :func:`join`
waits for them under a deadline, kills what is left, fails with a rank's
log if it failed, and returns what each rank wrote.
"""

import os
import subprocess
import sys

import torch

WORLD, JOIN_S = 4, 240


def spawn(worker: str, workdir: str, world: int = WORLD):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"log_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, worker, str(r), str(world), workdir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def join(procs, workdir: str, timeout: float = JOIN_S):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"log_{r}.txt")) as log:
            assert p.returncode == 0, f"rank {r}:\n{log.read()[-4000:]}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]
