"""One rank of ``tests/test_torch_examples_sharded.py``'s 4-process gloo
run.

    python tests/_torch_examples_worker.py RANK WORLD WORKDIR

Joins the process group through ``WORKDIR/pg`` (60 s timeout) and runs
``repro_torch.launch.big_model_serving.main(["--device", "cpu"])`` under
``REPRO_SMOKE=1``: in a world of 4 the launcher shards qwen3-8b over a
2x2 mesh, rank 0 drives the engine and the other ranks follow its
calls.  Writes the launcher's result (None off rank 0) to
``WORKDIR/out_RANK.pt``; imports torch and the port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import big_model_serving  # noqa: E402


def main() -> None:
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    os.environ["REPRO_SMOKE"] = "1"
    try:
        res = big_model_serving.main(["--device", "cpu"])
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(workdir, f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
