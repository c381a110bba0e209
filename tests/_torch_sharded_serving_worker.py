"""One rank of ``tests/test_torch_sharded_serving.py``'s 4-process gloo
run.

    python tests/_torch_sharded_serving_worker.py RANK WORLD WORKDIR

Reads ``WORKDIR/inputs.pt`` (configurations, the port's seeded weights,
prompts and frames, the cases), joins the process group through
``WORKDIR/pg`` (60 s timeout), builds a (2, 2) ``("data", "model")``
mesh, serves every case through ``make_sharded_session`` and writes the
tokens to ``WORKDIR/out_RANK.pt``.  It imports torch and the port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime.sharded import make_sharded_session  # noqa: E402


def _lm(name, inputs):
    model = LM(inputs["cfgs"][name], device="cpu")
    model.load_state_dict(inputs["weights"][name], strict=True)
    return model


def main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    out = {"sessions": {}}
    for name, layout in inputs["session_cases"]:
        case = inputs["prompts"][name]
        sess = make_sharded_session(_lm(name, inputs), mesh,
                                    max_len=inputs["max_len"], batch_size=4,
                                    layout=layout)
        m, tokens = sess.generate_with_lengths(
            case["tokens"], max_new=inputs["max_new"],
            lengths=case["lengths"], frames=case["frames"])
        out["sessions"][(name, layout)] = {"m": m, "tokens": tokens,
                                           "layout": sess.layout}
    name, layout = inputs["continuous_case"]
    sess = make_sharded_session(_lm(name, inputs), mesh, continuous=True,
                                max_slots=4, max_len=inputs["max_len"],
                                batch_size=4, layout=layout)
    out["continuous"] = sess.serve(inputs["continuous_prompts"],
                                   max_new=inputs["max_new"])
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
