"""The readings that set a cell's ``logit_gap`` limit, on the card.

    python3 cnmt_bench/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 10]

One process, one set-up.  For each seed the program gets that seed's
weights (copied into the same parameters, so its CUDA graphs stay
valid), serves a short window of the cell's own traffic at its own load,
and its sample (the run's own size) goes through the reference: the
program's widest gap.  On the control seeds the same positions are read
again with the reference in the next precision down (TF32 products):
the control's widest gap.  The lower reading is the largest program
gap, the upper the smallest control gap.  Prints one JSON line a seed.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seeds, control_seeds, seconds: float,
             device):
    """Yield one dict of readings a seed (see the module's docstring)."""
    from cnmt_bench.lib import check, harness

    cell = harness.find_cell(root, workload)
    setup = harness.set_up(cell, seeds[0], device, False)
    answers = setup.adapter.served
    for seed in seeds:
        params = harness._weights(cell, seed, device)
        setup.model.load_state_dict(params, strict=True)
        answers.clear()
        setup.fresh_engine()
        win = harness.window(cell, setup, seed, seconds, False, device)
        t_check = time.perf_counter()
        sample = check.sample(win.served, setup.card_index, answers, seed,
                              int(cell.mix["check"]["sample"]))
        gaps = check.widest_gaps(cell.reference, params,
                                 cell.config["widths"], sample, answers,
                                 device, control=seed in control_seeds)
        checks = check.verdict(win.served, setup.card_index, answers, gaps,
                               float(cell.config["check"]["logit_gap_limit"]))
        del params
        yield {"workload": workload, "seed": seed, "requests":
               len(win.served), "sample": len(sample),
               "check_s": time.perf_counter() - t_check, **gaps,
               "unserved": checks["unserved"]["value"],
               "wrong_length": checks["wrong_length"]["value"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for row in readings(ROOT, args.workload, seeds, control, args.seconds,
                        torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
