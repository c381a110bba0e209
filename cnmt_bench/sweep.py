"""Measurements that fix a cell's traffic file once, on the card.

    python3 cnmt_bench/sweep.py plane --workload <chat cell>
    python3 cnmt_bench/sweep.py knee --workload <chat cell> --rates 25,50,...
        [--seconds 10]

``plane``: the card's B=1 T_exe plane (``measure_seq2seq_grid`` +
``fit_device`` through the public translate, forced lengths on a grid
over the mix's lengths) and that plane times ``EDGE_SLOWDOWN``: the
modelled edge the mix freezes, so that a faster card never speeds up
the edge (the paper's Jetson TX2 against Titan XP gap).

``knee``: one process, one set-up; for each rate a fresh engine serves
an open-loop window of the mix at that rate.  Per rate it prints the
generator's lateness at the window's start and end, the mean and p95
latency and the card's share.  The knee is the highest rate whose
lateness does not grow through the window.

Run from the repository's root; prints JSON lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EDGE_SLOWDOWN = 5.0


def _plane(model, mix, vocab):
    from repro_torch.core.calibration import fit_device, measure_seq2seq_grid
    translate = model.make_translate_batched()

    def forced(tokens, m):
        lens, out = translate(tokens[None], None, m)
        return int(lens[0]), out[0]

    top = int(mix["lengths"]["n_max"])
    grid = [g for g in (4, 16, 64, 128) if g <= top]
    n, m, t = measure_seq2seq_grid(forced, grid, lambda _: grid, reps=2,
                                   vocab=vocab)
    prof = fit_device("card", n, m, t)
    return {"alpha_n": prof.model.alpha_n, "alpha_m": prof.model.alpha_m,
            "beta": prof.model.beta, "samples": int(len(t))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("plane", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=20220411)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import numpy as np
    import torch

    from cnmt_bench.lib import harness, loops, system
    from cnmt_bench.lib import traffic as traffic_lib

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(ROOT, args.workload)
    vocab = int(cell.config["widths"]["vocab_src"])
    if args.what == "plane":
        model = system.build_model(
            cell.config, harness._weights(cell, args.seed, device), device)
        plane = _plane(model, cell.mix, vocab)
        edge = {k: plane[k] * EDGE_SLOWDOWN
                for k in ("alpha_n", "alpha_m", "beta")}
        print(json.dumps({"workload": args.workload, "card_plane": plane,
                          "scale": EDGE_SLOWDOWN, "edge_plane": edge}))
        return 0
    rates = [float(r) for r in args.rates.split(",") if r]
    cell.mix["arrival"]["rate_hz"] = rates[0]
    setup = harness.set_up(cell, args.seed, device, False)
    for rate in rates:
        engine = setup.fresh_engine()
        card_index = setup.card_index
        sched = traffic_lib.schedule(cell.mix, args.seed, vocab,
                                     args.seconds, rate_hz=rate)
        t0 = time.perf_counter()
        win = loops.open_loop(engine, setup.adapter, card_index, sched)
        late = np.array([s.late_s for s in win.served])
        lat = np.array([s.latency_s for s in win.served])
        q = max(1, len(late) // 5)
        print(json.dumps({
            "workload": args.workload, "rate_hz": rate,
            "requests": len(late), "wall_s": time.perf_counter() - t0,
            "late_first_fifth_ms": 1e3 * float(late[:q].mean()),
            "late_last_fifth_ms": 1e3 * float(late[-q:].mean()),
            "late_max_ms": 1e3 * float(late.max()),
            "latency_mean_ms": 1e3 * float(lat.mean()),
            "latency_p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "card_share": float(np.mean([s.device == card_index
                                         for s in win.served])),
            "blocks": len(win.blocks),
            "capture_pct": 100 * win.capture_s / win.length_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
