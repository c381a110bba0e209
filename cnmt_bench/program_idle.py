"""One cell with the program's own spans on: where the card's idle time
lies, by step of the program, and what the spans cost.

    python3 cnmt_bench/program_idle.py --workload <cell> --seed <n>
        --seconds <s> [--cost-seconds 15] [--cost-rounds 2]

One process, one set-up (``repro_torch.runtime.telemetry`` on from the
start).  First a window as a ``--trace 1`` run's: the profiler over its
last ``trace.last_s`` seconds, every existing per-layer metric read by
its reader, and beside them the idle shares by innermost program span
(``cnmt_bench/lib/program_trace.py``, the device's events moved onto
the host's clock), the graph keys built in the window and the capture
milliseconds a key.  Then ``--cost-rounds``
rounds of four untraced windows of ``--cost-seconds`` each, spans off,
on, on, off, each a fresh engine over the same backlog as the first
window (a prefix of its calls: every graph key already built), and the
``tokens_per_s`` of each; last, an empty span's host microseconds, off
and on.  Beside each window, the garbage collector's pauses in it.

Run from the repository's root, on a card.  The last line of standard
output is one JSON object.  Exits 2 without a card or when the program
has no telemetry.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class GcPauses:
    """Seconds the interpreter's garbage collector paused, and its longest
    pause, since the last :meth:`take` (a pause lands inside whatever step
    allocated last, program or benchmark)."""

    def __init__(self):
        self.total = self.longest = 0.0
        self._t0 = 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            pause = time.perf_counter() - self._t0
            self.total += pause
            self.longest = max(self.longest, pause)

    def take(self) -> dict:
        out = {"gc_s": self.total, "gc_longest_s": self.longest}
        self.total = self.longest = 0.0
        return out

    def close(self) -> None:
        gc.callbacks.remove(self._on)


def span_cost_us(telemetry, n: int = 20000) -> dict:
    """Host microseconds of one empty span, spans off and on (no profiler
    running)."""
    out = {}
    for on in (False, True):
        telemetry.enable(on)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with telemetry.span("repro_torch.cost"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n / 1e3
    telemetry.enable(False)
    return out


def measure(root: Path, workload: str, seed: int, seconds: float,
            cost_seconds: float, cost_rounds: int, device, t_start: float):
    """The result (the dict printed as the last line) of one cell of
    ``root/BENCHMARK.json`` on ``device``."""
    import torch

    from cnmt_bench.lib import harness, loops, program_trace
    from cnmt_bench.lib import traffic as traffic_lib
    from cnmt_bench.lib.trace import Slice
    from repro_torch.runtime import telemetry

    class KeptSlice(Slice):
        """The harness's slice, reduced with the program's spans apart."""

        reduced = program_trace.Reduced(None)

        def close(self):
            if self.prof is None:
                return None
            torch.cuda.synchronize()
            self.prof.stop()
            self.reduced = program_trace.reduce(self.prof)
            return self.reduced.summary

    cell = harness.find_cell(root, workload)
    if cell.mix["loop"] != "closed":
        raise ValueError("a closed-loop (docs) cell only")
    vocab = int(cell.config["widths"]["vocab_src"])

    def window(secs, slice_=None):
        return loops.closed_loop(setup.fresh_engine(), setup.adapter,
                                 setup.card_index,
                                 traffic_lib.backlog(cell.mix, seed, vocab),
                                 secs, slice_)

    telemetry.enable(True)
    setup = harness.set_up(cell, seed, device, True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # the traced window
    pauses = GcPauses()
    before = program_trace.program_counters()
    spans0 = telemetry.snapshot()["spans"]
    last_s = float(cell.mix["trace"]["last_s"])
    slice_ = KeptSlice(max(0.0, seconds - last_s))
    win = window(seconds, slice_)
    moved = program_trace.delta(before, program_trace.program_counters())
    spans = {name: {k: v - spans0.get(name, {}).get(k, 0)
                    for k, v in tot.items()}
             for name, tot in telemetry.snapshot()["spans"].items()}
    run = harness.Run(cell, win, setup_s, cell.config["widths"])
    metrics = harness.read_metrics(root, cell.end_to_end + cell.per_layer,
                                   run)
    red = slice_.reduced
    new = program_trace.idle_shares(red)
    new.update(program_trace.key_metrics(moved))
    s, a = win.slice, red.aligned

    def idle_pct(summary):
        return (100.0 * (1.0 - summary.busy_s / summary.window_s)
                if summary else None)

    traced = {
        "metrics": {k: v["value"] for k, v in metrics.items()},
        "program_metrics": new,
        "window_s": s.window_s if s else None,
        "idle_pct_aligned": idle_pct(a),
        "idle_by_program": a.top(red.by_program, 20) if a else [],
        "idle_by_program_raw": a.top(red.by_program_raw, 20) if a else [],
        "clock": red.clock,
        "idle_gaps": s.top(s.idle_by_host) if s else [],
        "idle_gaps_aligned": a.top(a.idle_by_host) if a else [],
        "capture_pct_from_keys": (
            100.0 * new["capture_ms_per_key"] * new["graph_keys_built"]
            / 1e3 / win.length_s if new.get("capture_ms_per_key") else None),
        "counters": moved, "spans": spans, "length_s": win.length_s,
        **pauses.take()}

    # the spans' cost: untraced windows, spans off / on in turns
    setup.adapter.tracing = False
    tps = [m for m in cell.end_to_end if m["name"] == "tokens_per_s"]
    cost = {"off": [], "on": [], "capture_s": [], "gc_s": []}
    for _ in range(cost_rounds):
        for on in (False, True, True, False):
            telemetry.enable(on)
            w = window(cost_seconds)
            got = harness.read_metrics(
                root, tps, harness.Run(cell, w, setup_s,
                                       cell.config["widths"]))
            cost["on" if on else "off"].append(got["tokens_per_s"]["value"])
            cost["capture_s"].append(w.capture_s)
            cost["gc_s"].append(pauses.take()["gc_s"])
    pauses.close()
    telemetry.enable(False)
    cost["span_us"] = span_cost_us(telemetry)
    if cost["off"]:
        off = statistics.median(cost["off"])
        cost["on_vs_off_pct"] = 100.0 * (statistics.median(cost["on"])
                                         - off) / off
    return {"workload": workload, "seed": seed,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "setup_s": setup_s, "traced": traced, "cost": cost}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-seconds", type=float, default=15.0)
    ap.add_argument("--cost-rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cnmt_bench.run import CACHE_DIRS
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from repro_torch.runtime import telemetry  # noqa: F401
    except ImportError:
        print("the program has no telemetry", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(json.dumps(measure(ROOT, args.workload, args.seed, args.seconds,
                             args.cost_seconds, args.cost_rounds,
                             torch.device("cuda", 0), t_start)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
