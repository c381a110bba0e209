"""One run of one cell: set-up, the window, the check, the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<traffic>.json``), the
reference of its configuration's family (``reference/<family>.py``) and
one reader per metric (``metrics/<metric>.py``, a ``read(run)`` that
returns a number, or None when the run has nothing for it to read).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict

import torch

from cnmt_bench.lib import check, loops, peaks, system
from cnmt_bench.lib import traffic as traffic_lib
from cnmt_bench.lib import weights as weights_lib
from cnmt_bench.lib.trace import Slice

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path) -> ModuleType:
    """A module from its file (names may hold dots: ``mfu.docs.py``)."""
    spec = importlib.util.spec_from_file_location(
        "cnmt_bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    mix: Dict
    reference: ModuleType
    end_to_end: list
    per_layer: list


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    workload = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"])
                        .read_text())
    mix = json.loads((root / "cnmt_bench" / "traffic"
                      / f"{workload['traffic']}.json").read_text())
    reference = load_module(root / "cnmt_bench" / "reference"
                            / f"{config['reference']}.py")
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, workload, config, mix, reference, e2e, layer)


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""

    cell: Cell
    window: loops.Window
    setup_s: float
    widths: Dict
    peaks: ModuleType = peaks


def read_metrics(root: Path, specs: list, run: Run) -> Dict:
    out = {}
    for spec in specs:
        reader = load_module(root / "cnmt_bench" / "metrics"
                             / f"{spec['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def _weights(cell: Cell, seed: int, device):
    return weights_lib.make(cell.reference.param_spec(cell.config["widths"]),
                            seed, device)


@dataclasses.dataclass
class Setup:
    """The program as a run drives it, warmed up; :meth:`fresh_engine` for
    another window with empty queues."""

    model: object
    adapter: system.Adapter
    engine: object
    card_index: int
    card: object
    n2m: object
    mix: Dict
    seed: int

    def fresh_engine(self):
        self.engine, self.card_index = system.build_engine(
            self.mix, self.adapter, self.card, self.n2m, self.seed)
        return self.engine


def set_up(cell: Cell, seed: int, device, tracing: bool) -> Setup:
    """The program at the cell's configuration with the seed's weights,
    its engine, warmed up on the cell's own traffic (a stream apart from
    the window's).  Logs each phase's seconds on standard error."""
    clock = [time.perf_counter()]

    def phase(what):
        now = time.perf_counter()
        print(f"set-up: {what} {now - clock[0]:.3f} s", file=sys.stderr)
        clock[0] = now

    torch.zeros(1, device=device).add_(1).cpu()
    phase("device context")
    model = system.build_model(cell.config, _weights(cell, seed, device),
                               device)
    phase("weights and model")
    vocab = int(cell.config["widths"]["vocab_src"])
    mix = cell.mix
    adapter = system.Adapter(model, tracing)
    card = (system.calibrate(model, mix["calibration"], vocab)
            if "calibration" in mix else system.nominal_card())
    phase("calibration")
    n2m = system.n2m_of(mix)
    engine, card_index = system.build_engine(mix, adapter, card, n2m, seed)
    if mix["loop"] == "closed":
        warm = traffic_lib.backlog(mix, seed, vocab, stream=1)
        for _ in range(int(mix["warmup"]["calls"])):
            call = next(warm)
            adapter.expect(call)
            engine.submit_batch([r.tokens for r in call], now_s=0.0)
    else:
        warm = traffic_lib.schedule(mix, seed, vocab,
                                    float(mix["warmup"]["seconds"]),
                                    stream=1)
        loops.open_loop(engine, adapter, card_index, warm)
    phase("warm-up")
    adapter.blocks.clear()
    adapter.served.clear()
    if tracing and device.type == "cuda":
        Slice.warm()
    setup = Setup(model, adapter, None, card_index, card, n2m, mix, seed)
    setup.fresh_engine()
    return setup


def window(cell: Cell, setup: Setup, seed: int, seconds: float,
           tracing: bool, device) -> loops.Window:
    mix = cell.mix
    adapter, engine, card_index = setup.adapter, setup.engine, \
        setup.card_index
    vocab = int(cell.config["widths"]["vocab_src"])
    profiler = (Slice(max(0.0, seconds - float(mix["trace"]["last_s"])))
                if tracing and device.type == "cuda" else None)
    if mix["loop"] == "closed":
        return loops.closed_loop(engine, adapter, card_index,
                                 traffic_lib.backlog(mix, seed, vocab),
                                 seconds, profiler)
    return loops.open_loop(engine, adapter, card_index,
                           traffic_lib.schedule(mix, seed, vocab, seconds),
                           profiler)


def device_info(device, count: int, peak_bytes: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak_bytes}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak_bytes}


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> Dict:
    """The result of one run (the dict printed as the last line)."""
    cell = find_cell(root, name)
    print(f"set-up: start and imports {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr)
    setup = set_up(cell, seed, device, trace)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = window(cell, setup, seed, seconds, trace, device)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    answers, card_index = dict(setup.adapter.served), setup.card_index
    del setup
    system.release()

    run = Run(cell, win, setup_s, cell.config["widths"])
    metrics = read_metrics(root, cell.per_layer if trace else cell.end_to_end,
                           run)
    t_check = time.perf_counter()
    sample = check.sample(win.served, card_index, answers, seed,
                          int(cell.mix["check"]["sample"]))
    params = _weights(cell, seed, device)
    gaps = check.widest_gaps(cell.reference, params, cell.config["widths"],
                             sample, answers, device)
    del params
    print(f"check: {len(sample)} requests, {gaps['positions']} positions, "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = check.verdict(win.served, card_index, answers, gaps,
                           float(cell.config["check"]["logit_gap_limit"]))
    failed = checks["unserved"]["value"] + checks["wrong_length"]["value"]
    result = {"correct": check.passed(checks),
              "attempted": len(win.served), "failed": failed,
              "metrics": metrics,
              "device": device_info(device, int(cell.workload["chips"]),
                                    peak)}
    if trace and win.slice is not None:
        result["device"]["busy_s"] = win.slice.busy_s
        result["device"]["window_s"] = win.slice.window_s
        result["breakdown"] = {
            "device_ops": win.slice.top(win.slice.kernel_s),
            "idle_gaps": win.slice.top(win.slice.idle_by_host)}
    result["checks"] = checks
    return result
