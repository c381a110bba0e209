"""A cell, a traffic mix and a per-layer metric added as new files and
new manifest entries only are found by name and run."""

import json
import time

import torch

from cnmt_bench.lib import harness


def test_new_cell_mix_and_metric_from_added_files(tiny_root):
    (tiny_root / "cnmt_bench/metrics/blocks_run.docs.py").write_text(
        '"""Blocks the card ran in the window."""\n\n\n'
        "def read(run):\n    return len(run.window.blocks) or None\n")
    mix = json.loads((tiny_root / "cnmt_bench/traffic/tiny-docs.json")
                     .read_text())
    mix["per_call"] = 4
    (tiny_root / "cnmt_bench/traffic/tiny-docs4.json").write_text(
        json.dumps(mix))
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny-marian.docs4",
                           "config": "tiny-marian", "traffic": "tiny-docs4",
                           "chips": 1, "why": "added by files only"})
    for e in m["end_to_end"]:
        if e["name"] == "tokens_per_s":
            e["workloads"].append("tiny-marian.docs4")
    m["per_layer"].append({"name": "blocks_run.docs", "unit": "blocks",
                           "better": "higher", "source": "program_span",
                           "layer": "Batching (data/pipeline.py TokenBatcher)",
                           "moves": "tokens_per_s",
                           "workloads": ["tiny-marian.docs4"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.find_cell(tiny_root, "tiny-marian.docs4")
    assert cell.mix["per_call"] == 4
    assert [e["name"] for e in cell.per_layer] == ["blocks_run.docs"]
    r = harness.run_cell(tiny_root, "tiny-marian.docs4", 42, 0.5, True,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["blocks_run.docs"]["value"] >= 1
    r = harness.run_cell(tiny_root, "tiny-marian.docs4", 42, 0.5, False,
                         torch.device("cpu"), time.perf_counter())
    assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
