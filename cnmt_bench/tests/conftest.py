"""Shared set-up of the benchmark's CPU tests: the port and the benchmark
on the path, and a copy of the benchmark beside tiny cells that run on
the CPU in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny widths of each family, as the program's registry builds them at
# scale 0.05 with 64 words
TINY = {
    "marian": ("cnmt:en-zh", {"d_model": 24, "heads": 2, "d_ff": 102,
                              "enc_layers": 1, "dec_layers": 1,
                              "vocab_src": 64, "vocab_tgt": 64,
                              "max_src_len": 512, "max_decode_len": 32,
                              "ln_eps": 1e-5, "bos_id": 1}),
    "bilstm": ("cnmt:de-en", {"embed": 25, "hidden": 25, "layers": 2,
                              "vocab_src": 64, "vocab_tgt": 64,
                              "max_decode_len": 32, "bos_id": 1}),
}


def tiny_mix(root: Path, mix: str) -> dict:
    """The cell's traffic file cut to the tiny models' lengths."""
    t = json.loads((root / f"cnmt_bench/traffic/{mix}.en-zh.json")
                   .read_text())
    t["lengths"].update(n_mean_log=2.0, n_min=2, n_max=20, m_max=32,
                        pool_size=512)
    if mix == "docs":
        t["per_call"] = 16
        t["tiers"][0]["batch_size"] = 8
    else:
        t["arrival"]["rate_hz"] = 20.0
        t["tiers"][0]["plane"] = {"alpha_n": 1e-3, "alpha_m": 1e-2,
                                  "beta": 2e-2}
        t["calibration"] = {"n": [4, 8], "m": [4, 8], "reps": 1}
        t["warmup"]["seconds"] = 0.3
    t["check"]["sample"] = 16
    return t


def add_tiny_cells(root: Path) -> Path:
    """``root`` holding a copy of the benchmark plus tiny cells
    ``tiny-<family>.<docs|chat>``, added as new files and entries only."""
    shutil.copytree(ROOT / "cnmt_bench", root / "cnmt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for fam, (name, widths) in TINY.items():
        cfg = {"reference": fam,
               "program": {"name": name, "scale": 0.05, "vocab": 64,
                           "max_decode_len": 32},
               "widths": widths, "check": {"logit_gap_limit": 1e-5}}
        (root / f"cnmt_bench/configs/tiny-{fam}.json").write_text(
            json.dumps(cfg))
        m["configs"].append({"name": f"tiny-{fam}", "source": "test",
                             "file": f"cnmt_bench/configs/tiny-{fam}.json",
                             "reduced": [], "why": "test"})
    for mix in ("docs", "chat"):
        (root / f"cnmt_bench/traffic/tiny-{mix}.json").write_text(
            json.dumps(tiny_mix(root, mix)))
        for fam in TINY:
            cell = f"tiny-{fam}.{mix}"
            m["workloads"].append({"name": cell, "config": f"tiny-{fam}",
                                   "traffic": f"tiny-{mix}", "chips": 1,
                                   "why": "test"})
            for e in m["end_to_end"] + m["per_layer"]:
                if any(w.endswith("." + mix) for w in e.get("workloads", [])):
                    e["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return add_tiny_cells(tmp_path)
