"""BENCHMARK.json against the rules a manifest keeps: names, units, files
found by name, what every cell reports, the run length's budget."""

import json
import re

import pytest

from conftest import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert len(M["command"]) <= 32 and M["command"][1].startswith("cnmt_bench/")
    assert len(json.dumps(M)) < 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_one_line_fields():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert all(NAME.match(e["name"]) for e in M[group])
    for e in M["configs"] + M["workloads"]:
        assert _one_line(e["why"])
    assert all(_one_line(c["source"]) for c in M["configs"])
    assert all(_one_line(e["layer"]) for e in M["per_layer"])
    assert all(_one_line(word) for word in M["command"])
    metrics = M["end_to_end"] + M["per_layer"]
    for e in metrics:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in M[group]}) == len(M[group])


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for e in M["end_to_end"]:
        assert set(e) <= METRIC_KEYS | {"bound"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in M["per_layer"]:
        assert set(e) <= METRIC_KEYS | {"layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_name_finds_its_file():
    configs = {c["name"] for c in M["configs"]}
    for c in M["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("cnmt_bench/")
        ref = json.loads(f.read_text())["reference"]
        assert (ROOT / f"cnmt_bench/reference/{ref}.py").is_file()
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    for w in M["workloads"]:
        assert w["config"] in configs
        assert (ROOT / f"cnmt_bench/traffic/{w['traffic']}.json").is_file()
    for e in M["end_to_end"] + M["per_layer"]:
        assert (ROOT / f"cnmt_bench/metrics/{e['name']}.py").is_file()
    used = {w["config"] for w in M["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_what_each_cell_reports(cell):
    e2e = [e["name"] for e in M["end_to_end"]
           if cell in e.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [e for e in M["per_layer"] if cell in e.get("workloads", [])]
    assert layer
    for e in M["per_layer"]:
        cells = e.get("workloads", [])
        assert e["moves"] in [x["name"] for x in M["end_to_end"]]
        if cell in cells:
            assert e["moves"] in e2e


def test_layers_name_one_layer_one_way():
    layers = {e["layer"] for e in M["per_layer"]}
    stems = {}
    for e in M["per_layer"]:
        stems.setdefault(e["name"].split(".")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in stems.values())
    assert all(1 <= len(x) <= 200 for x in layers)


def test_run_seconds_fit_the_check_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
