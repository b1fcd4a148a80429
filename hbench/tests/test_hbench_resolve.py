"""BENCHMARK.json resolves by name, and keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from hb_util import HBENCH

ROOT = HBENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hbench/run.py"]
    assert BENCH["paths"] == ["hbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    from harness import cells, traffic
    cell = cells.resolve(name)
    traffic.check_mix(cell.mix)
    assert cell.chips == 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_resolves(name):
    from harness import cells
    assert callable(cells.load_reader(name))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("hbench/configs/")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["limits"]["rel_err"] > 0
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for w in BENCH["workloads"]:
        assert (HBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_cell_raises():
    from harness import cells
    with pytest.raises(KeyError):
        cells.resolve("no-such-cell")
