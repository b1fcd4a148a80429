"""Resolve a cell of ``BENCHMARK.json`` into its configuration, its traffic
mix and its metrics, by name.

A configuration is ``configs[].file``; a traffic mix is
``hbench/traffic/<traffic>.json``; a per-layer metric ``<base>.<split>`` or
``<base>`` is read by ``hbench/metrics/<base>.py``.  A later benchmark adds
a cell, a mix or a metric by adding files and entries, not by editing these.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HBENCH = Path(__file__).resolve().parents[1]
ROOT = HBENCH.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: tuple       # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", (cell,))


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``; ``KeyError`` if ``BENCHMARK.json`` has none."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((HBENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=cfg, mix=mix,
                end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)))


def metric_file(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<base>.py``, where
    ``base`` is the name up to its first dot (``dense_roofline.flood`` and
    ``dense_roofline.steady`` share one reader)."""
    return HBENCH / "metrics" / f"{name.split('.')[0]}.py"


def load_reader(name: str):
    """The ``read(run) -> float | None`` function of metric ``name``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"hbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
