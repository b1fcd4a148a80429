#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` with the program's tracer on over the
measured window, then print what its spans read.

    python3 scripts/trace_cell.py --workload gauss2d.steady --seed 7 --seconds 51 \\
        --trace 1 [--out build/spans.json]

Run from the root of a checkout, on a CUDA card.  It is ``hbench/run.py``
(the same set-up, window, judge and result line) with ``repro_torch.obs``
enabled from the window's start (``install``).  With ``--trace 1`` the
records are collected once the window has closed, and the program's host
spans, those still open among them, join the harness's own in naming the
device's idle gaps.  After the result
line it prints one JSON line of readings (the functions below, each
``read(run) -> float | None`` on ``run["program"]``); ``--out`` keeps the
records.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HBENCH = ROOT / "hbench"
STAGES = ("runtime.upload", "apply.permute_in", "apply.lowrank", "apply.dense",
          "apply.scatter", "apply.permute_out", "runtime.transpose")


def _spans(run: dict, name: str):
    """The records called ``name`` of ``run["program"]``, or None when there
    is no program record or it dropped records."""
    program = run.get("program")
    if program is None or program["dropped"]:
        return None
    return [s for s in program["spans"] if s["name"] == name]


def queue_wait_ms(run: dict):
    """95th percentile of the window's ``runtime.queued`` spans, ms."""
    spans = _spans(run, "runtime.queued")
    if not spans:
        return None
    return float(np.percentile([(s["t1_ns"] - s["t0_ns"]) / 1e6 for s in spans], 95))


def slot_wait_share(run: dict):
    """``runtime.slot_wait`` time over the traced window, %: how much of it
    the card, not the batching policy, held the scheduler."""
    spans = _spans(run, "runtime.slot_wait")
    if not spans:
        return None
    w0, w1 = run["program"]["t0_ns"], run["program"]["t1_ns"]
    held = sum(max(0, min(s["t1_ns"], w1) - max(s["t0_ns"], w0)) for s in spans)
    return 100.0 * held / (w1 - w0)


def device_ms(name: str):
    """The reader of the device ms of ``name``'s spans a panel: summed over
    each panel's spans (a batched stage has one a batch), the mean over
    the panels."""
    def read(run: dict):
        spans = _spans(run, name)
        if not spans:
            return None
        panels: dict = {}
        for s in spans:
            panels[s["panel"]] = panels.get(s["panel"], 0.0) + s["device_ms"]
        return float(np.mean(list(panels.values())))
    return read


scatter_ms = device_ms("apply.scatter")
aca_ms = device_ms("apply.aca")


def batches(name: str):
    """The reader of the batches an apply ran a stage in: the ``batches``
    of ``name``'s spans (``apply.lowrank``, ``apply.dense``), the largest."""
    def read(run: dict):
        spans = _spans(run, name)
        counts = [s["batches"] for s in spans or () if s.get("batches") is not None]
        return max(counts) if counts else None
    return read


def stage_gap(run: dict):
    """The largest share of a panel's ``device.panel`` time that its seven
    stage spans (``STAGES``) do not account for, % (absolute)."""
    panels = _spans(run, "device.panel")
    if not panels:
        return None
    stages: dict = {}
    for s in run["program"]["spans"]:
        if s["name"] in STAGES:
            stages[s["panel"]] = stages.get(s["panel"], 0.0) + s["device_ms"]
    return max(100.0 * abs(p["device_ms"] - stages.get(p["panel"], 0.0)) / p["device_ms"]
               for p in panels)


READINGS = {"queue_wait_ms": queue_wait_ms, "slot_wait_share": slot_wait_share,
            "scatter_ms": scatter_ms, "stage_gap_pct": stage_gap, "aca_ms": aca_ms,
            "lowrank_batches": batches("apply.lowrank"), "dense_batches": batches("apply.dense"),
            "device_panel_ms": device_ms("device.panel"),
            **{f"{name}_ms": device_ms(name) for name in STAGES if name != "apply.scatter"}}


def readings(run: dict) -> dict:
    out = {name: read(run) for name, read in READINGS.items()}
    program = run.get("program")
    if program is not None:
        names: dict = {}
        for s in program["spans"]:
            names[s["name"]] = names.get(s["name"], 0) + 1
        out.update(dropped=program["dropped"], counts=names)
    return out


def host_spans(program: dict) -> list:
    """The program's host spans as the harness keeps its own, ``(name,
    thread, t0_ns, t1_ns)``, but ``runtime.queued``: a request waiting is
    no thread's work, and some request waits through nearly every gap."""
    return [(s["name"], s["thread"], s["t0_ns"], s["t1_ns"]) for s in program["spans"]
            if s["kind"] == "host" and s["name"] != "runtime.queued"]


def install(bench, drive, tracing, obs, patch=setattr) -> dict:
    """Wrap the harness so that the tracer is on from the window's start:
    ``drive.run`` enables it; ``trace.reduce_trace`` (a traced run, after the
    window has closed) collects it and names the idle gaps by the program's
    host spans too; ``bench.run_cell`` collects it if nothing did and puts
    the records under ``run["program"]``.  Returns the dict that keeps them."""
    kept: dict = {}
    drive_run, reduce_trace, run_cell = drive.run, tracing.reduce_trace, bench.run_cell

    def collect():
        if "program" not in kept:
            obs.disable()
            kept["program"] = dict(obs.collect(), t0_ns=kept["t0_ns"], t1_ns=kept["t1_ns"])
        return kept["program"]

    def run(srv, plan, pool, rows, seconds, spans):
        kept["t0_ns"] = time.perf_counter_ns()
        obs.enable()
        try:
            win = drive_run(srv, plan, pool, rows, seconds, spans)
            srv.runtime.drain()
        finally:
            kept["t1_ns"] = time.perf_counter_ns()
        return win

    def reduce(trace, mark_ns, t_start_ns, t_end_ns, spans):
        return reduce_trace(trace, mark_ns, t_start_ns, t_end_ns,
                            list(spans) + host_spans(collect()))

    def cell(*args, **kw):
        result = run_cell(*args, **kw)
        result["run"]["program"] = collect()
        kept["run"] = result["run"]
        return result

    patch(drive, "run", run)
    patch(tracing, "reduce_trace", reduce)
    patch(bench, "run_cell", cell)
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the records and readings here as JSON")
    args, rest = ap.parse_known_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HBENCH)]
    import run as hbench_run
    from harness import bench, drive
    from harness import trace as tracing

    from repro_torch import obs

    kept = install(bench, drive, tracing, obs)
    rc = hbench_run.main(rest)
    if rc != 0 or "run" not in kept:
        return rc
    line = readings(kept["run"])
    print(json.dumps({"program": line}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"readings": line,
                                              "program": kept["run"]["program"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
