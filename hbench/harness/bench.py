"""One run of one cell: set-up, the measured window, the trace, the judge,
and the result line.

Set-up makes the configuration's points on the device, builds the
H-matrix with ``build_hmatrix`` as the configuration states it (``k``,
``c_leaf``, ``eta``, ``precompute``: stored factors or not), makes the
request pool from the seed, starts an ``HMatrixServer`` with the mix's
``server`` settings and warms the panel widths the mix uses through the
same submit and fetch the window uses.  The window then drives the mix's
plan (``traffic.plan``, ``drive.run``); with ``trace`` the profiler
records it.  Once the window has
closed and every answer is in, the device's peak is read, the program's
state is freed, and the reference judges every answer at the sampled rows.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import drive, inputs, judge, traffic
from . import trace as tracing
from .cells import Cell, load_reader
from .work import plan_shapes

SAMPLED_ROWS = 512
GIB = float(1 << 30)


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in
    ``/proc/self/stat`` against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(srv, mix: dict, pool: np.ndarray):
    """``warm.panels`` panels of each of the mix's ``warm.widths``, through
    submit, flush and fetch, their answers held at once (the window's
    pinned fetch buffers come from the same cache).  Each panel is launched
    before the next is submitted, so that it keeps its width."""
    for w in mix["warm"]["widths"]:
        futs = []
        for _ in range(int(mix["warm"].get("panels", 1))):
            futs += [srv.submit(pool[j % pool.shape[0]]) for j in range(w)]
            srv.runtime.drain()
        held = [f.result() for f in futs]
        del held


def window_stats(before: dict, after: dict, requests: int) -> dict:
    """The runtime's counters over the window: its panels' widths (the
    width each computed, a partial panel padded to its bucket) and host
    pack seconds (the deques keep the last 1,024 panels), and the
    ``requests`` the window's panels carried."""
    panels = after["panels_launched"] - before["panels_launched"]
    kept = min(panels, len(after["launched_widths"]))
    return {"panels": panels, "complete": kept == panels, "requests": requests,
            "widths": list(after["launched_widths"])[len(after["launched_widths"]) - kept:],
            "pack_s": list(after["pack_s"])[len(after["pack_s"]) - kept:],
            "failures": after["panel_failures"] - before["panel_failures"],
            "shed": after["shed_requests"] - before["shed_requests"]}


@dataclass
class Program:
    """The system under test as set-up leaves it, and what set-up measured."""
    pts: torch.Tensor
    hm: object
    srv: object
    shapes: dict
    store_bytes: int
    build_s: float


def start(cell: Cell, device) -> Program:
    """The configuration's points, its H-matrix and the server."""
    from repro_torch.core.hmatrix import build_hmatrix
    from repro_torch.serve.step import HMatrixServer

    cfg, mix = cell.config, cell.mix
    traffic.check_mix(mix)
    if cfg["precision"] != {"dtype": "float32", "tf32": False}:
        raise ValueError(f"precision {cfg['precision']}: the apply serves float32 with "
                         f"TF32 off")
    pts = inputs.points(cfg, device)
    _sync(device)
    t = time.perf_counter()
    hm = build_hmatrix(pts, kernel=cfg["kernel"], k=cfg["k"], c_leaf=cfg["c_leaf"],
                       eta=cfg["eta"], precompute=bool(cfg["precompute"]), device=device)
    _sync(device)
    build_s = time.perf_counter() - t
    server = mix["server"]
    srv = HMatrixServer(hm, max_batch=int(server["max_batch"]),
                        deadline_s=server.get("deadline_s"))
    return Program(pts=pts, hm=hm, srv=srv,
                   shapes=plan_shapes(hm.plan, cfg["k"], cfg["kernel"], int(cfg["dim"])),
                   store_bytes=int(hm.memory_report()["factor_bytes"]), build_s=build_s)


def measure(prog: Program, cell: Cell, seed: int, pool: np.ndarray, rows: np.ndarray,
            seconds: float, trace: bool, device) -> dict:
    """The window of ``cell``'s mix on a warm server, traced or not: the
    window's record, the runtime's counters over it, the device's peak
    over it (reset at its start), set-up's peak, the seconds from the
    process's start to the window's, and the reduced trace."""
    srv = prog.srv
    spans = tracing.Spans()
    plan = traffic.plan(cell.mix, seed, seconds)
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.start()
        mark_ns = tracing.mark(record_function)
    stats0 = srv.runtime.stats()
    setup_s = process_age_s()
    t_start_ns = time.perf_counter_ns()
    win = drive.run(srv, plan, pool, rows, seconds, spans)
    srv.runtime.drain()
    t_end_ns = time.perf_counter_ns()
    reduced = None
    if prof is not None:
        prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            reduced = tracing.reduce_trace(tracing.load_trace(path), mark_ns, t_start_ns,
                                           t_end_ns, spans.items)
    return {"window": win, "stats": window_stats(stats0, srv.runtime.stats(), win.accepted),
            "window_peak": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0,
            "setup_peak": setup_peak, "setup_s": setup_s, "trace": reduced}


def free(prog: Program, device) -> None:
    """Stop the server and drop the program's state (the factors)."""
    prog.srv.close()
    prog.srv = prog.hm = None
    if device.type == "cuda":
        torch.cuda.empty_cache()


def served_errors(cell: Cell, pts: torch.Tensor, rows: np.ndarray, pool: np.ndarray,
                  win) -> tuple[bool, dict]:
    """The judge on every answered request of ``win`` (``judge.judge``)."""
    from reference.exact import exact_rows
    ref = exact_rows(pts, torch.from_numpy(rows), torch.from_numpy(pool), cell.config["kernel"])
    ok = win.answered()
    return judge.judge(win.samples[ok], win.pool_index[ok], ref.cpu().numpy(),
                       int((~ok).sum()), float(cell.config["limits"]["rel_err"]))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             setup: dict | None = None) -> dict:
    """Run ``cell`` once; returns the result line's fields.  ``setup``: the
    caller's own set-up marks, kept in the result's ``setup``."""
    device = torch.device(device)
    setup = dict(setup or {}, start_s=process_age_s())
    t = time.perf_counter()
    prog = start(cell, device)
    setup["program_s"] = time.perf_counter() - t
    setup["build_s"] = prog.build_s
    t = time.perf_counter()
    pool = inputs.request_pool(seed, int(cell.mix["pool"]), int(cell.config["n"]), device)
    rows = inputs.sampled_rows(seed, int(cell.config["n"]), SAMPLED_ROWS)
    setup["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm(prog.srv, cell.mix, pool)
    _sync(device)
    setup["warm_s"] = time.perf_counter() - t
    m = measure(prog, cell, seed, pool, rows, seconds, trace, device)
    free(prog, device)
    win = m["window"]
    correct, checks = served_errors(cell, prog.pts, rows, pool, win)
    lat = win.latency_s()
    e2e = {"apply_rps": win.rps(),
           "apply_p95_ms": float(np.percentile(lat, 95) * 1e3),
           "peak_gib": m["window_peak"] / GIB,
           "setup_s": m["setup_s"]}
    run = {"cell": cell.name, "config": cell.config, "mix": cell.mix, "shapes": prog.shapes,
           "stats": m["stats"], "store_bytes": prog.store_bytes, "build_s": prog.build_s,
           "trace": m["trace"]}
    return {"correct": correct, "attempted": int(win.due.shape[0]),
            "failed": int((~win.answered()).sum()), "e2e": e2e, "run": run, "checks": checks,
            "memory_peak_bytes": int(max(m["setup_peak"], m["window_peak"])),
            "window": {"late_p95_ms": float(np.percentile(win.late_s, 95) * 1e3),
                       "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
                       "panels": m["stats"]["panels"],
                       "span_s": float(np.nanmax(win.done) - win.t0) if win.answered().any()
                       else None},
            "setup": setup}


def metrics_line(cell: Cell, result: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (``trace`` on), each ``{"value", "unit"}``; a reader with nothing to
    read leaves its metric out."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            value = result["e2e"].get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = load_reader(m["name"])(result["run"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
