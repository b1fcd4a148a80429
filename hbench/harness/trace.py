"""Host spans of the benchmark's own calls into the program, and the
reduction of a ``torch.profiler`` trace to device numbers.

Spans are kept in memory (name, thread, start, end on ``perf_counter_ns``)
from every thread that drives the window.  The traced run marks the host
clock inside the trace once (a ``record_function`` named ``MARK``), which
maps the spans onto the trace's clock: an idle gap of the device is named
by the spans the host had open at its middle.

Device activity is the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events (CUPTI records every stream of the card, whichever thread launched).
"""
from __future__ import annotations

import contextlib
import json
import re
import threading
import time

MARK = "hbench.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host intervals; ``span(name)`` is a context manager."""

    def __init__(self):
        self.items: list = []          # (name, thread id, t0_ns, t1_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            # list.append is atomic under the interpreter lock
            self.items.append((name, threading.get_ident(), t0, time.perf_counter_ns()))


def mark(prof_record_function) -> int:
    """Enter a ``record_function(MARK)`` and return the host clock (ns) at
    its start; the trace holds the same instant on its own clock."""
    t = time.perf_counter_ns()
    with prof_record_function(MARK):
        pass
    return t


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:96] or name[:96]


def merged(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(trace: dict, mark_ns: int, t_start_ns: int, t_end_ns: int,
                 spans: list) -> dict:
    """Device numbers of the traced window ``[t_start_ns, t_end_ns]`` (host
    clock) from a chrome trace (``export_chrome_trace``'s JSON).

    Returns ``busy_s`` (union of device activity inside the window),
    ``window_s``, ``kernels`` ([(short name, seconds)], one per kernel
    launch in the window, clipped to it), ``device_ops`` and ``idle_gaps`` (the ten
    largest by total device time, and the ten longest gaps, each named by
    the host spans open at its middle).
    """
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError("trace: the host mark is missing")
    offset_us = float(marks[0]["ts"]) - mark_ns / 1e3     # trace us = host us + offset
    w0 = t_start_ns / 1e3 + offset_us
    w1 = t_end_ns / 1e3 + offset_us
    busy, kernels, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        name = short_name(e.get("name", "")) if e["cat"] == "kernel" else e["cat"]
        ops.append((name, (b - a) / 1e6))
        if e["cat"] == "kernel":
            kernels.append(ops[-1])
    by_name: dict = {}
    for name, s in ops:
        by_name[name] = by_name.get(name, 0.0) + s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps: between merged busy intervals, and at the window's edges
    spans_busy = merged(busy)
    edges = [w0] + [x for iv in spans_busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, a / 1e3 + offset_us, b / 1e3 + offset_us) for n, _, a, b in spans]
    idle = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        names = sorted({n for n, s0, s1 in host if s0 <= mid <= s1})
        idle.append(["+".join(names) if names else "no span", (b - a) / 1e6])
    return {"busy_s": sum(b - a for a, b in spans_busy) / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernels": kernels, "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": idle}


def load_trace(path) -> dict:
    with open(path) as f:
        return json.load(f)
