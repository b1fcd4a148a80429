"""Helpers of the benchmark's tests."""
from __future__ import annotations

import dataclasses
from pathlib import Path

HBENCH = Path(__file__).resolve().parents[1]


def small_cell(name: str, n: int = 4096, c_leaf: int = 128):
    """Cell ``name`` at a size a CPU test holds: ``n`` points, leaves of
    ``c_leaf``, the mix's load and panel width scaled down with it (an
    open source at 30 requests/s into panels of 16, a closed one of 32
    callers into panels of 8)."""
    from harness import cells
    cell = cells.resolve(name)
    mix = dict(cell.mix)
    if any(s["kind"] == "open" for s in mix["sources"]):
        width, warm = 16, [4, 8, 16]
    else:
        width, warm = 8, [8]
    mix.update(server=dict(mix["server"], max_batch=width),
               warm=dict(mix["warm"], widths=warm),
               sources=[dict(s, rate_rps=30) if s["kind"] == "open" else dict(s, clients=32)
                        for s in mix["sources"]])
    return dataclasses.replace(cell, config=dict(cell.config, n=n, c_leaf=c_leaf), mix=mix)
