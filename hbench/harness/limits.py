"""The readings a judge's limit is set from, in one process.

The program is built once; each seed's pool is served at the cell's own
load for a short window and its answers kept at the seed's sampled rows.
With the program freed, every answer is judged against the exact rows
(the program's readings, the lower ones), and so is the control, the
reference one precision below the configuration's (TF32), on the same
requests (the upper readings).
"""
from __future__ import annotations

import numpy as np
import torch

from . import bench, inputs, judge
from .cells import Cell


def readings(cell: Cell, seeds, seconds: float, device) -> list:
    """One dict per seed: the program's worst and median relative error,
    the control's worst, best and median on the same requests, and the
    window's rate and tail."""
    from reference.exact import control_rows, exact_rows
    device = torch.device(device)
    n, size = int(cell.config["n"]), int(cell.mix["pool"])
    prog = bench.start(cell, device)
    kept = []
    for i, seed in enumerate(seeds):
        pool = inputs.request_pool(seed, size, n, device)
        rows = inputs.sampled_rows(seed, n, bench.SAMPLED_ROWS)
        if i == 0:
            bench.warm(prog.srv, cell.mix, pool)
        m = bench.measure(prog, cell, seed, pool, rows, seconds, False, device)
        kept.append((seed, rows, m["window"], m["stats"]["panels"]))
    bench.free(prog, device)
    out = []
    for seed, rows, win, panels in kept:
        pool = torch.from_numpy(inputs.request_pool(seed, size, n, device))
        rows_t = torch.from_numpy(rows)
        ref = exact_rows(prog.pts, rows_t, pool, cell.config["kernel"]).cpu().numpy()
        ctrl = control_rows(prog.pts, rows_t, pool, cell.config["kernel"],
                            cell.config["precision"]).cpu().numpy()
        ok = win.answered()
        used = win.pool_index[ok]
        errs = judge.rel_errors(win.samples[ok], used, ref)
        ctrl_errs = judge.rel_errors(ctrl[:, used].T, used, ref)
        out.append({"seed": seed, "answered": int(ok.sum()), "unanswered": int((~ok).sum()),
                    "panels": panels, "program_max": float(errs.max()),
                    "program_median": float(np.median(errs)),
                    "control_max": float(ctrl_errs.max()),
                    "control_min": float(ctrl_errs.min()),
                    "control_median": float(np.median(ctrl_errs)),
                    "rps": win.rps(),
                    "p95_ms": float(np.percentile(win.latency_s(), 95) * 1e3)})
    return out
