"""The knee of an open-loop cell: the highest offered rate the server
sustains without a growing backlog, by one sweep on the card.

    python3 hbench/tools/knee.py --workload gauss2d.steady --rates 100,120,140 --seconds 20

Builds the cell's program once and warms it, then offers each rate for
``--seconds`` (the cell's mix with its open sources' ``rate_rps``
replaced; a seed of its own per rate).  Per rate it prints the answered rate, the latency's
median and 95th percentile, the mean panel width and the backlog's growth:
the median latency of the last quarter of the requests less that of the
first quarter (near 0 while the server keeps up).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

HBENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HBENCH.parent / "src"), str(HBENCH)]


def main() -> int:
    import numpy as np
    import torch

    from harness import bench, cells, inputs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    device = torch.device(args.device)
    cell = cells.resolve(args.workload)
    if not any(s["kind"] == "open" for s in cell.mix["sources"]):
        raise SystemExit("knee: the cell's mix has no open source")
    n = int(cell.config["n"])
    prog = bench.start(cell, device)
    pool = inputs.request_pool(1, int(cell.mix["pool"]), n, device)
    rows = inputs.sampled_rows(1, n, bench.SAMPLED_ROWS)
    bench.warm(prog.srv, cell.mix, pool)
    lines = []
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        sources = [dict(s, rate_rps=rate) if s["kind"] == "open" else s
                   for s in cell.mix["sources"]]
        at = dataclasses.replace(cell, mix=dict(cell.mix, sources=sources))
        m = bench.measure(prog, at, 1000 + i, pool, rows, args.seconds, False, device)
        win = m["window"]
        lat = win.latency_s()
        q = max(1, lat.size // 4)
        line = {"offered_rps": rate, "answered_rps": win.rps(),
                "unanswered": int((~win.answered()).sum()),
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p95_ms": float(np.percentile(lat, 95) * 1e3),
                "backlog_growth_ms": float((np.median(lat[-q:]) - np.median(lat[:q])) * 1e3),
                "mean_width": float(np.mean(m["stats"]["widths"])) if m["stats"]["widths"]
                else None,
                "requests_a_panel": m["stats"]["requests"] / max(1, m["stats"]["panels"]),
                "panels": m["stats"]["panels"],
                "late_p95_ms": float(np.percentile(win.late_s, 95) * 1e3)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    bench.free(prog, device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rates": lines}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
