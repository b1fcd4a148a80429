"""Readings the judge's limit is set from, on the card, in one process.

    python3 hbench/tools/limits.py --workload gauss2d.steady --seeds 1,2,3 --seconds 5

Serves each seed's pool at the cell's own load for ``--seconds`` on one
build of the program, then judges the program's answers and the control's
(``harness.limits``).  Prints one JSON line per seed and a summary: the
lower reading (the program's worst) and the upper one (the control's
least worst); with ``--out`` writes them there too.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HBENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HBENCH.parent / "src"), str(HBENCH)]


def main() -> int:
    import run as hrun
    import torch

    from harness import cells, limits

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = cells.resolve(args.workload)
    lines = limits.readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                            args.device)
    for line in lines:
        print(json.dumps(line), flush=True)
    cuda = torch.device(args.device).type == "cuda"
    summary = {"workload": args.workload, "lower": max(x["program_max"] for x in lines),
               "upper": min(x["control_max"] for x in lines),
               "card": torch.cuda.get_device_name(0) if cuda else "cpu",
               "power_limit": hrun.power_limit() if cuda else None}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"seeds": lines, "summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
