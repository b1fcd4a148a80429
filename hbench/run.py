"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 hbench/run.py --workload gauss2d.steady --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  The last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the judge compared, with its limit (also the last lines on standard
error).  ``card`` (power limit), ``window`` (latency median, panels, the
span to the last answer) and ``setup`` (seconds from the process's start
at each set-up stage's end, and each stage's own seconds) are for reading
a run.  Without a CUDA card, or with fewer cards than the cell asks for,
it prints no result and exits with 2.

The program builds its kernels into ``build/repro_torch/<hash>/`` inside
the checkout, a fixed path, so only a checkout's first run compiles.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBENCH = Path(__file__).resolve().parent
ROOT = HBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Modules (``sys.modules`` unless ``names`` is given) whose top-level
    name, compared whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HBENCH)]
    from harness import bench, cells

    marks = {"python_at_s": bench.process_age_s()}
    cell = cells.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"hbench: the program is not in this checkout ({exc})", file=sys.stderr)
        return 3
    marks["program_import_at_s"] = bench.process_age_s()
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), setup=marks)
    bad = forbidden_modules()
    if bad:
        print(f"hbench: the run loaded {bad}; nothing it runs may import JAX or the "
              f"JAX package", file=sys.stderr)
        return 4
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"],
            "metrics": bench.metrics_line(cell, result, bool(args.trace)),
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": result["memory_peak_bytes"]},
            "card": {"power_limit": power_limit(), "torch": torch.__version__},
            "window": result["window"], "setup": result["setup"]}
    trace = result["run"]["trace"]
    if args.trace:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = result["checks"]
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
