#!/usr/bin/env python3
"""hlint_torch entry point: the device-discipline linter of the PyTorch port.

Usage::

    python scripts/hlint_torch/run.py                 # lint the port vs its baseline
    python scripts/hlint_torch/run.py path/to/file.py # lint specific files only
    python scripts/hlint_torch/run.py --json          # machine-readable output
    python scripts/hlint_torch/run.py --update-baseline

Exit status is 0 iff there are no non-baselined findings, no stale baseline
entries, and every baseline entry carries a justification.  Stdlib only: it
imports neither torch nor jax.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hlint_torch import framework  # noqa: E402
# importing the rule modules registers them
from hlint_torch import rules_host_sync, rules_kernel_contract, rules_lock  # noqa: E402,F401


def _finding_dict(f):
    return {"rule": f.rule, "path": f.path, "line": f.line, "qualname": f.qualname,
            "message": f.message}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="device-discipline linter of src/repro_torch")
    ap.add_argument("paths", nargs="*",
                    help="specific files to lint (default: the port, reconciled against the "
                         "baseline)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite baseline.json from the current findings (new entries get "
                         "justification=TODO, which still fails the run until filled in)")
    args = ap.parse_args(argv)

    root = framework.REPO_ROOT
    baseline = framework.load_baseline()
    if args.paths:
        findings = []
        for p in args.paths:
            path = Path(p)
            rel = (path.resolve().relative_to(root) if path.is_absolute() else path).as_posix()
            findings.extend(framework.check_source(rel, (root / rel).read_text()))
        keys = {framework.baseline_key(e) for e in baseline}
        new = [f for f in findings if f.key() not in keys]
        stale, unjustified = [], []
    else:
        findings = framework.walk_repo(root)
        new, _, stale, unjustified = framework.reconcile(findings, baseline)

    if args.update_baseline:
        old = {framework.baseline_key(e): e for e in baseline}
        entries, seen = [], set()
        for f in findings:
            if f.key() in seen:         # several findings can share one entry
                continue
            seen.add(f.key())
            e = old.get(f.key())
            entries.append({"rule": f.rule, "path": f.path, "qualname": f.qualname,
                            "message": f.message,
                            "justification": e["justification"] if e else "TODO"})
        framework.save_baseline(entries)
        print(f"wrote {len(entries)} entries to {framework.BASELINE_PATH}")
        return 0

    ok = not new and not stale and not unjustified
    if args.as_json:
        print(json.dumps({
            "findings": [_finding_dict(f) for f in new],
            "stale_baseline": stale,
            "unjustified_baseline": unjustified,
            "total_findings": len(findings),
            "baselined": len(findings) - len(new),
            "ok": ok,
        }, indent=2))
        return 0 if ok else 1

    for f in sorted(new, key=lambda f: (f.path, f.line)):
        print(f.format())
    for e in stale:
        print(f"stale baseline entry (fixed? remove it): {e['path']} [{e['rule']}] "
              f"{e['qualname']}")
    for e in unjustified:
        print(f"baseline entry lacks justification: {e['path']} [{e['rule']}] {e['qualname']}")
    if ok:
        n = len(findings) - len(new)
        print(f"hlint-torch: clean ({n} baselined finding(s), {len(baseline)} baseline "
              f"entr{'y' if len(baseline) == 1 else 'ies'})")
    else:
        print(f"hlint-torch: {len(new)} new finding(s), {len(stale)} stale, "
              f"{len(unjustified)} unjustified baseline entr(ies)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
