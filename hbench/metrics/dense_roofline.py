"""dense_roofline: the dense near field's share of its roofline, in %: the
least time the card needs for the window's dense work (counted from the
plan's shapes at each panel's width, ``harness.work.dense_work``) over the
profiler's time of the near-field kernel (``dense_matmat_kernel``, #1 and
#2).  Nothing to read unless the trace holds one launch per panel."""
from harness import work

KERNEL = "dense_matmat_kernel"


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or not stats["complete"]:
        return None
    times = [s for name, s in trace["kernels"] if name.startswith(KERNEL)]
    if not times or len(times) != len(stats["widths"]):
        return None
    least = sum(work.dense_least_s(run["shapes"], w) for w in stats["widths"])
    return 100.0 * least / sum(times)
