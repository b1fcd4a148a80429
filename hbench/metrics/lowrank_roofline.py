"""lowrank_roofline: the far field's level entry (#4) at its roofline, in %:
the least time for the window's ``Z += U (V^T X)`` over every level group
(``harness.work.lowrank_work``, U, V, X and Z once per group) over the
profiler's time of its two kernels (``lowrank_vtx_kernel``,
``lowrank_ut_kernel``)."""
from harness import work

KERNELS = ("lowrank_vtx_kernel", "lowrank_ut_kernel")


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or not stats["complete"] or not stats["widths"]:
        return None
    times = [s for name, s in trace["kernels"] if name.startswith(KERNELS)]
    if not times:
        return None
    least = sum(work.lowrank_least_s(run["shapes"], w) for w in stats["widths"])
    return 100.0 * least / sum(times)
