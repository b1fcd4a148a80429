"""aca_ms: device milliseconds of the ACA's kernels (``aca_``, #3) per
launched panel, from the profiler's trace of the window: the NP apply's
regeneration of its factors.  Nothing to read without a complete window
or where no ``aca_`` kernel ran (P mode)."""

PREFIX = "aca_"


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or not stats["complete"] or stats["panels"] == 0:
        return None
    times = [s for name, s in trace["kernels"] if name.startswith(PREFIX)]
    if not times:
        return None
    return 1e3 * sum(times) / stats["panels"]
