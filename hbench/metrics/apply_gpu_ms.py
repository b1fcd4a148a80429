"""apply_gpu_ms: device milliseconds of the window's kernels per launched
panel, from the profiler's trace of the window."""


def read(run):
    trace, panels = run["trace"], run["stats"]["panels"]
    if trace is None or not trace["kernels"] or panels == 0:
        return None
    return 1e3 * sum(s for _, s in trace["kernels"]) / panels
