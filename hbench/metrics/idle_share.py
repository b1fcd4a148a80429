"""idle_share: the share of the traced window, in %, in which nothing ran on
the card (no kernel, copy or memset), from the profiler's trace."""


def read(run):
    trace = run["trace"]
    if trace is None or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
