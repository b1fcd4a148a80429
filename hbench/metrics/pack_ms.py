"""pack_ms: host milliseconds the serving runtime spends packing a panel's
request rows into its staging buffer, the mean over the window's panels
(``PanelRuntime.stats()["pack_s"]``, a counter of the program)."""


def read(run):
    stats = run["stats"]
    if not stats["complete"] or not stats["pack_s"]:
        return None
    return 1e3 * sum(stats["pack_s"]) / len(stats["pack_s"])
