"""apply_mfu: the whole apply's share of the card's peak, in %: the least
time of the work the window's requests need, over the traced window's
length.  The work is every panel's dense and low-rank work
(``harness.work``) at the panel's occupancy, the requests it carried (the
window's mean, ``panel_width``), not at its padded width: padding is work
no request needs.  It bounds any gain that fuses or drops a kernel whose
own roofline then reads nothing."""
from harness import work


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or trace["busy_s"] <= 0.0 or stats["panels"] == 0:
        return None
    shapes, panels = run["shapes"], stats["panels"]
    r = stats["requests"] / panels
    least = panels * (work.dense_least_s(shapes, r) + work.lowrank_least_s(shapes, r))
    return 100.0 * least / trace["window_s"]
