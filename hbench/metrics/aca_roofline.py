"""aca_roofline: the NP apply's regeneration of its factors (#3, the batched
ACA) at its roofline, in %: the least time of every launched panel's
regeneration over the profiler's time of the ACA's kernels (``aca_``:
``aca_resident_kernel``, ``aca_stream_*``).

The work is counted from the plan's shapes, whatever implements it.  Per
level group of B blocks of m x n (m = n), each block's k steps generate a
column of m and a row of n entries and update them with the earlier steps
(``chip_smoke.py``'s ``aca_work``, for any d): ``(m + n)(k(3d + 2) +
k(k - 1))`` operations a block (3d - 1 for the squared distance, 1 for phi,
1 for the residual, 1 to scale or compare, 2r for step r's dot); bytes: U
and V written once, ``4 B (m + n) k``, and the group's points read once,
``4 n_pad d``.  Each group is launched on its own.  Nothing to read
without a complete window or where no ``aca_`` kernel ran (P mode)."""
from harness import work

PREFIX = "aca_"
F32 = 4.0


def regeneration_least_s(shapes: dict) -> float:
    """Least seconds of one apply's regeneration of every level group."""
    k, d = shapes["k"], shapes["d"]
    least = 0.0
    for g in shapes["groups"]:
        m = n = g["m"]
        ops = float(g["blocks"]) * (m + n) * (k * (3 * d + 2) + k * (k - 1))
        nbytes = F32 * (float(g["blocks"]) * (m + n) * k + shapes["n_pad"] * d)
        least += work.least_s(ops, nbytes)
    return least


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or not stats["complete"] or stats["panels"] == 0:
        return None
    times = [s for name, s in trace["kernels"] if name.startswith(PREFIX)]
    if not times:
        return None
    return 100.0 * stats["panels"] * regeneration_least_s(run["shapes"]) / sum(times)
