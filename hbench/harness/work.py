"""The yardstick for the device metrics: the card's peaks and the work an
apply needs, counted from the plan's shapes whatever implements it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit;
the card's own limit is recorded beside every traced run): 67 TFLOP/s in
float32 outside the tensor cores, the precision the H-matrix path runs in
(TF32 is off), and 3.35 TB/s of HBM3.

The formulas are those of ``chip_smoke.py`` (``bound_ms``, the dense count
``b c^2 ((3d - 1) + phi + 2R)``, ``lowrank_bytes``), copied here so that the
yardstick does not move with the program.  Every input byte is counted read
once and every output byte written once.
"""
from __future__ import annotations

import numpy as np

PEAK_FP32 = 67e12        # FLOP/s, H100 SXM, float32 without tensor cores
PEAK_BYTES = 3.35e12     # bytes/s, H100 SXM HBM3
F32 = 4.0

# Operations a kernel entry phi(d2) costs after its squared distance, by
# the rule: an add, multiply, compare or select 1, a fused multiply-add 2,
# a division, square root, exp or log 1 (one instruction issue each).
#   gaussian: exp(-d2) -> 1.
#   matern (csrc/phi.cuh; r <= sqrt(3) < 2 on the unit cube, so only the
#   small-argument branch of K_1 runs): sqrt, two max, the compare and the
#   select around r 5; in bessel_k1 the branch compare 1, x / 3.75 and its
#   square 2, the I_1 polynomial (6 fma, times x) 13, x / 2 and its square
#   2, the P polynomial (6 fma) 12, log(x / 2) 2, log * i1 + p / x 3; then
#   r * K_1 and the division by the norm 2 -> 42.
PHI_OPS = {"gaussian": 1, "matern": 42}


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory bandwidth."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def dense_work(blocks: int, c: int, d: int, r: int, kernel: str) -> tuple[float, float]:
    """Operations and bytes of the dense near field on a (N, r) panel:
    ``blocks`` generated c x c blocks, each entry a direct squared distance
    (3d - 1), its phi and 2r for the multiply-adds.  Bytes as
    ``chip_smoke.py`` counts them, per block: its row and column points,
    its panel slice read and its result written.  At the cells' widths the
    operations' time is over 20 times the bytes', so the bytes never set
    the bound."""
    ops = float(blocks) * c * c * ((3 * d - 1) + PHI_OPS[kernel] + 2 * r)
    nbytes = F32 * (2.0 * blocks * c * d + 2.0 * blocks * c * r)
    return ops, nbytes


def lowrank_work(blocks: int, m: int, k: int, r: int, row_clusters: int,
                 col_clusters: int) -> tuple[float, float]:
    """Operations and bytes of one level group's ``Z += U (V^T X)`` on a
    (N, r) panel: U and V read once, the X slices of the group's distinct
    column clusters read once, Z's distinct row clusters read and written
    once; 2 m k r operations for V^T X and as many for U T per block."""
    ops = 4.0 * blocks * m * k * r
    nbytes = F32 * (2.0 * blocks * m * k + col_clusters * m * r + 2.0 * row_clusters * m * r)
    return ops, nbytes


def plan_shapes(plan, k: int, kernel: str, d: int) -> dict:
    """The numbers of a plan the work functions need (``HMatrixPlan``:
    ``dense_blocks`` and ``aca_levels``, (B, 2) arrays of cluster pairs)."""
    groups = []
    for level, blocks in sorted(plan.aca_levels.items()):
        blocks = np.asarray(blocks)
        groups.append({"level": int(level), "blocks": int(blocks.shape[0]),
                       "m": int(plan.n_pad >> int(level)),
                       "rows": int(np.unique(blocks[:, 0]).size),
                       "cols": int(np.unique(blocks[:, 1]).size)})
    return {"dense_blocks": int(np.asarray(plan.dense_blocks).shape[0]),
            "c": int(plan.c_leaf), "d": int(d), "k": int(k), "kernel": kernel,
            "n_pad": int(plan.n_pad), "groups": groups}


def dense_least_s(shapes: dict, r: int) -> float:
    return least_s(*dense_work(shapes["dense_blocks"], shapes["c"], shapes["d"], r,
                               shapes["kernel"]))


def lowrank_least_s(shapes: dict, r: int) -> float:
    """Summed over the level groups: each group is launched on its own."""
    return sum(least_s(*lowrank_work(g["blocks"], g["m"], shapes["k"], r, g["rows"],
                                     g["cols"])) for g in shapes["groups"])
