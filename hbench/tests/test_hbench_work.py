"""The work functions give hand-counted operations and bytes on a small
plan, and the least time takes the larger of its two bounds."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest


def small_plan():
    # 4 leaves of 8 points (n_pad 32): 6 dense leaf blocks; level 1 holds the
    # pair of halves (0, 1), (1, 0): rows {0, 1}, columns {0, 1}
    return SimpleNamespace(
        dense_blocks=np.array([[0, 0], [1, 1], [2, 2], [3, 3], [0, 1], [1, 0]], np.int32),
        aca_levels={1: np.array([[0, 1], [1, 0]], np.int32)}, c_leaf=8, n_pad=32)


def test_plan_shapes():
    from harness import work
    s = work.plan_shapes(small_plan(), k=2, kernel="gaussian", d=2)
    assert s["dense_blocks"] == 6 and s["c"] == 8 and s["n_pad"] == 32
    assert s["groups"] == [{"level": 1, "blocks": 2, "m": 16, "rows": 2, "cols": 2}]


@pytest.mark.parametrize("kernel, phi", [("gaussian", 1), ("matern", 42)])
def test_dense_work_by_hand(kernel, phi):
    from harness import work
    ops, nbytes = work.dense_work(6, 8, 2, 3, kernel)
    # per entry: 5 for the distance in 2-D, phi, 6 for three multiply-adds
    assert ops == 6 * 64 * (5 + phi + 6)
    # per block: 2 x 8 points of 2 floats, an 8 x 3 slice in and out
    assert nbytes == 4 * 6 * (32 + 48)


def test_lowrank_work_by_hand():
    from harness import work
    ops, nbytes = work.lowrank_work(2, 16, 2, 3, 2, 2)
    assert ops == 2 * (2 * 16 * 2 * 3) * 2          # V^T X and U T, each 2 m k r
    # U and V (2 x 16 x 2 floats a block), X's 2 column clusters (16 x 3
    # floats each), Z's 2 row clusters read and written
    assert nbytes == 4 * (2 * 2 * 16 * 2 + 2 * 16 * 3 + 2 * 2 * 16 * 3)


def test_least_time_takes_the_larger_bound():
    from harness import work
    assert work.least_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_panel_least_times_of_the_paper_problem():
    """P's dense bound at R = 64 is 10,636 x 2048^2 x 134
    operations, about 89 ms; its store (8,948,603,984 B) is read once a
    panel by the level entry, at least 2.67 ms."""
    from harness import work
    shapes = {"dense_blocks": 10636, "c": 2048, "d": 2, "k": 16, "kernel": "gaussian",
              "n_pad": 1 << 20, "groups": []}
    assert work.dense_least_s(shapes, 64) == pytest.approx(10636 * 2048 ** 2 * 134 / 67e12)
    assert 0.088 < work.dense_least_s(shapes, 64) < 0.090
    assert 8948603984 / work.PEAK_BYTES == pytest.approx(2.671e-3, rel=1e-3)
