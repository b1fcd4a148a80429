"""The control, the reference one precision below the configuration's
(TF32), fails the judge's limit, and the program passes it: on the CPU at
a small size, and on the card (``cuda`` marker) at 2^16 points."""
from __future__ import annotations

import pytest

from hb_util import small_cell

CELLS = ["gauss2d.steady", "matern3d.flood"]
SEEDS = [2 ** 31 + 5, 17, 40961]


def check(cell, lines):
    limit = cell.config["limits"]["rel_err"]
    for line in lines:
        assert line["unanswered"] == 0 and line["answered"] > 0
        assert line["program_max"] < limit, line
        assert line["control_max"] > limit, line


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_on_cpu(name):
    from harness import limits
    cell = small_cell(name)
    check(cell, limits.readings(cell, SEEDS, 1.0, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_on_card(name, card):
    import dataclasses

    from harness import cells, limits
    cell = cells.resolve(name)
    cell = dataclasses.replace(cell, config=dict(cell.config, n=1 << 16))
    check(cell, limits.readings(cell, SEEDS, 3.0, "cuda"))
