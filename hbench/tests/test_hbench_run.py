"""The command refuses to run without a card (decided at run time), and
a CPU run of each cell at a small size is correct; broken underneath, it
is not."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from hb_util import HBENCH, small_cell

CELLS = ["gauss2d.steady", "matern3d.flood"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "hbench/run.py", "--workload", "gauss2d.steady",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=HBENCH.parent, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def broken(kind):
    """``make_apply`` of the program with one fault planted in its result."""
    from repro_torch.core import hmatrix

    def make_apply(hm, **kw):
        real = hmatrix.make_apply(hm, **kw)

        def apply(x):
            if kind == "state_unchanged":
                return x.clone()
            z = real(x)
            if kind == "half_the_panel":
                z[:, z.shape[1] // 2:] = 0.0
            elif kind == "answer_altered":
                z[:, 0] *= 1.001
            return z

        return apply

    return make_apply


def run_small(name, monkeypatch, fault=None):
    from harness import bench
    if fault is not None:
        monkeypatch.setattr("repro_torch.serve.step.make_apply", broken(fault))
    return bench.run_cell(small_cell(name, n=2048), 2 ** 31 + 99, 1.0, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    res = run_small(name, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["rel_err"]["value"] < res["checks"]["rel_err"]["limit"]
    assert list(res["checks"]) == ["rel_err", "unanswered"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_panel", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    res = run_small(name, monkeypatch, fault)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rel_err"]["value"] > res["checks"]["rel_err"]["limit"]


def test_build_mode_is_the_configurations(monkeypatch):
    """``precompute: false`` in a configuration's file builds and serves the
    NP mode (the factors recomputed in every apply), with no code change."""
    import dataclasses

    from harness import bench
    from repro_torch.core import hmatrix
    built = []
    real = hmatrix.build_hmatrix

    def spy(*args, **kw):
        built.append(kw["precompute"])
        return real(*args, **kw)

    monkeypatch.setattr(hmatrix, "build_hmatrix", spy)
    cell = small_cell("gauss2d.steady", n=2048)
    cell = dataclasses.replace(cell, config=dict(cell.config, precompute=False))
    res = bench.run_cell(cell, 2 ** 31 + 7, 1.0, False, device="cpu")
    assert built == [False] and res["correct"], res["checks"]
    assert res["run"]["store_bytes"] == 0
