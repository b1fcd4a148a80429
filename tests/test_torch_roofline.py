"""The port's roofline (the H100's constants) against ``repro.analysis.roofline``
(TPU v5e's): the same inputs give each term rescaled by the ratio of the
two packages' constants, and the derived properties follow."""
import math

import pytest

from repro.analysis import roofline as jroof
from repro_torch.analysis import roofline as roof
from torch_parity_util import one_torch_thread  # noqa: F401

CASES = [(3.1e14, 2.2e11, 4.0e9, 2.9e14), (1.0e9, 5.0e12, 0.0, 8.0e8),
         (7.0e15, 1.0e12, 9.0e12, 6.5e15), (0.0, 1.0, 0.0, 0.0), (2.0e12, 0.0, 1.0e9, 0.0)]


@pytest.mark.parametrize("flops,hbm,coll,model", CASES)
def test_terms_are_repros_rescaled_by_the_constants(flops, hbm, coll, model):
    j = jroof.roofline_terms(flops, hbm, coll, model)
    t = roof.roofline_terms(flops, hbm, coll, model)
    assert math.isclose(t.compute_s, j.compute_s * jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
                        rel_tol=1e-12, abs_tol=0)
    assert math.isclose(t.memory_s, j.memory_s * jroof.HBM_BW / roof.HBM_BW,
                        rel_tol=1e-12, abs_tol=0)
    assert math.isclose(t.collective_s, j.collective_s * jroof.ICI_BW / roof.LINK_BW,
                        rel_tol=1e-12, abs_tol=0)
    terms = {"compute": t.compute_s, "memory": t.memory_s, "collective": t.collective_s}
    assert t.step_time_s == max(terms.values())
    assert t.dominant == max(terms, key=terms.get)
    assert t.useful_flops_ratio == j.useful_flops_ratio
    if t.step_time_s > 0:
        assert math.isclose(t.roofline_fraction,
                            model / roof.PEAK_FLOPS / t.step_time_s, rel_tol=1e-12)
    else:
        assert t.roofline_fraction == 0.0
    d = t.as_dict()
    assert set(d) == set(j.as_dict())
    assert d["dominant"] == t.dominant and d["roofline_fraction"] == t.roofline_fraction


def test_zero_guards_and_an_unmeasured_collective_term():
    t = roof.roofline_terms(0.0, 0.0, 0.0, 5.0)
    assert t.useful_flops_ratio == 0.0 and t.roofline_fraction == 0.0
    none = roof.roofline_terms(1e12, 1e9, None, 5e11)
    assert none.collective_s is None and none.collective_bytes_per_chip is None
    assert none.step_time_s == max(none.compute_s, none.memory_s)
    assert none.dominant == "compute"
    assert none.as_dict()["collective_s"] is None


def test_the_cards_constants():
    assert roof.PEAK_FLOPS == 989e12 and roof.HBM_BW == 3.35e12 and roof.LINK_BW == 450e9
