"""Port parity: on-device construction (``core/build_device.py``).

The port's ``build_hmatrix_device`` must give the permutation, points,
boxes and plan of the reference's ``build_hmatrix_device`` and of the
port's own host builder ``build_hmatrix`` EXACTLY (integers, and min / max
of the same float32 points), over the geometry cases of the reference's
``tests/test_build_device.py``.  With ``use_kernels=False`` the factors are
bit-identical to the host builder's; the kernel route's factors (direct-
difference entries) are held to the dense oracle at 1e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix_device as j_build_hmatrix_device
from repro.core import eval_dense_leaves as j_eval_dense_leaves
from repro.core import halton
from repro_torch.core import (BuildReport, build_hmatrix, build_hmatrix_device,
                              build_hmatrix_device_report, dense_matvec_oracle,
                              eval_dense_leaves, make_apply)
from torch_parity_util import rel_err


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dup_points(n, d):
    pts = np.array(halton(n, d), dtype=np.float32)
    pts[n // 3: n // 3 + 40] = pts[7]
    pts[::11] = pts[3]
    return pts


def _collinear(n):
    t = np.linspace(0.0, 5.0, n, dtype=np.float32)
    return np.stack([t, np.full(n, 2.5, np.float32)], axis=1)


# name -> (points factory, c_leaf, eta), as in tests/test_build_device.py
CASES = {
    "halton2d": (lambda: np.asarray(halton(1500, 2)) * 32.0, 128, 1.5),
    "nonpow2-3d": (lambda: np.asarray(halton(777, 3)), 64, 2.0),
    "duplicates": (lambda: _dup_points(900, 2), 64, 1.0),
    "collinear": (lambda: _collinear(640), 64, 1.5),
    "scaled-translated": (lambda: np.asarray(halton(1000, 2)) * 1e4 - 7e3, 128, 1.5),
    "single-leaf": (lambda: np.asarray(halton(300, 2)), 512, 1.5),
}


def _points(case):
    factory, c_leaf, eta = CASES[case]
    return np.array(factory(), np.float32), c_leaf, eta


def _assert_same_structure(hm, tree, plan):
    np.testing.assert_array_equal(hm.tree.perm.numpy(), np.asarray(tree.perm))
    np.testing.assert_array_equal(hm.tree.points.numpy(), np.asarray(tree.points))
    assert (hm.tree.n, hm.tree.n_pad, hm.tree.n_levels) == (tree.n, tree.n_pad, tree.n_levels)
    for lv in range(tree.n_levels + 1):
        np.testing.assert_array_equal(hm.tree.bb_min[lv].numpy(), np.asarray(tree.bb_min[lv]))
        np.testing.assert_array_equal(hm.tree.bb_max[lv].numpy(), np.asarray(tree.bb_max[lv]))
    assert (hm.plan.c_leaf, hm.plan.n_pad, hm.plan.n_levels, hm.plan.eta) == \
        (plan.c_leaf, plan.n_pad, plan.n_levels, plan.eta)
    assert sorted(hm.plan.aca_levels) == sorted(plan.aca_levels)
    for lv, blocks in plan.aca_levels.items():
        np.testing.assert_array_equal(hm.plan.aca_levels[lv], blocks)
    np.testing.assert_array_equal(hm.plan.dense_blocks, plan.dense_blocks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_plan_matches_reference_and_host_builder_exactly(case):
    pts, c_leaf, eta = _points(case)
    hm = build_hmatrix_device(pts, c_leaf=c_leaf, eta=eta, device="cpu")
    jhm = j_build_hmatrix_device(jnp.asarray(pts), c_leaf=c_leaf, eta=eta)
    _assert_same_structure(hm, jhm.tree, jhm.plan)
    host = build_hmatrix(pts, c_leaf=c_leaf, eta=eta, device="cpu")
    _assert_same_structure(hm, host.tree, host.plan)
    assert hm.plan.coverage_check()
    assert hm.factors is None


@pytest.mark.parametrize("case", ["halton2d", "nonpow2-3d", "duplicates"])
def test_plain_route_is_bit_identical_to_the_host_builder(case):
    pts, c_leaf, eta = _points(case)
    kw = dict(kernel="matern" if case == "nonpow2-3d" else "gaussian", k=8, c_leaf=c_leaf,
              eta=eta, precompute=True, device="cpu")
    dev = build_hmatrix_device(pts, use_kernels=False, **kw)
    host = build_hmatrix(pts, **kw)
    assert sorted(dev.factors.levels) == sorted(host.factors.levels)
    for lv, (u, v) in host.factors.items():
        assert torch.equal(dev.factors[lv][0], u) and torch.equal(dev.factors[lv][1], v)
        assert torch.equal(dev.factors.rank_tables[lv], host.factors.rank_tables[lv])
    x = np.random.RandomState(1).randn(pts.shape[0], 3).astype(np.float32)
    assert torch.equal(make_apply(dev)(x), make_apply(host)(x))


@pytest.mark.parametrize("case,kernel", [("halton2d", "gaussian"), ("nonpow2-3d", "matern"),
                                         ("scaled-translated", "gaussian")])
def test_kernel_route_factors_meet_the_oracle(case, kernel):
    pts, c_leaf, eta = _points(case)
    if case == "scaled-translated":
        pts = pts / 300.0
    hm, report = build_hmatrix_device_report(pts, kernel, k=16, c_leaf=c_leaf, eta=eta,
                                             precompute=True, device="cpu")
    assert isinstance(report, BuildReport)
    assert (report.n, report.n_pad, report.n_levels) == (pts.shape[0], hm.tree.n_pad,
                                                          hm.tree.n_levels)
    assert report.num_aca_blocks == hm.plan.num_aca_blocks
    assert report.num_dense_blocks == hm.plan.num_dense_blocks
    assert report.launches == 0                    # CPU tensors: plain versions only
    assert report.total_s >= report.plan_s >= 0.0
    x = np.random.RandomState(2).randn(pts.shape[0], 4).astype(np.float32)
    oracle = dense_matvec_oracle(pts, kernel, x, device="cpu").numpy()
    assert rel_err(make_apply(hm)(x).numpy(), oracle) <= 1e-4


def test_eval_dense_leaves_matches_reference():
    """On the unit box: the expansion-form distances of both packages sum in
    other orders, which shows as 2e-4 at coordinates of 32 (ROADMAP §3)."""
    pts, c_leaf, eta = _points("nonpow2-3d")
    want = np.asarray(j_eval_dense_leaves(j_build_hmatrix_device(jnp.asarray(pts),
                                                                 c_leaf=c_leaf, eta=eta)))
    got = eval_dense_leaves(build_hmatrix_device(pts, c_leaf=c_leaf, eta=eta, device="cpu"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_unported_options_raise():
    pts, c_leaf, eta = _points("single-leaf")
    # chaos= is ported (tests/test_torch_faults.py): a malformed spec is
    # rejected by the reference's grammar
    with pytest.raises(ValueError, match="chaos"):
        build_hmatrix_device(pts, c_leaf=c_leaf, chaos="nan:1.0", device="cpu")
    # recompress_tol= is ported: the store comes truncated, with its time
    hm, report = build_hmatrix_device_report(pts, c_leaf=c_leaf, precompute=True,
                                             recompress_tol=1e-2, device="cpu")
    assert hm.factors is not None and report.recompress_s >= 0.0
    with pytest.raises(ValueError, match="power of two"):
        build_hmatrix_device(pts, c_leaf=100, device="cpu")
