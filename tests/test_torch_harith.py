"""Port parity: H-arithmetic (task graph, H-LU factorization and solve, the
H-LU preconditioned PCG).

Sizes are ``repro``'s own test sizes (n <= 2000, c_leaf = 128).  The
reference runs its plain versions (``use_pallas=False``, its default); the
port runs its dispatchers, which send CPU tensors to the plain versions.
Tolerances:

* tile grids, task graphs, schedules and solve tables: equal, array for
  array;
* factor buffers: dense tiles within ``DENSE_ATOL`` (5e-4; entries up to
  ~1, and the two packages' QR / SVD and Cholesky sum in other orders,
  amplified by the shifted system's conditioning), low-rank tiles compared
  as ``u v^T`` (their factors are fixed only up to the SVD's signs) within
  ``LOWRANK_ATOL`` (1e-4);
* ``hlu_solve_panels`` on the reference's own factors: 1e-5 relative;
* PCG iterations per column within 2 of ``repro``'s (counts move with
  rounding at the tolerance, ROADMAP §3); solutions against the dense
  float64 oracle at 1e-2 relative, as ``tests/test_harith.py`` holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.harith import build_schedule as j_build_schedule
from repro.harith import build_taskgraph as j_build_taskgraph
from repro.harith import build_tile_grid as j_build_tile_grid
from repro.harith import factorize_hlu as j_factorize_hlu
from repro.harith import hlu_solve_panels as j_hlu_solve_panels
from repro.harith import make_hlu_preconditioner as j_make_hlu_preconditioner
from repro.harith.taskgraph import SLOTS
from repro.harith.taskgraph import build_solve_tables as j_build_solve_tables
from repro.solve import make_solver as j_make_solver
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import build_hmatrix
from repro_torch.harith import (HLUFactors, HLUPreconditioner, assemble_lower, build_schedule,
                                build_solve_tables, build_taskgraph, build_tile_grid,
                                factorize_hlu, hlu_solve_panels, make_hlu_preconditioner)
from repro_torch.kernels.batched_schur_update.ops import (batched_schur_dense,
                                                          batched_schur_retruncate)
from repro_torch.kernels.batched_trsm_lowrank.ops import batched_trsm_panels
from repro_torch.solve import make_solver
from test_build_device import CASES
from torch_parity_util import export_hmatrix

SIGMA2 = 1e-2
DENSE_ATOL = 5e-4
LOWRANK_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(n, scale, kernel="gaussian", precompute=True):
    """The reference's H-matrix and the port's copy of it (same factors)."""
    jhm = j_build_hmatrix(jnp.asarray(np.asarray(j_halton(n, 2)) * scale), kernel, k=16,
                          c_leaf=128, precompute=precompute)
    return jhm, hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")


def _hat_oracle(hm, sigma2):
    """Dense pad-decoupled shifted system on the tree ordering, float64."""
    pts = hm.tree.points
    a = hm.kernel(pts, pts).double().numpy()
    n, n_pad = hm.tree.n, hm.tree.n_pad
    valid = np.arange(n_pad) < n
    a[~valid, :] = 0.0
    a[:, ~valid] = 0.0
    a[np.diag_indices(n_pad)] += np.where(valid, sigma2, 1.0)
    return a


# ---------------------------------------------------------------------------
# task graph: equal to the reference's, array for array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_grid_schedule_and_tables_equal_reference(case):
    factory, c_leaf, eta = CASES[case]
    pts = factory()
    j_plan = j_build_hmatrix(jnp.asarray(pts), c_leaf=c_leaf, eta=eta).plan
    plan = build_hmatrix(pts, c_leaf=c_leaf, eta=eta, device="cpu").plan
    g, jg = build_tile_grid(plan), j_build_tile_grid(j_plan)
    assert (g.t, g.c, g.n_levels) == (jg.t, jg.c, jg.n_levels)
    for name in ("kind", "dense_id", "lr_id", "dense_pairs", "lr_pairs", "lr_source",
                 "promoted"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name), err_msg=name)
    dag, jdag = build_taskgraph(g), j_build_taskgraph(jg)
    assert [(t.kind, t.i, t.j, t.t, t.deps) for t in dag.tasks] == \
        [(t.kind, t.i, t.j, t.t, t.deps) for t in jdag.tasks]
    np.testing.assert_array_equal(dag.levels, jdag.levels)
    assert dag.ready_sets == jdag.ready_sets
    sched, jsched = build_schedule(g), j_build_schedule(jg)
    assert sched.runs == jsched.runs
    for st, jst in zip(sched.steps, jsched.steps, strict=True):
        assert (st.t, st.fac_id) == (jst.t, jst.fac_id)
        for name in SLOTS:
            np.testing.assert_array_equal(getattr(st, name), getattr(jst, name))
    tb, jtb = build_solve_tables(g), j_build_solve_tables(jg)
    for name in ("diag_ids", "row_dense", "row_dense_col", "row_lr", "row_lr_col",
                 "col_dense", "col_dense_row", "col_lr", "col_lr_row"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jtb, name), err_msg=name)


# ---------------------------------------------------------------------------
# factorization and solve against the reference
# ---------------------------------------------------------------------------


def _lowrank_products(ulr, vlr):
    return np.einsum("bck,bdk->bcd", np.asarray(ulr, np.float64), np.asarray(vlr, np.float64))


@pytest.mark.parametrize("n,scale,kernel", [(1200, 2.0, "gaussian"), (1200, 1.0, "matern"),
                                            (2000, 4.0, "gaussian")])
def test_factorize_hlu_buffers_match_reference(n, scale, kernel):
    """Configurations whose low-rank tiles are not all zero, so that the
    re-truncations do real work (at scale 8 they are exactly zero)."""
    jhm, hm = _pair(n, scale, kernel)
    jf = j_factorize_hlu(jhm, SIGMA2, tol=1e-3)
    f = factorize_hlu(hm, SIGMA2, tol=1e-3)
    assert f.dense.shape == jf.dense.shape and f.ulr.shape == jf.ulr.shape
    np.testing.assert_allclose(f.dense.numpy(), np.asarray(jf.dense), rtol=0, atol=DENSE_ATOL)
    prod, jprod = _lowrank_products(f.ulr, f.vlr), _lowrank_products(jf.ulr, jf.vlr)
    assert np.abs(jprod).max() > 0.01            # the low-rank path is exercised
    np.testing.assert_allclose(prod, jprod, rtol=0, atol=LOWRANK_ATOL)
    assert f.rank_stats()["max"] == jf.rank_stats()["max"]
    assert f.nbytes() == jf.nbytes()


def test_hlu_solve_panels_on_reference_factors_matches_reference():
    """The port's two sweeps applied to ``repro``'s own factor buffers."""
    jhm, hm = _pair(2000, 4.0)
    jf = j_factorize_hlu(jhm, SIGMA2, tol=1e-3)
    meta = factorize_hlu(hm, SIGMA2, tol=1e-3, _plan_only=True)
    f = HLUFactors(*(torch.from_numpy(np.array(t)) for t in (jf.dense, jf.ulr, jf.vlr)), meta)
    r = np.zeros((hm.tree.n_pad, 3), np.float32)
    r[:hm.tree.n] = np.random.RandomState(3).randn(hm.tree.n, 3)
    want = np.asarray(j_hlu_solve_panels(jf, jnp.asarray(r)), np.float64)
    got = hlu_solve_panels(f, torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_hlu_factors_reconstruct_the_shifted_system():
    """``L L^T`` from the packed tiles against the dense shifted system and
    its float64 Cholesky, with ``tests/test_harith.py``'s bounds."""
    _, hm = _pair(600, 8.0, precompute=False)
    factors = factorize_hlu(hm, SIGMA2, tol=1e-6)
    lmat = assemble_lower(factors).astype(np.float64)
    a_hat = _hat_oracle(hm, SIGMA2)
    assert np.abs(np.triu(lmat, 1)).max() == 0.0
    assert np.abs(lmat @ lmat.T - a_hat).max() / np.abs(a_hat).max() < 5e-4
    l_ref = np.linalg.cholesky(a_hat)
    assert np.abs(lmat - l_ref).max() / np.abs(l_ref).max() < 5e-3


def test_np_mode_factorization_equals_p_mode():
    """Without stored factors the needed blocks are factored by the plain
    ACA, the port's P-mode build's own function: the same buffers bit for
    bit."""
    pts = np.asarray(j_halton(1200, 2)) * 2.0
    hm_p = build_hmatrix(pts, k=16, c_leaf=128, precompute=True, device="cpu")
    hm_np = build_hmatrix(pts, k=16, c_leaf=128, device="cpu")
    fp, fn = factorize_hlu(hm_p, SIGMA2), factorize_hlu(hm_np, SIGMA2)
    for a, b in ((fp.dense, fn.dense), (fp.ulr, fn.ulr), (fp.vlr, fn.vlr)):
        assert torch.equal(a, b)


def test_hlu_factorization_bit_reproducible_and_scratch_zero():
    _, hm = _pair(1200, 2.0)
    fa, fb = factorize_hlu(hm, SIGMA2, tol=1e-4), factorize_hlu(hm, SIGMA2, tol=1e-4)
    for a, b in ((fa.dense, fb.dense), (fa.ulr, fb.ulr), (fa.vlr, fb.vlr)):
        assert torch.equal(a, b)
        assert float(a[-1].abs().max()) == 0.0        # the scratch tile


def test_make_hlu_preconditioner_report_matches_reference():
    jhm, hm = _pair(2000, 4.0)
    jpre = j_make_hlu_preconditioner(jhm, SIGMA2, tol=1e-3)
    pre = make_hlu_preconditioner(hm, SIGMA2, tol=1e-3)
    rep, jrep = pre.report(), jpre.report()
    assert rep["setup_seconds"] > 0 and rep["nbytes"] == pre.nbytes() == jrep["nbytes"]
    for key in ("tol", "kp", "tiles", "schedule"):
        assert rep[key] == jrep[key], key
    assert rep["ranks"]["kp"] == jrep["ranks"]["kp"] == pre.kp == 32
    assert rep["ranks"]["max"] == jrep["ranks"]["max"]
    assert abs(rep["ranks"]["mean"] - jrep["ranks"]["mean"]) <= 0.1


# ---------------------------------------------------------------------------
# the H-LU preconditioned PCG
# ---------------------------------------------------------------------------


def test_make_solver_hlu_matches_dense_oracle_and_reference_iterations():
    jhm, hm = _pair(700, 8.0)
    f = np.random.RandomState(11).randn(700, 4).astype(np.float32)
    kw = dict(tol=1e-6, max_iter=200, precond="hlu")
    _, jinfo = j_make_solver(jhm, SIGMA2, **kw)(jnp.asarray(f))
    solve = make_solver(hm, SIGMA2, **kw)
    c1, info = solve(torch.from_numpy(f))
    c2, _ = solve(torch.from_numpy(f))
    assert torch.equal(c1, c2)                       # bit-reproducible solves
    assert isinstance(solve.preconditioner, HLUPreconditioner)
    assert info.converged
    assert np.abs(info.iters_per_column - np.asarray(jinfo.iters_per_column)).max() <= 2
    pts = np.asarray(j_halton(700, 2)) * 8.0
    a = hm.kernel(torch.from_numpy(pts), torch.from_numpy(pts)).double().numpy()
    c_ref = np.linalg.solve(a + SIGMA2 * np.eye(700), f.astype(np.float64))
    assert np.abs(c1.numpy() - c_ref).max() / np.abs(c_ref).max() < 1e-2
    # a prebuilt preconditioner is used as it is
    solve2 = make_solver(hm, SIGMA2, tol=1e-6, max_iter=200, precond=solve.preconditioner)
    assert solve2.preconditioner is solve.preconditioner
    assert torch.equal(solve2(torch.from_numpy(f))[0], c1)


def test_hlu_precond_cuts_iterations_vs_block_jacobi():
    """``tests/test_harith.py``'s ill-conditioned short-length-scale case at
    its n = 2000: H-LU needs at least 3x fewer iterations than block Jacobi,
    and each column's count is within 2 of ``repro``'s."""
    jhm, hm = _pair(2000, 45.0)
    f = np.random.RandomState(11).randn(2000, 2).astype(np.float32)
    kw = dict(tol=1e-5, max_iter=600)
    _, bj = make_solver(hm, 1e-4, precond="bj", **kw)(torch.from_numpy(f))
    _, hl = make_solver(hm, 1e-4, precond="hlu", hlu_opts={"tol": 1e-4}, **kw)(
        torch.from_numpy(f))
    _, jhl = j_make_solver(jhm, 1e-4, precond="hlu", hlu_opts={"tol": 1e-4}, **kw)(
        jnp.asarray(f))
    assert bj.converged and hl.converged
    assert hl.iterations * 3 <= bj.iterations, (hl.iterations, bj.iterations)
    assert np.abs(hl.iters_per_column - np.asarray(jhl.iters_per_column)).max() <= 2


# ---------------------------------------------------------------------------
# the H-LU kernel dispatchers on the CPU (plain versions)
# ---------------------------------------------------------------------------


def test_hlu_kernel_dispatchers_on_cpu_match_library_and_reference():
    from repro.kernels.batched_schur_update.ref import (
        batched_schur_retruncate_ref as j_retruncate_ref)
    rng = np.random.RandomState(7)
    m = rng.randn(3, 64, 64).astype(np.float32) / 8.0
    lmat = torch.from_numpy(np.tril(m, -1) + np.eye(64, dtype=np.float32))
    x = torch.from_numpy(rng.randn(3, 64, 5).astype(np.float32))
    want = torch.linalg.solve_triangular(lmat, x, upper=False)
    torch.testing.assert_close(batched_trsm_panels(lmat, x), want, rtol=1e-4, atol=1e-4)
    shared = batched_trsm_panels(lmat[:1], x)      # one L for the batch
    torch.testing.assert_close(shared, torch.linalg.solve_triangular(lmat[:1], x, upper=False),
                               rtol=1e-4, atol=1e-4)
    c = torch.from_numpy(rng.randn(3, 64, 48).astype(np.float32))
    a = torch.from_numpy(rng.randn(3, 64, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 48, 16).astype(np.float32))
    torch.testing.assert_close(batched_schur_dense(c, a, b), c - a @ b.transpose(1, 2),
                               rtol=1e-5, atol=1e-5)
    u = rng.randn(2, 64, 16).astype(np.float32) * (0.3 ** np.arange(16)).astype(np.float32)
    v = rng.randn(2, 64, 16).astype(np.float32)
    u2, v2 = batched_schur_retruncate(torch.from_numpy(u), torch.from_numpy(v), 1e-3, 8)
    ju, jv = j_retruncate_ref(jnp.asarray(u), jnp.asarray(v), 1e-3, 8)
    assert u2.shape == v2.shape == (2, 64, 8)
    np.testing.assert_allclose(_lowrank_products(u2, v2), _lowrank_products(ju, jv),
                               rtol=0, atol=1e-5)
