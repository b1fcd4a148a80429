"""Port parity: the block-Jacobi PCG solve and its setup.

The reference's H-matrix goes through ``convert.hmatrix_from_arrays`` so
both solvers iterate on the same operator; the reference runs its Pallas
kernels in interpret mode.  Iterations per column must agree within one
(the residual norms, summed in another order, can cross ``tol`` one trip
apart); solutions to rtol 1e-3 / atol 1e-4, as ``tests/test_solve.py``
holds two converged solves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.solve import make_solver as j_make_solver
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import build_hmatrix, dense_kernel_matrix, make_apply
from repro_torch.solve import SolveInfo, build_preconditioner, host_loop_cg, make_solver
from torch_parity_util import export_hmatrix, one_torch_thread  # noqa: F401


def _system(n, scale, r, seed, c_leaf=64):
    pts = np.asarray(j_halton(n, 2)) * scale
    jhm = j_build_hmatrix(jnp.asarray(pts), "gaussian", k=8, c_leaf=c_leaf, precompute=True)
    f = np.random.RandomState(seed).randn(n, r).astype(np.float32)
    return pts, jhm, f


@pytest.mark.parametrize("precond", ["bj", "none"])
@pytest.mark.parametrize("n", [512, 700])
def test_solver_matches_reference(precond, n):
    pts, jhm, f = _system(n, 16.0, 4, seed=n)
    kw = dict(tol=1e-5, max_iter=200, precond=precond)
    c_j, info_j = j_make_solver(jhm, 0.5, use_pallas=True, **kw)(jnp.asarray(f))
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    c_t, info_t = make_solver(hm, 0.5, **kw)(torch.from_numpy(f))
    assert info_j.converged and info_t.converged
    assert np.abs(info_t.iters_per_column - info_j.iters_per_column).max() <= 1
    assert info_t.iterations == int(info_t.iters_per_column.max())
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-3, atol=1e-4)


def test_preconditioner_factors_the_shifted_diagonal_blocks():
    pts, jhm, _ = _system(600, 6.0, 1, seed=0, c_leaf=128)
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    chol = build_preconditioner(hm, 1e-2)
    c = hm.plan.c_leaf
    tree_pts = hm.tree.points.reshape(-1, c, 2)
    a0 = dense_kernel_matrix(tree_pts[0]) + 1e-2 * torch.eye(c)
    torch.testing.assert_close(chol[0] @ chol[0].T, a0, rtol=1e-4, atol=1e-5)
    assert bool((torch.triu(chol, diagonal=1) == 0).all())
    plain = build_preconditioner(hm, 1e-2, use_kernels=False)
    torch.testing.assert_close(chol, plain)


def test_solver_contract_vector_frozen_column_and_options():
    pts, jhm, f = _system(512, 16.0, 3, seed=5)
    f[:, 1] = 0.0
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    solve = make_solver(hm, 0.5, tol=1e-6, max_iter=300)
    c, info = solve(f)
    assert isinstance(info, SolveInfo) and repr(info) == "SolveInfo(<pending on device>)"
    assert info.converged and info.iters_per_column[1] == 0
    assert float(c[:, 1].abs().max()) == 0.0
    c_vec, _ = solve(f[:, 0])
    assert c_vec.shape == (512,)
    torch.testing.assert_close(c_vec, c[:, 0], rtol=1e-5, atol=1e-6)
    op = make_apply(hm)
    resid = op(c) + 0.5 * c - torch.from_numpy(f)
    assert float(resid.norm(dim=0).max()) < 1e-5
    with pytest.raises(ValueError):
        solve(np.zeros(513, np.float32))
    with pytest.raises(ValueError):
        make_solver(hm, 1e-2, precond="ilu")
    # precond="hlu" is ported: an H-LU preconditioned solve of the same system
    solve_hlu = make_solver(hm, 0.5, tol=1e-6, max_iter=300, precond="hlu")
    c_hlu, info_hlu = solve_hlu(f)
    assert info_hlu.converged and solve_hlu.preconditioner is not None
    torch.testing.assert_close(c_hlu, c, rtol=1e-3, atol=1e-4)
    with pytest.raises(TypeError, match="PanelMesh"):
        make_solver(hm, 1e-2, mesh=object())


def test_host_loop_cg_matches_fused_solver():
    pts, jhm, f = _system(512, 16.0, 4, seed=6)
    hm = build_hmatrix(pts, "gaussian", k=8, c_leaf=64, precompute=True, device="cpu")
    tol = 1e-5
    c, info = make_solver(hm, 0.5, tol=tol, max_iter=400, precond="none")(f)
    op = make_apply(hm)
    c_host, it_host = host_loop_cg(lambda v: op(v) + 0.5 * v, torch.from_numpy(f), tol=tol,
                                   max_iter=400)
    np.testing.assert_allclose(c.numpy(), c_host.numpy(), rtol=1e-3, atol=1e-4)
    assert abs(info.iterations - it_host) <= 1
