"""Port parity of the batched ACA (kernel #3, ``kernels/batched_aca``) and of
NP mode, where every apply recomputes the factors through it.

The plain version (``core.aca`` on the direct-difference entries of
``kernels/phi.py``, what ``csrc/aca.cu`` computes) is held against the
reference's Pallas ``batched_aca_t`` in interpret mode by the contract of
``tests/test_kernels.py``: the two may pick different pivots on near-ties,
so each is compared by the max error of ``U V^T`` against the true block,
the port's within ``max(2 x the reference's, 1e-4)``.  NP-mode applies are
held to the reference's NP apply and to the dense oracle at 1e-4 relative,
NP-mode solves to the reference's solver as ``tests/test_torch_solve.py``
holds P mode (iterations within 2 per column here: the two recompute their
factors in other summation orders; solutions within 1e-3).
"""
from dataclasses import replace
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.core import make_apply as j_make_apply
from repro.kernels.batched_aca.kernel import batched_aca_t
from repro.solve import make_solver as j_make_solver
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import batched_aca, build_hmatrix, dense_matvec_oracle, make_apply
from repro_torch.core.hmatrix import block_groups
from repro_torch.kernels.batched_aca.ops import batched_aca_level
from repro_torch.kernels.batched_aca.ref import batched_aca_ref
from repro_torch.kernels.phi import phi_matrix
from repro_torch.solve import make_solver
from torch_parity_util import export_hmatrix, rel_err


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: beside XLA's own pool in the same process, more
    threads only contend (and the suite runs several workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recon_err(rows, cols, u, v, kernel):
    u, v = torch.as_tensor(np.array(u)), torch.as_tensor(np.array(v))
    a = phi_matrix(torch.as_tensor(rows), torch.as_tensor(cols), kernel)
    return float((a - torch.bmm(u, v.transpose(1, 2))).abs().max())


@pytest.mark.parametrize("b,m,n,k", [(1, 64, 64, 4), (3, 64, 32, 8), (2, 128, 128, 16)])
@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
def test_plain_aca_matches_reference_kernel(b, m, n, k, kernel):
    rng = np.random.RandomState(b * 1000 + m + n + k)
    rows = rng.rand(b, m, 2).astype(np.float32)
    cols = (rng.rand(b, n, 2) + 2.0).astype(np.float32)
    uj, vj = batched_aca_t(jnp.asarray(np.swapaxes(rows, 1, 2)),
                           jnp.asarray(np.swapaxes(cols, 1, 2)), kernel, k, interpret=True)
    u, v = batched_aca_ref(torch.from_numpy(rows), torch.from_numpy(cols), kernel, k)
    assert u.shape == (b, m, k) and v.shape == (b, n, k)
    err_ref = _recon_err(rows, cols, np.asarray(uj), np.asarray(vj), kernel)
    assert _recon_err(rows, cols, u, v, kernel) < max(2.0 * err_ref, 1e-4)


def test_pivots_are_distinct_and_normalise_their_rows():
    rng = np.random.RandomState(3)
    rows = torch.from_numpy(rng.rand(4, 96, 2).astype(np.float32))
    cols = torch.from_numpy((rng.rand(4, 80, 2) + 1.5).astype(np.float32))
    phi = partial(phi_matrix, kernel_name="gaussian")
    u, v, piv_rows, piv_cols = batched_aca(rows, cols, phi, 12, return_pivots=True)
    assert piv_cols[:, 0].tolist() == [0, 0, 0, 0]
    for b in range(4):
        assert len(set(piv_rows[b].tolist())) == 12
        assert len(set(piv_cols[b].tolist())) == 12
        ar = torch.arange(12)
        torch.testing.assert_close(u[b, piv_rows[b], ar], torch.ones(12), rtol=1e-6, atol=0)
    u2, v2 = batched_aca_ref(rows, cols, "gaussian", 12)
    assert torch.equal(u, u2) and torch.equal(v, v2)


def test_level_entry_is_the_gathered_batched_aca():
    pts = torch.from_numpy(np.array(j_halton(512, 2)))
    rows = torch.tensor([0, 3, 5])
    cols = torch.tensor([6, 0, 1])
    u, v = batched_aca_level(pts, rows, cols, 3, "matern", 6)
    grouped = pts.reshape(8, 64, 2)
    u2, v2 = batched_aca_ref(grouped[rows], grouped[cols], "matern", 6)
    assert torch.equal(u, u2) and torch.equal(v, v2)


def test_block_groups_check_cluster_ids_once_at_build():
    """The ACA kernel reads clusters by id unchecked: a plan whose ids lie
    outside their level is refused when its block groups are built."""
    plan = build_hmatrix(np.asarray(j_halton(512, 2)), c_leaf=64, device="cpu").plan
    block_groups(plan, "cpu")
    level = min(plan.aca_levels)
    for bad in (1 << level, -1):
        blocks = plan.aca_levels[level].copy()
        blocks[0, 1] = bad
        with pytest.raises(ValueError, match="cluster ids"):
            block_groups(replace(plan, aca_levels={**plan.aca_levels, level: blocks}), "cpu")


def _np_problem(n, kernel, scale=1.0, c_leaf=64, k=8):
    pts = np.asarray(j_halton(n, 2)) * scale
    jhm = j_build_hmatrix(jnp.asarray(pts), kernel, k=k, c_leaf=c_leaf)
    assert jhm.factors is None
    return pts, jhm, hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")


@pytest.mark.parametrize("kernel,r", [("gaussian", 8), ("gaussian", 1), ("matern", 4)])
def test_np_apply_matches_reference_np_apply_and_oracle(kernel, r):
    pts, jhm, hm = _np_problem(600, kernel)
    assert hm.factors is None
    x = np.random.RandomState(r).randn(600, r).astype(np.float32)
    x = x[:, 0] if r == 1 else x
    want = np.asarray(j_make_apply(jhm, use_pallas=True)(jnp.asarray(x)))
    got = make_apply(hm)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4
    oracle = dense_matvec_oracle(pts, kernel, x, device="cpu").numpy()
    assert rel_err(got, oracle) <= 1e-4
    assert rel_err(make_apply(hm, use_kernels=False)(x).numpy(), oracle) <= 1e-4


def test_np_solver_matches_reference_solver():
    pts, jhm, hm = _np_problem(512, "gaussian", scale=16.0)
    f = np.random.RandomState(7).randn(512, 3).astype(np.float32)
    kw = dict(tol=1e-5, max_iter=200)
    c_j, info_j = j_make_solver(jhm, 0.5, use_pallas=True, **kw)(jnp.asarray(f))
    c_t, info_t = make_solver(hm, 0.5, **kw)(torch.from_numpy(f))
    assert info_j.converged and info_t.converged
    assert np.abs(info_t.iters_per_column - info_j.iters_per_column).max() <= 2
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-3, atol=1e-4)
