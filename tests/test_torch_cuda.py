"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device, and import
nothing of JAX or ``repro`` so that they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 relative (Frobenius) for the three
products and the dense Schur update, 1e-4 for the Cholesky pair with
``|L L^T - A| / |A| <= 1e-5`` and for the panel triangular solve, Morton
codes exactly equal, the ACA by the max error of ``U V^T`` against the
block, within ``max(2 x the plain version's, 1e-4)`` (the two may pick
other pivots on near-ties), and the recompression (Gram + Jacobi against
the plain QR + SVD) by equal ranks or a reconstruction error within
``2 tol`` of each block's Frobenius norm.
"""
import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.kernels.batched_aca import kernel as aca_kernel
from repro_torch.kernels.batched_aca.ops import batched_aca_level, batched_lowrank_matmat
from repro_torch.kernels.batched_aca.ref import batched_aca_ref, batched_lowrank_matmat_ref
from repro_torch.kernels.batched_block_solve.ops import (batched_block_cholesky,
                                                         batched_block_cholesky_solve)
from repro_torch.kernels.batched_block_solve.ref import (batched_block_cholesky_ref,
                                                         batched_block_cholesky_solve_ref)
from repro_torch.kernels.batched_dense_matvec.ops import (batched_kernel_matmat,
                                                          batched_kernel_matvec)
from repro_torch.kernels.batched_dense_matvec.ref import (batched_kernel_matmat_ref,
                                                          batched_kernel_matvec_ref)
from repro_torch.kernels.morton.ops import morton_encode
from repro_torch.kernels.morton.ref import morton_encode_ref
from repro_torch.kernels.phi import phi_matrix


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(rng, b, c):
    q = rng.randn(b, c, c).astype(np.float32)
    return (q @ np.swapaxes(q, 1, 2) + c * np.eye(c, dtype=np.float32)).astype(np.float32)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc on first use)")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("c,r", [(96, 1), (256, 8), (200, 13)])
def test_dense_matmat_kernel_matches_plain_on_card(cuda_device, c, r):
    g = torch.Generator(device="cpu").manual_seed(c + r)
    rows = torch.rand(5, c, 2, generator=g).to(cuda_device)
    cols = torch.rand(5, c, 2, generator=g).to(cuda_device) + 0.5
    x = torch.randn(5, c, r, generator=g).to(cuda_device)
    for kernel in ("gaussian", "matern"):
        y = batched_kernel_matmat(rows, cols, x, kernel)
        assert _rel(y, batched_kernel_matmat_ref(rows, cols, x, kernel)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,r", [(1000, 16, 8), (4096, 16, 1), (300, 7, 80)])
def test_lowrank_matmat_kernel_matches_plain_on_card(cuda_device, m, k, r):
    g = torch.Generator(device="cpu").manual_seed(m + k + r)
    u = torch.randn(3, m, k, generator=g).to(cuda_device)
    v = torch.randn(3, m, k, generator=g).to(cuda_device)
    x = torch.randn(3, m, r, generator=g).to(cuda_device)
    y = batched_lowrank_matmat(u, v, x)
    assert _rel(y, batched_lowrank_matmat_ref(u, v, x)) <= 1e-5
    assert torch.equal(y, batched_lowrank_matmat(u, v, x))      # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("c,r", [(64, 8), (100, 1), (512, 8)])
def test_block_cholesky_kernels_match_plain_on_card(cuda_device, c, r):
    a = torch.from_numpy(_spd(_rs(c), 3, c)).to(cuda_device)
    l_k = batched_block_cholesky(a)
    assert _rel(l_k, batched_block_cholesky_ref(a)) <= 1e-4
    assert _rel(l_k @ l_k.transpose(1, 2), a) <= 1e-5
    x = torch.from_numpy(_rs(c + 1).randn(3, c, r).astype(np.float32)).to(cuda_device)
    assert _rel(batched_block_cholesky_solve(l_k, x),
                batched_block_cholesky_solve_ref(l_k, x)) <= 1e-4


@pytest.mark.cuda
def test_build_apply_and_solve_on_card_match_the_cpu_port(cuda_device):
    """The whole path on the card (kernels) against the same path on the CPU
    (plain versions): same plan, apply within 1e-5, solve within tolerance."""
    from repro_torch.core import build_hmatrix, halton, make_apply
    from repro_torch.solve import make_solver
    pts = halton(3000, 2) * 16.0
    x = torch.from_numpy(_rs(3).randn(3000, 4).astype(np.float32))
    hm_cpu = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, precompute=True, device="cpu")
    hm_gpu = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, precompute=True)
    for lv, blocks in hm_cpu.plan.aca_levels.items():
        np.testing.assert_array_equal(hm_gpu.plan.aca_levels[lv], blocks)
    _build.reset_launches()
    z_gpu = make_apply(hm_gpu)(x.to(cuda_device))
    assert _build.LAUNCHES["batched_kernel_matmat"] == 1
    assert _build.LAUNCHES["batched_lowrank_matmat"] == len(hm_gpu.plan.aca_levels)
    assert torch.equal(z_gpu, make_apply(hm_gpu)(x.to(cuda_device)))
    z_cpu = make_apply(hm_cpu)(x)
    assert _rel(z_gpu.cpu(), z_cpu) <= 1e-5
    c_gpu, info_gpu = make_solver(hm_gpu, 0.5, tol=1e-5)(x.to(cuda_device))
    c_cpu, info_cpu = make_solver(hm_cpu, 0.5, tol=1e-5)(x)
    assert info_gpu.converged and info_cpu.converged
    assert np.abs(info_gpu.iters_per_column - info_cpu.iters_per_column).max() <= 1
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, rtol=1e-3, atol=1e-4)
    # NP mode: the factors recomputed by the ACA kernel in every apply
    hm_np = build_hmatrix(pts, "gaussian", k=8, c_leaf=128)
    _build.reset_launches()
    z_np = make_apply(hm_np)(x.to(cuda_device))
    assert _build.LAUNCHES["batched_aca"] == len(hm_np.plan.aca_levels)
    assert _rel(z_np, z_gpu) <= 1e-4
    assert torch.equal(z_np, make_apply(hm_np)(x.to(cuda_device)))
    c_np, info_np = make_solver(hm_np, 0.5, tol=1e-5)(x.to(cuda_device))
    assert info_np.converged
    assert np.abs(info_np.iters_per_column - info_gpu.iters_per_column).max() <= 2
    torch.testing.assert_close(c_np, c_gpu, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(96, 2), (256, 3), (2048, 2)])
def test_dense_matvec_kernel_matches_plain_on_card(cuda_device, c, d):
    g = torch.Generator(device="cpu").manual_seed(c + d)
    rows = torch.rand(6, c, d, generator=g).to(cuda_device)
    cols = torch.rand(6, c, d, generator=g).to(cuda_device) + 0.5
    x = torch.randn(6, c, generator=g).to(cuda_device)
    for kernel in ("gaussian", "matern"):
        y = batched_kernel_matvec(rows, cols, x, kernel)
        assert y.shape == (6, c)
        assert _rel(y, batched_kernel_matvec_ref(rows, cols, x, kernel)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
def test_morton_kernel_matches_plain_on_card(cuda_device, d):
    pts = torch.rand(100_003, d, generator=torch.Generator().manual_seed(d))
    pts[0], pts[1], pts[2, 0] = 0.0, 1.0, 1.0
    codes = morton_encode(pts.to(cuda_device))
    assert torch.equal(codes.cpu(), morton_encode_ref(pts))


def _aca_err(rows, cols, u, v, kernel):
    return float((phi_matrix(rows, cols, kernel) - u @ v.transpose(1, 2)).abs().max())


def _aca_blocks(rows, cols, kernel, k):
    """The ACA kernel on gathered blocks (B, m, d), (B, n, d) -> (U, V, row
    pivots, column pivots), the pivots (B, k) decoded from the kernel's keys."""
    b, m, d = rows.shape
    ids = torch.arange(b, device=rows.device)
    u, v, keys = aca_kernel._aca_launch(rows.reshape(-1, d), ids, cols.reshape(-1, d), ids,
                                        m, cols.shape[1], kernel, k)
    idx = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    piv_cols = torch.zeros_like(idx[0].t())
    piv_cols[:, 1:] = idx[1, :-1].t()
    return u, v, idx[0].t(), piv_cols


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,k", [(3, 64, 64, 8), (2, 300, 200, 16), (1, 5000, 5000, 16),
                                     (4, 10, 12, 16)])
@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
def test_aca_kernel_matches_plain_on_card(cuda_device, b, m, n, k, kernel):
    g = torch.Generator(device="cpu").manual_seed(b + m + n + k)
    rows = torch.rand(b, m, 2, generator=g).to(cuda_device)
    cols = (torch.rand(b, n, 2, generator=g) + 1.5).to(cuda_device)
    u, v, piv_rows, piv_cols = _aca_blocks(rows, cols, kernel, k)
    ur, vr = batched_aca_ref(rows, cols, kernel, k)
    assert _aca_err(rows, cols, u, v, kernel) <= max(2.0 * _aca_err(rows, cols, ur, vr, kernel),
                                                     1e-4)
    u2, v2, _, _ = _aca_blocks(rows, cols, kernel, k)
    assert torch.equal(u, u2) and torch.equal(v, v2)               # no order-dependent sums
    if min(m, n) >= k:
        for blk in range(b):
            assert len(set(piv_rows[blk].tolist())) == k
            assert len(set(piv_cols[blk].tolist())) == k


@pytest.mark.cuda
def test_aca_level_kernel_reads_the_clusters_in_place(cuda_device):
    pts = torch.rand(4096, 2, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    rows = torch.tensor([0, 3, 5, 7], device=cuda_device)
    cols = torch.tensor([6, 0, 1, 2], device=cuda_device)
    u, v = batched_aca_level(pts, rows, cols, 3, "gaussian", 16)
    grouped = pts.reshape(8, 512, 2)
    u2, v2, _, _ = _aca_blocks(grouped[rows].contiguous(), grouped[cols].contiguous(),
                               "gaussian", 16)
    assert torch.equal(u, u2) and torch.equal(v, v2)
    ur, vr = batched_aca_level(pts.cpu(), rows.cpu(), cols.cpu(), 3, "gaussian", 16)
    # an id outside [0, 8) reads nothing outside pts: that block's factors are NaN
    ub, vb = batched_aca_level(pts, torch.where(rows == 5, 8, rows), cols, 3, "gaussian", 16)
    assert ub[2].isnan().all() and vb[2].isnan().all()
    keep = torch.tensor([0, 1, 3], device=cuda_device)
    assert torch.equal(ub[keep], u[keep]) and torch.equal(vb[keep], v[keep])
    assert _aca_err(grouped[rows], grouped[cols], u, v, "gaussian") <= max(
        2.0 * _aca_err(grouped[rows].cpu(), grouped[cols].cpu(), ur, vr, "gaussian"), 1e-4)


@pytest.mark.cuda
def test_device_build_on_card_matches_the_host_builder(cuda_device):
    from repro_torch.core import (build_hmatrix, build_hmatrix_device,
                                  build_hmatrix_device_report, dense_matvec_oracle, halton,
                                  make_apply)
    pts = halton(3000, 2) * 16.0
    host = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, precompute=True)
    _build.reset_launches()
    dev, report = build_hmatrix_device_report(pts, "gaussian", k=8, c_leaf=128,
                                              precompute=True)
    assert _build.LAUNCHES["morton_encode"] == 1
    assert _build.LAUNCHES["batched_aca"] == len(dev.plan.aca_levels)
    assert report.launches == 1 + len(dev.plan.aca_levels)
    assert torch.equal(dev.tree.perm, host.tree.perm)
    assert torch.equal(dev.tree.points, host.tree.points)
    assert sorted(dev.plan.aca_levels) == sorted(host.plan.aca_levels)
    for lv, blocks in host.plan.aca_levels.items():
        np.testing.assert_array_equal(dev.plan.aca_levels[lv], blocks)
    np.testing.assert_array_equal(dev.plan.dense_blocks, host.plan.dense_blocks)
    x = torch.from_numpy(_rs(4).randn(3000, 4).astype(np.float32))
    oracle = dense_matvec_oracle(pts, "gaussian", x, device="cpu")
    assert _rel(make_apply(dev)(x.to(cuda_device)).cpu(), oracle) <= 1e-4
    plain = build_hmatrix_device(pts, "gaussian", k=8, c_leaf=128, precompute=True,
                                 use_kernels=False)
    for lv, (u, v) in host.factors.items():
        assert torch.equal(plain.factors[lv][0], u) and torch.equal(plain.factors[lv][1], v)


def _decaying(b, m, n, k, seed):
    rng = _rs(seed)
    scale = (0.35 ** np.arange(k)).astype(np.float32)
    u = torch.from_numpy(rng.randn(b, m, k).astype(np.float32) * scale)
    v = torch.from_numpy(rng.randn(b, n, k).astype(np.float32))
    return u, v


def _recompress_ok(u, v, u2, v2, ranks, ur, vr, ranks_ref, tol):
    """Every block within 2 tol of its Frobenius norm, and every block of the
    plain version's rank within 0.1 tol of the plain version's own error."""
    a0 = u.double() @ v.double().transpose(1, 2)
    norm = torch.linalg.matrix_norm(a0).clamp_min(1e-300)
    rel = torch.linalg.matrix_norm(u2.double() @ v2.double().transpose(1, 2) - a0) / norm
    rel_ref = torch.linalg.matrix_norm(ur.double() @ vr.double().transpose(1, 2) - a0) / norm
    same = ranks == ranks_ref
    return bool((rel <= 2 * tol).all()) and bool(((rel - rel_ref).abs()[same] <= 0.1 * tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,k,tol", [(6, 48, 40, 12, 1e-2), (5, 256, 256, 64, 1e-3),
                                         (3, 5000, 3000, 16, 1e-2), (4, 70, 90, 7, 1e-1)])
def test_recompress_kernel_matches_plain_on_card(cuda_device, b, m, n, k, tol):
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    from repro_torch.kernels.batched_recompress.ops import batched_recompress
    from repro_torch.kernels.batched_recompress.ref import batched_recompress_ref
    u, v = _decaying(b, m, n, k, seed=m + k)
    u[1], v[-1] = 0.0, 0.0                             # all-zero blocks
    ug, vg = u.to(cuda_device), v.to(cuda_device)
    _build.reset_launches()
    u2, v2, ranks = batched_recompress(ug, vg, tol)
    assert _build.LAUNCHES["batched_recompress"] == 1
    ur, vr, r_ref = batched_recompress_ref(u, v, tol)
    assert _recompress_ok(u, v, u2.cpu(), v2.cpu(), ranks.cpu(), ur, vr, r_ref, tol)
    assert ranks[1] == 0 and ranks[-1] == 0
    assert bool(torch.isfinite(u2).all()) and bool(torch.isfinite(v2).all())
    for blk, r in enumerate(ranks.tolist()):
        assert bool((u2[blk, :, r:] == 0).all()) and bool((v2[blk, :, r:] == 0).all())
    _, _, s, ranks2, sweeps = batched_recompress_cuda(ug, vg, tol)
    assert torch.equal(ranks2, ranks)
    assert bool((s[:, 1:] <= s[:, :-1]).all()) and bool((sweeps >= 1).all())
    assert bool((sweeps <= 8).all())
    u3, v3, _ = batched_recompress(ug, vg, tol)       # no order-dependent sums
    assert torch.equal(u2, u3) and torch.equal(v2, v3)
    _build.reset_launches()
    batched_recompress(ug, vg, 1e-4)                  # below the Gram floor: the oracle
    assert _build.LAUNCHES["batched_recompress"] == 0
    assert _build.ORACLE_CALLS["batched_recompress"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,p,shared", [(3, 256, 256, True), (4, 256, 32, True),
                                          (2, 100, 13, False)])
def test_trsm_panels_kernel_matches_plain_on_card(cuda_device, b, c, p, shared):
    from repro_torch.kernels.batched_trsm_lowrank.ops import batched_trsm_panels
    from repro_torch.kernels.batched_trsm_lowrank.ref import batched_trsm_panels_ref
    a = torch.from_numpy(_spd(_rs(c + p), 1 if shared else b, c)).to(cuda_device)
    lmat = batched_block_cholesky(a)
    x = torch.from_numpy(_rs(c).randn(b, c, p).astype(np.float32)).to(cuda_device)
    y = batched_trsm_panels(lmat, x)
    assert _rel(y, batched_trsm_panels_ref(lmat, x)) <= 1e-4
    assert _rel(torch.linalg.solve_triangular(lmat, x, upper=False), y) <= 1e-4
    assert torch.equal(y, batched_trsm_panels(lmat, x))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,p", [(3, 256, 256, 256), (5, 256, 256, 32), (2, 100, 70, 9)])
def test_schur_dense_kernel_matches_plain_on_card(cuda_device, b, m, n, p):
    from repro_torch.kernels.batched_schur_update.ops import batched_schur_dense
    from repro_torch.kernels.batched_schur_update.ref import batched_schur_dense_ref
    g = torch.Generator(device="cpu").manual_seed(m + n + p)
    c = torch.randn(b, m, n, generator=g).to(cuda_device)
    a = torch.randn(b, m, p, generator=g).to(cuda_device)
    bb = torch.randn(b, n, p, generator=g).to(cuda_device)
    y = batched_schur_dense(c, a, bb)
    assert _rel(y, batched_schur_dense_ref(c, a, bb)) <= 1e-5
    assert torch.equal(y, batched_schur_dense(c, a, bb))


@pytest.mark.cuda
def test_memory_tier_and_hlu_on_card_match_the_cpu_port(cuda_device):
    """Recompression, spill / reload and the H-LU preconditioned solve on the
    card (kernels) against the same on the CPU (plain versions)."""
    from repro_torch.core import build_hmatrix, halton, make_apply
    from repro_torch.harith import factorize_hlu
    from repro_torch.solve import make_solver
    pts = halton(2000, 2) * 4.0
    x = torch.from_numpy(_rs(9).randn(2000, 4).astype(np.float32))
    flat = build_hmatrix(pts, "gaussian", k=16, c_leaf=128, precompute=True)
    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=128, precompute=True,
                       recompress_tol=1e-2)
    z = make_apply(hm)(x.to(cuda_device))
    assert _rel(z, make_apply(flat)(x.to(cuda_device))) <= 5e-2
    hm.factors.spill()
    with pytest.raises(RuntimeError, match="spilled"):
        make_apply(hm)(x.to(cuda_device))
    hm.factors.reload()
    assert torch.equal(make_apply(hm)(x.to(cuda_device)), z)

    hm_cpu = build_hmatrix(pts, "gaussian", k=16, c_leaf=128, precompute=True, device="cpu")
    _build.reset_launches()
    f_gpu = factorize_hlu(flat, 1e-2, tol=1e-3)
    for name in ("batched_block_cholesky", "batched_trsm_panels", "batched_schur_dense",
                 "batched_recompress"):
        assert _build.LAUNCHES[name] > 0, name
    f_cpu = factorize_hlu(hm_cpu, 1e-2, tol=1e-3)
    # two truncation algorithms at tol = 1e-3 (Gram + Jacobi on the card, QR +
    # SVD on the CPU): their tiles part by about tol times the tiles' scale
    assert bool(torch.isfinite(f_gpu.dense).all()) and bool(torch.isfinite(f_gpu.ulr).all())
    assert (f_gpu.dense.cpu() - f_cpu.dense).abs().max() <= 1e-3
    prod = (f_gpu.ulr @ f_gpu.vlr.transpose(1, 2)).cpu()
    assert (prod - f_cpu.ulr @ f_cpu.vlr.transpose(1, 2)).abs().max() <= 1e-3
    f_again = factorize_hlu(flat, 1e-2, tol=1e-3)
    assert torch.equal(f_again.dense, f_gpu.dense) and torch.equal(f_again.ulr, f_gpu.ulr)
    c_gpu, info_gpu = make_solver(flat, 1e-2, tol=1e-5, precond="hlu")(x.to(cuda_device))
    c_cpu, info_cpu = make_solver(hm_cpu, 1e-2, tol=1e-5, precond="hlu")(x)
    assert info_gpu.converged and info_cpu.converged
    assert np.abs(info_gpu.iters_per_column - info_cpu.iters_per_column).max() <= 2
    # at sigma2 = 1e-2 the solutions' entries reach ~1e2 against targets of
    # ~1: a fresh fp32 apply of them rounds at eps |A| |c| / |x| (~2e-3 at
    # most), and the two devices' operators (their ACA factors differ in
    # rounding) part in the solution by the system's conditioning
    xg = x.to(cuda_device)
    assert _rel(make_apply(flat)(c_gpu) + 1e-2 * c_gpu, xg) <= 1e-3
    assert _rel(c_gpu.cpu(), c_cpu) <= 1e-2
