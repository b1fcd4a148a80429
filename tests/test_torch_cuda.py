"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device, and import
nothing of JAX or ``repro`` so that they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 relative (Frobenius) for the three
products and the dense Schur update, 1e-4 for the Cholesky pair with
``|L L^T - A| / |A| <= 1e-5`` (the factorisation on both its routes and at
their boundary, also with a clamped pivot) and for the panel triangular
solve, Morton codes exactly equal (also on edge points and a base that is
not 16-byte aligned), the ACA by the max error of ``U V^T`` against the
block, within ``max(2 x the plain version's, 1e-4)`` (the two may pick
other pivots on near-ties), and the recompression (Gram + Jacobi against
the plain QR + SVD) by equal ranks or a reconstruction error within
``2 tol`` of each block's Frobenius norm (also on H-LU's mix of all-zero,
rank-deficient and decaying blocks at k in {1, 7, 16, 64}), the
H-attention near field by ``m`` within 1e-5 absolute and ``num``, ``den``
within 1e-4 relative (the JAX test's limits; also with a row max that
rises in later key tiles), its backward #11b against the plain derivative
within 1e-4 relative per gradient (also with maxima tied inside a leaf and
across its two blocks, a key two ulps below a row's max, and scores up to
about +-30), ``h_attention``'s gradient through #11 / #11b
against the plain route within 1e-3 (ACA pivots are on the path), and the
LM's prefill through the kernel against the same prefill through the plain
version on the card within 1e-4 relative.
The ACA's two routes (resident, at every cluster size that fits, and
streamed) must give the same bits, the dense leaves' level entry the
gathered entry's bits, the dense product's wide route (R > 8) the bits of
its narrow route's 8-column slices, and the low-rank level entry the bits of the
gathered entry followed by ``_scatter_rows``.  With TF32 on, every entry point raises for CUDA
operands.
"""
import ctypes

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
from torch_parity_util import one_torch_thread  # noqa: F401


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
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("c", [96, 200, 256])
@pytest.mark.parametrize("r", [1, 8, 13, 16, 27, 32, 64, 80])
def test_dense_matmat_kernel_matches_plain_on_card(cuda_device, c, r, d):
    """Both routes (R <= 8 narrow, wider panels wide) and each of the wide
    route's instances (16, 32 and 64 columns; 13 and 27 ragged, without the
    16-byte copies of X), with ragged row and column tiles (c = 200) and, at
    R = 80, a ragged second column group."""
    g = torch.Generator(device="cpu").manual_seed(c + r)
    rows = torch.rand(5, c, d, generator=g).to(cuda_device)
    cols = torch.rand(5, c, d, generator=g).to(cuda_device) + 0.5
    x = torch.randn(5, c, r, generator=g).to(cuda_device)
    for kernel in ("gaussian", "matern"):
        y = batched_kernel_matmat(rows, cols, x, kernel)
        assert _rel(y, batched_kernel_matmat_ref(rows, cols, x, kernel)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 13, 16, 27, 32, 64])
def test_dense_wide_route_is_counted_and_repeats_the_narrow_bits_on_card(cuda_device, r):
    """The wide route counts its launches, gives the same bits twice (no
    atomics, a fixed order of sums), and the bits of the narrow route's
    8-column slices (each column chains its sums in the same order)."""
    from repro_torch.kernels.batched_dense_matvec.kernel import dense_route
    g = torch.Generator(device="cpu").manual_seed(r)
    rows = torch.rand(4, 2048, 3, generator=g).to(cuda_device)
    cols = torch.rand(4, 2048, 3, generator=g).to(cuda_device) + 0.5
    x = torch.randn(4, 2048, r, generator=g).to(cuda_device)
    for kernel in ("gaussian", "matern"):
        before = dict(_build.LAUNCHES)
        y = batched_kernel_matmat(rows, cols, x, kernel)
        assert _build.LAUNCHES["batched_kernel_matmat"] == before["batched_kernel_matmat"] + 1
        assert (_build.LAUNCHES["batched_kernel_matmat_wide"]
                == before["batched_kernel_matmat_wide"] + (dense_route(r) == "wide"))
        assert torch.equal(y, batched_kernel_matmat(rows, cols, x, kernel))
        slices = [batched_kernel_matmat(rows, cols, x[:, :, q:q + 8].contiguous(), kernel)
                  for q in range(0, r, 8)]
        assert torch.equal(y, torch.cat(slices, dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 256, 2048])
@pytest.mark.parametrize("r", [1, 8, 13, 32, 64])
def test_dense_level_entry_equals_the_gathered_entry_on_card(cuda_device, c, r):
    from repro_torch.kernels.batched_dense_matvec.ops import (batched_kernel_matmat_level,
                                                              batched_kernel_matvec_level)
    g = torch.Generator(device="cpu").manual_seed(c + r)
    n_leaf = 6
    points = (torch.rand(n_leaf * c, 2, generator=g) * 2).to(cuda_device)
    x_pad = torch.randn(n_leaf * c, r, generator=g).to(cuda_device)
    rows = torch.tensor([4, 0, 4, 2, 5, 1, 4], device=cuda_device)
    cols = torch.tensor([1, 0, 5, 2, 5, 3, 0], device=cuda_device)
    leaf = points.reshape(n_leaf, c, 2)
    g_rows, g_cols = leaf[rows].contiguous(), leaf[cols].contiguous()
    g_x = x_pad.reshape(n_leaf, c, r)[cols].contiguous()
    for kernel in ("gaussian", "matern"):
        before = _build.LAUNCHES["batched_kernel_matmat"]
        y = batched_kernel_matmat_level(points, rows, cols, x_pad, c, kernel)
        assert _build.LAUNCHES["batched_kernel_matmat"] == before + 1
        assert torch.equal(y, batched_kernel_matmat(g_rows, g_cols, g_x, kernel))
        assert _rel(y, batched_kernel_matmat_ref(g_rows, g_cols, g_x, kernel)) <= 1e-5
        if r == 1:
            yv = batched_kernel_matvec_level(points, rows, cols, x_pad[:, 0], c, kernel)
            assert torch.equal(yv, batched_kernel_matvec(g_rows, g_cols, g_x[:, :, 0], kernel))
            assert torch.equal(yv, y[:, :, 0])
    # a leaf id outside the leaves reads nothing outside the arrays: NaN rows
    bad = torch.where(rows == 2, n_leaf, rows)
    yb = batched_kernel_matmat_level(points, bad, cols, x_pad, c)
    assert yb[3].isnan().all()
    keep = torch.tensor([0, 1, 2, 4, 5, 6], device=cuda_device)
    assert torch.equal(yb[keep], batched_kernel_matmat_level(points, rows, cols, x_pad, c)[keep])


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


def _level_case(device, seed, n_clusters, m, b, k, r):
    """A level group of b blocks over n_clusters clusters of m rows, with
    repeated row clusters, and its operands."""
    from repro_torch.core.hmatrix import block_group
    rng = _rs(seed)
    blocks = np.stack([rng.randint(0, n_clusters, b), rng.randint(0, n_clusters, b)], axis=1)
    g = block_group(blocks, device)
    g_cpu = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.randn(b, m, k, generator=g_cpu).to(device)
    v = torch.randn(b, m, k, generator=g_cpu).to(device)
    x_pad = torch.randn(n_clusters * m, r, generator=g_cpu).to(device)
    z_pad = torch.randn(n_clusters * m, r, generator=g_cpu).to(device)
    return g, u, v, x_pad, z_pad


def _check_level_entry(g, u, v, x_pad, z_pad):
    from repro_torch.core.hmatrix import _scatter_rows
    from repro_torch.kernels.batched_aca.kernel import lowrank_column_chunks
    from repro_torch.kernels.batched_aca.ops import batched_lowrank_matmat_level
    m, k, r = u.shape[1], u.shape[2], x_pad.shape[1]
    y = batched_lowrank_matmat(u, v, x_pad.reshape(-1, m, r)[g.cols])
    want = _scatter_rows(z_pad.clone(), y, g)
    before = _build.LAUNCHES["batched_lowrank_matmat"]
    got = batched_lowrank_matmat_level(u, v, x_pad, g.cols, g, z_pad.clone())
    assert _build.LAUNCHES["batched_lowrank_matmat"] == before + len(lowrank_column_chunks(k, r))
    assert torch.equal(got, want)
    assert torch.equal(got, batched_lowrank_matmat_level(u, v, x_pad, g.cols, g, z_pad.clone()))
    plain = z_pad.clone()
    from repro_torch.kernels.batched_aca.ref import batched_lowrank_matmat_level_ref
    batched_lowrank_matmat_level_ref(u, v, x_pad, g.cols, g, plain)
    assert _rel(got - z_pad, plain - z_pad) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 16, 64])
@pytest.mark.parametrize("r", [1, 8, 80])
def test_lowrank_level_entry_equals_gathered_and_scatter_on_card(cuda_device, k, r):
    """The level entry (X read in place, each row cluster's blocks summed in
    table order into Z) against the gathered kernel + ``_scatter_rows``:
    the same bits, run to run too; k * R > 1024 goes in column chunks of
    strided views.  m = 2500 splits V^T X over two CTAs a block."""
    _check_level_entry(*_level_case(cuda_device, 100 + k + r, 8, 2500, 24, k, r))


@pytest.mark.cuda
def test_lowrank_level_entry_on_a_coarse_group_on_card(cuda_device):
    """4 blocks of 131,072 rows (problem P's level 3): 64 splits a block."""
    _check_level_entry(*_level_case(cuda_device, 7, 8, 131072, 4, 16, 8))


def _well_conditioned_lower(b, c, device, seed):
    """Lower factors with a diagonal in [1, 2) and small entries below it."""
    gen = torch.Generator(device=device.type).manual_seed(seed)
    lmat = torch.randn(b, c, c, generator=gen, device=device).tril_(-1).mul_(0.5 / c ** 0.5)
    lmat.diagonal(dim1=1, dim2=2).copy_(1.0 + torch.rand(b, c, generator=gen, device=device))
    return lmat


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", [(75, 3), (100, 1), (100, 128), (256, 1), (256, 128),
                                 (2048, 1), (2048, 512)])
@pytest.mark.parametrize("r", [1, 3, 8])
def test_block_cholesky_solve_kernel_matches_plain_on_card(cuda_device, c, b, r):
    """#6 at problem K's (128, 256) and problem P's (512, 2048) shapes, at
    B = 1, with a ragged last tile (c = 75, 100) and c % 4 != 0 (4-byte
    copies): within 1e-4 of the plain version and bit-identical run to run."""
    lmat = _well_conditioned_lower(b, c, cuda_device, c + b + r)
    x = torch.randn(b, c, r, generator=torch.Generator(device="cuda").manual_seed(r),
                    device=cuda_device)
    before = _build.LAUNCHES["batched_block_cholesky_solve"]
    y = batched_block_cholesky_solve(lmat, x)
    assert _build.LAUNCHES["batched_block_cholesky_solve"] == before + 1
    assert _rel(y, batched_block_cholesky_solve_ref(lmat, x)) <= 1e-4
    assert torch.equal(y, batched_block_cholesky_solve(lmat, x))


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
@pytest.mark.parametrize("b,c", [(1, 1), (1, 31), (1, 33), (1, 100), (1, 256),
                                 (1, 288), (1, 289), (1, 512),
                                 (2, 2048)])
def test_block_cholesky_routes_on_card(cuda_device, b, c):
    """#5 on its shared-memory route (c <= 288), its wide route and their
    boundary, with ragged tiles and c % 4 != 0 (4-byte copies): one launch
    a call, within 1e-4 of the plain version, |L L^T - A| / |A| <= 1e-5,
    exact zeros above the diagonal, and two calls bit-identical.  The C
    entry's launches one by one (``repro_block_cholesky_part``, index 0, 1,
    ... until kind -1) give the same bits: one launch at c <= 288, three
    a step of 128 columns above, the last step's diagonal tile alone."""
    from repro_torch.kernels import stream_handle
    a = torch.from_numpy(_spd(_rs(c + b), b, c)).to(cuda_device)
    before = _build.LAUNCHES["batched_block_cholesky"]
    l_k = batched_block_cholesky(a)
    assert _build.LAUNCHES["batched_block_cholesky"] == before + 1
    assert _rel(l_k, batched_block_cholesky_ref(a)) <= 1e-4
    assert _rel(l_k @ l_k.transpose(1, 2), a) <= 1e-5
    assert (torch.triu(l_k, diagonal=1) == 0).all()
    assert torch.equal(l_k, batched_block_cholesky(a))
    part = _build.c_function("block_cholesky", "repro_block_cholesky_part",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                             + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    l_parts, dinv, kind = torch.empty_like(a), a.new_empty((b, c)), ctypes.c_int()
    kinds = []
    while not kinds or kinds[-1] >= 0:
        _build.check(part(a.data_ptr(), l_parts.data_ptr(), dinv.data_ptr(), b, c, len(kinds),
                          ctypes.byref(kind), stream_handle(a.device)), "part")
        kinds.append(kind.value)
    assert kinds[:-1] == ([0] if c <= 288 else [0, 1, 2] * ((c - 1) // 128) + [0])
    assert torch.equal(l_parts, l_k)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [100, 256, 289, 512])
def test_block_cholesky_clamped_pivot_on_card(cuda_device, c):
    """Row and column 40 zeroed: the pivot is clamped at 1e-30 on both
    routes, column 40 of L is exactly zero, and L agrees with the plain
    version."""
    a = torch.from_numpy(_spd(_rs(3 * c), 2, c))
    a[:, 40, :] = 0.0
    a[:, :, 40] = 0.0
    a = a.to(cuda_device)
    l_k = batched_block_cholesky(a)
    l_r = batched_block_cholesky_ref(a)
    assert bool(torch.isfinite(l_k).all())
    assert (l_k[:, :, 40] == 0).all() and (l_r[:, :, 40] == 0).all()
    assert _rel(l_k, l_r) <= 1e-4
    assert (torch.triu(l_k, diagonal=1) == 0).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 5, 7, 1001])
def test_morton_kernel_edge_points_on_card(cuda_device, d, n):
    """The box's corners, 1.0, the float just below 1.0, points outside the
    box and (d = 1) the nb >= 25 clamp, N not a multiple of the kernel's 2
    points a thread, and a base that is not 16-byte aligned (a view one
    point in): the plain version's codes bit for bit."""
    pts = torch.rand(n, d, generator=torch.Generator().manual_seed(n + d))
    below = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    edges = torch.tensor([[0.0] * d, [1.0] * d, [below] * d, [-0.5] * d, [2.0] * d,
                          [1.0] + [0.0] * (d - 1), [0.0] * (d - 1) + [below]])
    pts[:min(n, len(edges))] = edges[:n]
    want = morton_encode_ref(pts)
    assert torch.equal(morton_encode(pts.to(cuda_device)).cpu(), want)
    shifted = torch.cat([torch.zeros(1, d), pts]).to(cuda_device)[1:]
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(morton_encode(shifted).cpu(), want)


def _aca_err(rows, cols, u, v, kernel):
    return float((phi_matrix(rows, cols, kernel) - u @ v.transpose(1, 2)).abs().max())


def _aca_blocks(rows, cols, kernel, k, route=None, cluster=None):
    """The ACA kernel on gathered blocks (B, m, d), (B, n, d) -> (U, V, row
    pivots, column pivots), the pivots (B, k) decoded from the kernel's keys."""
    b, m, d = rows.shape
    ids = torch.arange(b, device=rows.device)
    u, v, keys = aca_kernel._aca_launch(rows.reshape(-1, d), ids, cols.reshape(-1, d), ids,
                                        m, cols.shape[1], kernel, k, route, cluster)
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
@pytest.mark.parametrize("b,m,n,k", [(3, 64, 64, 8), (2, 300, 200, 16), (1, 5000, 5000, 16),
                                     (4, 10, 12, 16), (2, 300, 200, 64)])
@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d", [1, 3])
def test_aca_routes_give_the_same_bits_on_card(cuda_device, b, m, n, k, kernel, d):
    g = torch.Generator(device="cpu").manual_seed(b + m + n + k + d)
    rows = torch.rand(b, m, d, generator=g).to(cuda_device)
    cols = (torch.rand(b, n, d, generator=g) + 1.5).to(cuda_device)
    want = _aca_blocks(rows, cols, kernel, k, "streamed")
    limit = aca_kernel.smem_per_block(rows.device)
    clusters = [cs for cs in aca_kernel.RESIDENT_CLUSTERS
                if aca_kernel.resident_fits(m, n, k, d, cs, limit)]
    assert clusters
    for cs in clusters:
        got = _aca_blocks(rows, cols, kernel, k, "resident", cs)
        assert all(torch.equal(a, w) for a, w in zip(got, want)), cs
    # the picker's own route gives the same bits as well
    assert all(torch.equal(a, w) for a, w in zip(_aca_blocks(rows, cols, kernel, k), want))
    ur, vr = batched_aca_ref(rows, cols, kernel, k)
    assert _aca_err(rows, cols, want[0], want[1], kernel) <= max(
        2.0 * _aca_err(rows, cols, ur, vr, kernel), 1e-4)


@pytest.mark.cuda
def test_aca_resident_route_refuses_a_block_too_large(cuda_device):
    pts = torch.rand(1 << 15, 2, device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="resident"):
        aca_kernel.batched_aca_level_cuda(pts, ids, ids, 0, "gaussian", 16, route="resident")
    u, v = aca_kernel.batched_aca_level_cuda(pts, ids, ids, 0, "gaussian", 16)     # streamed
    assert u.shape == (1, 1 << 15, 16) and bool(torch.isfinite(u).all())


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


def _hlu_mix(b, m, k, seed):
    """Blocks as H-LU re-truncates them: every third all-zero, every third a
    rank-deficient concatenation [u | -u C] (k >= 2; C with orthonormal
    columns, so the block's nonzero singular values stay within the Gram
    route's fp32 resolution), the rest decaying."""
    rng = _rs(seed)
    u, v = _decaying(b, m, m, k, seed)
    if k >= 2:
        half = k // 2
        u1 = rng.randn(b, m, half).astype(np.float32)
        c = np.linalg.qr(rng.randn(b, k - half, k - half))[0][:, :half].astype(np.float32)
        defic = torch.from_numpy(np.concatenate([u1, -u1 @ c], axis=2))
        u[1::3] = defic[1::3]
    u[::3] = 0.0
    return u, v


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 16, 64])
@pytest.mark.parametrize("b", [1, 5, 2048])
def test_recompress_kernel_on_hlu_blocks_on_card(cuda_device, b, k):
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    from repro_torch.kernels.batched_recompress.ref import batched_recompress_ref
    tol = 1e-3
    u, v = (t.to(cuda_device) for t in _hlu_mix(b, 256, k, seed=b + k))
    u2, v2, s, ranks, sweeps = batched_recompress_cuda(u, v, tol)
    ur, vr, r_ref = batched_recompress_ref(u, v, tol)
    assert _recompress_ok(u, v, u2, v2, ranks, ur, vr, r_ref, tol)
    zero = (u.abs().amax(dim=(1, 2)) == 0) | (v.abs().amax(dim=(1, 2)) == 0)
    assert bool((ranks[zero] == 0).all()) and bool((s[zero] == 0).all())
    assert bool(torch.isfinite(u2).all()) and bool(torch.isfinite(v2).all())
    cols = torch.arange(k, device=cuda_device)
    past = cols[None, None, :] >= ranks[:, None, None]
    assert not bool((u2 * past).any()) and not bool((v2 * past).any())
    assert bool((s[:, 1:] <= s[:, :-1]).all()) and bool(((sweeps >= 1) & (sweeps <= 8)).all())
    again = batched_recompress_cuda(u, v, tol)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (u2, v2, s, ranks, sweeps)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,p,shared,zero_pivot", [
    (3, 256, 256, True, False), (4, 256, 32, True, False), (2, 100, 13, False, False),
    (1, 256, 256, True, False), (128, 256, 32, True, False),   # H-LU's B = 1 and V panels
    (24, 256, 64, True, False),                                  # 16-column chunks
    (2, 1024, 40, False, False),                                 # c = 1024: 7 passes a step
    (2, 75, 7, False, False),                                    # c % 4 != 0: scalar L reads
    (3, 96, 20, True, True)])                                    # a clamped zero pivot
def test_trsm_panels_kernel_matches_plain_on_card(cuda_device, b, c, p, shared, zero_pivot):
    from repro_torch.kernels.batched_trsm_lowrank.ops import batched_trsm_panels
    from repro_torch.kernels.batched_trsm_lowrank.ref import batched_trsm_panels_ref
    a = torch.from_numpy(_spd(_rs(c + p), 1 if shared else b, c)).to(cuda_device)
    lmat = batched_block_cholesky(a)
    x = torch.from_numpy(_rs(c).randn(b, c, p).astype(np.float32)).to(cuda_device)
    if zero_pivot:
        # row 40 of L (pivot included), its column below and its X row
        # zero: the 1e-30 clamp gives y = 0 there, as in the plain version
        lmat[:, 40, :] = 0.0
        lmat[:, 40:, 40] = 0.0
        x[:, 40, :] = 0.0
    y = batched_trsm_panels(lmat, x)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, batched_trsm_panels_ref(lmat, x)) <= 1e-4
    if zero_pivot:
        assert bool((y[:, 40, :] == 0).all())
    else:
        assert _rel(torch.linalg.solve_triangular(lmat, x, upper=False), y) <= 1e-4
    assert torch.equal(y, batched_trsm_panels(lmat, x))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,p,view", [
    (3, 256, 256, 256, False), (5, 256, 256, 32, False), (2, 100, 70, 9, False),
    (1, 256, 256, 256, False), (7, 256, 256, 32, False),        # small grids: 64 x 64 tiles
    (40, 256, 256, 32, False),                                   # 128 x 128 tiles
    (3, 130, 200, 17, False),                                    # ragged tiles, p % 16 != 0
    (2, 37, 45, 9, True)])                                       # bases not 16-byte aligned
def test_schur_dense_kernel_matches_plain_on_card(cuda_device, b, m, n, p, view):
    from repro_torch.kernels.batched_schur_update.ops import batched_schur_dense
    from repro_torch.kernels.batched_schur_update.ref import batched_schur_dense_ref
    g = torch.Generator(device="cpu").manual_seed(m + n + p)
    lead = b + 1 if view else b
    c = torch.randn(lead, m, n, generator=g).to(cuda_device)
    a = torch.randn(lead, m, p, generator=g).to(cuda_device)
    bb = torch.randn(lead, n, p, generator=g).to(cuda_device)
    if view:
        # t[1:] starts m n, m p, n p floats in: odd counts, so 4-byte aligned only
        c, a, bb = c[1:], a[1:], bb[1:]
        assert all(t.data_ptr() % 16 for t in (c, a, bb))
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


@pytest.mark.cuda
@pytest.mark.parametrize("bh,nl,c,d", [(2, 4, 64, 32), (1, 8, 128, 16), (3, 2, 32, 64),
                                       (2, 3, 100, 16), (2, 4, 512, 128)])
def test_hattention_nearfield_kernel_matches_plain_on_card(cuda_device, bh, nl, c, d):
    from repro_torch.kernels.hattention_block.ops import hattention_nearfield_op
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    g = torch.Generator(device="cpu").manual_seed(bh + nl + c + d)
    q, k, v = (torch.randn(bh, nl, c, d, generator=g).to(cuda_device) for _ in range(3))
    q = q / d ** 0.5
    before = _build.LAUNCHES["hattention_nearfield"]
    num, den, m = hattention_nearfield_op(q, k, v)
    assert _build.LAUNCHES["hattention_nearfield"] == before + 1
    num_r, den_r, m_r = hattention_nearfield_ref(q, k, v)
    assert float((m - m_r).abs().max()) <= 1e-5
    assert _rel(den, den_r) <= 1e-4 and _rel(num, num_r) <= 1e-4
    again = hattention_nearfield_op(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(again, (num, den, m)))     # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 100, 512])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("nl", [1, 3])
def test_hattention_nearfield_online_rescaling_on_card(cuda_device, c, d, nl):
    """Keys whose mean grows along the sequence against a query with a
    positive mean: a row's max rises in later key tiles, so the kernel's
    rescaling of num and den runs."""
    from repro_torch.kernels.hattention_block.kernel import hattention_nearfield_cuda
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    rng = _rs(c + d + nl)
    bh = 2
    pos = (np.arange(nl * c).reshape(nl, c) / (nl * c))[None, :, :, None]
    q = torch.from_numpy(((rng.randn(bh, nl, c, d) + 1.0) / np.sqrt(d)).astype(np.float32))
    k = torch.from_numpy((rng.randn(bh, nl, c, d) + 3.0 * pos).astype(np.float32))
    v = torch.from_numpy(rng.randn(bh, nl, c, d).astype(np.float32))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    num, den, m = hattention_nearfield_cuda(q, k, v)
    num_r, den_r, m_r = hattention_nearfield_ref(q, k, v)
    assert float((m - m_r).abs().max()) <= 1e-5
    assert _rel(den, den_r) <= 1e-4 and _rel(num, num_r) <= 1e-4
    again = hattention_nearfield_cuda(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(again, (num, den, m)))


def _nearfield_bwd_case(device, bh, nl, c, d, seed, ties: bool):
    """q, k, v for #11b, and random cotangents; with ``ties``, rows whose max
    is attained by several keys: key 5 of every leaf a copy of key 3, key 7
    of leaf n - 1 a copy of leaf n's key 3, and rows 9, 40 and c - 1 of
    every leaf aligned with key 3 (so that it is their max), in leaf 0
    without a previous block."""
    rng = _rs(seed)
    q = rng.randn(bh, nl, c, d) / np.sqrt(d)
    k = rng.randn(bh, nl, c, d)
    v = rng.randn(bh, nl, c, d)
    if ties:
        k[:, :, 5] = k[:, :, 3]
        k[:, :-1, 7] = k[:, 1:, 3]
        for r in (9, 40, c - 1):
            q[:, :, r] = k[:, :, 3] / np.sqrt(d)
    g = [rng.randn(bh, nl, c, d), rng.randn(bh, nl, c), rng.randn(bh, nl, c)]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (q, k, v, *g)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,nl,c,d,ties", [(2, 4, 64, 32, False), (3, 3, 100, 32, True),
                                            (2, 2, 96, 64, True), (4, 3, 512, 128, True),
                                            (40, 2, 512, 128, False), (2, 3, 100, 16, True),
                                            (1, 1, 33, 16, False)])
def test_hattention_nearfield_bwd_kernel_matches_plain_on_card(cuda_device, bh, nl, c, d, ties):
    """#11b against the plain derivative on the card, from #11's (num, den,
    m), within 1e-4 relative per gradient; with tied maxima inside a leaf
    and across the two blocks (the cotangent of m split as JAX splits it);
    two launches bit-identical."""
    from repro_torch.kernels.hattention_block.kernel import (hattention_nearfield_bwd_cuda,
                                                             hattention_nearfield_cuda)
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_bwd_ref
    q, k, v, gnum, gden, gm = _nearfield_bwd_case(cuda_device, bh, nl, c, d, c + d, ties)
    num, den, m = hattention_nearfield_cuda(q, k, v)
    before = _build.LAUNCHES["hattention_nearfield_bwd"]
    got = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
    assert _build.LAUNCHES["hattention_nearfield_bwd"] == before + 1
    want = hattention_nearfield_bwd_ref(q, k, v, num, den, m, gnum, gden, gm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    if ties:
        # the case is there: row 9's max in its own leaf is attained by keys 3 and 5
        s = torch.einsum("bncd,bnkd->bnck", q, k)[:, :, 9, :10]
        assert torch.equal(s[..., 3], s[..., 5]) and torch.equal(s[..., 3], s.amax(-1))
    again = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
    assert all(torch.equal(a, b) for a, b in zip(again, got))          # no atomics


def _nearfield_bwd_stress(device, bh, nl, c, d, seed, kind: str):
    """#11b's inputs for two harder cases.  ``near_tie``: rows 9, 40 and
    c - 1 of every leaf are 2 e_0 and key 3 is 17 e_0, so key 3 is their
    max (s = 34), and key 5 is key 3 times (1 - 2^-22), whose score 34 -
    2^-17 lies two ulps below m and must not be taken as a tie (leaf n +
    1's rows tie exactly across the two blocks on key 3).  Every score of
    keys 3 and 5 is one rounded product, the same in any order, and stays
    below key 3's in every row.  ``large``: q scaled by 7.5, so that
    the scores reach about +-30."""
    rng = _rs(seed)
    q = (rng.randn(bh, nl, c, d) / np.sqrt(d)).astype(np.float32)
    k = rng.randn(bh, nl, c, d).astype(np.float32)
    v = rng.randn(bh, nl, c, d).astype(np.float32)
    if kind == "near_tie":
        for r in (9, 40, c - 1):
            q[:, :, r] = 0.0
            q[:, :, r, 0] = 2.0
        k[:, :, 3] = 0.0
        k[:, :, 3, 0] = 17.0
        k[:, :, 5] = k[:, :, 3] * np.float32(1.0 - 2.0 ** -22)
    else:
        q *= np.float32(7.5)
    g = [rng.randn(bh, nl, c, d), rng.randn(bh, nl, c), rng.randn(bh, nl, c)]
    return [torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
            for a in (q, k, v, *g)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,nl,c,d,kind", [(3, 3, 100, 32, "near_tie"),
                                            (4, 3, 512, 128, "near_tie"),
                                            (2, 2, 96, 16, "near_tie"),
                                            (3, 3, 100, 64, "large"),
                                            (4, 3, 512, 128, "large"),
                                            (2, 2, 33, 16, "large")])
def test_hattention_nearfield_bwd_near_ties_and_large_scores_on_card(cuda_device, bh, nl, c, d,
                                                                     kind):
    """#11b against the plain derivative on the card (1e-4 relative per
    gradient) where a key's score lies two ulps below the row's max (not a
    tie: the scores are recomputed in #11's order, the other products run
    on the tensor cores at fp32 accuracy), and with scores up to about
    +-30; two launches bit-identical."""
    from repro_torch.kernels.hattention_block.kernel import (hattention_nearfield_bwd_cuda,
                                                             hattention_nearfield_cuda)
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_bwd_ref
    q, k, v, gnum, gden, gm = _nearfield_bwd_stress(cuda_device, bh, nl, c, d, c + d + 7, kind)
    num, den, m = hattention_nearfield_cuda(q, k, v)
    s = torch.einsum("bncd,bnkd->bnck", q, k)
    if kind == "near_tie":
        # the case is there: row 9's max is key 3 alone, key 5 two ulps below
        assert bool((s[:, :, 9, 3] == 34.0).all()) and bool((m[:, :, 9] == 34.0).all())
        assert bool((s[:, :, 9, 5] == 34.0 - 2.0 ** -17).all())
    else:
        assert float(s.abs().amax()) > 20.0
    got = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
    want = hattention_nearfield_bwd_ref(q, k, v, num, den, m, gnum, gden, gm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    again = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_hattention_nearfield_bwd_resources_on_card(cuda_device):
    """#11b's kernels at every head dim keep the design's occupancy, two
    CTAs (16 warps) an SM within 128 registers, where ptxas may spill a few
    registers (phase 1 of chip_smoke.py records how many), not more."""
    from repro_torch.kernels.hattention_block.kernel import (HEAD_DIMS,
                                                             hattention_nearfield_bwd_info)
    for d in HEAD_DIMS:
        info = hattention_nearfield_bwd_info(d)
        for kernel, row in info.items():
            assert row["ctas_per_sm"] >= 2 and row["registers"] <= 128, (d, kernel, row)
            assert row["spill_bytes"] <= 32, (d, kernel, row)


def _plain_nearfield(monkeypatch):
    from repro_torch.kernels.hattention_block import ops as nearfield_ops
    from repro_torch.kernels.hattention_block.ref import (hattention_nearfield_bwd_ref,
                                                          hattention_nearfield_ref)
    monkeypatch.setattr(nearfield_ops, "hattention_nearfield_op", hattention_nearfield_ref)
    monkeypatch.setattr(nearfield_ops, "hattention_nearfield_bwd_op",
                        hattention_nearfield_bwd_ref)


def _h_attention_grads(q, k, v, w, c_leaf, rank):
    from repro_torch.core.hattention import h_attention
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (h_attention(*leaves, c_leaf=c_leaf, rank=rank) * w).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.cuda
def test_h_attention_grad_on_card_matches_the_plain_route(cuda_device, monkeypatch):
    """dq, dk, dv of h_attention through #11 and #11b against the same
    gradient through the plain near field and its plain backward on the
    card (1e-3 relative: ACA pivots sit on the path, and m differs by
    rounding between the routes), on smooth inputs at c_leaf 256, 8 leaves;
    two backward passes through the kernels bit-identical."""
    b, s, h, hkv, d = 1, 2048, 4, 2, 64
    t = np.linspace(0, 4 * np.pi, s)
    feats = np.stack([np.sin(t * (i + 1) / d) for i in range(d)], -1)
    rng = _rs(21)
    q = np.tile(feats[None, :, None, :], (b, 1, h, 1)) * 2.0 + 0.01 * rng.randn(b, s, h, d)
    k = np.tile(feats[None, :, None, :], (b, 1, hkv, 1)) * 2.0 + 0.01 * rng.randn(b, s, hkv, d)
    v = rng.randn(b, s, hkv, d)
    w = rng.randn(b, s, h, d)
    q, k, v, w = (torch.from_numpy(a.astype(np.float32)).to(cuda_device) for a in (q, k, v, w))
    before = dict(_build.LAUNCHES)
    got = _h_attention_grads(q, k, v, w, 256, 8)
    assert _build.LAUNCHES["hattention_nearfield"] == before["hattention_nearfield"] + 1
    assert _build.LAUNCHES["hattention_nearfield_bwd"] == before["hattention_nearfield_bwd"] + 1
    again = _h_attention_grads(q, k, v, w, 256, 8)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    with monkeypatch.context() as mp:
        _plain_nearfield(mp)
        want = _h_attention_grads(q, k, v, w, 256, 8)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))


@pytest.mark.cuda
def test_lm_prefill_on_card_matches_the_plain_route(cuda_device, monkeypatch):
    """The smoke hmatrix LM's prefill through kernel #11 against the same
    prefill with the near field forced to its plain version on the card,
    and a greedy decode through both."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.hattention_block import ops as nearfield_ops
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import get_model
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype="float32")
    model = get_model(cfg)
    params = model["init_params"](torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda_device,
                            generator=torch.Generator(device="cuda").manual_seed(1))
    _build.reset_launches()
    out = generate(params, cfg, prompts, 4)
    assert _build.LAUNCHES["hattention_nearfield"] == cfg.n_layers
    monkeypatch.setattr(nearfield_ops, "hattention_nearfield_op", hattention_nearfield_ref)
    plain = generate(params, cfg, prompts, 4)
    assert _rel(out["prefill_logits"], plain["prefill_logits"]) <= 1e-4
    assert torch.equal(out["tokens"], plain["tokens"])


@pytest.mark.cuda
def test_entry_points_raise_while_tf32_is_on(cuda_device, monkeypatch):
    from repro_torch.core import (build_hmatrix, build_hmatrix_device,
                                  build_hmatrix_device_report, halton, make_apply)
    from repro_torch.core.clustering import permute_to_tree
    from repro_torch.core.hattention import h_attention
    from repro_torch.harith import factorize_hlu, hlu_solve_panels
    from repro_torch.solve import make_solver
    pts = halton(1000, 2) * 4.0
    x = torch.from_numpy(_rs(11).randn(1000, 2).astype(np.float32)).to(cuda_device)
    hm = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, precompute=True)
    apply_h, solve = make_apply(hm), make_solver(hm, 1e-2, tol=1e-4)
    factors = factorize_hlu(hm, 1e-2, tol=1e-3)
    r_pad = permute_to_tree(hm.tree, x)
    q = torch.randn(1, 1024, 2, 16, device=cuda_device)
    kv = torch.randn(1, 1024, 1, 16, device=cuda_device)      # one KV head, one sequence
    calls = {"build_hmatrix": lambda: build_hmatrix(pts, "gaussian", k=8, c_leaf=128),
             "build_hmatrix_device": lambda: build_hmatrix_device(pts, "gaussian", k=8,
                                                                  c_leaf=128),
             "build_hmatrix_device_report": lambda: build_hmatrix_device_report(
                 pts, "gaussian", k=8, c_leaf=128),
             "apply": lambda: apply_h(x), "solve": lambda: solve(x),
             "factorize_hlu": lambda: factorize_hlu(hm, 1e-2, tol=1e-3),
             "hlu_solve_panels": lambda: hlu_solve_panels(factors, r_pad),
             "h_attention": lambda: h_attention(q, kv, kv, c_leaf=256, rank=4)}
    for name, call in calls.items():
        call()                                      # TF32 off: runs
    with monkeypatch.context() as mp:
        mp.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="TF32"):
                call()
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="TF32"):
                call()
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(apply_h(x), apply_h(x))        # TF32 off again: runs


@pytest.mark.cuda
def test_sharded_executors_on_card_order_after_their_shards(cuda_device):
    """The sharded apply and solve on four logical shards of card 0 (and on
    every card where there are several), issued from a second stream behind
    a device-side sleep: the gathered results, read on that stream, equal
    the same shards run on the CPU mesh within 1e-5, and two calls give the
    same bits; every shard launched the kernels."""
    from repro_torch.core import build_hmatrix, halton, make_apply
    from repro_torch.parallel import make_panel_mesh
    from repro_torch.solve import make_solver
    pts = halton(3000, 2) * 4.0
    x = torch.from_numpy(_rs(21).randn(3000, 6).astype(np.float32))
    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=128, precompute=True)
    hm_cpu = build_hmatrix(pts, "gaussian", k=16, c_leaf=128, precompute=True, device="cpu")
    cpu_mesh = make_panel_mesh(devices=("cpu",) * 4)
    meshes = [make_panel_mesh(devices=("cuda:0",) * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_panel_mesh())
    side = torch.cuda.Stream()
    for mesh in meshes:
        for shard in ("columns", "rows"):
            want = make_apply(hm_cpu, mesh=cpu_mesh, shard=shard)(x)
            apply_s = make_apply(hm, mesh=mesh, shard=shard)
            _build.reset_launches()
            with torch.cuda.stream(side):
                torch.cuda._sleep(int(5e7))         # the shards queue behind it
                z = apply_s(x.to(cuda_device))
                z_host = z.cpu()                    # a read ordered on the same stream
            assert _build.LAUNCHES["batched_kernel_matmat"] + \
                _build.LAUNCHES["batched_kernel_matvec"] >= len(mesh.devices)
            assert _build.LAUNCHES["batched_lowrank_matmat"] >= len(mesh.devices)
            assert _rel(z_host, want) <= 1e-5
            with torch.cuda.stream(side):
                assert torch.equal(apply_s(x.to(cuda_device)), z)
        solve = make_solver(hm, 0.5, tol=1e-5, max_iter=300, mesh=mesh)
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(5e7))
            c, info = solve(x.to(cuda_device))
            c_host = c.cpu()
        c_want, _ = make_solver(hm_cpu, 0.5, tol=1e-5, max_iter=300, mesh=cpu_mesh)(x)
        assert info.converged and info.iterations == int(info.iters_per_column.max())
        torch.testing.assert_close(c_host, c_want, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["P", "NP"])
@pytest.mark.parametrize("budget", [64 << 20, 1])
def test_batched_apply_gives_the_one_batch_bits_on_card(cuda_device, mode, budget):
    """An apply in batches of whole row clusters (every stage split at 64
    MiB, or one row cluster a batch) against the one-batch apply, through
    #2, #3 (NP) and #4 on the card: the same bits at R in {1, 8, 64}."""
    from dataclasses import replace

    from repro_torch.core import halton
    from repro_torch.core import hmatrix as H
    n = 1 << 16
    hm = H.build_hmatrix(halton(n, 2, device=cuda_device), "gaussian", k=16, c_leaf=512,
                         precompute=mode == "P", device=cuda_device)
    saved = H.APPLY_BATCH_BYTES
    H.APPLY_BATCH_BYTES = budget
    try:
        hb = replace(hm, groups=H.block_groups(hm.plan, cuda_device, hm.k))
    finally:
        H.APPLY_BATCH_BYTES = saved
    counts = [len(g.parts()) for g in hb.groups.values()]
    assert counts[-1] >= 3 and sum(c >= 3 for c in counts) >= 3, counts
    assert all(g.batches == () for g in hm.groups.values())
    gen = torch.Generator(device="cuda").manual_seed(11)
    for r in (1, 8, 64):
        x = torch.randn(n, r, generator=gen, device=cuda_device)
        one = H.make_apply(hm)(x)
        assert torch.equal(H.make_apply(hb)(x), one), (mode, budget, r)
        assert torch.equal(H.make_apply(hm)(x), one)
