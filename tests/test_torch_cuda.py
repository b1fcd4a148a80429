"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device, and import
nothing of JAX or ``repro`` so that they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 relative (Frobenius) for the two
products, 1e-4 for the Cholesky pair with ``|L L^T - A| / |A| <= 1e-5``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.batched_aca.ops import batched_lowrank_matmat
from repro_torch.kernels.batched_aca.ref import batched_lowrank_matmat_ref
from repro_torch.kernels.batched_block_solve.ops import (batched_block_cholesky,
                                                         batched_block_cholesky_solve)
from repro_torch.kernels.batched_block_solve.ref import (batched_block_cholesky_ref,
                                                         batched_block_cholesky_solve_ref)
from repro_torch.kernels.batched_dense_matvec.ops import batched_kernel_matmat
from repro_torch.kernels.batched_dense_matvec.ref import batched_kernel_matmat_ref


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
    from repro_torch import _build
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
    with pytest.raises(NotImplementedError):
        make_apply(build_hmatrix(pts, "gaussian", k=8, c_leaf=128))
