"""Port parity of the kernel packages.

On the CPU: each plain PyTorch version (``ref.py``, what the CUDA kernel
computes) against the reference's Pallas kernel run in interpret mode, on
the same seeded inputs.  Tolerances rtol 1e-5 / atol 1e-5 (float32, other
summation orders) for the products and the dense Schur update, 1e-4 for
the Cholesky pair as ``tests/test_solve.py`` holds the Pallas kernels to
their own oracles, and for the panel triangular solve (c sequential
substitution steps, as the card tests and ``chip_smoke.py`` hold it).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_aca.kernel import batched_lowrank_matmat_t
from repro.kernels.batched_block_solve.kernel import (batched_block_cholesky_solve_t,
                                                      batched_block_cholesky_t)
from repro.kernels.batched_dense_matvec.kernel import batched_kernel_matmat_t
from repro.kernels.batched_schur_update.kernel import batched_schur_dense_t
from repro.kernels.batched_trsm_lowrank.kernel import batched_trsm_panels_t
from repro_torch.kernels.batched_aca.ops import batched_lowrank_matmat
from repro_torch.kernels.batched_block_solve.ops import (batched_block_cholesky,
                                                         batched_block_cholesky_solve)
from repro_torch.kernels.batched_block_solve.ref import (batched_block_cholesky_ref,
                                                         batched_block_cholesky_solve_ref)
from repro_torch.kernels.batched_dense_matvec.ops import batched_kernel_matmat
from repro_torch.kernels.batched_schur_update.ops import batched_schur_dense
from repro_torch.kernels.batched_trsm_lowrank.ops import batched_trsm_panels


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(rng, b, c):
    q = rng.randn(b, c, c).astype(np.float32)
    return (q @ np.swapaxes(q, 1, 2) + c * np.eye(c, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d,r", [(2, 1), (2, 8), (3, 4)])
def test_dense_matmat_plain_matches_pallas(kernel, d, r):
    rng = _rs(10 + d + r)
    rows = (rng.rand(3, 64, d) * 2).astype(np.float32)
    cols = (rng.rand(3, 64, d) * 2).astype(np.float32)
    x = rng.randn(3, 64, r).astype(np.float32)
    want = np.asarray(batched_kernel_matmat_t(
        jnp.asarray(np.swapaxes(rows, 1, 2)), jnp.asarray(np.swapaxes(cols, 1, 2)),
        jnp.asarray(x), kernel, interpret=True))
    got = batched_kernel_matmat(torch.from_numpy(rows), torch.from_numpy(cols),
                                torch.from_numpy(x), kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [1, 8])
def test_lowrank_matmat_plain_matches_pallas(r):
    rng = _rs(20 + r)
    u = rng.randn(3, 128, 16).astype(np.float32)
    v = rng.randn(3, 128, 16).astype(np.float32) * 0.1
    x = rng.randn(3, 128, r).astype(np.float32)
    want = np.asarray(batched_lowrank_matmat_t(jnp.asarray(u), jnp.asarray(v),
                                               jnp.asarray(x), interpret=True))
    got = batched_lowrank_matmat(torch.from_numpy(u), torch.from_numpy(v),
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,c", [(2, 64), (1, 80)])
def test_block_cholesky_plain_matches_pallas(b, c):
    a = _spd(_rs(30 + c), b, c)
    want = np.asarray(batched_block_cholesky_t(jnp.asarray(a), interpret=True))
    got = batched_block_cholesky(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (np.triu(got, k=1) == 0).all()


@pytest.mark.parametrize("b,c,r", [(2, 64, 1), (1, 80, 8)])
def test_block_cholesky_solve_plain_matches_pallas(b, c, r):
    rng = _rs(40 + c + r)
    l_mat = np.linalg.cholesky(_spd(rng, b, c).astype(np.float64)).astype(np.float32)
    x = rng.randn(b, c, r).astype(np.float32)
    want = np.asarray(batched_block_cholesky_solve_t(jnp.asarray(l_mat), jnp.asarray(x),
                                                     interpret=True))
    got = batched_block_cholesky_solve(torch.from_numpy(l_mat), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_block_cholesky_plain_pivot_clamp_and_identity():
    """Identity blocks factor to themselves; a zero pivot is clamped at
    1e-30 (rsqrt stays finite) as in the reference kernel."""
    eye = torch.eye(40).expand(2, 40, 40).contiguous()
    torch.testing.assert_close(batched_block_cholesky_ref(eye), eye)
    a = torch.zeros(1, 4, 4)
    assert bool(torch.isfinite(batched_block_cholesky_ref(a)).all())
    x = torch.randn(2, 40, 3, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(batched_block_cholesky_solve_ref(eye, x), x)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,c,p", [(2, 64, 5), (3, 64, 32)])
def test_trsm_panels_plain_matches_pallas(b, c, p, shared):
    """#9's plain version against ``batched_trsm_panels_t``; a shared L is
    one (1, c, c) factor here and broadcast to B for the Pallas kernel,
    whose BlockSpec indexes L by batch."""
    rng = _rs(50 + c + p)
    l_mat = np.linalg.cholesky(_spd(rng, 1 if shared else b, c).astype(np.float64))
    l_mat = l_mat.astype(np.float32)
    x = rng.randn(b, c, p).astype(np.float32)
    want = np.asarray(batched_trsm_panels_t(
        jnp.asarray(np.broadcast_to(l_mat, (b, c, c))), jnp.asarray(x), interpret=True))
    got = batched_trsm_panels(torch.from_numpy(l_mat), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,m,n,p", [(2, 64, 48, 16), (1, 80, 80, 80)])
def test_schur_dense_plain_matches_pallas(b, m, n, p):
    rng = _rs(60 + m + n + p)
    c = rng.randn(b, m, n).astype(np.float32)
    a = rng.randn(b, m, p).astype(np.float32)
    bb = rng.randn(b, n, p).astype(np.float32)
    want = np.asarray(batched_schur_dense_t(jnp.asarray(c), jnp.asarray(a), jnp.asarray(bb),
                                            interpret=True))
    got = batched_schur_dense(torch.from_numpy(c), torch.from_numpy(a),
                              torch.from_numpy(bb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
