"""Port parity: the single-block ACA, Algorithm 2 with its stopping
criterion, and the bridge from adaptive ranks to the padded store.

``repro_torch.core.aca_fixed_rank`` against ``repro.core.aca_fixed_rank``
(``U V^T`` within 1e-5, as ``tests/test_aca.py`` holds batched against
single), ``aca_adaptive`` against ``repro``'s on the matrices of
``tests/test_aca.py:63`` and ``:79`` (the same rank, the reference's
reconstruction bounds), and ``pad_adaptive`` on the case of
``tests/test_factor_store.py:168-170`` (the rank table lands on the clamped
ranks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aca import aca_adaptive as j_aca_adaptive
from repro.core.aca import aca_fixed_rank as j_aca_fixed_rank
from repro.core.factor_store import pad_adaptive as j_pad_adaptive
from repro.core.geometry import gaussian_kernel as j_gaussian_kernel
from repro.core.geometry import get_kernel as j_get_kernel
from repro_torch.core import (FactorStore, aca_adaptive, aca_fixed_rank, batched_aca,
                              effective_ranks, gaussian_kernel, get_kernel, pad_adaptive)


def _sep_points(rng, m, n, d, gap=2.0):
    rows = rng.rand(m, d).astype(np.float32)
    cols = rng.rand(n, d).astype(np.float32) + gap
    return rows, cols


def _rel(a, approx):
    return float(np.linalg.norm(a - approx) / np.linalg.norm(a))


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("k", [1, 4, 12])
def test_aca_fixed_rank_matches_reference(kernel, k):
    rows, cols = _sep_points(np.random.RandomState(3 + k), 64, 48, 2)
    j_u, j_v = j_aca_fixed_rank(jnp.asarray(rows), jnp.asarray(cols), j_get_kernel(kernel), k)
    u, v = aca_fixed_rank(torch.from_numpy(rows), torch.from_numpy(cols), get_kernel(kernel), k)
    assert u.shape == (64, k) and v.shape == (48, k)
    np.testing.assert_allclose((u @ v.T).numpy(), np.asarray(j_u @ j_v.T), atol=1e-5)


def test_aca_fixed_rank_is_one_block_of_the_batch():
    rng = np.random.RandomState(5)
    rows = torch.from_numpy(rng.rand(3, 40, 2).astype(np.float32))
    cols = torch.from_numpy(rng.rand(3, 40, 2).astype(np.float32) + 2.0)
    ub, vb = batched_aca(rows, cols, gaussian_kernel, 6)
    for b in range(3):
        u, v = aca_fixed_rank(rows[b], cols[b], gaussian_kernel, 6)
        torch.testing.assert_close(u @ v.T, ub[b] @ vb[b].T, rtol=0, atol=1e-5)


def test_aca_fixed_rank_zero_block_gives_zeros():
    """All-zero block: zero factors, not NaN (``tests/test_aca.py``)."""
    rows = cols = torch.zeros((16, 2))
    u, v = aca_fixed_rank(rows, cols, lambda y, yp: torch.zeros(y.shape[:-1] + yp.shape[-2:-1]),
                          4)
    assert bool(torch.isfinite(u).all()) and bool((u == 0).all()) and bool((v == 0).all())


def test_adaptive_aca_stopping_matches_reference():
    """``tests/test_aca.py:63``: converged before the cap, error < 1e-5."""
    rows, cols = _sep_points(np.random.RandomState(11), 60, 60, 2)
    a = np.array(j_gaussian_kernel(jnp.asarray(rows), jnp.asarray(cols)))
    j_u, j_v, j_rank = j_aca_adaptive(a, eps=1e-6, k_max=40)
    u, v, rank = aca_adaptive(torch.from_numpy(a), eps=1e-6, k_max=40)
    assert rank == j_rank and rank < 40
    assert u.dtype == torch.float64 and u.shape == (60, rank) and v.shape == (60, rank)
    assert _rel(a, (u @ v.T).numpy()) < 1e-5
    assert _rel(a, j_u @ j_v.T) < 1e-5
    np.testing.assert_allclose(u.numpy(), j_u, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), j_v, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n", [(6, 6), (4, 8), (8, 4)])
def test_adaptive_aca_rank_clamped_matches_reference(m, n):
    """``tests/test_aca.py:79``: k_max beyond min(m, n) stops once every
    pivot is consumed; the full cross reproduces the block."""
    a = np.random.RandomState(7).randn(m, n)
    j_u, j_v, j_rank = j_aca_adaptive(a, eps=0.0, k_max=2 * max(m, n))
    u, v, rank = aca_adaptive(a, eps=0.0, k_max=2 * max(m, n))
    assert rank == j_rank and rank <= min(m, n)
    assert u.shape == (m, rank) and v.shape == (n, rank)
    assert _rel(a, (u @ v.T).numpy()) < 1e-10
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())


def test_rank_table_agrees_below_pad_width():
    """``tests/test_factor_store.py:168-170``: adaptive ranks below the pad
    width, padded by ``pad_adaptive``, are the table ``effective_ranks``
    measures, and ``repro``'s ``pad_adaptive`` pads the same way."""
    rng = np.random.RandomState(13)
    k_pad, true_rank = 12, 3
    mats = rng.randn(40, 36, true_rank) @ rng.randn(40, true_rank, 36)
    pu, pv, clamped = [], [], []
    for a in mats:
        u, v, rank = aca_adaptive(a, eps=1e-8, k_max=k_pad)
        j_u, j_v, j_rank = j_aca_adaptive(a, eps=1e-8, k_max=k_pad)
        assert rank == j_rank and rank < k_pad
        up, vp = pad_adaptive(u, v, rank, k_pad)
        j_up, j_vp = j_pad_adaptive(j_u, j_v, j_rank, k_pad)
        np.testing.assert_allclose(up.numpy(), j_up, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(vp.numpy(), j_vp, rtol=1e-12, atol=1e-12)
        pu.append(up.float())
        pv.append(vp.float())
        clamped.append(rank)
    U, V = torch.stack(pu), torch.stack(pv)
    clamped = np.asarray(clamped, np.int32)
    np.testing.assert_array_equal(effective_ranks(U, V).numpy(), clamped)
    store = FactorStore.from_factors({2: (U, V)}, ranks={2: clamped})
    np.testing.assert_array_equal(store.rank_table(2).numpy(), clamped)
    with pytest.raises(ValueError, match="claimed rank"):
        FactorStore.from_factors({2: (U, V)}, ranks={2: np.maximum(clamped - 1, 0)})
    with pytest.raises(ValueError, match="exceeds pad width"):
        pad_adaptive(U[0], V[0], k_pad + 1, k_pad)
