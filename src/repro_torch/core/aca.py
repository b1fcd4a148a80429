"""Adaptive cross approximation (paper §2.4, Algorithm 2), fixed-rank form.

Port of ``repro.core.aca``.  ``batched_aca``: ``k`` pivoted rank-1 steps per
block, all blocks of one level group at once (the reference's ``vmap``
becomes the leading batch dimension).  Row pivots are the argmax of the
masked residual column, column pivots the argmax of the masked residual
row, the first index winning ties; a pivot of magnitude <= 1e-30 yields
zero columns.  Entries come from the kernel function with the
expansion-form distances, as in the reference.

``aca_fixed_rank`` is the same on one block; ``aca_adaptive`` is
Algorithm 2 with its Frobenius stopping criterion on an explicit matrix, a
float64 host loop for convergence studies and tests.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels import bmm


def _masked_argmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax of |x| over positions where mask (1.0 = available);
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does."""
    return torch.argmax(x.abs() * mask - (1.0 - mask), dim=-1)


def batched_aca(row_pts: torch.Tensor, col_pts: torch.Tensor,
                kernel: Callable, k: int, return_pivots: bool = False):
    """Rank-``k`` cross approximation of B blocks ``kernel(row_pts[b], col_pts[b])``.

    row_pts: (B, m, d), col_pts: (B, n, d) -> U: (B, m, k), V: (B, n, k)
    with ``A[b] ~= U[b] @ V[b].T``.  With ``return_pivots`` also the (B, k)
    int64 row and column pivots: ``(U, V, rows, cols)``, step r of block b
    having crossed row ``rows[b, r]`` and column ``cols[b, r]``.
    """
    bsz, m, _ = row_pts.shape
    n = col_pts.shape[1]
    dev, dtype = row_pts.device, row_pts.dtype
    U = torch.zeros((bsz, m, k), dtype=dtype, device=dev)
    V = torch.zeros((bsz, n, k), dtype=dtype, device=dev)
    row_mask = torch.ones((bsz, m), dtype=dtype, device=dev)
    col_mask = torch.ones((bsz, n), dtype=dtype, device=dev)
    j_r = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    ar = torch.arange(bsz, device=dev)
    piv_rows = torch.zeros((bsz, k), dtype=torch.int64, device=dev)
    piv_cols = torch.zeros((bsz, k), dtype=torch.int64, device=dev)
    for r in range(k):
        # residual column j_r:  A[:, j_r] - U @ V[j_r]
        a_col = kernel(row_pts, col_pts[ar, j_r][:, None, :])[:, :, 0]
        u_hat = a_col - bmm(U, V[ar, j_r][:, :, None])[:, :, 0]
        i_r = _masked_argmax(u_hat, row_mask)
        alpha = u_hat[ar, i_r]
        safe = alpha.abs() > 1e-30
        inv = torch.where(safe, 1.0 / torch.where(safe, alpha, torch.ones_like(alpha)),
                          torch.zeros_like(alpha))
        u_r = u_hat * inv[:, None]
        # residual row i_r:  A[i_r, :] - V @ U[i_r]
        a_row = kernel(row_pts[ar, i_r][:, None, :], col_pts)[:, 0, :]
        v_r = a_row - bmm(V, U[ar, i_r][:, :, None])[:, :, 0]
        v_r = torch.where(safe[:, None], v_r, torch.zeros_like(v_r))
        u_r = torch.where(safe[:, None], u_r, torch.zeros_like(u_r))
        U[:, :, r] = u_r
        V[:, :, r] = v_r
        row_mask[ar, i_r] = 0.0
        col_mask[ar, j_r] = 0.0
        piv_rows[:, r] = i_r
        piv_cols[:, r] = j_r
        j_r = _masked_argmax(v_r, col_mask)
    return (U, V, piv_rows, piv_cols) if return_pivots else (U, V)


def aca_fixed_rank(row_pts: torch.Tensor, col_pts: torch.Tensor, kernel: Callable, k: int):
    """Rank-``k`` cross approximation of ``A[i, j] = kernel(row_pts[i], col_pts[j])``.

    row_pts: (m, d), col_pts: (n, d) -> U: (m, k), V: (n, k) with
    ``A ~= U @ V.T``.  Degenerate pivots (the block has rank < k) yield zero
    columns, so ``U V^T`` stays exact then.
    """
    u, v = batched_aca(row_pts[None], col_pts[None], kernel, k)
    return u[0], v[0]


def aca_adaptive(a, eps: float, k_max: int, eta: float = 0.0):
    """Algorithm 2 verbatim, with its stopping criterion, on an explicit matrix.

    A float64 host loop (reference and benchmark use).  Stops when the new
    rank-1 term is small against the approximation so far (``eps``,
    ``eta``), when a pivot vanishes, or when every row or column pivot is
    consumed, so the rank never exceeds ``min(m, n)``.  Returns ``(U, V,
    rank)``: float64 CPU tensors of shape (m, rank) and (n, rank).
    """
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float64)
    m, n = a.shape
    U = np.zeros((m, k_max))
    V = np.zeros((n, k_max))
    row_mask = np.ones(m, bool)
    col_mask = np.ones(n, bool)
    j_r = 0
    frob_sq = 0.0
    rank = k_max
    for r in range(k_max):
        u_hat = a[:, j_r] - U[:, :r] @ V[j_r, :r]
        i_r = int(np.argmax(np.where(row_mask, np.abs(u_hat), -1.0)))
        alpha = u_hat[i_r]
        if abs(alpha) < 1e-300:
            rank = r
            break
        u_r = u_hat / alpha
        v_r = a[i_r, :] - V[:, :r] @ U[i_r, :r]
        U[:, r] = u_r
        V[:, r] = v_r
        row_mask[i_r] = False
        col_mask[j_r] = False
        # ||sum_l u_l v_l^T||_F^2, updated (the criterion's right-hand side)
        frob_sq += (u_r @ u_r) * (v_r @ v_r)
        for l in range(r):
            frob_sq += 2.0 * (U[:, l] @ u_r) * (V[:, l] @ v_r)
        nu, nv = np.linalg.norm(u_r), np.linalg.norm(v_r)
        if nu * nv <= eps * (1.0 - eta) / (1.0 + eps) * np.sqrt(max(frob_sq, 0.0)):
            rank = r + 1
            break
        if not (row_mask.any() and col_mask.any()):
            # every row or column pivot is consumed: the cross is complete; a
            # stale j_r would cross a consumed column whose residual is noise
            rank = r + 1
            break
        j_r = int(np.argmax(np.where(col_mask, np.abs(v_r), -1.0)))
    return torch.from_numpy(U[:, :rank].copy()), torch.from_numpy(V[:, :rank].copy()), rank
