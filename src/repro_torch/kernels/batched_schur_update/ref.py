"""Plain PyTorch versions of the batched Schur updates.

``batched_schur_dense_ref`` applies ``C - A B^T`` to dense targets;
``batched_schur_retruncate_ref`` re-truncates a low-rank target widened by
concatenation (``[u | -a]``, ``[v | b]``) back to the working width with the
QR + SVD oracle of ``batched_recompress``.
"""
from __future__ import annotations

import torch

from ..batched_recompress.ref import batched_recompress_ref


def batched_schur_dense_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[b] - A[b] B[b]^T``.  c: (B, m, n), a: (B, m, p), b: (B, n, p)."""
    return c - torch.einsum("bip,bjp->bij", a, b)


def batched_schur_retruncate_ref(u: torch.Tensor, v: torch.Tensor, tol: float, kp: int):
    """Truncate concatenated panels u: (B, m, w), v: (B, n, w) back to width
    ``kp``: columns in descending-sigma order, past each block's surviving
    rank exactly zero."""
    u2, v2, _ = batched_recompress_ref(u, v, tol)
    return u2[:, :, :kp], v2[:, :, :kp]
