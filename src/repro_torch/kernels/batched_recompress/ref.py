"""Plain PyTorch version of the batched recompression: the QR + SVD oracle.

Port of ``repro/kernels/batched_recompress/ref.py``: one QR per factor and
one small SVD per block (Bebendorf §1.1.4),

    A = U V^T = (Qu Ru)(Qv Rv)^T,   M = Ru Rv^T = W S Z^T  (k x k)
    A' = (Qu W S_t)(Qv Z_t)^T

with ``S_t`` the singular values truncated at the relative, per-block
threshold ``sigma_i > tol * sigma_0``.  Columns come in descending-sigma
order and truncated columns are exactly zero.  It is another algorithm than
the kernel's (Gram matrices, Cholesky, one-sided Jacobi), so the two agree
on ranks and within the truncation bound, not entry by entry.
"""
from __future__ import annotations

import torch


def batched_recompress_ref(u: torch.Tensor, v: torch.Tensor, tol: float):
    """Recompress one level group.  u: (B, m, k), v: (B, n, k).

    Returns ``(u2, v2, ranks)``: same shapes with columns ordered by
    descending singular value of ``U V^T``, columns at or beyond each block's
    surviving rank exactly zero, and ``ranks`` the (B,) int32 surviving ranks.
    """
    qu, ru = torch.linalg.qr(u)                     # (B, m, k), (B, k, k)
    qv, rv = torch.linalg.qr(v)
    core = ru @ rv.transpose(-1, -2)                # (B, k, k)
    w, s, zt = torch.linalg.svd(core, full_matrices=False)
    keep = s > tol * s[:, :1]                       # s sorted descending
    s_t = torch.where(keep, s, torch.zeros_like(s))
    u2 = qu @ (w * s_t[:, None, :])                 # Qu W S_t
    v2 = (qv @ zt.transpose(-1, -2)) * keep[:, None, :].to(u.dtype)
    return u2, v2, keep.sum(dim=1).to(torch.int32)
