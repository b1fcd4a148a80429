"""Plain PyTorch version of the batched panel triangular solve.

The reference's algorithm (``repro/kernels/batched_trsm_lowrank/kernel.py``):
c forward-substitution axpy steps, each dividing by the diagonal clamped at
1e-30.  Plain tensor operations only; ``torch.linalg.solve_triangular`` is
the library yardstick, not part of the port.
"""
from __future__ import annotations

import torch

TINY = 1e-30


def batched_trsm_panels_ref(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Y[b] = L[b]^{-1} X[b]``.  l: (B, c, c) lower triangular, or (1, c, c)
    for one L shared by the batch; x: (B, c, P) -> (B, c, P)."""
    c = l.shape[1]
    xr = x.clone()
    for j in range(c):
        d = l[:, j, j]
        d = torch.where(d.abs() > TINY, d, torch.full_like(d, TINY))
        yj = xr[:, j, :] / d[:, None]
        xr[:, j, :] = yj
        if j + 1 < c:
            xr[:, j + 1:, :] -= l[:, j + 1:, j, None] * yj[:, None, :]
    return xr
