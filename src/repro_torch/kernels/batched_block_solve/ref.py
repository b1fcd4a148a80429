"""Plain PyTorch versions of the batched block Cholesky factorise / solve.

The factorisation is right-looking by panels of ``NB`` columns: each
diagonal tile by rank-1 steps with the reference's pivot rule
``dinv = rsqrt(max(d, 1e-30))``, ``L[:, j] = residual[:, j] * dinv``, the
rows below it by substitution with the same rule, then the rank-``NB``
trailing update.  That is the blocking of the CUDA kernel's shared-memory
route (c <= 288); its wide route (steps of 128 columns, each panel by four
32-column substitutions, a two-level trailing update) computes the same
function with other sums.  The solve follows the CUDA kernel's tiles of
``NB``, with the reference's division by the diagonal in both
substitutions.  Both use plain tensor operations only; the library
factorisations are yardsticks, not parts of the port.
"""
from __future__ import annotations

import torch

NB = 32      # panel width / row tile, as in the kernels
TINY = 1e-30


def batched_block_cholesky_ref(a: torch.Tensor) -> torch.Tensor:
    """a: (B, c, c) SPD -> lower Cholesky factors (B, c, c), zeros above."""
    b, c, _ = a.shape
    w = a.clone()
    lmat = torch.zeros_like(a)
    for j0 in range(0, c, NB):
        j1 = min(c, j0 + NB)
        nb = j1 - j0
        t = w[:, j0:j1, j0:j1].clone()
        dinv = torch.empty((b, nb), dtype=a.dtype, device=a.device)
        for j in range(nb):
            dj = torch.rsqrt(torch.clamp(t[:, j, j], min=TINY))
            dinv[:, j] = dj
            t[:, j:, j] *= dj[:, None]
            t[:, j + 1:, j + 1:] -= t[:, j + 1:, j, None] * t[:, None, j + 1:, j]
        lmat[:, j0:j1, j0:j1] = torch.tril(t)
        if j1 == c:
            break
        p = w[:, j1:, j0:j1].clone()
        for jj in range(nb):
            s = p[:, :, jj] - torch.bmm(p[:, :, :jj], t[:, jj, :jj, None])[:, :, 0]
            p[:, :, jj] = s * dinv[:, jj, None]
        lmat[:, j1:, j0:j1] = p
        w[:, j1:, j1:] -= torch.bmm(p, p.transpose(1, 2))
    return lmat


def batched_block_cholesky_solve_ref(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} X per block.  l: (B, c, c) lower, x: (B, c, R)."""
    c = l.shape[1]
    xr = x.clone()
    for j0 in range(0, c, NB):                                # L Y1 = X
        j1 = min(c, j0 + NB)
        for j in range(j0, j1):
            yj = xr[:, j, :] / l[:, j, j, None]
            xr[:, j, :] = yj
            xr[:, j + 1:j1, :] -= l[:, j + 1:j1, j, None] * yj[:, None, :]
        if j1 < c:
            xr[:, j1:, :] -= torch.bmm(l[:, j1:, j0:j1], xr[:, j0:j1, :])
    for j0 in reversed(range(0, c, NB)):                      # L^T Y = Y1
        j1 = min(c, j0 + NB)
        for i in range(j1 - 1, j0 - 1, -1):
            zi = xr[:, i, :] / l[:, i, i, None]
            xr[:, i, :] = zi
            xr[:, j0:i, :] -= l[:, i, j0:i, None] * zi[:, None, :]
        if j0 > 0:
            xr[:, :j0, :] -= torch.bmm(l[:, j0:j1, :j0].transpose(1, 2), xr[:, j0:j1, :])
    return xr
