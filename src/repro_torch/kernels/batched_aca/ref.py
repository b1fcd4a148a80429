"""Plain PyTorch versions of the batched ACA and the low-rank product U (V^T X).

The ACA's plain version is ``repro_torch.core.aca`` run on the entries the
CUDA kernel computes: the direct-difference phi of ``repro_torch.kernels.phi``
(``repro/kernels/_phi.py``), not the expansion form of ``core.geometry``.
"""
from __future__ import annotations

from functools import partial

import torch

from ...core.aca import batched_aca
from .. import bmm
from ..phi import phi_matrix


def batched_aca_ref(rows: torch.Tensor, cols: torch.Tensor, kernel_name: str, k: int):
    """rows: (B, m, d), cols: (B, n, d) -> U (B, m, k), V (B, n, k)."""
    return batched_aca(rows, cols, partial(phi_matrix, kernel_name=kernel_name), k)


def batched_aca_level_ref(points: torch.Tensor, row_ids: torch.Tensor, col_ids: torch.Tensor,
                          level: int, kernel_name: str, k: int):
    """Gather one level group's cluster points from the tree-ordered
    ``points`` (n_pad, d), then :func:`batched_aca_ref`."""
    m = points.shape[0] >> level
    pts = points.reshape(1 << level, m, -1)
    return batched_aca_ref(pts[row_ids], pts[col_ids], kernel_name, k)


def batched_lowrank_matmat_ref(u: torch.Tensor, v: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """u: (B, m, k), v: (B, n, k), x: (B, n, R) -> U (V^T X): (B, m, R)."""
    return bmm(u, bmm(v.transpose(1, 2), x))


def batched_lowrank_matmat_level_ref(u: torch.Tensor, v: torch.Tensor, x_pad: torch.Tensor,
                                     cols: torch.Tensor, group,
                                     z_pad: torch.Tensor) -> torch.Tensor:
    """Gather the level group's X slices from ``x_pad`` (n_pad, R),
    :func:`batched_lowrank_matmat_ref`, then the apply's fixed-order scatter
    into ``z_pad`` (``core.hmatrix._scatter_rows``, in place).  Returns ``z_pad``."""
    from ...core.hmatrix import _scatter_rows
    m, r = u.shape[1], x_pad.shape[1]
    x_blk = x_pad.reshape(-1, m, r)[cols]
    return _scatter_rows(z_pad, batched_lowrank_matmat_ref(u, v, x_blk), group)
