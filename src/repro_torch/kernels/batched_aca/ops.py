"""Dispatch of the batched ACA and the batched low-rank apply (paper §5.4.1).

No size-based route to the plain version: every level group, the coarse
ones included, goes to the kernel on the card.
"""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import (batched_aca_level_cuda, batched_lowrank_matmat_cuda,
                     batched_lowrank_matmat_level_cuda)
from .ref import (batched_aca_level_ref, batched_lowrank_matmat_level_ref,
                  batched_lowrank_matmat_ref)


def batched_aca_level(points: torch.Tensor, row_ids: torch.Tensor, col_ids: torch.Tensor,
                      level: int, kernel_name: str, k: int):
    """Batched fixed-rank ACA of ONE admissible level group: the device
    build's factors, and in NP mode every apply's.

    points: (n_pad, d) tree-ordered points; row_ids, col_ids: (B,) int64
    cluster ids at ``level`` -> U, V: (B, m, k), m = n_pad >> level, with
    ``phi(cluster rows, cluster cols) ~= U[b] @ V[b].T``.  CPU tensors run
    the plain version (which gathers the clusters); CUDA tensors the kernel,
    which reads them from ``points`` in place.
    """
    if on_cpu("batched_aca_level", points, row_ids, col_ids):
        return batched_aca_level_ref(points, row_ids, col_ids, level, kernel_name, k)
    return batched_aca_level_cuda(points, row_ids, col_ids, level, kernel_name, k)


def batched_lowrank_matmat(u: torch.Tensor, v: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Low-rank apply ``Y[b] = U[b] @ (V[b]^T @ X[b])`` in multi-RHS form.

    u: (B, m, k), v: (B, n, k) factors of one level group; x: (B, n, R)
    panel slices -> (B, m, R).  CPU tensors run the plain version, CUDA
    tensors the kernel.
    """
    if on_cpu("batched_lowrank_matmat", u, v, x):
        return batched_lowrank_matmat_ref(u, v, x)
    return batched_lowrank_matmat_cuda(u, v, x)


def batched_lowrank_matmat_level(u: torch.Tensor, v: torch.Tensor, x_pad: torch.Tensor,
                                 cols: torch.Tensor, group, z_pad: torch.Tensor) -> torch.Tensor:
    """One admissible level group of the apply, in place on ``z_pad``:
    every distinct row cluster of ``group`` gets the sum of its blocks'
    ``U (V^T X)``, blocks in table order (the apply's fixed-order scatter).

    u, v: (B, m, k); x_pad, z_pad: (n_pad, R) tree-ordered panels; cols:
    (B,) column clusters.  CPU tensors run the plain version (gather,
    :func:`batched_lowrank_matmat_ref`, scatter); CUDA tensors the kernel,
    which reads X in place and gives the same bits as the gathered kernel
    followed by the scatter.  Returns ``z_pad``.
    """
    if on_cpu("batched_lowrank_matmat_level", u, v, x_pad, z_pad):
        return batched_lowrank_matmat_level_ref(u, v, x_pad, cols, group, z_pad)
    return batched_lowrank_matmat_level_cuda(u, v, x_pad, cols, group, z_pad)
