"""Dispatch of the batched dense kernel-block product (paper §5.4.2)."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import (batched_kernel_matmat_cuda, batched_kernel_matmat_level_cuda,
                     batched_kernel_matvec_cuda, batched_kernel_matvec_level_cuda)
from .ref import (batched_kernel_matmat_level_ref, batched_kernel_matmat_ref,
                  batched_kernel_matvec_level_ref, batched_kernel_matvec_ref)


def batched_kernel_matvec(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                          kernel_name: str = "gaussian") -> torch.Tensor:
    """On-the-fly dense leaf product of one vector ``y[b] = phi(rows[b], cols[b]) @ x[b]``.

    rows, cols: (B, C, d) row / column cluster points per leaf block;
    x: (B, C) operand slices -> (B, C).  CPU tensors run the plain version,
    CUDA tensors the kernel.
    """
    if on_cpu("batched_kernel_matvec", rows, cols, x):
        return batched_kernel_matvec_ref(rows, cols, x, kernel_name)
    return batched_kernel_matvec_cuda(rows, cols, x, kernel_name)


def batched_kernel_matmat(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                          kernel_name: str = "gaussian") -> torch.Tensor:
    """Multi-RHS on-the-fly dense leaf product ``Y[b] = phi(rows[b], cols[b]) @ X[b]``.

    rows, cols: (B, C, d) row / column cluster points per leaf block;
    x: (B, C, R) panel slices -> (B, C, R).  CPU tensors run the plain
    version, CUDA tensors the kernel.
    """
    if on_cpu("batched_kernel_matmat", rows, cols, x):
        return batched_kernel_matmat_ref(rows, cols, x, kernel_name)
    return batched_kernel_matmat_cuda(rows, cols, x, kernel_name)


def batched_kernel_matmat_level(points: torch.Tensor, row_ids: torch.Tensor,
                                col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                kernel_name: str = "gaussian") -> torch.Tensor:
    """The dense leaves of an apply, read in place: ``Y[b] = phi(leaf
    row_ids[b], leaf col_ids[b]) @ x_pad[leaf col_ids[b]]``.

    points: (n_pad, d) tree-ordered points; row_ids, col_ids: (B,) int64
    leaf ids; x_pad: (n_pad, R) tree-ordered padded panel -> (B, c_leaf, R).
    CPU tensors run the plain version (which gathers the leaves), CUDA
    tensors the kernel, which reads them in place.
    """
    if on_cpu("batched_kernel_matmat_level", points, row_ids, col_ids, x_pad):
        return batched_kernel_matmat_level_ref(points, row_ids, col_ids, x_pad, c_leaf,
                                               kernel_name)
    return batched_kernel_matmat_level_cuda(points, row_ids, col_ids, x_pad, c_leaf, kernel_name)


def batched_kernel_matvec_level(points: torch.Tensor, row_ids: torch.Tensor,
                                col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                kernel_name: str = "gaussian") -> torch.Tensor:
    """The vector form of :func:`batched_kernel_matmat_level`: x_pad
    (n_pad,) -> (B, c_leaf)."""
    if on_cpu("batched_kernel_matvec_level", points, row_ids, col_ids, x_pad):
        return batched_kernel_matvec_level_ref(points, row_ids, col_ids, x_pad, c_leaf,
                                               kernel_name)
    return batched_kernel_matvec_level_cuda(points, row_ids, col_ids, x_pad, c_leaf, kernel_name)
