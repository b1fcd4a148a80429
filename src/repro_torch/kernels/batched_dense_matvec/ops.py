"""Dispatch of the batched dense kernel-block product (paper §5.4.2)."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import batched_kernel_matmat_cuda, batched_kernel_matvec_cuda
from .ref import batched_kernel_matmat_ref, batched_kernel_matvec_ref


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
