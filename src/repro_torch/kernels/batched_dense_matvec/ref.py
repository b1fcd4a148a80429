"""Plain PyTorch version of the batched dense kernel-block product.

It computes what the CUDA kernel computes: the direct-difference phi of
``repro_torch.kernels.phi``, then a batched float32 product.
"""
from __future__ import annotations

import torch

from ..phi import phi_matrix


def batched_kernel_matvec_ref(rows: torch.Tensor, cols: torch.Tensor,
                              x: torch.Tensor, kernel_name: str = "gaussian") -> torch.Tensor:
    """rows, cols: (B, C, d); x: (B, C) -> (B, C)."""
    return torch.bmm(phi_matrix(rows, cols, kernel_name), x[:, :, None])[:, :, 0]


def batched_kernel_matmat_ref(rows: torch.Tensor, cols: torch.Tensor,
                              x: torch.Tensor, kernel_name: str = "gaussian") -> torch.Tensor:
    """rows, cols: (B, C, d); x: (B, C, R) -> (B, C, R)."""
    return torch.bmm(phi_matrix(rows, cols, kernel_name), x)
