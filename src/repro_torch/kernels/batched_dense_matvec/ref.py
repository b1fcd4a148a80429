"""Plain PyTorch version of the batched dense kernel-block product.

It computes what the CUDA kernel computes: the direct-difference phi of
``repro_torch.kernels.phi``, then a batched float32 product.
"""
from __future__ import annotations

import torch

from ..phi import pairwise_sqdist, phi_from_sqdist


def batched_kernel_matmat_ref(rows: torch.Tensor, cols: torch.Tensor,
                              x: torch.Tensor, kernel_name: str = "gaussian") -> torch.Tensor:
    """rows, cols: (B, C, d); x: (B, C, R) -> (B, C, R)."""
    a = phi_from_sqdist(pairwise_sqdist(rows, cols), kernel_name, rows.shape[-1])
    return torch.bmm(a, x)
