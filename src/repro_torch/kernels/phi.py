"""Plain PyTorch form of the maths the kernels compute (``csrc/phi.cuh``).

Port of ``repro.kernels._phi``.  Squared distances are summed as DIRECT
differences, dimension by dimension, which is what every CUDA kernel of
this package does; ``repro_torch.core.geometry`` keeps the expansion form of
the reference's plain path.  The two forms must not be mixed up.
"""
from __future__ import annotations

import torch

from ..core.geometry import bessel_k1, matern_norm

KERNEL_IDS = {"gaussian": 0, "matern": 1}


def pairwise_sqdist(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """rows: (..., m, d), cols: (..., n, d) -> (..., m, n) squared distances."""
    acc = None
    for dim in range(rows.shape[-1]):
        diff = rows[..., :, dim, None] - cols[..., None, :, dim]
        term = diff * diff
        acc = term if acc is None else acc + term
    return acc


def phi_from_sqdist(d2: torch.Tensor, kernel_name: str, point_dim: int) -> torch.Tensor:
    """Apply the named kernel to squared distances, elementwise."""
    if kernel_name == "gaussian":
        return torch.exp(-d2)
    if kernel_name == "matern":
        r = torch.sqrt(torch.clamp(d2, min=0.0))
        val = torch.where(r > 1e-8, r * bessel_k1(torch.clamp(r, min=1e-30)),
                          torch.ones_like(r))
        return val / matern_norm(point_dim)
    raise ValueError(f"unknown kernel {kernel_name!r}")


def phi_matrix(rows: torch.Tensor, cols: torch.Tensor, kernel_name: str) -> torch.Tensor:
    """rows: (..., m, d), cols: (..., n, d) -> (..., m, n) kernel entries, as
    the CUDA kernels compute them."""
    return phi_from_sqdist(pairwise_sqdist(rows, cols), kernel_name, rows.shape[-1])


def kernel_id(kernel_name: str) -> int:
    """Integer id of a kernel function as ``phi.cuh`` numbers them."""
    if kernel_name not in KERNEL_IDS:
        raise ValueError(f"unknown kernel {kernel_name!r}")
    return KERNEL_IDS[kernel_name]
