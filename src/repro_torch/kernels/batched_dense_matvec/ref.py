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


def _leaf_points(points: torch.Tensor, ids: torch.Tensor, c_leaf: int) -> torch.Tensor:
    return points.reshape(points.shape[0] // c_leaf, c_leaf, -1)[ids]


def batched_kernel_matmat_level_ref(points: torch.Tensor, row_ids: torch.Tensor,
                                    col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                    kernel_name: str = "gaussian") -> torch.Tensor:
    """Gather the leaves' points and panel slices from the tree-ordered
    ``points`` (n_pad, d) and ``x_pad`` (n_pad, R), then
    :func:`batched_kernel_matmat_ref` -> (B, c_leaf, R)."""
    x_blk = x_pad.reshape(x_pad.shape[0] // c_leaf, c_leaf, -1)[col_ids]
    return batched_kernel_matmat_ref(_leaf_points(points, row_ids, c_leaf),
                                     _leaf_points(points, col_ids, c_leaf), x_blk, kernel_name)


def batched_kernel_matvec_level_ref(points: torch.Tensor, row_ids: torch.Tensor,
                                    col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                    kernel_name: str = "gaussian") -> torch.Tensor:
    """The vector form: x_pad (n_pad,) -> (B, c_leaf)."""
    x_blk = x_pad.reshape(-1, c_leaf)[col_ids]
    return batched_kernel_matvec_ref(_leaf_points(points, row_ids, c_leaf),
                                     _leaf_points(points, col_ids, c_leaf), x_blk, kernel_name)
