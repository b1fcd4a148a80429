"""Dispatch of the batched block Cholesky factorise / solve (block Jacobi)."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import batched_block_cholesky_cuda, batched_block_cholesky_solve_cuda
from .ref import batched_block_cholesky_ref, batched_block_cholesky_solve_ref


def batched_block_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors ``L[b]`` of SPD blocks ``a: (B, c, c)`` (the
    shifted diagonal leaf blocks ``A_ii + sigma^2 I``).  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if on_cpu("batched_block_cholesky", a):
        return batched_block_cholesky_ref(a)
    return batched_block_cholesky_cuda(a)


def batched_block_cholesky_solve(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi apply ``Y[b] = (L[b] L[b]^T)^{-1} X[b]``; l: (B, c, c),
    x: (B, c, R) -> (B, c, R).  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if on_cpu("batched_block_cholesky_solve", l, x):
        return batched_block_cholesky_solve_ref(l, x)
    return batched_block_cholesky_solve_cuda(l, x)
