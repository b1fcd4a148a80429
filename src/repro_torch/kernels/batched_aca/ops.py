"""Dispatch of the batched low-rank apply of one ACA level group (§5.4.1)."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import batched_lowrank_matmat_cuda
from .ref import batched_lowrank_matmat_ref


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
