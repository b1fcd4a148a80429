"""Dispatch of the batched Schur updates of H-LU.

CPU tensors run the plain versions, CUDA tensors the kernels.  The low-rank
re-truncation is ``batched_recompress`` at the widened width, so it keeps
that dispatch's routes (the Gram floor included).
"""
from __future__ import annotations

import torch

from .. import on_cpu
from ..batched_recompress.ops import batched_recompress
from .kernel import batched_schur_dense_cuda
from .ref import batched_schur_dense_ref


def batched_schur_dense(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense-target Schur update ``Y[b] = C[b] - A[b] B[b]^T``.

    c: (B, m, n) gathered target tiles; a: (B, m, p), b: (B, n, p) update
    factors (p = c for dense x dense products, the working rank for
    low-rank products hitting a dense target) -> (B, m, n).
    """
    if on_cpu("batched_schur_dense", c, a, b):
        return batched_schur_dense_ref(c, a, b)
    return batched_schur_dense_cuda(c, a, b)


def batched_schur_retruncate(u: torch.Tensor, v: torch.Tensor, tol: float, kp: int):
    """Low-rank-target Schur update: truncate the widened panels
    u: (B, m, w), v: (B, n, w) (target and update concatenated) to tolerance
    and re-pack them to width ``kp``, dominant columns first -> (B, m, kp),
    (B, n, kp) with columns past each block's surviving rank exactly zero.
    """
    u2, v2, _ = batched_recompress(u, v, tol)
    return u2[:, :, :kp], v2[:, :, :kp]
