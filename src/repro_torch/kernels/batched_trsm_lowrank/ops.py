"""Dispatch of the batched panel triangular solve (H-LU's TRSM task)."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import batched_trsm_panels_cuda
from .ref import batched_trsm_panels_ref


def batched_trsm_panels(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched forward substitution ``Y[b] = L[b]^{-1} X[b]``.

    l: (B, c, c) lower-triangular factors, or (1, c, c) for the one ``L_tt``
    of an elimination step; x: (B, c, P) panels: V factors of low-rank tiles
    (P = working rank) or transposed dense tiles (P = c).  CPU tensors run
    the plain version, CUDA tensors the kernel.
    """
    if on_cpu("batched_trsm_panels", l, x):
        return batched_trsm_panels_ref(l, x)
    return batched_trsm_panels_cuda(l, x)
