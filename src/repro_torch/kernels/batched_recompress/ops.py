"""Dispatch of the batched recompression (the memory tier and H-LU's
re-truncation).

CPU tensors run the plain version (the QR + SVD oracle), CUDA tensors the
kernel.  One numeric route of the reference stays: below ``GRAM_TOL_FLOOR``
the Gram matrices the kernel forms cannot resolve the threshold in fp32
(they square the condition number), so tolerances below it take the QR +
SVD oracle on any device.  That route is counted apart from the kernel's
launches, in ``_build.ORACLE_CALLS``.
"""
from __future__ import annotations

import torch

from ... import _build
from .. import on_cpu
from .kernel import batched_recompress_cuda
from .ref import batched_recompress_ref

# Below this relative tolerance the Gram formation (fp32) cannot resolve
# the truncation threshold: ~sqrt(eps_f32), as in the reference.
GRAM_TOL_FLOOR = 3e-4


def batched_recompress(u: torch.Tensor, v: torch.Tensor, tol: float):
    """SVD-truncate one level group of low-rank factors to tolerance.

    u: (B, m, k), v: (B, n, k) packed factors; block ``b`` keeps singular
    values ``sigma_i > tol * sigma_0(b)``.  Returns ``(u2, v2, ranks)``:
    factors of the same shapes with columns in descending-sigma order and
    truncated columns exactly zero, and the (B,) int32 surviving ranks.
    """
    if on_cpu("batched_recompress", u, v):
        return batched_recompress_ref(u, v, tol)
    if tol < GRAM_TOL_FLOOR:
        _build.ORACLE_CALLS["batched_recompress"] += 1
        return batched_recompress_ref(u, v, tol)
    u2, v2, _, ranks, _ = batched_recompress_cuda(u, v, tol)
    return u2, v2, ranks
