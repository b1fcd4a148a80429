"""Dispatch of the H-attention near field.

CPU tensors run the plain version, CUDA tensors the kernel
``csrc/hattention_nearfield.cu``.  ``repro``'s route to its reference above
an 8 MiB VMEM budget is not carried over: the CUDA kernel tiles the leaf
blocks through shared memory at every leaf size (``kernels/__init__.py``).
"""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import hattention_nearfield_cuda
from .ref import hattention_nearfield_ref


def hattention_nearfield_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Blocked near-field leaf attention: each leaf block attends to itself
    (causal) and to its predecessor (in full), the inadmissible band of the
    attention matrix.

    q, k, v: (BH, n_leaf, c, D) float32, q pre-scaled by ``1/sqrt(D)``.
    Returns ``num`` (BH, n_leaf, c, D), the unnormalised numerator; ``den``
    (BH, n_leaf, c), the softmax denominator; ``m`` (BH, n_leaf, c), the row
    max over both blocks (the stabiliser of the merge with the far field).
    """
    if on_cpu("hattention_nearfield", q, k, v):
        return hattention_nearfield_ref(q, k, v)
    return hattention_nearfield_cuda(q, k, v)
