"""Dispatch of the H-attention near field and of its backward.

CPU tensors run the plain versions, CUDA tensors the kernels
``csrc/hattention_nearfield.cu`` (#11) and ``csrc/hattention_nearfield_bwd.cu``
(#11b).  ``repro``'s route to its reference above an 8 MiB VMEM budget is
not carried over: the CUDA kernels tile the leaf blocks through shared
memory at every leaf size (``kernels/__init__.py``).
"""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import hattention_nearfield_bwd_cuda, hattention_nearfield_cuda
from .ref import hattention_nearfield_bwd_ref, hattention_nearfield_ref


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


def hattention_nearfield_bwd_op(q, k, v, num, den, m, gnum, gden, gm):
    """Gradients (dq, dk, dv) of the near field from the cotangents of its
    outputs; ``num``, ``den``, ``m`` are the forward's outputs on the same
    operands (see ``ref.hattention_nearfield_bwd_ref``)."""
    if on_cpu("hattention_nearfield_bwd", q, k, v, num, den, m, gnum, gden, gm):
        return hattention_nearfield_bwd_ref(q, k, v, num, den, m, gnum, gden, gm)
    return hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)


class NearField(torch.autograd.Function):
    """The near field with its gradient: forward #11 (or the plain version
    on the CPU), backward #11b from the saved q, k, v, num, den, m.  A
    cotangent autograd leaves out (an output that was not used) is zero."""

    @staticmethod
    def forward(ctx, q, k, v):
        num, den, m = hattention_nearfield_op(q, k, v)
        ctx.save_for_backward(q, k, v, num, den, m)
        return num, den, m

    @staticmethod
    def backward(ctx, gnum, gden, gm):
        q, k, v, num, den, m = ctx.saved_tensors
        grads = [torch.zeros_like(ref) if g is None else g.contiguous()
                 for g, ref in ((gnum, num), (gden, den), (gm, m))]
        return hattention_nearfield_bwd_op(q, k, v, num, den, m, *grads)
