"""Plain PyTorch version of the H-attention near field.

The same function as ``repro``'s ``kernels/hattention_block/ref.py`` (and
the dense near field of ``core/hattention.h_attention``), line for line:
the CPU path of ``ops.hattention_nearfield_op`` and the yardstick the CUDA
kernel is held to on the card.
"""
from __future__ import annotations

import torch

NEG = -1e30


def hattention_nearfield_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v: (BH, n_leaf, c, D); q pre-scaled -> (num, den, m)."""
    bh, nl, c, d = q.shape
    s_diag = torch.einsum("bncd,bnkd->bnck", q, k)
    ii = torch.arange(c, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[None, None]
    s_diag = torch.where(causal, s_diag, torch.full_like(s_diag, NEG))
    kp = torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
    s_prev = torch.einsum("bncd,bnkd->bnck", q, kp)
    firstmask = (torch.arange(nl, device=q.device) == 0)[None, :, None, None]
    s_prev = torch.where(firstmask, torch.full_like(s_prev, NEG), s_prev)
    m = torch.maximum(s_diag.amax(-1), s_prev.amax(-1))
    p_diag = torch.exp(s_diag - m[..., None])
    p_prev = torch.exp(s_prev - m[..., None])
    num = torch.einsum("bnck,bnkd->bncd", p_diag, v) + \
        torch.einsum("bnck,bnkd->bncd", p_prev, vp)
    den = p_diag.sum(-1) + p_prev.sum(-1)
    return num, den, m
