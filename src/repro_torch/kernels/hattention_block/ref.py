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


def hattention_nearfield_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 num: torch.Tensor, den: torch.Tensor, m: torch.Tensor,
                                 gnum: torch.Tensor, gden: torch.Tensor, gm: torch.Tensor):
    """The plain derivative of ``hattention_nearfield_ref``: from the
    cotangents (gnum, gden, gm) of (num, den, m), the gradients (dq, dk, dv)
    of q, k, v, as ``jax.vjp`` of ``repro``'s version gives them.

    Beside p = exp(s - m), the cotangent of m reaches the scores through
    ``m = max(max s_diag, max s_prev)``: JAX gives a block's max all of it,
    or half where both blocks' maxima are equal, and splits that evenly
    among the entries that attain it.  The tied entries are found in this
    function's own scores; ``m``, ``num`` and ``den`` enter p and
    ``dm = gm - (gnum . num + gden den)``.  The CPU path of
    ``ops.NearField``'s backward and the yardstick of kernel #11b.
    """
    bh, nl, c, d = q.shape
    ii = torch.arange(c, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[None, None]
    kp = torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
    s_diag = torch.einsum("bncd,bnkd->bnck", q, k)
    s_diag = torch.where(causal, s_diag, torch.full_like(s_diag, NEG))
    s_prev = torch.einsum("bncd,bnkd->bnck", q, kp)
    firstmask = (torch.arange(nl, device=q.device) == 0)[None, :, None, None]
    s_prev = torch.where(firstmask, torch.full_like(s_prev, NEG), s_prev)
    p_diag = torch.exp(s_diag - m[..., None])
    p_prev = torch.exp(s_prev - m[..., None])

    dm = gm - ((gnum * num).sum(-1) + gden * den)
    md, ms = s_diag.amax(-1), s_prev.amax(-1)
    mm = torch.maximum(md, ms)
    hit_d = (s_diag == md[..., None]).to(q.dtype)
    hit_s = (s_prev == ms[..., None]).to(q.dtype)
    both = (md == ms).to(q.dtype) + 1.0
    coef_d = dm * ((md == mm).to(q.dtype) / both) / hit_d.sum(-1)
    coef_s = dm * ((ms == mm).to(q.dtype) / both) / hit_s.sum(-1)

    ds_diag = p_diag * (torch.einsum("bncd,bnkd->bnck", gnum, v) + gden[..., None]) \
        + hit_d * coef_d[..., None]
    ds_prev = p_prev * (torch.einsum("bncd,bnkd->bnck", gnum, vp) + gden[..., None]) \
        + hit_s * coef_s[..., None]
    dq = torch.einsum("bnck,bnkd->bncd", ds_diag, k) + \
        torch.einsum("bnck,bnkd->bncd", ds_prev, kp)
    dk = torch.einsum("bnck,bncd->bnkd", ds_diag, q)
    dv = torch.einsum("bnck,bncd->bnkd", p_diag, gnum)
    # leaf n's rows see leaf n - 1's keys in full
    dk_prev = torch.einsum("bnck,bncd->bnkd", ds_prev, q)
    dv_prev = torch.einsum("bnck,bncd->bnkd", p_prev, gnum)
    dk = dk + torch.cat([dk_prev[:, 1:], torch.zeros_like(dk_prev[:, :1])], dim=1)
    dv = dv + torch.cat([dv_prev[:, 1:], torch.zeros_like(dv_prev[:, :1])], dim=1)
    return dq, dk, dv
