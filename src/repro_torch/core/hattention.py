"""H-matrix attention: the paper's block partition on the 1-D sequence domain.

A port of ``repro.core.hattention``.  Causal attention scores S = Q K^T are
partitioned with the static balanced 1-D analogue of the paper's block
cluster tree (clusters are contiguous position ranges):

  * inadmissible leaves: diagonal (i, i) (causal-masked) and first
    sub-diagonal (i, i-1) blocks -> exact, batched dense attention, through
    the near-field kernel and its backward (``kernels/hattention_block``:
    ``NearField``, kernels #11 and #11b);
  * admissible blocks: at every level, (i, i-2) for every i and (i, i-3) for
    odd i -> rank-k ACA on exp(s - m_row), with the entries generated from
    q-row / k-column inner products.

Softmax is computed through the partition: numerator and denominator are
accumulated per block (dense exactly, admissible via U (V^T v) / U (V^T 1)),
with the row stabiliser m taken from the dense near field and far-field
exponents clamped to [-30, 30].

Complexity per head: O(S * c_leaf) dense + O(S * k * log(S / c_leaf)) low
rank, against O(S^2) for full attention.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import require_full_fp32
from ..kernels.hattention_block.ops import NearField

CLAMP = 30.0


def causal_hmatrix_plan(seq: int, c_leaf: int) -> dict:
    """Static plan: levels with admissible (row, col) cluster ids."""
    n_leaf = seq // c_leaf
    if seq % c_leaf != 0 or n_leaf & (n_leaf - 1) != 0:
        raise ValueError(f"seq/c_leaf must be a power of two, got {seq}/{c_leaf}")
    n_levels = int(math.log2(n_leaf))
    levels = {}
    for lvl in range(2, n_levels + 1):
        n_cl = 1 << lvl
        rows, cols = [], []
        for i in range(n_cl):
            # children with distance >= 2x their size of the (recursed)
            # diff-1 parents: (i, i-2) for every i, plus (i, i-3) for odd i
            if i >= 2:
                rows.append(i); cols.append(i - 2)
            if i >= 3 and i % 2 == 1:
                rows.append(i); cols.append(i - 3)
        if rows:
            levels[lvl] = (tuple(rows), tuple(cols))
    return {"n_leaf": n_leaf, "n_levels": n_levels, "levels": levels}


def _plan_coverage(seq: int, c_leaf: int):
    """Dense 0/1 coverage matrix of the plan (test helper, small seq only)."""
    plan = causal_hmatrix_plan(seq, c_leaf)
    cov = np.zeros((seq, seq), np.int32)
    n_leaf = plan["n_leaf"]
    for i in range(n_leaf):
        r0 = i * c_leaf
        for a in range(c_leaf):
            cov[r0 + a, r0:r0 + a + 1] += 1                     # causal diag
        if i >= 1:
            cov[r0:r0 + c_leaf, (i - 1) * c_leaf:i * c_leaf] += 1
    for lvl, (rows, cols) in plan["levels"].items():
        m = seq >> lvl
        for r, c in zip(rows, cols):
            cov[r * m:(r + 1) * m, c * m:(c + 1) * m] += 1
    return cov


def _scatter_passes(rows: tuple) -> list[list[int]]:
    """Block indices of a level split into passes of distinct row clusters,
    in plan order: pass p holds every row's (p+1)-th block.  Adding pass by
    pass fixes the order of the sums where a row appears twice ((i, i-2) and
    (i, i-3) for odd i), with no atomics."""
    passes: list[list[int]] = []
    seen: dict[int, int] = {}
    for blk, r in enumerate(rows):
        p = seen.get(r, 0)
        seen[r] = p + 1
        if p == len(passes):
            passes.append([])
        passes[p].append(blk)
    return passes


# ---------------------------------------------------------------------------
# Bilinear fixed-rank ACA (entries generated from q.k inner products)
# ---------------------------------------------------------------------------


def _masked_argmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First index of the max of ``|x|`` over ``mask`` (float 0/1), per row.
    A pivot carries no gradient (JAX's argmax has none), so ``x`` is read
    detached."""
    return torch.argmax(x.detach().abs() * mask - (1.0 - mask), dim=-1)


def aca_bilinear(q_rows: torch.Tensor, m_rows: torch.Tensor, k_cols: torch.Tensor,
                 rank: int):
    """Rank-``rank`` ACA of A[r, c] = exp(clip(q_rows[r] . k_cols[c] - m_rows[r])).

    q_rows: (..., R, D) pre-scaled; m_rows: (..., R); k_cols: (..., C, D);
    the leading dimensions are independent blocks (``repro``'s
    ``vmap(vmap(aca_bilinear))``).  Returns U: (..., R, rank), V: (..., C, rank).
    Differentiable, as ``repro``'s ``lax.scan`` is: while autograd records,
    step r's columns join U and V out of place (``torch.where`` on column r,
    the values the in-place write gives otherwise), so no tensor autograd
    saved is overwritten; without a graph (serving) they are written in
    place, which costs the prefill less.
    """
    lead = q_rows.shape[:-2]
    R, d = q_rows.shape[-2:]
    C = k_cols.shape[-2]
    q = q_rows.reshape(-1, R, d)
    m = m_rows.reshape(-1, R)
    kc = k_cols.reshape(-1, C, d)
    n = q.shape[0]
    dev, f32 = q.device, torch.float32
    nidx = torch.arange(n, device=dev)
    col = torch.arange(rank, device=dev)
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q_rows, m_rows, k_cols))

    U = torch.zeros((n, R, rank), dtype=f32, device=dev)
    V = torch.zeros((n, C, rank), dtype=f32, device=dev)
    row_mask = torch.ones((n, R), dtype=f32, device=dev)
    col_mask = torch.ones((n, C), dtype=f32, device=dev)
    j_r = torch.zeros(n, dtype=torch.int64, device=dev)
    for r in range(rank):
        s = torch.einsum("nrd,nd->nr", q, kc[nidx, j_r])
        a_col = torch.exp(torch.clamp(s - m, -CLAMP, CLAMP))
        u_hat = a_col - torch.einsum("nrk,nk->nr", U, V[nidx, j_r])
        i_r = _masked_argmax(u_hat, row_mask)
        alpha = u_hat[nidx, i_r]
        safe = alpha.abs() > 1e-30
        inv = torch.where(safe, 1.0 / torch.where(safe, alpha, torch.ones_like(alpha)),
                          torch.zeros_like(alpha))
        u_r = u_hat * inv[:, None]
        s_row = torch.einsum("ncd,nd->nc", kc, q[nidx, i_r])
        a_row = torch.exp(torch.clamp(s_row - m[nidx, i_r][:, None], -CLAMP, CLAMP))
        v_r = a_row - torch.einsum("nck,nk->nc", V, U[nidx, i_r])
        v_r = torch.where(safe[:, None], v_r, torch.zeros_like(v_r))
        u_r = torch.where(safe[:, None], u_r, torch.zeros_like(u_r))
        row_mask[nidx, i_r] = 0.0
        col_mask[nidx, j_r] = 0.0
        j_r = _masked_argmax(v_r, col_mask)
        if recording:
            U = torch.where(col == r, u_r[:, :, None], U)
            V = torch.where(col == r, v_r[:, :, None], V)
        else:
            U[:, :, r] = u_r
            V[:, :, r] = v_r
    return U.reshape(*lead, R, rank), V.reshape(*lead, C, rank)


# ---------------------------------------------------------------------------
# Full H-matrix attention
# ---------------------------------------------------------------------------


def leaf_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, c_leaf: int):
    """The near-field kernel's operands of ``h_attention(q, k, v)``.

    q: (B, S, H, D); k, v: (B, S, Hkv, D) -> qf, kf, vf: (BH, S, D) float32
    (q scaled by 1/sqrt(D), K and V repeated over each group of H / Hkv query
    heads) and their leaf views ql, kl, vl: (BH, S / c_leaf, c_leaf, D).
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, s, hkv, g, d)
    # contiguous copies: for one sequence the reshapes below would stay views
    # (strided q heads, stride-0 repeated K / V heads), which the kernel refuses
    qf = qf.permute(0, 2, 3, 1, 4).reshape(b * hkv * g, s, d).contiguous()   # (BH, S, D)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, s, d)
    kf = kf.reshape(b * hkv * g, s, d).contiguous()
    vf = v.float().permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, s, d)
    vf = vf.reshape(b * hkv * g, s, d).contiguous()
    n_leaf = s // c_leaf
    bh = qf.shape[0]
    return (qf, kf, vf, qf.view(bh, n_leaf, c_leaf, d), kf.view(bh, n_leaf, c_leaf, d),
            vf.view(bh, n_leaf, c_leaf, d))


def h_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, c_leaf: int = 512,
                rank: int = 16) -> torch.Tensor:
    """Causal H-matrix attention.

    q: (B, S, H, D); k, v: (B, S, Hkv, D) -> (B, S, H, D) in q's dtype.  The
    near field runs through ``NearField`` (kernels #11 and #11b for CUDA
    tensors), the far field as batched ACA per level in PyTorch; both are
    differentiable.  The far field's sums are added into num and den pass by
    pass, in the fixed order of ``_scatter_passes``: out of place
    (``index_copy``) while autograd records, so the near field's saved
    outputs are never overwritten, in place otherwise (the same bits).
    Raises for CUDA operands while TF32 is enabled for float32 matmuls.
    """
    require_full_fp32("h_attention", q.device)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    plan = causal_hmatrix_plan(s, c_leaf)
    qf, kf, vf, ql, kl, vl = leaf_blocks(q, k, v, c_leaf)
    bh = qf.shape[0]
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    # ---- dense near field: (i, i) causal + (i, i-1) full ------------------
    num, den, m = NearField.apply(ql, kl, vl)
    m_flat = m.reshape(bh, s)
    num = num.reshape(bh, s, d)
    den = den.reshape(bh, s)

    # ---- far field: batched ACA per level ----------------------------------
    for lvl, (rows, cols) in plan["levels"].items():
        msz = s >> lvl
        n_cl = 1 << lvl
        r_ids = torch.tensor(rows, device=q.device)
        c_ids = torch.tensor(cols, device=q.device)
        q_lvl = qf.view(bh, n_cl, msz, d)[:, r_ids]                    # (BH,nb,m,D)
        m_lvl = m_flat.view(bh, n_cl, msz)[:, r_ids]
        k_lvl = kf.view(bh, n_cl, msz, d)[:, c_ids]
        v_lvl = vf.view(bh, n_cl, msz, d)[:, c_ids]

        U, V = aca_bilinear(q_lvl, m_lvl, k_lvl, rank)                 # (BH,nb,m,k)
        num_blk = torch.einsum("bnmk,bnme->bnke", V, v_lvl)            # V^T v
        num_blk = torch.einsum("bnmk,bnke->bnme", U, num_blk)          # U (V^T v)
        den_blk = torch.einsum("bnmk,bnm->bnk", V, torch.ones(v_lvl.shape[:3],
                                                              device=q.device))
        den_blk = torch.einsum("bnmk,bnk->bnm", U, den_blk)
        num_cl = num.view(bh, n_cl, msz, d)
        den_cl = den.view(bh, n_cl, msz)
        for blocks in _scatter_passes(rows):
            sel = torch.tensor(blocks, device=q.device)
            dst = r_ids[sel]
            if recording:
                num_cl = num_cl.index_copy(1, dst, num_cl[:, dst] + num_blk[:, sel])
                den_cl = den_cl.index_copy(1, dst, den_cl[:, dst] + den_blk[:, sel])
            else:
                num_cl[:, dst] = num_cl[:, dst] + num_blk[:, sel]
                den_cl[:, dst] = den_cl[:, dst] + den_blk[:, sel]
        num = num_cl.view(bh, s, d)
        den = den_cl.view(bh, s)

    out = num / torch.clamp(den, min=1e-30)[..., None]                # (BH,S,D)
    out = out.reshape(b, hkv, g, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out.to(q.dtype)
