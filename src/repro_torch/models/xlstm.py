"""xLSTM blocks: chunk-parallel mLSTM (matrix memory) and sequential sLSTM
(``repro.models.xlstm`` in PyTorch).

mLSTM recurrence (per head, stabilised exponential gating):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (matrix memory, D_v x D_k)
    n_t = f_t n_{t-1} + i_t k_t              (normaliser)
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with i_t = exp(i~_t - m_t), f_t = exp(logsig(f~_t)) and the running
stabiliser m_t.  The chunkwise form is batched products inside chunks and a
loop across chunks, carrying ``repro``'s (C, n, m) state.

sLSTM keeps a true hidden-state recurrence (R h_{t-1} in the gates), so it
runs as a loop over time steps, one per token, as ``repro``'s ``lax.scan``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# mLSTM (chunk-parallel)
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``w_up`` (d, 4 d), ``wq``, ``wk``, ``wv`` (2 d, 2 d), ``w_if`` (2 d, 2 H),
    ``w_down`` (2 d, d) and the float32 forget-gate bias ``f_bias`` (H,)."""

    def __init__(self, w_up, wq, wk, wv, w_if, w_down, f_bias):
        super().__init__()
        self.w_up, self.wq, self.wk, self.wv, self.w_if, self.w_down, self.f_bias = (
            nn.Parameter(t) for t in (w_up, wq, wk, wv, w_if, w_down, f_bias))


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """q, k, v: (B, S, H, D); i_pre, f_pre: (B, S, H) pre-activations.

    Returns (B, S, H, D) and the final (C, n, m) state.  Within a chunk the
    log gates are stabilised by their chunk-local max (exact: the stabiliser
    cancels in the h_t ratio).
    """
    b, s, h, d = q.shape
    nc = s // chunk
    scale = d ** -0.5

    qf = q.float().reshape(b, nc, chunk, h, d) * scale
    kf = k.float().reshape(b, nc, chunk, h, d)
    vf = v.float().reshape(b, nc, chunk, h, d)
    logf = log_sigmoid(f_pre.float()).reshape(b, nc, chunk, h)
    ipre = i_pre.float().reshape(b, nc, chunk, h)

    logf_c = torch.cumsum(logf, dim=2)                         # within-chunk cumsum
    logf_total = logf_c[:, :, -1]                              # (B,nc,H)

    # log weight of (k_j -> q_l) inside the chunk: logf_c[l] - logf_c[j] + ipre[j]
    lw = logf_c[:, :, :, None, :] - logf_c[:, :, None, :, :] + ipre[:, :, None, :, :]
    ii = torch.arange(chunk, device=q.device)
    causal = ii[:, None] >= ii[None, :]
    lw = torch.where(causal[None, None, :, :, None], lw, torch.full_like(lw, -torch.inf))
    lw_state = logf_c                                          # initial state -> q_l
    lw_to_end = logf_total[:, :, None, :] - logf_c + ipre      # key j -> chunk state

    c_st = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    n_st = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m_st = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for ci in range(nc):
        qc, kc, vc = qf[:, ci], kf[:, ci], vf[:, ci]
        lwc, lw_st, lw_end, lf_tot = lw[:, ci], lw_state[:, ci], lw_to_end[:, ci], logf_total[:, ci]
        # this chunk's stabiliser: max over (l, j) and the incoming-state path
        m_local = torch.maximum(lwc.amax(dim=(1, 2)), lw_st.amax(dim=1) + m_st)
        m_local = torch.clamp(m_local, min=-1e30)
        # intra-chunk
        w = torch.exp(lwc - m_local[:, None, None, :])         # (B,L,L,H)
        sc = torch.einsum("blhd,bjhd->bljh", qc, kc)
        scw = sc * w
        num_intra = torch.einsum("bljh,bjhd->blhd", scw, vc)
        den_intra = scw.sum(dim=2)                             # (B,L,H)
        # state contribution
        w_st = torch.exp(lw_st + m_st[:, None, :] - m_local[:, None, :])   # (B,L,H)
        qs = torch.einsum("blhd,bhde->blhe", qc, c_st)
        num_state = qs * w_st[..., None]
        den_state = torch.einsum("blhd,bhd->blh", qc, n_st) * w_st
        num = num_intra + num_state
        den = torch.abs(den_intra + den_state)
        ys.append(num / torch.maximum(den, torch.exp(-m_local)[:, None, :])[..., None])
        # the state, stabilised by the new running max
        m_new = torch.maximum(lf_tot + m_st, lw_end.amax(dim=1))
        w_end = torch.exp(lw_end - m_new[:, None, :])          # (B,L,H)
        decay = torch.exp(lf_tot + m_st - m_new)
        c_st = c_st * decay[..., None, None] + torch.einsum(
            "blhd,blhe->bhde", kc * w_end[..., None], vc)
        n_st = n_st * decay[..., None] + torch.einsum("blh,blhd->bhd", w_end, kc)
        m_st = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, h, d)
    return y.to(q.dtype), (c_st, n_st, m_st)


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """Single-token recurrent mLSTM update.  state: (C, n, m)."""
    c_st, n_st, m_st = state
    d = q.shape[-1]
    qf = q.float() * (d ** -0.5)
    logf = log_sigmoid(f_pre.float())                          # (B,H)
    ipre = i_pre.float()
    m_new = torch.maximum(logf + m_st, ipre)
    i_g = torch.exp(ipre - m_new)
    f_g = torch.exp(logf + m_st - m_new)
    c_new = c_st * f_g[..., None, None] + \
        i_g[..., None, None] * torch.einsum("bhd,bhe->bhde", k.float(), v.float())
    n_new = n_st * f_g[..., None] + i_g[..., None] * k.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y.to(q.dtype), (c_new, n_new, m_new)


def make_mlstm_params(gen: torch.Generator, cfg, dtype) -> MLSTM:
    d = cfg.d_model
    d_inner = 2 * d
    h = cfg.n_heads
    return MLSTM(dense_init(gen, d, 2 * d_inner, dtype),
                 dense_init(gen, d_inner, d_inner, dtype),
                 dense_init(gen, d_inner, d_inner, dtype),
                 dense_init(gen, d_inner, d_inner, dtype),
                 dense_init(gen, d_inner, 2 * h, dtype),
                 dense_init(gen, d_inner, d, dtype),
                 torch.full((h,), 3.0, dtype=torch.float32, device=gen.device))  # open forget gates


def mlstm_block(p: MLSTM, cfg, x, *, mode: str, state=None):
    b, s, d = x.shape
    d_inner = 2 * d
    h = cfg.n_heads
    hd = d_inner // h
    up = x @ p.w_up
    xm, z = torch.chunk(up, 2, dim=-1)
    q = (xm @ p.wq).reshape(b, s, h, hd)
    k = (xm @ p.wk).reshape(b, s, h, hd)
    v = (xm @ p.wv).reshape(b, s, h, hd)
    gates = xm @ p.w_if
    i_pre = gates[..., :h].float()
    f_pre = gates[..., h:].float() + p.f_bias
    if mode == "decode":
        y, new_state = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
        y = y[:, None]
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        # padded steps: i -> -30 (no input), f -> +30 (no decay): the carried
        # (C, n, m) state is kept exactly
        pad4 = (0, 0, 0, 0, 0, pad)
        y, new_state = mlstm_chunked(F.pad(q, pad4), F.pad(k, pad4), F.pad(v, pad4),
                                     F.pad(i_pre, (0, 0, 0, pad), value=-30.0),
                                     F.pad(f_pre, (0, 0, 0, pad), value=30.0), chunk)
        y = y[:, :s]
    y = y.reshape(b, s, d_inner)
    out = (y * F.silu(z.float()).to(y.dtype)) @ p.w_down
    return out, new_state


def mlstm_state_shape(cfg, batch: int):
    d_inner = 2 * cfg.d_model
    hd = d_inner // cfg.n_heads
    return ((batch, cfg.n_heads, hd, hd), (batch, cfg.n_heads, hd), (batch, cfg.n_heads))


# ---------------------------------------------------------------------------
# sLSTM (a loop over time: the true recurrence)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """``w_x`` (d, 4 d) input weights of the gates (z, i, f, o), ``r_h`` (H,
    hd, 4 hd) block-diagonal recurrent weights, float32 ``bias`` (4 d) and
    ``w_out`` (d, d)."""

    def __init__(self, w_x, r_h, bias, w_out):
        super().__init__()
        self.w_x, self.r_h, self.bias, self.w_out = (nn.Parameter(t)
                                                     for t in (w_x, r_h, bias, w_out))


def make_slstm_params(gen: torch.Generator, cfg, dtype) -> SLSTM:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    w_x = dense_init(gen, d, 4 * d, dtype)
    r_h = (torch.randn((h, hd, 4 * hd), generator=gen, device=gen.device)
           / math.sqrt(hd)).to(dtype)
    return SLSTM(w_x, r_h, torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
                 dense_init(gen, d, d, dtype))


def slstm_block(p: SLSTM, cfg, x, *, mode: str, state=None):
    """x: (B, S, D).  One step per token (hidden-state recurrence); decode
    starts from ``state`` (c, n, m, h), the rest from zeros with m = -1e30.
    Returns (out, final state)."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    wx = (x @ p.w_x).float()                                   # (B,S,4D)
    r_h = p.r_h.float()
    bias = p.bias.reshape(h, 4 * hd)
    if mode == "decode" and state is not None:
        c, n, m, hid = state
    else:
        c = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        m = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
        hid = torch.zeros_like(c)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", hid, r_h)
        gates = wx[:, t].reshape(b, h, 4 * hd) + rec + bias
        zt, it, ft, ot = torch.chunk(gates, 4, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        # stabilised exponential gating (per head and unit)
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m[..., None], it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(logf + m[..., None] - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        hid = ot * c / torch.clamp(n, min=1.0)
        m = m_new.amax(-1)
        hs.append(hid)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return y @ p.w_out, (c, n, m, hid)


def slstm_state_shape(cfg, batch: int):
    h = cfg.n_heads
    hd = cfg.d_model // h
    return ((batch, h, hd), (batch, h, hd), (batch, h), (batch, h, hd))
