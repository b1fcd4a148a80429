"""Mamba2 (SSD, state-space duality) block, chunk-parallel
(``repro.models.mamba2`` in PyTorch).

Train / prefill: ``ssd_chunked`` (batched products inside chunks, a short
loop across chunks).  Decode: ``ssd_step`` (a constant-time update of the
SSM state (B, H, P, N), float32, which plays the KV cache's part).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init


class Mamba(nn.Module):
    """``w_in`` (d_model, 2 d_inner + 2 N + H), ``w_out`` (d_inner, d_model)
    and the float32 per-head constants ``a_log``, ``d_skip``, ``dt_bias``."""

    def __init__(self, w_in, w_out, a_log, d_skip, dt_bias):
        super().__init__()
        self.w_in, self.w_out = nn.Parameter(w_in), nn.Parameter(w_out)
        self.a_log, self.d_skip, self.dt_bias = (nn.Parameter(t)
                                                 for t in (a_log, d_skip, dt_bias))


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum(logd):
    """Lower-triangular cumulative sums: out[i, j] = sum_{j < k <= i} logd[k].

    logd: (..., L) -> (..., L, L) with -inf above the diagonal.
    """
    n = logd.shape[-1]
    csum = torch.cumsum(logd, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    ii = torch.arange(n, device=logd.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk: int):
    """Chunked SSD scan.

    x:     (B, S, H, P)    inputs per head
    dt:    (B, S, H)       softplus-activated step sizes
    a_log: (H,)            log(-A) parameterisation, A = -exp(a_log)
    b_mat: (B, S, N)       input projection (single group)
    c_mat: (B, S, N)       output projection
    d_skip:(H,)            skip connection
    Returns (B, S, H, P), final_state (B, H, P, N) float32.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    da = dtf * a                                              # (B,S,H) log-decay per step

    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dac = da.reshape(bsz, nc, chunk, h)
    dtc = dtf.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n).float()
    cc = c_mat.reshape(bsz, nc, chunk, n).float()

    # intra-chunk: y[b,c,l,h,p] = sum_k scores[b,c,l,k] decay[b,c,h,l,k] dt[b,c,k,h] x[b,c,k,h,p]
    dac_t = dac.permute(0, 1, 3, 2)                           # (B,nc,H,L)
    scores = torch.einsum("bcln,bckn->bclk", cc, bc)          # (B,nc,L,L)
    wx = scores[:, :, None] * torch.exp(_segsum(dac_t))       # (B,nc,H,L,L), masked lower-tri
    wx = wx * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]       # weight by dt_k
    y_intra = torch.einsum("bchlk,bckhp->bclhp", wx, xc)
    del wx

    # chunk states: sum_k decay(k+1..end) dt_k B_k x_k
    total = dac_t.sum(-1, keepdim=True)
    decay_to_end = torch.exp(total - torch.cumsum(dac_t, dim=-1))
    w_end = (decay_to_end * dtc.permute(0, 1, 3, 2)).permute(0, 1, 3, 2)   # (B,nc,L,H)
    sb = torch.einsum("bckhp,bckn->bchpn", xc * w_end[..., None], bc)      # (B,nc,H,P,N)

    # inter-chunk loop (``repro``'s lax.scan), in chunk order
    chunk_decay = torch.exp(total[..., 0])                    # (B,nc,H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states_before = []
    for ci in range(nc):
        states_before.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + sb[:, ci]
    states_before = torch.stack(states_before, dim=1)        # (B,nc,H,P,N)

    # inter-chunk output
    decay_from_start = torch.exp(torch.cumsum(dac_t, dim=-1))
    y_inter = torch.einsum("bcln,bchpn->bclhp", cc, states_before) * \
        decay_from_start.permute(0, 1, 3, 2)[..., None]

    y = y_intra + y_inter + d_skip.float()[None, None, :, None] * xc
    return y.reshape(bsz, s, h, p).to(x.dtype), state


def ssd_step(state, x, dt, a_log, b_vec, c_vec, d_skip):
    """Single-token recurrent update.  state: (B, H, P, N) float32."""
    a = -torch.exp(a_log.float())
    dtf = dt.float()                                           # (B, H)
    da = torch.exp(dtf * a)
    xb = torch.einsum("bhp,bn->bhpn", x.float() * dtf[..., None], b_vec.float())
    state = state * da[..., None, None] + xb
    y = torch.einsum("bhpn,bn->bhp", state, c_vec.float())
    y = y + d_skip.float()[None, :, None] * x.float()
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections around the SSD core)
# ---------------------------------------------------------------------------


def make_mamba_params(gen: torch.Generator, cfg, dtype) -> Mamba:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    h = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    dev = gen.device
    return Mamba(dense_init(gen, d, 2 * d_inner + 2 * n + h, dtype),
                 dense_init(gen, d_inner, d, dtype),
                 torch.zeros((h,), dtype=torch.float32, device=dev),
                 torch.ones((h,), dtype=torch.float32, device=dev),
                 torch.zeros((h,), dtype=torch.float32, device=dev))


def mamba_block(p: Mamba, cfg, x, *, mode: str, state=None):
    """x: (B, S, D).  Returns (out, new_state)."""
    bsz, s, d = x.shape
    d_inner = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    h = d_inner // hd
    n = cfg.ssm_state

    zxbcdt = x @ p.w_in
    z, xs, b_mat, c_mat, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    dt = softplus(dt.float() + p.dt_bias)
    xh = xs.reshape(bsz, s, h, hd)

    if mode == "decode":
        y, new_state = ssd_step(state, xh[:, 0], dt[:, 0], p.a_log, b_mat[:, 0],
                                c_mat[:, 0], p.d_skip)
        y = y[:, None]
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        # dt = 0 on padded steps: decay exp(0) = 1 and input 0, state-neutral
        y, new_state = ssd_chunked(F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                                   p.a_log, F.pad(b_mat, (0, 0, 0, pad)),
                                   F.pad(c_mat, (0, 0, 0, pad)), p.d_skip, chunk)
        y = y[:, :s]
    y = y.reshape(bsz, s, d_inner)
    out = (y * F.silu(z.float()).to(y.dtype)) @ p.w_out
    return out, new_state


def mamba_state_shape(cfg, batch: int):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    return (batch, h, cfg.ssm_head_dim, cfg.ssm_state)
