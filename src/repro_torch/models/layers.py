"""Shared neural-net layers of the port (``repro.models.layers`` in PyTorch).

Parameters live in small ``nn.Module``s (``Norm``, ``Attention``, ``MLP``)
whose parameter names are ``repro``'s pytree keys, with ``repro``'s layout:
a projection is ``x @ W`` with ``W`` shaped ``(d_in, d_out)``.  The layer
functions take those modules the way ``repro``'s take the pytrees.

Attention paths:
  * ``chunked_attention`` — flash-style online-softmax loop over KV chunks
    with ``repro``'s custom VJP (prompts up to ``h_c_leaf`` and backend
    ``full``);
  * ``banded_attention`` — sliding-window attention that computes only the
    band (a loop over q chunks, each on a (chunk + window) KV span): backend
    ``swa``, causal;
  * ``core.hattention.h_attention`` — backend ``hmatrix`` beyond ``h_c_leaf``;
  * ``decode_attention`` — single-token attention over the KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.hattention import h_attention


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """``w`` (rmsnorm: a zero-centred gain, applied as ``1 + w``), plus ``b``
    for layernorm."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


class Attention(nn.Module):
    """``wq, wk, wv`` (d_model, heads * head_dim), ``wo`` (H * head_dim,
    d_model) and, with QKV bias, ``bq, bk, bv``."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (nn.Parameter(t) for t in (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (None if t is None else nn.Parameter(t)
                                     for t in (bq, bk, bv))


class MLP(nn.Module):
    """``wg`` (gated MLPs only), ``wu`` (d_model, d_ff), ``wd`` (d_ff, d_model)."""

    def __init__(self, wu, wd, wg=None):
        super().__init__()
        self.wg = None if wg is None else nn.Parameter(wg)
        self.wu, self.wd = nn.Parameter(wu), nn.Parameter(wd)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return (torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def make_norm_params(norm_type: str, d: int, dtype, *, device) -> Norm:
    if norm_type == "rmsnorm":
        return Norm(torch.zeros((d,), dtype=dtype, device=device))
    return Norm(torch.ones((d,), dtype=dtype, device=device),
                torch.zeros((d,), dtype=dtype, device=device))


def apply_norm(norm_type: str, p: Norm, x):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p.w)
    return layernorm(x, p.w, p.b)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if theta <= 0.0:
        return x
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (D/2,)
    ang = positions[..., :, None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype, device=None):
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _gqa_split(q, n_kv: int):
    """(B, S, H, D) -> (B, S, Hkv, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """Additive (Sq, Sk) f32 bias: 0 where visible, NEG_INF where masked."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def _flash_fwd(q, k, v, causal: bool, window: int, chunk: int, q_offset: int):
    """The online-softmax loop over KV chunks (``repro``'s ``_flash_fwd_scan``).
    Returns out (B, Hkv, G, Sq, D) float32 and the softmax stats (m, l);
    differentiable by autograd (the plain route ``_FlashAttention`` replaces)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = _gqa_split(q, hkv).float() * scale                   # (B,Sq,Hkv,G,D)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(sk // chunk):
        k_blk = k[:, ci * chunk:(ci + 1) * chunk].float()
        v_blk = v[:, ci * chunk:(ci + 1) * chunk].float()
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        s = s + _mask_bias(q_pos, k_pos, causal, window)[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out, m, l


def _flash_bwd(q, k, v, out, m, l, grad, causal: bool, window: int, chunk: int,
               q_offset: int):
    """``repro``'s ``_flash_bwd``: the scores are recomputed per KV chunk
    from the saved (m, l, out), so no (Sq, Sk) probability tensor is kept."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = _gqa_split(q, hkv).float() * scale                   # (B,Sq,Hkv,G,D)
    gg = _gqa_split(grad, hkv).float().permute(0, 2, 3, 1, 4)  # (B,Hkv,G,Sq,D)
    l_safe = torch.clamp(l, min=1e-30)
    dsum = torch.sum(gg * out, dim=-1)                        # (B,Hkv,G,Sq)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ci in range(sk // chunk):
        k_blk = k[:, ci * chunk:(ci + 1) * chunk].float()
        v_blk = v[:, ci * chunk:(ci + 1) * chunk].float()
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        s = s + _mask_bias(q_pos, k_pos, causal, window)[None, None, None]
        p = torch.exp(s - m[..., None]) / l_safe[..., None]   # normalised probs
        dp = torch.einsum("bhgqd,bkhd->bhgqk", gg, v_blk)
        ds = p * (dp - dsum[..., None])
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, gg))
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg))
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
    dq = (dq * scale).reshape(b, sq, h, d).to(q.dtype)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``repro``'s ``_flash_attention`` custom VJP: forward ``_flash_fwd``,
    backward ``_flash_bwd`` from the saved (q, k, v, out, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, m, l = _flash_fwd(q, k, v, causal, window, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.opts = (causal, window, chunk, q_offset)
        b, sq, h, d = q.shape
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, grad, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0):
    """Flash-style attention: a loop over KV chunks with online softmax and
    ``repro``'s custom VJP, which recomputes the scores per chunk in the
    backward pass (``_FlashAttention``).

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D).
    """
    sk = k.shape[1]
    chunk = min(chunk, sk)
    if sk % chunk != 0:
        raise ValueError(f"chunked_attention: {sk} keys do not split into chunks of {chunk}")
    return _FlashAttention.apply(q, k, v, causal, window, chunk, q_offset)


def banded_attention(q, k, v, *, window: int, chunk: int = 1024, q_offset: int = 0):
    """Sliding-window attention that computes only the band: a loop over q
    chunks, each step on a (chunk + window) KV span (``repro``'s scan with
    ``dynamic_slice``), O(S * window) score work.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, sq)
    if sq % chunk != 0:
        raise ValueError(f"banded_attention: {sq} queries do not split into chunks of {chunk}")
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    span = min(window + chunk, sk)
    kf, vf = k.float(), v.float()
    qg = _gqa_split(q, hkv).float() * scale                   # (B,Sq,Hkv,G,D)
    outs = []
    for qi in range(sq // chunk):
        q_blk = qg[:, qi * chunk:(qi + 1) * chunk]
        q_pos = q_offset + qi * chunk + torch.arange(chunk, device=q.device)
        start = min(max(qi * chunk + chunk - span, 0), sk - span)
        k_blk = kf[:, start:start + span]
        v_blk = vf[:, start:start + span]
        k_pos = start + torch.arange(span, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk)
        s = s + _mask_bias(q_pos, k_pos, True, window)[None, None, None]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk) / torch.clamp(
            p.sum(-1), min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, d))   # (B,chunk,H,D)
    # ``repro`` lays the chunks out as (B, chunk, nq) and reads that as (B,
    # nq, chunk): with several chunks, output row c * nq + n holds query n *
    # chunk + c.  The port computes what ``repro`` computes (ROADMAP §3).
    return torch.stack(outs, dim=2).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """One-token attention over the cache.  q: (B, 1, H, D); caches
    (B, S, Hkv, D).  The cache is read in its own dtype; scores, the
    probabilities' sum and the numerator are float32 (``repro``'s
    ``preferred_element_type``), the probabilities rounded to the cache's
    dtype before the product with V, as in ``repro``."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    qg = q.reshape(b, hkv, g, d) * scale
    s_scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    valid = torch.arange(s, device=q.device) < cache_len                # (S,)
    s_scores = torch.where(valid, s_scores, torch.full_like(s_scores, NEG_INF))
    m = s_scores.amax(dim=-1, keepdim=True)
    p = torch.exp(s_scores - m)
    num = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = num / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + backend dispatch)
# ---------------------------------------------------------------------------


def make_attention_params(gen: torch.Generator, cfg, dtype) -> Attention:
    d, hd = cfg.d_model, cfg.head_dim_
    wq = dense_init(gen, d, cfg.n_heads * hd, dtype)
    wk = dense_init(gen, d, cfg.n_kv_heads * hd, dtype)
    wv = dense_init(gen, d, cfg.n_kv_heads * hd, dtype)
    wo = dense_init(gen, cfg.n_heads * hd, d, dtype)
    biases = {}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            biases[name] = torch.zeros((width * hd,), dtype=dtype, device=gen.device)
    return Attention(wq, wk, wv, wo, **biases)


def _proj_qkv(p: Attention, cfg, x):
    hd = cfg.head_dim_
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def attention_block(p: Attention, cfg, x, *, positions, mode: str, cache=None,
                    cache_len: int | None = None, kv_override=None, causal: bool = True):
    """Full attention block.  Returns (out, new_cache_kv | None).

    mode: "train" | "prefill" | "decode".
    cache: (k_cache, v_cache) of shape (B, S_max, Hkv, D) for decode; the new
    token's K and V are written into it in place at slot ``cache_len`` (the
    caller hands the cache over, as ``repro``'s decode step donates it).
    kv_override: (k, v) for cross-attention (the encoder's); RoPE then
    applies to q only, and there is no cache to write.
    Decode attends over the whole cache whatever the backend: ``repro``
    windows only prefill (ROADMAP §3).
    """
    b, s, _ = x.shape
    q, k, v = _proj_qkv(p, cfg, x)
    if kv_override is not None:
        k, v = kv_override
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_override is None:
        k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode" and kv_override is None:
        k_cache, v_cache = cache
        k_cache[:, cache_len:cache_len + s] = k.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + s] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache, v_cache, cache_len + 1)
        new_cache = (k_cache, v_cache)
    else:
        if cfg.attention_backend == "swa" and cfg.sliding_window > 0 and causal:
            out = banded_attention(q, k, v, window=cfg.sliding_window)
        elif cfg.attention_backend == "hmatrix" and causal and s > cfg.h_c_leaf:
            out = h_attention(q, k, v, c_leaf=cfg.h_c_leaf, rank=cfg.h_rank)
        else:
            out = chunked_attention(q, k, v, causal=causal)
        new_cache = (k, v) if mode == "prefill" else None
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim_)
    return out @ p.wo, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def make_mlp_params(gen: torch.Generator, cfg, dtype) -> MLP:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        wg = dense_init(gen, d, f, dtype)
        wu = dense_init(gen, d, f, dtype)
        return MLP(wu, dense_init(gen, f, d, dtype), wg=wg)
    wu = dense_init(gen, d, f, dtype)
    return MLP(wu, dense_init(gen, f, d, dtype))


def mlp_block(p: MLP, cfg, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p.wg) * (x @ p.wu)
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ p.wg, approximate="tanh") * (x @ p.wu)   # jax.nn.gelu's default
    else:
        h = F.gelu(x @ p.wu, approximate="tanh")
    return h @ p.wd


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_tokens(table, tokens):
    return F.embedding(tokens, table)


def lm_head(x, table_or_w, tie: bool):
    if tie:
        return x @ table_or_w.T
    return x @ table_or_w
