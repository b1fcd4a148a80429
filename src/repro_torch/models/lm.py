"""Decoder-only LM of the port (``repro.models.lm`` in PyTorch), dense blocks.

The per-layer block kind comes from ``cfg.block_pattern`` cycled over
``n_layers``, as in ``repro``.  ``repro`` stacks the parameters of each
pattern position over the periods and scans them with ``lax.scan``; the
port keeps one ``Block`` per layer in an ``nn.ModuleList`` and loops over
them, in the same order.  Caches are a list with one ``(k, v)`` per layer,
each (B, S, Hkv, D).

mode: "train" (logits at every position; with ``remat=True`` each block
runs under ``torch.utils.checkpoint``, as ``repro``'s ``jax.checkpoint``
per block), "prefill" (the logits of the last position only, and the
caches), "decode" (one token, updates the caches in place).
``cross_entropy_loss`` is the training loss.

Only the ``dense`` block kind is ported; ``moe``, ``mamba``, ``mlstm``,
``slstm`` and ``shared_attn`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (Attention, MLP, Norm, apply_norm, attention_block, embed_init,
                     embed_tokens, lm_head, make_attention_params, make_mlp_params,
                     make_norm_params, mlp_block)

_NOT_PORTED = ("moe", "shared_attn", "mamba", "mlstm", "slstm")


def _require_ported(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r}: not yet ported to repro_torch")
    if kind != "dense":
        raise ValueError(f"unknown block kind {kind!r}")


class Block(nn.Module):
    """One dense block: ``ln1``, ``attn``, ``ln2`` and (``d_ff > 0``) ``mlp``."""

    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp: MLP | None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LM(nn.Module):
    """Parameters ``embed`` (padded vocab, d_model), ``final_norm``,
    ``lm_head`` (d_model, padded vocab; absent with tied embeddings) and
    ``layers`` (one ``Block`` per layer)."""

    def __init__(self, cfg, embed: torch.Tensor, final_norm: Norm,
                 lm_head: torch.Tensor | None, layers: list[Block]):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.layers = nn.ModuleList(layers)

    def forward(self, tokens, *, mode: str = "train", caches=None, cache_len=None,
                remat: bool = False):
        return forward(self, self.cfg, tokens, mode=mode, caches=caches, cache_len=cache_len,
                       remat=remat)


# ---------------------------------------------------------------------------
# Per-kind params / caches / apply
# ---------------------------------------------------------------------------


def make_block_params(gen: torch.Generator, cfg, kind: str, dtype) -> Block:
    _require_ported(kind)
    dev = gen.device
    return Block(make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=dev),
                 make_attention_params(gen, cfg, dtype),
                 make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=dev),
                 make_mlp_params(gen, cfg, dtype) if cfg.d_ff > 0 else None)


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, dtype, *, device):
    _require_ported(kind)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def apply_block(p: Block, cfg, kind: str, x, *, mode, cache, cache_len, positions):
    """Returns (x, new_cache)."""
    _require_ported(kind)
    h = apply_norm(cfg.norm_type, p.ln1, x)
    attn_out, new_kv = attention_block(p.attn, cfg, h, positions=positions, mode=mode,
                                       cache=cache if mode == "decode" else None,
                                       cache_len=cache_len)
    x = x + attn_out
    h = apply_norm(cfg.norm_type, p.ln2, x)
    if p.mlp is not None:
        x = x + mlp_block(p.mlp, cfg, h)
    return x, (new_kv if mode in ("prefill", "decode") else None)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg) -> LM:
    """Random parameters of ``cfg`` on ``gen``'s device, as ``repro``'s
    ``init_params`` draws them (normal projections scaled by 1/sqrt(d_in),
    embeddings by 0.02, zero biases and norm gains); the numbers differ from
    ``repro``'s, which draws from a JAX key."""
    dtype = getattr(torch, cfg.dtype)
    for kind in cfg.layer_kinds:
        _require_ported(kind)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    final_norm = make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=gen.device)
    head = None if cfg.tie_embeddings else embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    layers = [make_block_params(gen, cfg, kind, dtype) for kind in cfg.layer_kinds]
    return LM(cfg, embed, final_norm, head, layers)


def init_caches(cfg, batch: int, max_seq: int, *, device) -> list:
    dtype = getattr(torch, cfg.dtype)
    return [init_block_cache(cfg, kind, batch, max_seq, dtype, device=device)
            for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params: LM, cfg, tokens, *, mode: str = "train", caches=None, cache_len=None,
            remat: bool = False):
    """Returns (logits, new_caches).

    tokens: (B, S) integer ids.  For decode, S == 1 and ``caches`` /
    ``cache_len`` (a Python int, the number of filled slots) are given.
    Prefill applies the final norm and the LM head to the last position only
    (all ``repro``'s prefill step keeps), so its logits are (B, 1, V).
    ``remat`` (train mode only): each block keeps only its input for the
    backward pass and runs again there (non-reentrant checkpointing).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = embed_tokens(params.embed, tokens)
    s = x.shape[1]
    if mode == "decode":
        positions = torch.full((s,), cache_len, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)

    new_caches = []
    for i, (block, kind) in enumerate(zip(params.layers, cfg.layer_kinds)):
        cache = caches[i] if caches is not None else None
        if remat and mode == "train":
            x, nc = checkpoint(apply_block, block, cfg, kind, x, mode=mode, cache=None,
                               cache_len=cache_len, positions=positions, use_reentrant=False)
        else:
            x, nc = apply_block(block, cfg, kind, x, mode=mode, cache=cache,
                                cache_len=cache_len, positions=positions)
        new_caches.append(nc)

    if mode == "prefill":
        x = x[:, -1:]
    x = apply_norm(cfg.norm_type, params.final_norm, x)
    w = params.embed if cfg.tie_embeddings else params.lm_head
    logits = lm_head(x, w, cfg.tie_embeddings)
    return logits, (new_caches if mode in ("prefill", "decode") else None)


def cross_entropy_loss(logits, labels, vocab_size: int):
    """Mean next-token cross entropy in float32; labels outside ``[0,
    vocab_size)`` (the -1 closing each sequence, padding ids) are masked.

    ``repro`` picks the gold logit with a compare-select-sum over the vocab;
    exactly one term of that sum is nonzero, so the gather here gives the
    same bits without a (B, S, V) one-hot.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    mask = (labels >= 0) & (labels < vocab_size)
    idx = torch.where(mask, labels, torch.zeros_like(labels)).long()
    gold = torch.gather(lf, -1, idx[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
