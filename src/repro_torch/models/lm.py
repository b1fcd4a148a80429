"""Decoder-only LM of the port over heterogeneous block patterns
(``repro.models.lm`` in PyTorch).

One model covers dense transformers, MoE, the xLSTM stack and the Mamba2 /
shared-attention hybrid: the per-layer block kind comes from
``cfg.block_pattern`` cycled over ``n_layers``.  ``repro`` stacks the
parameters of each pattern position over the periods and scans them; the
port keeps one block per layer in an ``nn.ModuleList`` and loops over them
in the same order (layer ``i`` is period ``i // len(pattern)`` at position
``i % len(pattern)``, then the tail).  ``shared_attn`` layers use ONE weight
set, ``LM.shared``, at every occurrence; their places in ``layers`` hold an
empty module, as ``repro`` keeps ``{}`` there.  Each occurrence keeps its
own KV cache.

Caches: a list with one entry per layer: ``(k, v)`` (B, S, Hkv, D) for the
attention kinds, the float32 state for the recurrent ones (Mamba2: (B, H, P,
N); mLSTM: (C, n, m); sLSTM: (c, n, m, h)).

mode: "train" (logits at every position; with ``remat=True`` each block
runs under ``torch.utils.checkpoint``, as ``repro``'s ``jax.checkpoint``
per block), "prefill" (the logits of the last position only, and the
caches), "decode" (one token; updates K / V caches in place and returns new
recurrent states).  ``cross_entropy_loss`` is the training loss.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import mamba2, xlstm
from . import moe as moe_mod
from .layers import (Attention, MLP, Norm, apply_norm, attention_block, embed_init,
                     embed_tokens, lm_head, make_attention_params, make_mlp_params,
                     make_norm_params, mlp_block)

ATTN_KINDS = ("dense", "moe", "shared_attn")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


class Block(nn.Module):
    """An attention block: ``ln1``, ``attn``, ``ln2`` and ``moe`` (kind
    ``moe``) or, with ``d_ff > 0``, ``mlp``."""

    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp: MLP | None = None,
                 moe: moe_mod.MoE | None = None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp, self.moe = ln1, attn, ln2, mlp, moe


class RecurrentBlock(nn.Module):
    """``ln`` and the mixer under its kind's name: ``mamba``, ``mlstm`` or
    ``slstm``."""

    def __init__(self, kind: str, ln: Norm, mixer: nn.Module):
        super().__init__()
        self.ln = ln
        self.add_module(kind, mixer)


class LM(nn.Module):
    """Parameters ``embed`` (padded vocab, d_model), ``final_norm``,
    ``lm_head`` (d_model, padded vocab; absent with tied embeddings),
    ``layers`` (one block per layer, an empty module at ``shared_attn``
    layers) and ``shared`` (the ``shared_attn`` block, if the pattern has
    one)."""

    def __init__(self, cfg, embed: torch.Tensor, final_norm: Norm,
                 lm_head: torch.Tensor | None, layers: list[nn.Module],
                 shared: Block | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.layers = nn.ModuleList(layers)
        self.shared = shared

    def forward(self, tokens=None, embeds=None, *, mode: str = "train", caches=None,
                cache_len=None, remat: bool = False):
        return forward(self, self.cfg, tokens, embeds, mode=mode, caches=caches,
                       cache_len=cache_len, remat=remat)

    def stacked_parameter_names(self) -> set[str]:
        """The parameters ``repro`` stacks on a leading axis of periods: those
        of the layers before the tail (not ``shared``, which it keeps once)."""
        periods = self.cfg.n_layers // len(self.cfg.block_pattern)
        stacked = periods * len(self.cfg.block_pattern)
        return {f"layers.{i}.{name}" for i in range(stacked)
                for name, _ in self.layers[i].named_parameters()}


# ---------------------------------------------------------------------------
# Per-kind params / caches / apply
# ---------------------------------------------------------------------------

_MIXERS = {"mamba": mamba2.make_mamba_params, "mlstm": xlstm.make_mlstm_params,
           "slstm": xlstm.make_slstm_params}


def make_block_params(gen: torch.Generator, cfg, kind: str, dtype) -> nn.Module:
    dev = gen.device

    def norm():
        return make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=dev)

    if kind in ATTN_KINDS:
        ln1, attn, ln2 = norm(), make_attention_params(gen, cfg, dtype), norm()
        if kind == "moe":
            return Block(ln1, attn, ln2, moe=moe_mod.make_moe_params(gen, cfg, dtype))
        return Block(ln1, attn, ln2, make_mlp_params(gen, cfg, dtype) if cfg.d_ff > 0 else None)
    if kind in RECURRENT_KINDS:
        return RecurrentBlock(kind, norm(), _MIXERS[kind](gen, cfg, dtype))
    raise ValueError(f"unknown block kind {kind!r}")


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, dtype, *, device):
    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ATTN_KINDS:
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
        return zeros(shape, dtype), zeros(shape, dtype)
    if kind == "mamba":
        return zeros(mamba2.mamba_state_shape(cfg, batch))
    if kind == "mlstm":
        return tuple(zeros(s) for s in xlstm.mlstm_state_shape(cfg, batch))
    if kind == "slstm":
        return tuple(zeros(s) for s in xlstm.slstm_state_shape(cfg, batch))
    raise ValueError(f"unknown block kind {kind!r}")


_MIXER_BLOCKS = {"mamba": mamba2.mamba_block, "mlstm": xlstm.mlstm_block,
                 "slstm": xlstm.slstm_block}


def apply_block(p: nn.Module, cfg, kind: str, x, *, mode, cache, cache_len, positions):
    """Returns (x, new_cache)."""
    want_cache = mode in ("prefill", "decode")
    if kind in ATTN_KINDS:
        h = apply_norm(cfg.norm_type, p.ln1, x)
        attn_out, new_kv = attention_block(p.attn, cfg, h, positions=positions, mode=mode,
                                           cache=cache if mode == "decode" else None,
                                           cache_len=cache_len)
        x = x + attn_out
        h = apply_norm(cfg.norm_type, p.ln2, x)
        if kind == "moe":
            x = x + moe_mod.moe_block(p.moe, cfg, h)
        elif p.mlp is not None:
            x = x + mlp_block(p.mlp, cfg, h)
        return x, (new_kv if want_cache else None)
    if kind not in RECURRENT_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    h = apply_norm(cfg.norm_type, p.ln, x)
    out, st = _MIXER_BLOCKS[kind](getattr(p, kind), cfg, h, mode=mode, state=cache)
    return x + out, (st if want_cache else None)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg) -> LM:
    """Random parameters of ``cfg`` on ``gen``'s device, as ``repro``'s
    ``init_params`` draws them (normal projections scaled by 1/sqrt(d_in),
    embeddings by 0.02, zero biases and norm gains); the numbers differ from
    ``repro``'s, which draws from a JAX key."""
    dtype = getattr(torch, cfg.dtype)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    final_norm = make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=gen.device)
    head = None if cfg.tie_embeddings else embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    shared = (make_block_params(gen, cfg, "shared_attn", dtype)
              if "shared_attn" in cfg.layer_kinds else None)
    layers = [nn.Module() if kind == "shared_attn" else make_block_params(gen, cfg, kind, dtype)
              for kind in cfg.layer_kinds]
    return LM(cfg, embed, final_norm, head, layers, shared)


def init_caches(cfg, batch: int, max_seq: int, *, device) -> list:
    dtype = getattr(torch, cfg.dtype)
    return [init_block_cache(cfg, kind, batch, max_seq, dtype, device=device)
            for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params: LM, cfg, tokens=None, embeds=None, *, mode: str = "train", caches=None,
            cache_len=None, remat: bool = False):
    """Returns (logits, new_caches).

    tokens: (B, S) integer ids, or ``embeds``: (B, S, D) given embeddings
    (stub frontends).  For decode, S == 1 and ``caches`` / ``cache_len`` (a
    Python int, the number of filled slots) are given.
    Prefill applies the final norm and the LM head to the last position only
    (all ``repro``'s prefill step keeps), so its logits are (B, 1, V).
    ``remat`` (train mode only): each block keeps only its input for the
    backward pass and runs again there (non-reentrant checkpointing).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if embeds is None:
        x = embed_tokens(params.embed, tokens)
    else:
        x = embeds.to(getattr(torch, cfg.dtype))
    s = x.shape[1]
    if mode == "decode":
        positions = torch.full((s,), cache_len, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)

    new_caches = []
    for i, (block, kind) in enumerate(zip(params.layers, cfg.layer_kinds)):
        if kind == "shared_attn":
            block = params.shared
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
