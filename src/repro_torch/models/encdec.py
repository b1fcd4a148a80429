"""Encoder-decoder transformer, the whisper-tiny backbone
(``repro.models.encdec`` in PyTorch).

The conv / audio frontend is a stub, as in ``repro``: callers give frame
embeddings (B, S_enc, d_model).  Encoder: bidirectional self-attention and a
GELU MLP over sinusoidal positions.  Decoder: causal self-attention,
cross-attention to the encoder output and a GELU MLP over learned positions
(row ``min(position, 4095)`` of the table: ``repro`` clips positions past
its end).  Both stacks loop over their layers in order.

Caches: one dict per decoder layer, ``{"self": (k, v), "cross": (k, v)}``;
the cross K / V are computed once, at prefill, from the encoder output, and
decode only reads them.

Training: ``remat=True`` runs each encoder and decoder layer under
``torch.utils.checkpoint`` (non-reentrant), as ``lm.forward`` runs each
block.  ``repro``'s ``encdec.forward`` takes ``remat`` and ignores it;
checkpointing recomputes the same operations, so the values and gradients
are those of the plain forward.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (MLP, Attention, Norm, apply_norm, attention_block, embed_init,
                     embed_tokens, lm_head, make_attention_params, make_mlp_params,
                     make_norm_params, mlp_block, sinusoidal_positions)

DEC_POS = 4096   # rows of the learned decoder position table


class EncLayer(nn.Module):
    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecLayer(nn.Module):
    def __init__(self, ln1: Norm, self_attn: Attention, ln_x: Norm, cross_attn: Attention,
                 ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.self_attn, self.ln_x = ln1, self_attn, ln_x
        self.cross_attn, self.ln2, self.mlp = cross_attn, ln2, mlp


class EncDec(nn.Module):
    """Parameters ``enc_layers``, ``dec_layers``, ``embed`` (padded vocab,
    d_model; tied to the LM head), ``dec_pos`` (4096, d_model), ``enc_norm``
    and ``dec_norm``: ``repro``'s pytree keys."""

    def __init__(self, cfg, enc_layers, dec_layers, embed, dec_pos, enc_norm: Norm,
                 dec_norm: Norm):
        super().__init__()
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.embed = nn.Parameter(embed)
        self.dec_pos = nn.Parameter(dec_pos)
        self.enc_norm, self.dec_norm = enc_norm, dec_norm

    def forward(self, tokens=None, embeds=None, *, mode: str = "train", caches=None,
                cache_len=None, remat: bool = False):
        return forward(self, self.cfg, tokens, embeds, mode=mode, caches=caches,
                       cache_len=cache_len, remat=remat)

    def stacked_parameter_names(self) -> set[str]:
        """The parameters ``repro`` stacks on a leading axis of layers: every
        encoder and decoder layer's."""
        return {name for name, _ in self.named_parameters()
                if name.startswith(("enc_layers.", "dec_layers."))}


def init_params(gen: torch.Generator, cfg) -> EncDec:
    """Random parameters of ``cfg`` on ``gen``'s device, drawn as ``repro``
    draws them (the numbers differ: ``repro`` draws from a JAX key)."""
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device

    def norm():
        return make_norm_params(cfg.norm_type, cfg.d_model, dtype, device=dev)

    enc = [EncLayer(norm(), make_attention_params(gen, cfg, dtype), norm(),
                    make_mlp_params(gen, cfg, dtype)) for _ in range(cfg.n_enc_layers)]
    dec = [DecLayer(norm(), make_attention_params(gen, cfg, dtype), norm(),
                    make_attention_params(gen, cfg, dtype), norm(),
                    make_mlp_params(gen, cfg, dtype)) for _ in range(cfg.n_layers)]
    return EncDec(cfg, enc, dec, embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
                  embed_init(gen, DEC_POS, cfg.d_model, dtype), norm(), norm())


def _enc_layer(lp: EncLayer, cfg, x, positions):
    h = apply_norm(cfg.norm_type, lp.ln1, x)
    attn, _ = attention_block(lp.attn, cfg, h, positions=positions, mode="train", causal=False)
    x = x + attn
    h = apply_norm(cfg.norm_type, lp.ln2, x)
    return x + mlp_block(lp.mlp, cfg, h)


def encode(params: EncDec, cfg, frames, *, remat: bool = False):
    """frames: (B, S_enc, D) frame embeddings (frontend stub)."""
    b, s, d = frames.shape
    dtype = getattr(torch, cfg.dtype)
    x = frames.to(dtype) + sinusoidal_positions(s, d, dtype, frames.device)
    positions = torch.arange(s, device=frames.device)
    for lp in params.enc_layers:
        if remat:
            x = checkpoint(_enc_layer, lp, cfg, x, positions, use_reentrant=False)
        else:
            x = _enc_layer(lp, cfg, x, positions)
    return apply_norm(cfg.norm_type, params.enc_norm, x)


def _cross_kv(lp: DecLayer, cfg, enc_out):
    """Cross-attention K / V of one layer from the encoder output."""
    b, s, _ = enc_out.shape
    hd = cfg.head_dim_
    k = enc_out @ lp.cross_attn.wk
    v = enc_out @ lp.cross_attn.wv
    if cfg.qkv_bias:
        k, v = k + lp.cross_attn.bk, v + lp.cross_attn.bv
    return k.reshape(b, s, cfg.n_kv_heads, hd), v.reshape(b, s, cfg.n_kv_heads, hd)


def _dec_layer(lp: DecLayer, cfg, x, enc_out, positions, *, mode, cache, cache_len):
    """One decoder layer.  Returns (x, self-attention (k, v) or None, cross (k, v))."""
    h = apply_norm(cfg.norm_type, lp.ln1, x)
    attn, new_self = attention_block(lp.self_attn, cfg, h, positions=positions, mode=mode,
                                     cache=cache["self"] if cache is not None else None,
                                     cache_len=cache_len)
    x = x + attn
    h = apply_norm(cfg.norm_type, lp.ln_x, x)
    ck, cv = cache["cross"] if mode == "decode" else _cross_kv(lp, cfg, enc_out)
    cross, _ = attention_block(lp.cross_attn, cfg, h, positions=positions, mode="train",
                               kv_override=(ck, cv), causal=False)
    x = x + cross
    h = apply_norm(cfg.norm_type, lp.ln2, x)
    return x + mlp_block(lp.mlp, cfg, h), new_self, (ck, cv)


def _train_dec_layer(lp: DecLayer, cfg, x, enc_out, positions):
    return _dec_layer(lp, cfg, x, enc_out, positions, mode="train", cache=None,
                      cache_len=None)[0]


def decode_stack(params: EncDec, cfg, tokens, enc_out=None, *, mode: str = "train",
                 caches=None, cache_len=None, remat: bool = False):
    """tokens: (B, S_dec).  Returns (logits, new_caches).  Decode writes the
    new token's self-attention K / V into ``caches`` in place; ``remat``
    (train mode only) checkpoints each layer."""
    s = tokens.shape[1]
    x = embed_tokens(params.embed, tokens)
    if mode == "decode":
        positions = torch.full((s,), cache_len, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)
    x = x + params.dec_pos[torch.clamp(positions, 0, params.dec_pos.shape[0] - 1)]
    want_cache = mode in ("prefill", "decode")

    new_caches = []
    for i, lp in enumerate(params.dec_layers):
        if remat and mode == "train":
            x = checkpoint(_train_dec_layer, lp, cfg, x, enc_out, positions,
                           use_reentrant=False)
            continue
        cache = caches[i] if caches is not None else None
        x, new_self, cross_kv = _dec_layer(lp, cfg, x, enc_out, positions, mode=mode,
                                           cache=cache, cache_len=cache_len)
        new_caches.append({"self": new_self, "cross": cross_kv} if want_cache else None)

    if mode == "prefill":
        x = x[:, -1:]
    x = apply_norm(cfg.norm_type, params.dec_norm, x)
    logits = lm_head(x, params.embed, tie=True)
    return logits, (new_caches if want_cache else None)


def forward(params: EncDec, cfg, tokens=None, embeds=None, *, mode: str = "train",
            caches=None, cache_len=None, remat: bool = False):
    """The entry ``lm.forward`` has.  train / prefill: ``embeds`` are the
    encoder frames, ``tokens`` the decoder tokens; train's logits are (B,
    S_dec, V), prefill's the last position's (B, 1, V).  decode: ``tokens``
    (B, 1), the cross K / V in ``caches``.  ``remat`` (train mode only)
    checkpoints each encoder and decoder layer: the same values."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode":
        return decode_stack(params, cfg, tokens, None, mode=mode, caches=caches,
                            cache_len=cache_len)
    remat = remat and mode == "train"
    enc_out = encode(params, cfg, embeds, remat=remat)
    return decode_stack(params, cfg, tokens, enc_out, mode=mode, remat=remat)


def init_caches(cfg, batch: int, max_seq: int, enc_seq: int, *, device) -> list:
    dtype = getattr(torch, cfg.dtype)
    hd = cfg.head_dim_

    def zeros(seq):
        return torch.zeros((batch, seq, cfg.n_kv_heads, hd), dtype=dtype, device=device)

    return [{"self": (zeros(max_seq), zeros(max_seq)),
             "cross": (zeros(enc_seq), zeros(enc_seq))} for _ in range(cfg.n_layers)]
