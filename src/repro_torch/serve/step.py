"""LM serving steps (the LM part of ``repro.serve.step``).

  * ``prefill_step(params, tokens)``  tokens (B, S) -> logits (B, 1, V) of
    the last position, caches (one (k, v) per layer, each (B, S, Hkv, D));
  * ``decode_step(params, tokens, caches, cache_len)``  tokens (B, 1) +
    caches of capacity > cache_len -> logits (B, 1, V), the same caches with
    slot ``cache_len`` written in place.

Both run under ``torch.inference_mode``.  ``repro``'s ``HMatrixServer`` /
``HMatrixSolveServer`` are not ported yet.
"""
from __future__ import annotations

import torch

from ..models import lm


def _require_decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder serving is not yet ported")


def make_prefill_step(cfg):
    _require_decoder_only(cfg)

    @torch.inference_mode()
    def prefill_step(params, tokens):
        return lm.forward(params, cfg, tokens, mode="prefill")

    return prefill_step


def make_decode_step(cfg):
    _require_decoder_only(cfg)

    @torch.inference_mode()
    def decode_step(params, tokens, caches, cache_len: int):
        return lm.forward(params, cfg, tokens, mode="decode", caches=caches,
                          cache_len=cache_len)

    return decode_step


def greedy_sample(logits, vocab_size: int):
    """Greedy over the REAL vocab (padded entries masked) -> int64 ids."""
    lf = logits.float()
    mask = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
    lf = torch.where(mask, lf, torch.full_like(lf, -torch.inf))
    return torch.argmax(lf, dim=-1)
