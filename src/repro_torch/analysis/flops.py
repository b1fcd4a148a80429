"""Analytic FLOPs (``repro.analysis.flops`` in the port): MODEL_FLOPS = 6 N D
(dense) or 6 N_active D (MoE).

D = tokens processed by the step:
  train:   global_batch * seq_len      (x3 for fwd+bwd is already the 6N)
  prefill: global_batch * seq_len      (forward only -> 2*N*D)
  decode:  global_batch * 1            (forward only -> 2*N*D)
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig
from ..models.api import count_params_analytic


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n = count_params_analytic(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.tokens_per_step
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens_per_step
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def attention_extra_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Score/value FLOPs not captured by 6ND (quadratic term), forward only.

    full: 4 * B * S^2 * H * Dh per layer; swa: window-limited; hmatrix:
    O(S * (c_leaf + k log)) per layer.  Multiplied by 3 for training.
    """
    hd = cfg.head_dim_
    h = cfg.n_heads
    b, s = shape.global_batch, shape.seq_len
    attn_layers = sum(1 for k in cfg.layer_kinds if k in ("dense", "moe", "shared_attn"))
    if cfg.is_encoder_decoder:
        attn_layers = cfg.n_enc_layers + 2 * cfg.n_layers
    if shape.kind == "decode":
        return 4.0 * b * 1 * s * h * hd * attn_layers
    if cfg.attention_backend == "swa" and cfg.sliding_window:
        per_layer = 4.0 * b * s * min(cfg.sliding_window, s) * h * hd
    elif cfg.attention_backend == "hmatrix":
        per_layer = 4.0 * b * s * (2 * cfg.h_c_leaf) * h * hd
    else:
        per_layer = 4.0 * b * s * s * h * hd
    mult = 3.0 if shape.kind == "train" else 1.0
    return per_layer * attn_layers * mult
