"""Model API: arch config -> (init, forward, caches) + parameter counting."""
from __future__ import annotations

from .._device import resolve_device
from . import lm


def get_model(cfg, device=None) -> dict:
    """The functions of the decoder-only family for ``cfg`` on ``device``
    (``cuda`` unless the caller asks; raises without a card):
    ``init_params(generator)`` (the generator must live on that device),
    ``forward(params, **kw)`` and ``init_caches(batch, max_seq)``."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not yet ported "
                                  "to repro_torch")
    dev = resolve_device(device)

    def init_params(gen):
        if gen.device.type != dev.type:
            raise ValueError(f"init_params: the generator lives on {gen.device}, the model on "
                             f"{dev}")
        return lm.init_params(gen, cfg)

    return {
        "init_params": init_params,
        "forward": lambda params, **kw: lm.forward(params, cfg, **kw),
        "init_caches": lambda batch, max_seq: lm.init_caches(cfg, batch, max_seq, device=dev),
    }


def count_params(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def count_params_analytic(cfg) -> dict:
    """Analytic parameter counts from the config (no allocation).

    Returns {"total": N, "active": N_active} — active < total for MoE
    (experts_per_token of num_experts participate per token).
    """
    d, hd = cfg.d_model, cfg.head_dim_
    v = cfg.padded_vocab
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    mlp_dense = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    moe_expert = 3 * d * cfg.d_ff
    mamba_d_inner = cfg.ssm_expand * d
    mamba_h = mamba_d_inner // cfg.ssm_head_dim if cfg.ssm_head_dim else 0
    mamba = d * (2 * mamba_d_inner + 2 * cfg.ssm_state + mamba_h) + mamba_d_inner * d
    d_inner_m = 2 * d
    mlstm = d * 2 * d_inner_m + 3 * d_inner_m * d_inner_m + \
        d_inner_m * 2 * cfg.n_heads + d_inner_m * d
    slstm = d * 4 * d + cfg.n_heads * (d // cfg.n_heads) * 4 * (d // cfg.n_heads) + d * d

    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += d * v
    active = total
    seen_shared = False
    for kind in cfg.layer_kinds:
        if kind == "dense":
            total += attn + mlp_dense; active += attn + mlp_dense
        elif kind == "moe":
            total += attn + cfg.num_experts * moe_expert + d * cfg.num_experts
            active += attn + cfg.experts_per_token * moe_expert + d * cfg.num_experts
        elif kind == "shared_attn":
            if not seen_shared:
                total += attn + mlp_dense
                seen_shared = True
            active += attn + mlp_dense  # applied every occurrence
        elif kind == "mamba":
            total += mamba; active += mamba
        elif kind == "mlstm":
            total += mlstm; active += mlstm
        elif kind == "slstm":
            total += slstm; active += slstm
    if cfg.is_encoder_decoder:
        total += cfg.n_enc_layers * (attn + 2 * d * cfg.d_ff)
        active += cfg.n_enc_layers * (attn + 2 * d * cfg.d_ff)
        # decoder cross-attention + learned decoder position table
        total += cfg.n_layers * attn + 4096 * d
        active += cfg.n_layers * attn + 4096 * d
    return {"total": int(total), "active": int(active)}
