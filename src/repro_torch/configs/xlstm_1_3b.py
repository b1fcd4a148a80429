"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 ratio, per the xLSTM paper).

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304  [arXiv:2405.04517; unverified]
d_ff=0: no separate MLP — the mLSTM block carries a 2x internal expansion.
Attention-free -> long_500k runs natively (constant-size recurrent state).
sLSTM blocks are truly recurrent (hidden-state feedback) -> sequential
loop over time; mLSTM uses the chunk-parallel matrix-memory form.

A copy of ``repro.configs.xlstm_1_3b``, its numbers unchanged.  These
widths count 3.43 B parameters (``count_params_analytic``), not 1.3 B;
the port keeps ``repro``'s numbers (ROADMAP §3).
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_chunk=256,
    mlp_type="swiglu",               # unused (d_ff=0), kept for dataclass completeness
    norm_type="layernorm",
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="xlstm-1.3b-smoke", n_layers=4, d_model=64,
                        n_heads=2, n_kv_heads=2,
                        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
                        ssm_chunk=16, vocab_size=512, vocab_pad_multiple=16)
