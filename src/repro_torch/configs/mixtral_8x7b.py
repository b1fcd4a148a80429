"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2
[arXiv:2401.04088; hf]

SWA (window 4096) makes the arch sub-quadratic -> long_500k runs natively.

A copy of ``repro.configs.mixtral_8x7b``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("moe",),
    num_experts=8,
    experts_per_token=2,
    attention_backend="swa",
    sliding_window=4096,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="arXiv:2401.04088; hf",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="mixtral-8x7b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128,
                        num_experts=4, experts_per_token=2, sliding_window=64,
                        vocab_size=512, vocab_pad_multiple=16)
