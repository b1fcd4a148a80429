"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

32 experts divide the 16-way model axis -> expert-parallel eligible.

A copy of ``repro.configs.granite_moe_1b``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("moe",),
    num_experts=32,
    experts_per_token=8,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="granite-moe-1b-a400m-smoke", n_layers=2,
                        d_model=64, n_heads=2, n_kv_heads=1, d_ff=64,
                        num_experts=4, experts_per_token=2,
                        vocab_size=512, vocab_pad_multiple=16)
