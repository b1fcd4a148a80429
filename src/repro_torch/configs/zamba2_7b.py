"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]

Pattern: 5 Mamba2 blocks then one SHARED attention+MLP block (one weight set
reused at every occurrence, as in Zamba2); 81 layers = 13 full periods + 3
tail Mamba2 blocks.  ``sliding_window=4096`` makes the hybrid count as
sub-quadratic (``supports_long_context``), so long_500k is one of its cells.

A copy of ``repro.configs.zamba2_7b``, its numbers unchanged.  The shared
attention runs with backend ``full``: ``repro`` applies the window only for
backend ``swa``, so it is full causal attention, in the port as in
``repro`` (ROADMAP §3).
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    sliding_window=4096,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="arXiv:2411.15242; unverified",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="zamba2-7b-smoke", n_layers=7, d_model=64,
                        n_heads=2, n_kv_heads=2, d_ff=128, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16, sliding_window=32,
                        block_pattern=("mamba", "mamba", "shared_attn"),
                        vocab_size=512, vocab_pad_multiple=16)
