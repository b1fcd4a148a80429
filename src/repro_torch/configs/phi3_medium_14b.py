"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352  [arXiv:2404.14219; unverified]

A copy of ``repro.configs.phi3_medium_14b``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="arXiv:2404.14219; unverified",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="phi3-medium-14b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=192,
                        vocab_size=512, vocab_pad_multiple=16)
