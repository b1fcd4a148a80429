"""gemma-7b [dense] — GeGLU, head_dim=256.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000  [arXiv:2403.08295; hf]

A copy of ``repro.configs.gemma_7b``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="gemma-7b-smoke", n_layers=2, d_model=64,
                        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=256,
                        vocab_size=512, vocab_pad_multiple=16)
