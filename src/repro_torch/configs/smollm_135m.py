"""smollm-135m [dense] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152  [hf:HuggingFaceTB/SmolLM-135M; hf]
9 heads do not divide the 16-way model axis -> sequence-sharded attention TP
(auto mode, see parallel/mesh_ctx.py).

A copy of ``repro.configs.smollm_135m``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="smollm-135m-smoke", n_layers=2, d_model=48,
                        n_heads=3, n_kv_heads=1, d_ff=128,
                        vocab_size=512, vocab_pad_multiple=16)
