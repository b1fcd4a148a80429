"""chameleon-34b [vlm] — early-fusion, VQ image tokens (frontend stubbed).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536  [arXiv:2405.09818; unverified]
Early fusion means image content arrives as VQ token ids inside the same
vocabulary — the VQ tokenizer is a STUB; ``input_specs()`` provides mixed
text/image token ids.

A copy of ``repro.configs.chameleon_34b``, its numbers unchanged.
``repro`` applies no qk-norm (the comment below names it); neither does
the port (ROADMAP §3).
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    frontend="vq_stub",
    mlp_type="swiglu",
    norm_type="layernorm",           # chameleon uses LN + qk-norm for stability
    source="arXiv:2405.09818; unverified",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="chameleon-34b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=192,
                        vocab_size=512, vocab_pad_multiple=16)
