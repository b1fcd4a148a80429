"""whisper-tiny [audio] — enc-dec, conv frontend stubbed per the assignment.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865  [arXiv:2212.04356; unverified]
The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S, d_model).

A copy of ``repro.configs.whisper_tiny``, its numbers unchanged.
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                      # decoder layers
    n_enc_layers=4,                  # encoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    frontend="audio_stub",
    mlp_type="gelu",
    norm_type="layernorm",
    qkv_bias=True,
    rope_theta=0.0,                  # sinusoidal/learned positions, no RoPE
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)


def smoke() -> ArchConfig:
    return ARCH.replace(name="whisper-tiny-smoke", n_layers=2, n_enc_layers=2,
                        d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                        vocab_size=512, vocab_pad_multiple=16)
