"""qwen2.5-14b [dense] — GQA, QKV bias (a copy of ``repro.configs.qwen2_5_14b``).

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064  [hf:Qwen/Qwen2.5-0.5B; hf]

``qwen2.5-14b-hmatrix`` is the beyond-paper variant: the paper's H-matrix
block partition as the attention backend (``core/hattention.py``).

The numbers are ``repro``'s, unchanged, including ``rope_theta = 10000.0``
(the ``ArchConfig`` default; Qwen2.5's published value is 1e6) and the
``source`` string, which names the 0.5B checkpoint: both are kept so that
the port computes what the reference computes (ROADMAP §3).
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

ARCH_HMATRIX = ARCH.replace(name="qwen2.5-14b-hmatrix",
                            attention_backend="hmatrix",
                            h_c_leaf=512, h_rank=16)


def smoke() -> ArchConfig:
    return ARCH.replace(name="qwen2.5-14b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=192,
                        vocab_size=512, vocab_pad_multiple=16)


def smoke_hmatrix() -> ArchConfig:
    return ARCH_HMATRIX.replace(name="qwen2.5-14b-hmatrix-smoke", n_layers=2,
                                d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
                                vocab_size=512, vocab_pad_multiple=16,
                                h_c_leaf=64, h_rank=8)
