"""Architecture + input-shape configuration (a copy of ``repro.configs.base``).

Every architecture is a frozen ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) with the numbers of ``repro``'s module of
the same name, plus a reduced ``smoke()`` variant of the same family for
CPU tests.  ``--arch <id>`` resolution goes through ``registry.get_arch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # block structure: per-layer block kinds, cycled over n_layers
    block_pattern: tuple = ("dense",)
    # norms / activations / embeddings
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # attention
    attention_backend: str = "full"  # full | swa | hmatrix
    sliding_window: int = 0          # 0 = disabled; >0 for swa backend
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"           # none | audio_stub | vq_stub
    # H-matrix attention (the paper's technique in the LM stack)
    h_c_leaf: int = 512
    h_rank: int = 16
    # numerics
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    # provenance
    source: str = ""

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def layer_kinds(self) -> tuple:
        """Block kind per layer (pattern cycled to n_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("mamba", "mlstm", "slstm") for k in self.layer_kinds)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or attention-free) — eligible for long_500k."""
        if self.attention_backend in ("swa", "hmatrix"):
            return True
        kinds = set(self.layer_kinds)
        quadratic = {"dense", "moe"} & kinds
        if not quadratic and "shared_attn" not in kinds:
            return True
        # hybrid: a few shared/windowed attention blocks are fine if windowed
        if "shared_attn" in kinds and self.sliding_window > 0 and not quadratic:
            return True
        return False

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


# The assigned input-shape set (same for every LM-family arch).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524288, 1,   "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason) — long_500k skips for pure full-attention archs, per
    the assignment; enc-dec archs run decode via the decoder (cross-attending
    the long encoder output)."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, ("skipped: pure full-attention arch (O(S^2) prefill / "
                       "O(S) full cache at 500k); see DESIGN.md §7")
    return True, ""
