"""Plain PyTorch version of the Morton encode: ``repro_torch.core.morton``."""
from __future__ import annotations

import torch

from ...core.morton import morton_encode


def morton_encode_ref(coords: torch.Tensor) -> torch.Tensor:
    """coords: (N, d) in [0, 1]^d -> (N,) int64 codes, ``(hi << 32) | lo``."""
    return morton_encode(coords)
