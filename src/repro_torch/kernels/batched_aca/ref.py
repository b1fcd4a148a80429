"""Plain PyTorch version of the batched low-rank product U (V^T X)."""
from __future__ import annotations

import torch


def batched_lowrank_matmat_ref(u: torch.Tensor, v: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """u: (B, m, k), v: (B, n, k), x: (B, n, R) -> U (V^T X): (B, m, R)."""
    t = torch.bmm(v.transpose(1, 2), x)
    return torch.bmm(u, t)
