"""Bounding-box admissibility condition (paper §2.2, eq. (3)).

min(diam(Q_tau), diam(Q_sigma)) <= eta * dist(Q_tau, Q_sigma)

The device build decides the partition with these functions and must give
the host traversal's plan (``block_tree._admissible_np``, NumPy) bit for
bit: sums over the point dimension run in NumPy's order (dimension 0
first) on every device, and ``eta`` is a float32, as in the reference (a
float64 ``eta`` flips borderline blocks).
"""
from __future__ import annotations

import numpy as np
import torch


def _sum_dims(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, dimension 0 first."""
    acc = t[..., 0]
    for dim in range(1, t.shape[-1]):
        acc = acc + t[..., dim]
    return acc


def diam(bb_min: torch.Tensor, bb_max: torch.Tensor) -> torch.Tensor:
    """Euclidean diameter of axis-aligned boxes; shapes (..., d) -> (...)."""
    e = bb_max - bb_min
    return torch.sqrt(_sum_dims(e * e))


def dist(a_min: torch.Tensor, a_max: torch.Tensor,
         b_min: torch.Tensor, b_max: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between axis-aligned boxes (0 if overlapping)."""
    gap_ab = torch.clamp(a_min - b_max, min=0.0)
    gap_ba = torch.clamp(b_min - a_max, min=0.0)
    return torch.sqrt(_sum_dims(gap_ab * gap_ab + gap_ba * gap_ba))


def admissible(a_min, a_max, b_min, b_max, eta: float) -> torch.Tensor:
    """Vectorised eq. (3); broadcasts over leading dims."""
    eta32 = torch.tensor(np.float32(eta), dtype=torch.float32, device=a_min.device)
    return torch.minimum(diam(a_min, a_max), diam(b_min, b_max)) \
        <= eta32 * dist(a_min, a_max, b_min, b_max)
