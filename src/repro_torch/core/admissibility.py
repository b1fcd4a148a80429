"""Bounding-box admissibility condition (paper §2.2, eq. (3)).

min(diam(Q_tau), diam(Q_sigma)) <= eta * dist(Q_tau, Q_sigma)
"""
from __future__ import annotations

import torch


def diam(bb_min: torch.Tensor, bb_max: torch.Tensor) -> torch.Tensor:
    """Euclidean diameter of axis-aligned boxes; shapes (..., d) -> (...)."""
    e = bb_max - bb_min
    return torch.sqrt((e * e).sum(-1))


def dist(a_min: torch.Tensor, a_max: torch.Tensor,
         b_min: torch.Tensor, b_max: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between axis-aligned boxes (0 if overlapping)."""
    gap_ab = torch.clamp(a_min - b_max, min=0.0)
    gap_ba = torch.clamp(b_min - a_max, min=0.0)
    return torch.sqrt((gap_ab * gap_ab + gap_ba * gap_ba).sum(-1))


def admissible(a_min, a_max, b_min, b_max, eta: float) -> torch.Tensor:
    """Vectorised eq. (3); broadcasts over leading dims."""
    return torch.minimum(diam(a_min, a_max), diam(b_min, b_max)) \
        <= eta * dist(a_min, a_max, b_min, b_max)
