"""Z-order (Morton) space-filling curve — the paper's §4.4 spatial structure.

Port of ``repro.core.morton``.  The reference builds the code as two uint32
halves and sorts lexicographically; at most 63 interleaved bits fit one
non-negative int64, so here the code is ``(hi << 32) | lo`` in one int64 and
a stable sort on it gives the reference's order.
"""
from __future__ import annotations

import torch


def bits_per_dim(d: int) -> int:
    """Quantisation bits per dimension; total interleaved bits <= 63."""
    return min(32, 63 // d)


def quantize(coords: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Fixed-point coordinates in [0, 2^n_bits) as int64 (coords in [0,1]^d).

    The scale is float32(2^n_bits - 1), which rounds UP to 2^n_bits for
    n_bits >= 25: clamp after the cast, as the reference does.
    """
    scale = torch.tensor(2.0 ** n_bits - 1.0, dtype=torch.float32)
    q = torch.clamp(coords, 0.0, 1.0) * scale.to(coords.device)
    return torch.clamp(q.to(torch.int64), max=2 ** n_bits - 1)


def morton_encode(coords: torch.Tensor) -> torch.Tensor:
    """Morton codes of (N, d) points in [0,1]^d as one int64 per point.

    Bit ``b`` of dimension ``dim`` lands at position ``b*d + dim``
    (dimension 0 is the least significant of each group).
    """
    n, d = coords.shape
    nb = bits_per_dim(d)
    fx = quantize(coords, nb)
    code = torch.zeros((n,), dtype=torch.int64, device=coords.device)
    for b in range(nb):
        for dim in range(d):
            code |= ((fx[:, dim] >> b) & 1) << (b * d + dim)
    return code


def morton_order(coords: torch.Tensor) -> torch.Tensor:
    """Permutation sorting points along the Z-order curve (stable)."""
    return torch.sort(morton_encode(coords), stable=True).indices


def morton_sort(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort points along the Z-curve; returns (sorted_coords, permutation)."""
    order = morton_order(coords)
    return coords[order], order
