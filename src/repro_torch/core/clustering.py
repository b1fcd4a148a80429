"""Cardinality-based clustering (CBC) on the Morton-sorted point array.

Port of ``repro.core.clustering``.  N is padded to a power of two by
repeating the last sorted point, so the cluster tree is perfectly balanced:
cluster ``i`` at level ``l`` is the contiguous range ``[i*m, (i+1)*m)`` with
``m = n_pad >> l``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .morton import morton_sort


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class ClusterTree:
    """Implicit balanced cluster tree over the Morton-sorted points.

    points:   (n_pad, d) Morton-sorted, padded coordinates.
    perm:     (n,) int64, ``sorted[i] = original[perm[i]]``.
    n, n_pad, c_leaf, n_levels: sizes; leaves are level ``n_levels``.
    bb_min, bb_max: tuples over levels of (2^l, d) bounding boxes.
    """

    points: torch.Tensor
    perm: torch.Tensor
    n: int
    n_pad: int
    c_leaf: int
    n_levels: int
    bb_min: tuple
    bb_max: tuple

    def cluster_size(self, level: int) -> int:
        return self.n_pad >> level

    def num_clusters(self, level: int) -> int:
        return 1 << level

    def cluster_range(self, level: int, idx: int) -> tuple[int, int]:
        m = self.cluster_size(level)
        return idx * m, (idx + 1) * m


def _level_bounding_boxes(points: torch.Tensor, n_levels: int):
    """All-level bounding boxes, bottom-up by reshape-reduce."""
    n_pad, d = points.shape
    m_leaf = n_pad >> n_levels
    cur_min = points.reshape(1 << n_levels, m_leaf, d).amin(dim=1)
    cur_max = points.reshape(1 << n_levels, m_leaf, d).amax(dim=1)
    mins, maxs = [cur_min], [cur_max]
    for _ in range(n_levels):
        cur_min = cur_min.reshape(-1, 2, d).amin(dim=1)
        cur_max = cur_max.reshape(-1, 2, d).amax(dim=1)
        mins.append(cur_min)
        maxs.append(cur_max)
    mins.reverse()
    maxs.reverse()
    return tuple(mins), tuple(maxs)


def build_cluster_tree(coords: torch.Tensor, c_leaf: int = 256) -> ClusterTree:
    """Morton-sort, pad, and build the implicit balanced cluster tree.

    ``coords`` is an (N, d) float32 tensor; the tree lives on its device.
    The Morton code is taken on the normalised unit box (out-of-range
    coordinates would all clip to one code); geometry keeps the true
    coordinates.
    """
    n, d = coords.shape
    if c_leaf & (c_leaf - 1):
        raise ValueError("c_leaf must be a power of two")
    lo, hi = coords.amin(dim=0), coords.amax(dim=0)
    unit = (coords - lo) / torch.clamp(hi - lo, min=1e-30)
    _, perm = morton_sort(unit)
    sorted_pts = coords[perm]
    n_pad = max(next_pow2(n), c_leaf)
    if n_pad > n:
        pad = sorted_pts[-1:].expand(n_pad - n, d)
        sorted_pts = torch.cat([sorted_pts, pad], dim=0)
    n_levels = (n_pad // c_leaf).bit_length() - 1
    bb_min, bb_max = _level_bounding_boxes(sorted_pts, n_levels)
    return ClusterTree(points=sorted_pts.contiguous(), perm=perm, n=n,
                       n_pad=n_pad, c_leaf=c_leaf, n_levels=n_levels,
                       bb_min=bb_min, bb_max=bb_max)


def permute_to_tree(tree: ClusterTree, x: torch.Tensor) -> torch.Tensor:
    """Operand in original ordering -> padded tree (Morton) ordering."""
    xp = x[tree.perm]
    if tree.n_pad > tree.n:
        xp = torch.cat([xp, xp.new_zeros((tree.n_pad - tree.n,) + tuple(x.shape[1:]))])
    return xp


def permute_from_tree(tree: ClusterTree, z_pad: torch.Tensor) -> torch.Tensor:
    """Padded tree-ordered result -> original ordering (drops the pad)."""
    z = z_pad.new_zeros((tree.n,) + tuple(z_pad.shape[1:]))
    z[tree.perm] = z_pad[: tree.n]
    return z
