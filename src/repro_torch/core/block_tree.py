"""Block cluster tree construction by level-wise traversal (host, NumPy).

Port of the NumPy backend of ``repro.core.block_tree`` (paper Algorithm 1
with the count -> exclusive scan -> compact pattern of Algorithm 4).  The
per-level metadata is tiny, so it runs on the host from the tree's
bounding boxes; the result is the static plan every apply uses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .clustering import ClusterTree


@dataclass(frozen=True)
class HMatrixPlan:
    """Where each leaf block of the partition goes.

    aca_levels:   level -> (n_l, 2) int32 (row, col) cluster ids of the
                  admissible blocks at that level (rank-k factors).
    dense_blocks: (n_dense, 2) int32 leaf blocks evaluated directly.
    """

    aca_levels: dict
    dense_blocks: np.ndarray
    c_leaf: int
    n_pad: int
    n_levels: int
    eta: float

    @property
    def num_aca_blocks(self) -> int:
        return int(sum(v.shape[0] for v in self.aca_levels.values()))

    @property
    def num_dense_blocks(self) -> int:
        return int(self.dense_blocks.shape[0])

    def coverage_check(self) -> bool:
        """True iff the leaf blocks tile I_pad x I_pad exactly once."""
        total = 0
        for lvl, blocks in self.aca_levels.items():
            m = self.n_pad >> lvl
            total += int(blocks.shape[0]) * m * m
        total += self.num_dense_blocks * self.c_leaf * self.c_leaf
        return total == self.n_pad * self.n_pad


def _admissible_np(a_min, a_max, b_min, b_max, eta):
    d_a = np.sqrt(((a_max - a_min) ** 2).sum(-1))
    d_b = np.sqrt(((b_max - b_min) ** 2).sum(-1))
    gap_ab = np.maximum(0.0, a_min - b_max)
    gap_ba = np.maximum(0.0, b_min - a_max)
    dist = np.sqrt((gap_ab ** 2 + gap_ba ** 2).sum(-1))
    # eta stays float32, as in the reference: a float64 eta could flip
    # borderline blocks against the reference's plan
    return np.minimum(d_a, d_b) <= np.float32(eta) * dist


def build_block_tree(tree: ClusterTree, eta: float = 1.5) -> HMatrixPlan:
    """Level-wise traversal: count -> scan -> compact per level, on the host."""
    bb_min = [b.detach().cpu().numpy() for b in tree.bb_min]
    bb_max = [b.detach().cpu().numpy() for b in tree.bb_max]

    frontier_r = np.zeros((1,), np.int32)
    frontier_c = np.zeros((1,), np.int32)
    aca_levels: dict[int, np.ndarray] = {}
    dense_blocks = None

    for level in range(tree.n_levels + 1):
        bmn, bmx = bb_min[level], bb_max[level]
        adm = _admissible_np(bmn[frontier_r], bmx[frontier_r],
                             bmn[frontier_c], bmx[frontier_c], eta)
        adm_idx = np.nonzero(adm)[0]
        if adm_idx.shape[0] > 0:
            aca_levels[level] = np.stack(
                [frontier_r[adm_idx], frontier_c[adm_idx]], axis=1).astype(np.int32)

        if level == tree.n_levels:
            dense_idx = np.nonzero(~adm)[0]
            dense_blocks = np.stack(
                [frontier_r[dense_idx], frontier_c[dense_idx]], axis=1).astype(np.int32)
            break

        child_count = np.where(adm, 0, 4).astype(np.int32)
        if int(child_count.sum()) == 0:
            dense_blocks = np.zeros((0, 2), np.int32)
            break
        split_idx = np.nonzero(~adm)[0]
        r, c = frontier_r[split_idx], frontier_c[split_idx]
        quad = np.arange(4, dtype=np.int32)
        frontier_r = (2 * r[:, None] + (quad[None, :] // 2)).reshape(-1)
        frontier_c = (2 * c[:, None] + (quad[None, :] % 2)).reshape(-1)

    if dense_blocks is None:
        dense_blocks = np.zeros((0, 2), np.int32)
    return HMatrixPlan(aca_levels=aca_levels, dense_blocks=dense_blocks,
                       c_leaf=tree.c_leaf, n_pad=tree.n_pad,
                       n_levels=tree.n_levels, eta=eta)
