"""H-matrix assembly and fast application (paper §2.5, §5.4, Algorithm 3).

Port of ``repro.core.hmatrix``.  ``build_hmatrix`` builds the cluster tree,
the block tree and (with ``precompute``, the paper's P mode) the ACA
factors.  ``make_apply`` returns ``apply(X) = H X`` for ``x: (N,)`` or a
panel ``X: (N, R)``:

  * for every admissible level group, the batched rank-k product
    ``U (V^T X)`` (kernel ``batched_lowrank_matmat``, level entry: it reads
    X in place and adds each row cluster's blocks into Z itself); without
    stored factors (NP mode) the group's factors are first recomputed by
    the batched ACA (kernel ``batched_aca``) in every apply;
  * for the inadmissible leaves, the batched on-the-fly dense product
    ``phi(rows, cols) X`` (kernel ``batched_kernel_matmat``, or
    ``batched_kernel_matvec`` for a single column), the block never stored.

Block results are added into their row clusters by a deterministic
segment sum: a row cluster appears in several blocks of one group, and the
order of those additions is fixed at build time (``BlockGroup``), so two
applies on the card are bit-identical.  The dense leaves go through
``_scatter_rows``; the low-rank kernel sums in the same order itself.

Each stage (the dense leaves, each admissible level group) runs in batches
of whole row clusters whose working set stays under ``APPLY_BATCH_BYTES``,
planned at build time (``BlockGroup.batches``).  A row cluster's blocks
stay in one batch and in their order, so a batched apply gives the bits of
a one-batch apply.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from .. import obs
from .._device import as_f32, require_full_fp32, resolve_device
from .aca import batched_aca
from .block_tree import HMatrixPlan, build_block_tree
from .clustering import ClusterTree, build_cluster_tree, permute_from_tree, permute_to_tree
from .factor_store import FactorStore, recompress_store
from .geometry import get_kernel, kernel_name_of


APPLY_BATCH_BYTES = 48 << 30
"""Device bytes one batch of an apply stage may hold.

The paper batches the apply's linear algebra so that a batch's arrays fit
on the card beside the H-matrix (§6.5: at most ``bs_dense`` = 2^27 dense
and ``bs_aca`` = 2^25 ACA entries a batch).  Here a batch is a run of whole
row clusters of one stage, the dense leaves or one admissible level group,
and its working set is :func:`batch_bytes` at 64 columns.  Sized for the
H100's 80 GB (79.6 GiB): above the largest stage of the paper's problems at
N = 2^20 (the Matern 3-D dense leaves, 44.9 GiB), so those run every stage
in one launch, and about 31 GiB below the card for what an apply holds
beside a batch at N = 2^24 (points, index tables and the panels in flight,
4 GiB a 64-column panel buffer).
"""
PLANNED_COLUMNS = 64      # the panel width batches are sized for: the servers' widest panel
LOWRANK_ROWS_A_SPLIT = 2048   # rows of V a V^T X CTA sums (csrc/lowrank_matmat.cu: CHUNK)


@dataclass(frozen=True)
class BlockGroup:
    """Index tensors of one group of equally sized blocks, on the device.

    rows, cols:  (B,) row / column cluster of each block.
    out_rows:    (U,) the distinct row clusters, ascending.
    table:       (U, S) block indices per distinct row cluster in block
                 order, padded with B (an all-zero block appended at apply).
    offsets, blocks: the table without its pads: distinct row u's blocks
                 are ``blocks[offsets[u]:offsets[u + 1]]``, in table order;
                 (U + 1,) and (B,).
    longest_first: (U,) the distinct rows by decreasing block count (the
                 low-rank kernel's launch order, so the longest start first).
    members:     in a batch, (B,) its blocks' indices in the whole group
                 (their stored factors), ascending; None in a whole group.
    batches:     the group's batches of whole row clusters, taken by
                 decreasing block count; empty when the group is one batch.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    out_rows: torch.Tensor
    table: torch.Tensor
    offsets: torch.Tensor
    blocks: torch.Tensor
    longest_first: torch.Tensor
    members: torch.Tensor | None = None
    batches: tuple = ()

    @property
    def size(self) -> int:
        """Blocks in the group (host-side, from the shape)."""
        return int(self.rows.shape[0])

    def parts(self) -> tuple:
        """The batches an apply runs, in order: ``batches``, or the group."""
        return self.batches or (self,)


def block_group(blocks: np.ndarray, device, members: np.ndarray | None = None) -> BlockGroup:
    """Host-side row -> blocks lists of one (B, 2) block array, in stable order."""
    rows = np.asarray(blocks[:, 0], np.int64)
    n_blocks = rows.shape[0]
    order = np.argsort(rows, kind="stable")
    out_rows, counts = np.unique(rows, return_counts=True)
    width = int(counts.max()) if counts.size else 0
    table = np.full((out_rows.shape[0], width), n_blocks, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) if counts.size else counts
    for s in range(width):
        has = counts > s
        table[has, s] = order[starts[has] + s]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    longest_first = np.argsort(-counts, kind="stable").astype(np.int64)
    dev = torch.device(device)
    return BlockGroup(rows=torch.from_numpy(rows).to(dev),
                      cols=torch.from_numpy(np.asarray(blocks[:, 1], np.int64)).to(dev),
                      out_rows=torch.from_numpy(out_rows).to(dev),
                      table=torch.from_numpy(table).to(dev),
                      offsets=torch.from_numpy(offsets).to(dev),
                      blocks=torch.from_numpy(order.astype(np.int64)).to(dev),
                      longest_first=torch.from_numpy(longest_first).to(dev),
                      members=None if members is None
                      else torch.from_numpy(np.asarray(members, np.int64)).to(dev))


def batch_bytes(size: int, blocks: int, rows: int, k: int | None) -> int:
    """Device bytes a batch of ``blocks`` blocks of ``size`` x ``size`` over
    ``rows`` distinct row clusters holds on a ``PLANNED_COLUMNS``-wide panel.

    Dense leaves (``k`` None): #2's results and ``_scatter_rows``' copy of
    them (2 per block), its cluster sums and their temporaries (4 per row
    cluster), each ``size`` x 64 floats.  A level group (rank ``k``): U and V
    (2 size k floats a block, regenerated in NP mode, gathered in P mode),
    the ACA's streamed scratch (k (2 size + 1)) and #4's partials (k x 64 per
    split of ``LOWRANK_ROWS_A_SPLIT`` rows, and one).
    """
    w = PLANNED_COLUMNS
    if k is None:
        return 4 * size * w * (2 * blocks + 4 * rows)
    splits = -(-size // LOWRANK_ROWS_A_SPLIT)
    return 4 * blocks * k * (2 * size + (2 * size + 1) + w * (1 + splits))


def _row_runs(cost: np.ndarray, counts: np.ndarray, budget: int, max_blocks: int) -> list:
    """Runs ``(u0, u1)`` of a sequence of row clusters (``cost`` bytes and
    ``counts`` blocks each) into the fewest runs of about equal cost under
    ``budget`` bytes and ``max_blocks`` blocks.  A row cluster is never
    split: one over the budget is a run alone."""
    n_rows = cost.shape[0]
    cum = np.concatenate([[0], np.cumsum(cost)])
    cum_blocks = np.concatenate([[0], np.cumsum(counts)])
    n = max(1, -(-int(cum[-1]) // budget), -(-int(cum_blocks[-1]) // max_blocks))
    while n < n_rows:
        cuts = np.searchsorted(cum[1:], cum[-1] * np.arange(1, n) / n) + 1
        bounds = np.unique(np.concatenate([[0], cuts, [n_rows]]))
        runs = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
        if all(cum[u1] - cum[u0] <= budget and cum_blocks[u1] - cum_blocks[u0] <= max_blocks
               for u0, u1 in runs):
            return runs
        n += 1
    return [(u, u + 1) for u in range(n_rows)]


def batched_group(blocks: np.ndarray, device, size: int, k: int | None) -> BlockGroup:
    """``block_group`` of ``blocks`` with its batches: at most
    ``APPLY_BATCH_BYTES`` (``batch_bytes``: ``k`` None for the dense leaves,
    the ACA rank for a level group) and the kernels' ``MAX_BATCH`` blocks."""
    from ..kernels.batched_aca.kernel import MAX_BATCH
    g = block_group(blocks, device)
    rows = np.asarray(blocks[:, 0], np.int64)
    if rows.size == 0:
        return g
    out_rows, counts = np.unique(rows, return_counts=True)
    # row clusters by decreasing block count: the scatter's table is as wide
    # as a batch's longest row cluster, so clusters of like length share one
    order = np.argsort(-counts, kind="stable")
    runs = _row_runs(batch_bytes(size, counts[order], 1, k), counts[order], APPLY_BATCH_BYTES,
                     MAX_BATCH)
    if len(runs) == 1:
        return g
    parts = []
    for u0, u1 in runs:
        members = np.nonzero(np.isin(rows, out_rows[order[u0:u1]]))[0]
        parts.append(block_group(blocks[members], device, members=members))
    return replace(g, batches=tuple(parts))


def block_groups(plan: HMatrixPlan, device, k: int) -> dict:
    """``BlockGroup`` per ACA level (int keys) and for the dense leaves
    ("dense"), each with its batches for rank-``k`` factors.

    Every cluster id is checked against its level here, once: the ACA
    kernel reads clusters by id and reports a bad one only as NaN factors.
    """
    for lv, blocks in list(plan.aca_levels.items()) + [(plan.n_levels, plan.dense_blocks)]:
        if blocks.size and (blocks.min() < 0 or blocks.max() >= 1 << lv):
            raise ValueError(f"plan: cluster ids of level {lv} outside [0, 2^{lv})")
    groups = {lv: batched_group(b, device, plan.n_pad >> lv, k)
              for lv, b in plan.aca_levels.items()}
    groups["dense"] = batched_group(plan.dense_blocks, device, plan.c_leaf, None)
    return groups


@dataclass(frozen=True)
class HMatrix:
    tree: ClusterTree
    plan: HMatrixPlan
    kernel: Callable
    kernel_name: str
    k: int
    factors: FactorStore | None        # None in NP mode
    groups: dict

    @property
    def shape(self):
        return (self.tree.n, self.tree.n)

    @property
    def device(self) -> torch.device:
        return self.tree.points.device

    def memory_report(self) -> dict:
        """Bytes held by the representation (metadata vs factors)."""
        factor_bytes = self.factors.nbytes()["total"] if self.factors is not None else 0
        meta = sum(v.nbytes for v in self.plan.aca_levels.values())
        meta += self.plan.dense_blocks.nbytes
        return {"factor_bytes": int(factor_bytes), "meta_bytes": int(meta),
                "dense_equivalent_bytes": int(self.tree.n * self.tree.n * 4)}


def _cluster_points(points: torch.Tensor, level: int, ids: torch.Tensor) -> torch.Tensor:
    """Points of clusters ``ids`` at ``level``: (B, m, d)."""
    m = points.shape[0] >> level
    return points.reshape(1 << level, m, -1)[ids]


def level_factors(tree: ClusterTree, level: int, g: BlockGroup, kernel: Callable, k: int):
    """ACA factors ``(U, V)`` of one admissible level group (``core.aca``)."""
    return batched_aca(_cluster_points(tree.points, level, g.rows),
                       _cluster_points(tree.points, level, g.cols), kernel, k)


def compute_factors(tree: ClusterTree, plan: HMatrixPlan, kernel: Callable, k: int,
                    groups: dict) -> dict:
    """Precompute ACA factors for every admissible level group (P mode)."""
    return {level: level_factors(tree, level, groups[level], kernel, k)
            for level in plan.aca_levels}


def build_hmatrix(coords, kernel: str | Callable = "gaussian", k: int = 16,
                  c_leaf: int = 256, eta: float = 1.5, precompute: bool = False,
                  recompress_tol: float | None = None, device=None) -> HMatrix:
    """Full H-matrix construction (the paper's setup phase) on ``device``.

    ``coords`` is an (N, d) array or tensor.  ``device=None`` means CUDA and
    raises ``RuntimeError`` when there is no card.  With ``precompute`` the
    factors come as a :class:`FactorStore`; ``recompress_tol`` then
    SVD-truncates every level group to that relative tolerance
    (``recompress_store``).  The reference's host builder truncates with its
    QR + SVD oracle; here the dispatcher decides, so on the CPU both take the
    oracle and on the card the recompression kernel runs.
    """
    dev = resolve_device(device)
    require_full_fp32("build_hmatrix", dev)
    kname = kernel_name_of(kernel)
    kfn = get_kernel(kname)
    tree = build_cluster_tree(as_f32(coords, dev), c_leaf=c_leaf)
    plan = build_block_tree(tree, eta=eta)
    groups = block_groups(plan, dev, k)
    factors = None
    if precompute:
        factors = FactorStore.from_factors(compute_factors(tree, plan, kfn, k, groups),
                                           plan=plan)
        if recompress_tol is not None:
            recompress_store(factors, recompress_tol)
    return HMatrix(tree=tree, plan=plan, kernel=kfn, kernel_name=kname, k=k,
                   factors=factors, groups=groups)


def diagonal_blocks(hm: HMatrix, leaves_per_chunk: int | None = None) -> torch.Tensor:
    """Dense diagonal leaf blocks ``A[i*c:(i+1)*c, i*c:(i+1)*c]`` in tree order.

    Returns ``(n_leaf, c, c)``.  Pad rows / columns of a ragged last leaf are
    zero with a unit diagonal, so each block is the principal submatrix of
    its real rows plus decoupled unit pad rows.  The blocks are computed a
    chunk of leaves at a time (about 256 MiB of entries per chunk): the
    expansion-form distances need several temporaries of a chunk's size.
    """
    plan = hm.plan
    c = plan.c_leaf
    n_leaf = plan.n_pad // c
    pts = hm.tree.points.reshape(n_leaf, c, -1)
    if leaves_per_chunk is None:
        leaves_per_chunk = max(1, (256 << 20) // (4 * c * c))
    out = torch.empty((n_leaf, c, c), dtype=pts.dtype, device=pts.device)
    for i0 in range(0, n_leaf, leaves_per_chunk):
        p = pts[i0:i0 + leaves_per_chunk]
        out[i0:i0 + p.shape[0]] = hm.kernel(p, p)
    n = hm.tree.n
    if n == plan.n_pad:
        return out
    valid = (torch.arange(plan.n_pad, device=pts.device) < n).reshape(n_leaf, c)
    mask = valid[:, :, None] & valid[:, None, :]
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))
    eye = torch.eye(c, dtype=out.dtype, device=out.device)[None]
    return out + eye * (~valid)[:, :, None].to(out.dtype)


# ---------------------------------------------------------------------------
# Fast application.  The padded operand is a 2-D (n_pad, R) panel (R == 1
# for a vector) and every block batch is a (B, m, R) product.
# ---------------------------------------------------------------------------


def _scatter_rows(z_pad: torch.Tensor, y: torch.Tensor, g: BlockGroup) -> torch.Tensor:
    """z_pad[row cluster] += sum of its blocks' results, in block order."""
    n_clusters = z_pad.shape[0] // y.shape[1]
    y_ext = torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])
    acc = y_ext[g.table[:, 0]]
    for s in range(1, g.table.shape[1]):
        acc = acc + y_ext[g.table[:, s]]
    zl = z_pad.reshape(n_clusters, y.shape[1], -1)
    zl[g.out_rows] = zl[g.out_rows] + acc
    return z_pad


def _aca_level_apply(g: BlockGroup, U, V, x_pad: torch.Tensor, z_pad: torch.Tensor,
                     use_kernels: bool):
    """z_pad[row cluster] += its blocks' U (V^T X), in table order.  The
    kernel reads X in place and writes each row once; the plain version
    gathers, multiplies and scatters (the same bits on the card)."""
    if use_kernels:
        from ..kernels.batched_aca.ops import batched_lowrank_matmat_level as lowrank
    else:
        from ..kernels.batched_aca.ref import batched_lowrank_matmat_level_ref as lowrank
    return lowrank(U, V, x_pad, g.cols, g, z_pad)


def _dense_apply_points(points: torch.Tensor, plan: HMatrixPlan, kernel: Callable,
                        g: BlockGroup, x_pad: torch.Tensor, z_pad: torch.Tensor,
                        use_kernels: bool):
    """The dense leaves, a batch at a time: their points and panel slices
    are read by leaf id from ``points`` and ``x_pad`` (the kernel reads them
    in place; the plain versions gather them and store the (B, c, c)
    blocks), and each batch's results are added into Z before the next."""
    if g.size == 0:
        return z_pad
    c = plan.c_leaf
    kname = kernel_name_of(kernel)
    if use_kernels:
        from ..kernels.batched_dense_matvec.ops import (
            batched_kernel_matmat_level as matmat, batched_kernel_matvec_level as matvec)
    else:
        from ..kernels.batched_dense_matvec.ref import (
            batched_kernel_matmat_level_ref as matmat, batched_kernel_matvec_level_ref as matvec)
    parts = g.parts()
    for part in parts:
        with obs.device_span("apply.dense", x_pad, blocks=part.size, batches=len(parts)):
            if x_pad.shape[1] == 1:
                y = matvec(points, part.rows, part.cols, x_pad[:, 0], c, kname)[:, :, None]
            else:
                y = matmat(points, part.rows, part.cols, x_pad.contiguous(), c, kname)
        with obs.device_span("apply.scatter", x_pad, blocks=part.size):
            z_pad = _scatter_rows(z_pad, y, part)
        del y       # freed before the next batch's results are made
    return z_pad


def _batch_factors(points: torch.Tensor, level: int, part: BlockGroup, kernel: Callable,
                   k: int, factors, use_kernels: bool):
    """``(U, V)`` of one batch of a level group: the stored factors (P mode;
    a batch of a group gathers its own), else regenerated by the batched
    ACA (NP mode; the ``apply.aca`` span)."""
    if factors is not None:
        U, V = factors[level]
        return (U, V) if part.members is None else (U[part.members], V[part.members])
    with obs.device_span("apply.aca", points, blocks=part.size):
        if use_kernels:
            from ..kernels.batched_aca.ops import batched_aca_level
            return batched_aca_level(points, part.rows, part.cols, level, kernel_name_of(kernel),
                                     k)
        return batched_aca(_cluster_points(points, level, part.rows),
                           _cluster_points(points, level, part.cols), kernel, k)


def tree_kernel_name(kernel: Callable) -> str:
    """``repro``'s name of a kernel callable: ``gaussian_kernel`` and
    ``matern_kernel`` are ``gaussian`` and ``matern``, any other callable
    keeps its ``__name__`` (``gaussian`` without one).  The port's own
    lookup is ``geometry.kernel_name_of``, which raises on a callable it has
    not registered."""
    name = getattr(kernel, "__name__", "gaussian")
    return {"gaussian_kernel": "gaussian", "matern_kernel": "matern"}.get(name, name)


def apply_in_tree_order(tree: ClusterTree, plan: HMatrixPlan, kernel: Callable, k: int,
                        use_kernels: bool, points: torch.Tensor, factors, groups: dict,
                        x_pad: torch.Tensor) -> torch.Tensor:
    """``H @ x_pad`` on a TREE-ordered padded panel ``(n_pad, R)``.

    Shared by :func:`make_apply` (which adds the permutations) and the PCG
    loop of ``repro_torch.solve``.  ``factors`` None is NP mode: every apply
    recomputes each level group's factors, a batch at a time, through the
    batched ACA kernel with ``use_kernels`` (direct-difference entries, as
    the kernels compute them) and through ``core.aca`` without (the kernel
    function ``kernel``, as the P-mode build computes them).  A panel of one
    column sends the dense leaves through the vector kernel.  Every stage
    runs in the batches its ``BlockGroup`` holds.  Traced
    (``repro_torch.obs``), the device spans ``apply.lowrank`` (Z's zeros and
    every level group; ``batches`` its batches), ``apply.dense`` and
    ``apply.scatter`` (one each a dense batch; ``blocks``, and ``batches`` on
    ``apply.dense``) bracket the stages, and ``apply.aca`` each batch's
    regeneration in NP mode.
    """
    levels = [(level, groups[level].parts()) for level in plan.aca_levels]
    with obs.device_span("apply.lowrank", x_pad, batches=sum(len(p) for _, p in levels)):
        x_pad = x_pad.contiguous()
        z_pad = torch.zeros_like(x_pad)
        for level, parts in levels:
            for part in parts:
                U, V = _batch_factors(points, level, part, kernel, k, factors, use_kernels)
                z_pad = _aca_level_apply(part, U, V, x_pad, z_pad, use_kernels)
                del U, V    # freed before the next batch's factors are made
    return _dense_apply_points(points, plan, kernel, groups["dense"], x_pad, z_pad,
                               use_kernels)


def operand(x, hm: HMatrix, what: str = "operand") -> torch.Tensor:
    """``x`` as a float32 tensor on ``hm.device``, checked to be ``(N,)`` or
    ``(N, R)``: the explicit check the reference keeps (jnp gathers clamp)."""
    x = as_f32(x, hm.device)
    n = hm.tree.n
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"{what} shape {tuple(x.shape)} incompatible with "
                         f"H-matrix of size ({n}, {n})")
    return x


def panel_entry(hm: HMatrix, run: Callable) -> Callable:
    """``apply(x)`` around ``run(x2)``, which maps an ``(N, R)`` panel with
    R >= 1 to ``H x2``: the operand checks, the vector contract (an ``(N,)``
    operand runs as one column) and the empty panel."""

    def apply(x) -> torch.Tensor:
        require_full_fp32("apply", hm.device)
        x = operand(x, hm)
        if x.ndim == 1:
            return run(x[:, None])[:, 0]
        if x.shape[1] == 0:
            return torch.zeros_like(x)
        return run(x)

    return apply


def make_apply(hm: HMatrix, use_kernels: bool = True, mesh=None,
               shard: str = "rows") -> Callable:
    """``apply(x) -> Z = H x`` for ``x: (N,)`` or ``(N, R)`` in the ORIGINAL
    point order; the result has the same shape and lies on ``hm.device``.

    ``use_kernels`` routes the two hot loops through the kernel wrappers
    (CUDA kernels for CUDA tensors, their plain versions on the CPU);
    ``False`` calls the plain versions on any device: the same function,
    summed in another order (the plain path).  With a ``mesh``
    (``repro_torch.parallel.make_panel_mesh``) the work is sharded over it,
    by blocks (``shard="rows"``, the default) or by panel columns
    (``"columns"``; see ``repro_torch.parallel.hshard``).
    """
    if mesh is not None:
        from ..parallel.hshard import make_sharded_apply
        return make_sharded_apply(hm, mesh, shard=shard, use_kernels=use_kernels)
    tree, plan = hm.tree, hm.plan

    def _apply(x2: torch.Tensor) -> torch.Tensor:
        with obs.device_span("apply.permute_in", x2):
            x_pad = permute_to_tree(tree, x2)
        z_pad = apply_in_tree_order(tree, plan, hm.kernel, hm.k, use_kernels,
                                    tree.points, hm.factors, hm.groups, x_pad)
        with obs.device_span("apply.permute_out", x2):
            return permute_from_tree(tree, z_pad)

    return panel_entry(hm, _apply)


def make_matvec(hm: HMatrix, use_kernels: bool = True) -> Callable:
    """Single-vector convenience wrapper over :func:`make_apply`."""
    return make_apply(hm, use_kernels=use_kernels)


def dense_matvec_oracle(coords, kernel: str | Callable, x, device=None) -> torch.Tensor:
    """O(N^2) oracle (x may be (N,) or (N, R)); test use only."""
    dev = resolve_device(device)
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    pts = as_f32(coords, dev)
    return kfn(pts, pts) @ as_f32(x, dev)
