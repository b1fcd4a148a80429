"""Block-level task-DAG derivation for tiled H-Cholesky (H-LU of an SPD
H-matrix).

A copy of ``repro.harith.taskgraph`` (NumPy only) on the port's own
``HMatrixPlan``: the tile grid, the DAG, the schedule and the solve tables
are equal to the reference's array for array.

Everything else in this repo executes in LEVEL ORDER: construction,
matvec, and the fused PCG all batch the blocks of one tree level because
no block depends on another.  Factorization breaks that pattern — a
Schur update ``A_ij -= L_it L_jt^T`` cannot run before the triangular
solves that produce ``L_it``/``L_jt``, which cannot run before the
diagonal factorization of column ``t``.  Following the semi-automatic
task-graph construction of Börm/Christophersen/Kriemann (1911.07531),
this module derives the dependency DAG *from the block partition* and
levels it into ready-sets that the executor (:mod:`repro_torch.harith.hlu`)
launches as fixed-shape batches.

Tile flattening (BLR view)
--------------------------
The H-partition is flattened to the leaf-tile grid: ``T = n_pad /
c_leaf`` tiles per side, each tile ``(i, j)`` of the lower triangle
either *dense* (an inadmissible leaf from ``plan.dense_blocks``) or
*low-rank* (a ``(c, k)`` row/column slice of the admissible ancestor
block covering it: block ``(i // q, j // q)`` at level ``l`` with ``q =
2^(n_levels - l)`` leaves per cluster, offsets ``i % q`` / ``j % q``).
Slicing a rank-``k`` ancestor yields rank-``<= k`` tiles, so flattening
loses no accuracy; it costs some compression (each tile carries its own
panel copy) and buys fixed ``(c, k)`` shapes for every task — the price
the paper's batching patterns always pay.

Fill-in promotion
-----------------
A dense x dense Schur product is a full ``(c, c)`` update; if its target
tile is low-rank the update cannot be absorbed at rank ``k`` (classic
H-LU handles this with a costly dense->low-rank conversion per update).
Instead the grid PROMOTES such targets to dense at plan time, iterating
to a fixed point (a promoted tile is itself a dense producer for every
later elimination step).  Dense producers live near the diagonal, so
promotion stays a local band in practice.  A degenerate admissible
*diagonal* block (possible with duplicated points, where a cluster box
collapses to a point) is likewise promoted: Cholesky needs dense pivots.

Task DAG
--------
For elimination step ``t`` (Cholesky, ``A = L L^T``):

    FACTOR(t):      L_tt       = chol(A_tt)
    TRSM(i, t):     L_it       = A_it L_tt^{-T}          (i > t)
    SCHUR(i, j, t): A_ij      -= L_it L_jt^T             (i >= j > t)

with edges  FACTOR(t) <- SCHUR(t, t, t-1);  TRSM(i, t) <- FACTOR(t),
SCHUR(i, t, t-1);  SCHUR(i, j, t) <- TRSM(i, t), TRSM(j, t),
SCHUR(i, j, t-1).  The SCHUR chain on each target serializes its
accumulation — that is what makes the factorization bit-reproducible
run-to-run (no atomics, no reduction-order races; DESIGN choice shared
with the deterministic work queues of the construction path).  ASAP
levelling of this DAG yields the strict rotation ``3t`` / ``3t+1`` /
``3t+2``; the schedule merges each triple into one STEP per ``t`` whose
slots are padded to power-of-two batch sizes, and consecutive steps with
identical padded signatures are grouped into RUNS so the executor scans
each run as one compiled loop body.

Scratch padding
---------------
Padded lanes in every slot point at a dedicated all-zero scratch tile
(dense id ``n_dense``, low-rank id ``n_lr``): they gather zeros, compute
zeros, and scatter zeros back onto the scratch tile, so padding is
mathematically inert by construction (property-tested).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.block_tree import HMatrixPlan

EMPTY, DENSE, LOWRANK = 0, 1, 2

# Schur slot names, in execution order inside one step.
SLOTS = ("trsm_d", "trsm_l", "sdd", "sll_d", "sll_l", "smx_d", "smx_l")


@dataclass(frozen=True)
class TileGrid:
    """Lower-triangle leaf-tile view of an H-partition.

    kind[i, j]  : EMPTY (upper triangle) | DENSE | LOWRANK, (T, T) int8.
    dense_id    : (T, T) int32 id into the dense tile buffer, -1 elsewhere.
    lr_id       : (T, T) int32 id into the low-rank panel buffer, -1 elsewhere.
    dense_pairs : (n_dense, 2) tile coordinates per dense id.
    lr_pairs    : (n_lr, 2) tile coordinates per low-rank id.
    lr_source   : (n_lr, 4) int32 (level, block_idx, row_off, col_off) —
                  where in ``plan.aca_levels`` each tile's panel slice lives.
    promoted    : (n_promoted,) int32 dense ids created by fill-in promotion
                  (initialized by direct kernel evaluation, not ACA).
    """

    t: int
    c: int
    n_levels: int
    kind: np.ndarray
    dense_id: np.ndarray
    lr_id: np.ndarray
    dense_pairs: np.ndarray
    lr_pairs: np.ndarray
    lr_source: np.ndarray
    promoted: np.ndarray

    @property
    def n_dense(self) -> int:
        return int(self.dense_pairs.shape[0])

    @property
    def n_lr(self) -> int:
        return int(self.lr_pairs.shape[0])

    @property
    def diag_ids(self) -> np.ndarray:
        """Dense ids of the T diagonal tiles, in elimination order."""
        return self.dense_id[np.arange(self.t), np.arange(self.t)]


def build_tile_grid(plan: HMatrixPlan) -> TileGrid:
    """Flatten ``plan`` to the lower-triangle leaf-tile grid.

    Covers every tile ``(i, j), j <= i`` exactly once (the block partition
    tiles the index square, and admissibility is symmetric so the lower
    triangle is covered by blocks with ``row >= col``), then runs the
    fill-in promotion fixed point described in the module docstring.
    """
    t_tiles = plan.n_pad // plan.c_leaf
    kind = np.zeros((t_tiles, t_tiles), np.int8)
    src = {}                               # (i, j) -> (level, blk, roff, coff)
    forced_dense = set()                   # promoted before id assignment

    for (r, c) in np.asarray(plan.dense_blocks):
        if c <= r:
            kind[r, c] = DENSE

    for level, blocks in plan.aca_levels.items():
        q = 1 << (plan.n_levels - level)
        for b_idx, (r, c) in enumerate(np.asarray(blocks)):
            if r < c:
                continue                   # upper-triangle mirror
            if r == c:
                # degenerate admissible diagonal block (duplicate points):
                # Cholesky needs dense pivots, promote its lower wedge
                for i in range(r * q, (r + 1) * q):
                    for j in range(c * q, i + 1):
                        kind[i, j] = DENSE
                        forced_dense.add((i, j))
                continue
            for roff in range(q):
                for coff in range(q):
                    i, j = r * q + roff, c * q + coff
                    kind[i, j] = LOWRANK
                    src[(i, j)] = (level, b_idx, roff, coff)

    lower = np.tri(t_tiles, dtype=bool)
    if not (kind[lower] != EMPTY).all():
        missing = np.argwhere((kind == EMPTY) & lower)
        raise ValueError(f"plan does not cover lower-triangle tiles "
                         f"{missing[:4].tolist()}... — partition incomplete")

    # --- fill-in promotion fixed point: one increasing-t sweep suffices,
    # because promoting (i, j) only changes products at steps > t (it becomes
    # a producer at elimination step j > t).
    rows = np.arange(t_tiles)
    for t in range(t_tiles - 1):
        col_dense = (kind[:, t] == DENSE) & (rows > t)
        hit = np.outer(col_dense, col_dense) & lower
        newly = hit & (kind == LOWRANK)
        for i, j in np.argwhere(newly):
            kind[i, j] = DENSE
            forced_dense.add((int(i), int(j)))
            src.pop((int(i), int(j)), None)

    dense_id = np.full((t_tiles, t_tiles), -1, np.int32)
    lr_id = np.full((t_tiles, t_tiles), -1, np.int32)
    dense_pairs, lr_pairs, lr_source, promoted = [], [], [], []
    for i in range(t_tiles):
        for j in range(i + 1):
            if kind[i, j] == DENSE:
                dense_id[i, j] = len(dense_pairs)
                if (i, j) in forced_dense:
                    promoted.append(len(dense_pairs))
                dense_pairs.append((i, j))
            else:
                lr_id[i, j] = len(lr_pairs)
                lr_pairs.append((i, j))
                lr_source.append(src[(i, j)])

    return TileGrid(
        t=t_tiles, c=plan.c_leaf, n_levels=plan.n_levels, kind=kind,
        dense_id=dense_id, lr_id=lr_id,
        dense_pairs=np.asarray(dense_pairs, np.int32).reshape(-1, 2),
        lr_pairs=np.asarray(lr_pairs, np.int32).reshape(-1, 2),
        lr_source=np.asarray(lr_source, np.int32).reshape(-1, 4),
        promoted=np.asarray(sorted(promoted), np.int32))


@dataclass(frozen=True)
class Task:
    """One node of the H-Cholesky DAG (see module docstring for the math)."""

    kind: str            # "factor" | "trsm" | "schur"
    i: int
    j: int
    t: int
    deps: tuple          # indices into HLUTaskGraph.tasks


@dataclass(frozen=True)
class HLUTaskGraph:
    """Levelled task DAG: ``ready_sets[l]`` lists the task indices whose
    dependencies all live in strictly earlier ready-sets (ASAP levels)."""

    grid: TileGrid
    tasks: tuple         # tuple[Task, ...] in creation (topological) order
    levels: np.ndarray   # (n_tasks,) int32 ASAP level per task
    ready_sets: tuple    # tuple[tuple[int, ...], ...]


def build_taskgraph(plan_or_grid) -> HLUTaskGraph:
    """Derive the dependency DAG and level it into ready-sets."""
    grid = (plan_or_grid if isinstance(plan_or_grid, TileGrid)
            else build_tile_grid(plan_or_grid))
    t_tiles = grid.t
    tasks: list[Task] = []
    index: dict[tuple, int] = {}

    def add(kind, i, j, t, deps):
        index[(kind, i, j, t)] = len(tasks)
        tasks.append(Task(kind, i, j, t, tuple(deps)))

    for t in range(t_tiles):
        prev = [index[("schur", t, t, t - 1)]] if t else []
        add("factor", t, t, t, prev)
        fac = index[("factor", t, t, t)]
        for i in range(t + 1, t_tiles):
            deps = [fac] + ([index[("schur", i, t, t - 1)]] if t else [])
            add("trsm", i, t, t, deps)
        for j in range(t + 1, t_tiles):
            for i in range(j, t_tiles):
                deps = [index[("trsm", i, t, t)], index[("trsm", j, t, t)]]
                if t:
                    deps.append(index[("schur", i, j, t - 1)])
                add("schur", i, j, t, deps)

    # ASAP levelling: creation order is topological (every dep index is
    # smaller), so one forward pass computes longest-path levels.
    levels = np.zeros(len(tasks), np.int32)
    for n, task in enumerate(tasks):
        if task.deps:
            levels[n] = 1 + max(levels[d] for d in task.deps)
    n_levels = int(levels.max()) + 1 if len(tasks) else 0
    ready: list[list[int]] = [[] for _ in range(n_levels)]
    for n, lv in enumerate(levels):
        ready[lv].append(n)
    return HLUTaskGraph(grid=grid, tasks=tuple(tasks), levels=levels,
                        ready_sets=tuple(tuple(r) for r in ready))


# ---------------------------------------------------------------------------
# Schedule: merged per-t steps, power-of-two padded slots, signature runs
# ---------------------------------------------------------------------------


def _pow2_pad(n: int) -> int:
    return 0 if n == 0 else 1 << (n - 1).bit_length()


def _pad_rows(rows: list, width: int, pad_row: tuple) -> np.ndarray:
    out = list(rows) + [pad_row] * (_pow2_pad(len(rows)) - len(rows))
    return np.asarray(out, np.int32).reshape(-1, width)


@dataclass(frozen=True)
class ScheduleStep:
    """The merged (FACTOR, TRSM*, SCHUR*) work of one elimination step.

    Slot layouts (all int32, first dim power-of-two padded with scratch):
      trsm_d : (B, 1) dense ids of dense tiles (i, t)
      trsm_l : (B, 1) low-rank ids of low-rank tiles (i, t)
      sdd    : (B, 3) [dense src (i,t), dense src (j,t), dense target]
      sll_*  : (B, 3) [lr src (i,t), lr src (j,t), target]
      smx_*  : (B, 4) [dense src, lr src, swap, target]
               swap=0: contribution = (D v) u^T   (dense producer is row i)
               swap=1: contribution = u (D v)^T   (dense producer is row j)
    ``*_d`` slots target dense ids, ``*_l`` slots target low-rank ids.
    """

    t: int
    fac_id: int
    trsm_d: np.ndarray
    trsm_l: np.ndarray
    sdd: np.ndarray
    sll_d: np.ndarray
    sll_l: np.ndarray
    smx_d: np.ndarray
    smx_l: np.ndarray

    @property
    def signature(self) -> tuple:
        return tuple(int(getattr(self, s).shape[0]) for s in SLOTS)


@dataclass(frozen=True)
class HLUSchedule:
    """All steps plus the run partition the executor scans over."""

    grid: TileGrid
    steps: tuple         # tuple[ScheduleStep, ...], one per elimination t
    runs: tuple          # tuple[(signature, (step_idx, ...)), ...]

    @property
    def n_runs(self) -> int:
        return len(self.runs)


def build_schedule(grid: TileGrid) -> HLUSchedule:
    """Merge each DAG level triple into one step and group signature runs.

    The ASAP levels of :func:`build_taskgraph` rotate strictly FACTOR ->
    TRSM -> SCHUR per elimination step, so the merge is exact: within a
    step the executor sequences the three stages through functional
    buffer updates, preserving every DAG edge.
    """
    t_tiles = grid.t
    kind, d_id, l_id = grid.kind, grid.dense_id, grid.lr_id
    d_pad, l_pad = grid.n_dense, grid.n_lr      # scratch ids
    steps = []
    for t in range(t_tiles):
        trsm_d = [(int(d_id[i, t]),) for i in range(t + 1, t_tiles)
                  if kind[i, t] == DENSE]
        trsm_l = [(int(l_id[i, t]),) for i in range(t + 1, t_tiles)
                  if kind[i, t] == LOWRANK]
        sdd, sll_d, sll_l, smx_d, smx_l = [], [], [], [], []
        for j in range(t + 1, t_tiles):
            for i in range(j, t_tiles):
                ki, kj, kt = kind[i, t], kind[j, t], kind[i, j]
                tgt = int(d_id[i, j]) if kt == DENSE else int(l_id[i, j])
                if ki == DENSE and kj == DENSE:
                    # promotion fixed point guarantees a dense target
                    sdd.append((int(d_id[i, t]), int(d_id[j, t]), tgt))
                elif ki == LOWRANK and kj == LOWRANK:
                    row = (int(l_id[i, t]), int(l_id[j, t]), tgt)
                    (sll_d if kt == DENSE else sll_l).append(row)
                elif ki == DENSE:           # dl: (D_i v_j) u_j^T
                    row = (int(d_id[i, t]), int(l_id[j, t]), 0, tgt)
                    (smx_d if kt == DENSE else smx_l).append(row)
                else:                       # ld: u_i (D_j v_i)^T
                    row = (int(d_id[j, t]), int(l_id[i, t]), 1, tgt)
                    (smx_d if kt == DENSE else smx_l).append(row)
        steps.append(ScheduleStep(
            t=t, fac_id=int(d_id[t, t]),
            trsm_d=_pad_rows(trsm_d, 1, (d_pad,)),
            trsm_l=_pad_rows(trsm_l, 1, (l_pad,)),
            sdd=_pad_rows(sdd, 3, (d_pad, d_pad, d_pad)),
            sll_d=_pad_rows(sll_d, 3, (l_pad, l_pad, d_pad)),
            sll_l=_pad_rows(sll_l, 3, (l_pad, l_pad, l_pad)),
            smx_d=_pad_rows(smx_d, 4, (d_pad, l_pad, 0, d_pad)),
            smx_l=_pad_rows(smx_l, 4, (d_pad, l_pad, 0, l_pad))))

    runs: list[tuple] = []
    for idx, step in enumerate(steps):
        if runs and runs[-1][0] == step.signature:
            runs[-1] = (step.signature, runs[-1][1] + (idx,))
        else:
            runs.append((step.signature, (idx,)))
    return HLUSchedule(grid=grid, steps=tuple(steps), runs=tuple(runs))


# ---------------------------------------------------------------------------
# Solve tables: static per-row / per-column gather plans for the
# block-triangular substitutions (consumed by hlu.hlu_solve_panels)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SolveTables:
    """Padded gather tables for forward (row) and backward (column) sweeps.

    row_dense / row_lr : (T, P) ids of off-diagonal tiles (t, j), j < t —
                         the forward sweep's per-row producers.
    row_dense_col / row_lr_col : (T, P) the matching column indices j.
    col_dense / col_lr : (T, P) ids of tiles (i, t), i > t — the backward
                         sweep's per-column producers; *_row holds i.
    Padding points at the scratch tile (zero) and column/row index 0 — the
    gathered zero tile multiplies whatever panel it touches into zeros.
    """

    diag_ids: np.ndarray
    row_dense: np.ndarray
    row_dense_col: np.ndarray
    row_lr: np.ndarray
    row_lr_col: np.ndarray
    col_dense: np.ndarray
    col_dense_row: np.ndarray
    col_lr: np.ndarray
    col_lr_row: np.ndarray


def _pad_table(rows_per_t: list, pad_id: int) -> tuple:
    width = max((len(r) for r in rows_per_t), default=0)
    width = max(width, 1)                  # keep gathers static even if empty
    ids = np.full((len(rows_per_t), width), pad_id, np.int32)
    pos = np.zeros((len(rows_per_t), width), np.int32)
    for t, row in enumerate(rows_per_t):
        for p, (tile_id, where) in enumerate(row):
            ids[t, p] = tile_id
            pos[t, p] = where
    return ids, pos


def build_solve_tables(grid: TileGrid) -> SolveTables:
    t_tiles, kind = grid.t, grid.kind
    row_d = [[(int(grid.dense_id[t, j]), j) for j in range(t)
              if kind[t, j] == DENSE] for t in range(t_tiles)]
    row_l = [[(int(grid.lr_id[t, j]), j) for j in range(t)
              if kind[t, j] == LOWRANK] for t in range(t_tiles)]
    col_d = [[(int(grid.dense_id[i, t]), i) for i in range(t + 1, t_tiles)
              if kind[i, t] == DENSE] for t in range(t_tiles)]
    col_l = [[(int(grid.lr_id[i, t]), i) for i in range(t + 1, t_tiles)
              if kind[i, t] == LOWRANK] for t in range(t_tiles)]
    rd, rdc = _pad_table(row_d, grid.n_dense)
    rl, rlc = _pad_table(row_l, grid.n_lr)
    cd, cdr = _pad_table(col_d, grid.n_dense)
    cl, clr = _pad_table(col_l, grid.n_lr)
    return SolveTables(diag_ids=np.asarray(grid.diag_ids, np.int32),
                       row_dense=rd, row_dense_col=rdc,
                       row_lr=rl, row_lr_col=rlc,
                       col_dense=cd, col_dense_row=cdr,
                       col_lr=cl, col_lr_row=clr)
