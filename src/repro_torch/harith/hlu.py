"""Batched H-Cholesky execution of the task-DAG schedule.

Port of ``repro.harith.hlu``.  :func:`factorize_hlu` evaluates every
lower-triangle tile into three packed buffers and then runs the schedule's
elimination steps in order.  ``repro`` compiles the whole factorization into
one program with a ``lax.scan`` per signature run; here a Python loop walks
the runs and their steps, and each run's stacked index tables go to the
device once, so a step issues launches and reads nothing back.  One step:

    FACTOR  the diagonal tile          (kernel batched_block_cholesky)
    TRSM    the elimination column     (kernel batched_trsm_panels): dense
            tiles as transposed panels, low-rank tiles by their V factor
            only (``u v^T L_tt^{-T} = u (L_tt^{-1} v)^T``), one ``L_tt`` read
            with batch stride 0
    SCHUR   the trailing submatrix: dense targets by ``C - A B^T`` (kernel
            batched_schur_dense), low-rank targets by concatenation and
            re-truncation to the working width ``kp`` (kernel
            batched_recompress at width ``2 kp``)

The buffers are updated in place (``repro``'s are functional).  Every slot
is padded to a power of two onto an all-zero scratch tile, whose lanes
compute zeros, so a step's scatter writes each real target once and the
scratch tile only with zeros.  The Schur chain serializes each target's
accumulation and no kernel uses atomics: the factorization is
bit-reproducible run to run, as ``repro``'s is.

The factorized matrix is the pad-decoupled tree-ordered system
``[[A + sigma^2 I, 0], [0, I]]``, as in ``core.hmatrix.diagonal_blocks``.
Its dense tiles carry the entries the port's apply gives its dense leaves:
the direct-difference phi of ``kernels/phi.py`` (kernels #1 / #2 and their
plain versions), where ``repro`` evaluates them, like its plain apply, in
the expansion form of ``core.geometry``.  Each package so factors the
operator it applies.  The two forms differ by up to 3.8e-4 per entry at
coordinates of 32 (ROADMAP §3) against a shift of 1e-2: on an H100 the
H-LU preconditioned PCG of the regression problem (N = 2^15 on a domain of
32, sigma^2 = 1e-2, tol 1e-3) took 3 iterations with expansion-form tiles
and 1 with these, as ``repro``'s plain path takes.

:func:`hlu_solve_panels` applies ``(L L^T)^{-1}`` to a tree-ordered panel
with a forward and a backward block sweep over the padded gather tables of
``taskgraph.build_solve_tables``.  Its products and the diagonal solves are
outside any Pallas kernel in ``repro`` and stay PyTorch calls here.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import require_full_fp32
from ..core.aca import batched_aca
from ..core.factor_store import effective_ranks
from ..kernels.phi import phi_matrix
from .taskgraph import (SLOTS, HLUSchedule, SolveTables, TileGrid, build_schedule,
                        build_solve_tables, build_tile_grid)


class HLUMeta:
    """Static structure of one factorization: grid, schedule, solve tables,
    widths and the shift."""

    __slots__ = ("grid", "schedule", "tables", "kp", "tol", "sigma2", "n", "n_pad")

    def __init__(self, grid: TileGrid, schedule: HLUSchedule, tables: SolveTables, kp: int,
                 tol: float, sigma2: float, n: int, n_pad: int):
        self.grid = grid
        self.schedule = schedule
        self.tables = tables
        self.kp = kp
        self.tol = tol
        self.sigma2 = sigma2
        self.n = n
        self.n_pad = n_pad


class HLUFactors:
    """Approximate H-Cholesky factors as three packed tile buffers.

    dense:     (n_dense + 1, c, c) factored diagonal tiles (lower Cholesky),
               dense off-diagonal ``L`` tiles and a trailing zero scratch tile.
    ulr, vlr:  (n_lr + 1, c, kp) low-rank ``L`` tiles ``L_ij = u v^T`` and the
               scratch panel.
    """

    __slots__ = ("dense", "ulr", "vlr", "meta", "_solve_idx")

    def __init__(self, dense: torch.Tensor, ulr: torch.Tensor, vlr: torch.Tensor,
                 meta: HLUMeta):
        self.dense = dense
        self.ulr = ulr
        self.vlr = vlr
        self.meta = meta
        self._solve_idx = None

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (self.dense, self.ulr, self.vlr)))

    def rank_stats(self) -> dict:
        """Effective-rank distribution of the low-rank L tiles (syncs)."""
        if self.ulr.shape[0] <= 1:
            return {"max": 0, "mean": 0.0, "kp": int(self.meta.kp)}
        ranks = effective_ranks(self.ulr[:-1], self.vlr[:-1]).double()
        return {"max": int(ranks.max()), "mean": float(ranks.mean()), "kp": int(self.meta.kp)}

    def solve_index(self) -> dict:
        """The solve tables as int64 tensors on the factors' device (made once)."""
        if self._solve_idx is None:
            tb, dev = self.meta.tables, self.dense.device
            self._solve_idx = {name: torch.from_numpy(np.asarray(getattr(tb, name), np.int64))
                               .to(dev)
                               for name in ("row_dense", "row_dense_col", "row_lr", "row_lr_col",
                                            "col_dense", "col_dense_row", "col_lr",
                                            "col_lr_row")}
        return self._solve_idx


def _kernels(use_kernels: bool):
    if use_kernels:
        from ..kernels.batched_block_solve.ops import batched_block_cholesky
        from ..kernels.batched_schur_update.ops import (batched_schur_dense,
                                                        batched_schur_retruncate)
        from ..kernels.batched_trsm_lowrank.ops import batched_trsm_panels
        return (batched_block_cholesky, batched_trsm_panels, batched_schur_dense,
                batched_schur_retruncate)
    from ..kernels.batched_block_solve.ref import batched_block_cholesky_ref
    from ..kernels.batched_schur_update.ref import (batched_schur_dense_ref,
                                                    batched_schur_retruncate_ref)
    from ..kernels.batched_trsm_lowrank.ref import batched_trsm_panels_ref
    return (batched_block_cholesky_ref, batched_trsm_panels_ref, batched_schur_dense_ref,
            batched_schur_retruncate_ref)


def _long(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(dev)


def _init_tiles(meta: HLUMeta, plan, kernel, kernel_name: str, k: int, points: torch.Tensor,
                factors):
    """Evaluate / gather every lower-triangle tile into the packed buffers.

    Dense tiles (inadmissible leaves and promoted fill-in) are the
    direct-difference phi of the apply's dense leaves (module docstring), a
    chunk of tiles at a time (about 256 MiB of entries); low-rank tiles are
    ``(c, k)`` slices of their admissible ancestor's factors: the stored
    ones (P mode), or in NP mode the plain ACA of
    ``core.aca`` on exactly the blocks the lower triangle needs (the
    expansion-form entries of the P-mode build, as ``repro`` does).  Pad
    rows / columns are zero and pad diagonal entries 1.
    """
    grid, kp, sigma2 = meta.grid, meta.kp, meta.sigma2
    t_tiles, c = grid.t, grid.c
    dev, dtype = points.device, points.dtype
    pts = points.reshape(t_tiles, c, -1)
    valid = None
    if meta.n < meta.n_pad:
        valid = (torch.arange(meta.n_pad, device=dev) < meta.n).reshape(t_tiles, c)

    ii, jj = _long(grid.dense_pairs[:, 0], dev), _long(grid.dense_pairs[:, 1], dev)
    n_dense = grid.n_dense
    dense = torch.zeros((n_dense + 1, c, c), dtype=dtype, device=dev)
    tiles_per_chunk = max(1, (256 << 20) // (4 * c * c))
    eye = torch.eye(c, dtype=dtype, device=dev)
    for i0 in range(0, n_dense, tiles_per_chunk):
        ci, cj = ii[i0:i0 + tiles_per_chunk], jj[i0:i0 + tiles_per_chunk]
        blocks = phi_matrix(pts[ci], pts[cj], kernel_name)
        if valid is not None:
            mask = valid[ci][:, :, None] & valid[cj][:, None, :]
            blocks = torch.where(mask, blocks, torch.zeros((), dtype=dtype, device=dev))
            diag_add = torch.where(valid[ci], torch.full((), sigma2, dtype=dtype, device=dev),
                                   torch.ones((), dtype=dtype, device=dev))[:, :, None]
        else:
            diag_add = torch.full((ci.shape[0], c, 1), sigma2, dtype=dtype, device=dev)
        blocks = blocks + torch.where((ci == cj)[:, None, None], eye * diag_add,
                                      torch.zeros((), dtype=dtype, device=dev))
        dense[i0:i0 + ci.shape[0]] = blocks

    ulr = torch.zeros((grid.n_lr + 1, c, kp), dtype=dtype, device=dev)
    vlr = torch.zeros((grid.n_lr + 1, c, kp), dtype=dtype, device=dev)
    src = grid.lr_source
    for level in sorted(np.unique(src[:, 0]).tolist()):
        sel = src[:, 0] == level
        ids = _long(np.nonzero(sel)[0], dev)
        blk, roff, coff = src[sel, 1], src[sel, 2], src[sel, 3]
        q = 1 << (plan.n_levels - level)
        if factors is not None and level in factors:
            u_lvl, v_lvl = factors[level]
            need = np.arange(u_lvl.shape[0])
        else:
            need = np.unique(blk)
            lvl_blocks = np.asarray(plan.aca_levels[level])[need]
            pts_lvl = points.reshape(1 << level, q * c, -1)
            u_lvl, v_lvl = batched_aca(pts_lvl[_long(lvl_blocks[:, 0], dev)],
                                       pts_lvl[_long(lvl_blocks[:, 1], dev)], kernel, k)
        k_lvl = int(u_lvl.shape[2])
        if k_lvl > kp:
            raise ValueError(f"level {level} rank {k_lvl} exceeds working width kp={kp}; "
                             "raise kp")
        remap = _long(np.searchsorted(need, blk), dev)
        u_t = u_lvl.reshape(len(need), q, c, k_lvl)[remap, _long(roff, dev)]
        v_t = v_lvl.reshape(len(need), q, c, k_lvl)[remap, _long(coff, dev)]
        if valid is not None:
            ti = _long(grid.lr_pairs[sel, 0], dev)
            tj = _long(grid.lr_pairs[sel, 1], dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            u_t = torch.where(valid[ti][:, :, None], u_t, zero)
            v_t = torch.where(valid[tj][:, :, None], v_t, zero)
        ulr[ids, :, :k_lvl] = u_t
        vlr[ids, :, :k_lvl] = v_t
    return dense, ulr, vlr


def _lowrank_ab(ulr, vlr, dense, sll, smx):
    """``(a, b, targets)`` update factors of the low-rank-product slots: the
    update of target ``(i, j)`` is ``a b^T``."""
    out = []
    if sll is not None:
        ui, vi = ulr[sll[:, 0]], vlr[sll[:, 0]]
        uj, vj = ulr[sll[:, 1]], vlr[sll[:, 1]]
        out.append((ui @ (vi.transpose(1, 2) @ vj), uj, sll[:, 2]))     # u_i (v_i^T v_j), u_j
    if smx is not None:
        d_src = dense[smx[:, 0]]
        u_l, v_l = ulr[smx[:, 1]], vlr[smx[:, 1]]
        p = d_src @ v_l                                                  # D v
        swap = (smx[:, 2] == 1)[:, None, None]
        out.append((torch.where(swap, u_l, p), torch.where(swap, p, u_l), smx[:, 3]))
    return out


def _run_step(fns, sz: dict, kp: int, tol: float, dense, ulr, vlr, fac, tabs: dict):
    """One merged elimination step on the buffers, in place."""
    chol_fn, trsm_fn, schur_dense_fn, retrunc_fn = fns

    # FACTOR(t)
    ltt = chol_fn(dense[fac])                                 # (1, c, c)
    dense[fac] = ltt

    # TRSM(i, t): dense tiles as transposed panels, low-rank tiles by V
    if sz["trsm_d"]:
        idx = tabs["trsm_d"][:, 0]
        y = trsm_fn(ltt, dense[idx].transpose(1, 2).contiguous())
        dense[idx] = y.transpose(1, 2)
    if sz["trsm_l"]:
        idx = tabs["trsm_l"][:, 0]
        vlr[idx] = trsm_fn(ltt, vlr[idx])

    # SCHUR(i, j, t): dense x dense products onto dense targets
    if sz["sdd"]:
        sdd = tabs["sdd"]
        dense[sdd[:, 2]] = schur_dense_fn(dense[sdd[:, 2]], dense[sdd[:, 0]], dense[sdd[:, 1]])

    # low-rank products onto dense targets
    for a, b, tgt in _lowrank_ab(ulr, vlr, dense,
                                 tabs["sll_d"] if sz["sll_d"] else None,
                                 tabs["smx_d"] if sz["smx_d"] else None):
        dense[tgt] = schur_dense_fn(dense[tgt], a.contiguous(), b.contiguous())

    # low-rank products onto low-rank targets: concatenate, re-truncate
    for a, b, tgt in _lowrank_ab(ulr, vlr, dense,
                                 tabs["sll_l"] if sz["sll_l"] else None,
                                 tabs["smx_l"] if sz["smx_l"] else None):
        u2, v2 = retrunc_fn(torch.cat([ulr[tgt], -a], dim=2),
                            torch.cat([vlr[tgt], b], dim=2), tol, kp)
        ulr[tgt] = u2
        vlr[tgt] = v2


def factorize_hlu(hm, sigma2: float, *, tol: float = 1e-3, kp: int | None = None,
                  use_kernels: bool = True, _plan_only: bool = False):
    """Approximate H-Cholesky ``A_hat ~= L L^T`` of the pad-decoupled shifted
    system, on the H-matrix's device.

    ``hm``'s stored factors are sliced (P mode); without them the plain ACA
    runs for the needed blocks (NP mode).  ``tol`` is the relative per-block
    truncation tolerance of the Schur re-truncations, ``kp`` the working
    width of the low-rank tiles (default twice the input rank).
    ``use_kernels`` routes FACTOR, TRSM and SCHUR through the kernel
    wrappers (the CUDA kernels for CUDA tensors, their plain versions on the
    CPU); ``False`` takes the plain versions on any device.  Raises for a
    CUDA H-matrix while TF32 is enabled for float32 matmuls.
    """
    require_full_fp32("factorize_hlu", hm.tree.points.device)
    return _factorize_hlu(hm, sigma2, tol=tol, kp=kp, use_kernels=use_kernels,
                          _plan_only=_plan_only)


def _factorize_hlu(hm, sigma2: float, *, tol: float, kp: int | None, use_kernels: bool,
                   _plan_only: bool = False):
    """:func:`factorize_hlu` without the TF32 check."""
    plan, tree = hm.plan, hm.tree
    grid = build_tile_grid(plan)
    schedule = build_schedule(grid)
    tables = build_solve_tables(grid)

    k_max = hm.k
    if hm.factors is not None:
        widths = [int(hm.factors[lv][0].shape[2])
                  for lv in np.unique(grid.lr_source[:, 0]).tolist() if lv in hm.factors]
        k_max = max(widths, default=hm.k)
    kp = int(kp) if kp is not None else max(2 * k_max, 2)
    if kp < k_max:
        raise ValueError(f"kp={kp} below input rank {k_max}")

    meta = HLUMeta(grid=grid, schedule=schedule, tables=tables, kp=kp, tol=float(tol),
                   sigma2=float(sigma2), n=tree.n, n_pad=tree.n_pad)
    if _plan_only:
        return meta
    points = tree.points
    dev = points.device
    dense, ulr, vlr = _init_tiles(meta, plan, hm.kernel, hm.kernel_name, hm.k, points,
                                  hm.factors)
    fns = _kernels(use_kernels)
    steps = schedule.steps
    for sig, idxs in schedule.runs:
        sz = dict(zip(SLOTS, sig))
        fac = _long([steps[i].fac_id for i in idxs], dev)
        stacked = {name: _long(np.stack([getattr(steps[i], name) for i in idxs]), dev)
                   for name in SLOTS if sz[name]}
        for r in range(len(idxs)):
            _run_step(fns, sz, kp, meta.tol, dense, ulr, vlr, fac[r:r + 1],
                      {name: tab[r] for name, tab in stacked.items()})
    return HLUFactors(dense, ulr, vlr, meta)


def hlu_solve_panels(factors: HLUFactors, r_pad: torch.Tensor) -> torch.Tensor:
    """Apply ``(L L^T)^{-1}`` to a tree-ordered panel ``(n_pad, R)``.

    Forward block substitution row by row (dense tiles as (c, c) products,
    low-rank tiles as two thin ones), then the transposed backward sweep.
    Raises for CUDA operands while TF32 is enabled for float32 matmuls.
    """
    require_full_fp32("hlu_solve_panels", r_pad.device)
    meta = factors.meta
    grid = meta.grid
    t_tiles, c = grid.t, grid.c
    r_width = r_pad.shape[1]
    dense, ulr, vlr = factors.dense, factors.ulr, factors.vlr
    ix = factors.solve_index()
    diag = meta.tables.diag_ids.tolist()
    rb = r_pad.reshape(t_tiles, c, r_width)

    y = torch.zeros_like(rb)
    for t in range(t_tiles):
        acc = rb[t] - torch.einsum("pij,pjr->ir", dense[ix["row_dense"][t]],
                                   y[ix["row_dense_col"][t]])
        core = torch.einsum("pck,pcr->pkr", vlr[ix["row_lr"][t]], y[ix["row_lr_col"][t]])
        acc = acc - torch.einsum("pck,pkr->cr", ulr[ix["row_lr"][t]], core)
        y[t] = torch.linalg.solve_triangular(dense[diag[t]], acc, upper=False)
    x = y
    for t in reversed(range(t_tiles)):
        acc = x[t] - torch.einsum("pji,pjr->ir", dense[ix["col_dense"][t]],
                                  x[ix["col_dense_row"][t]])
        core = torch.einsum("pck,pcr->pkr", ulr[ix["col_lr"][t]], x[ix["col_lr_row"][t]])
        acc = acc - torch.einsum("pck,pkr->cr", vlr[ix["col_lr"][t]], core)
        x[t] = torch.linalg.solve_triangular(dense[diag[t]].transpose(0, 1), acc, upper=True)
    return x.reshape(meta.n_pad, r_width)


def assemble_lower(factors: HLUFactors) -> np.ndarray:
    """The full ``(n_pad, n_pad)`` lower-triangular L on the host.

    Test oracle only (O(n_pad^2) memory): dense tiles copied (diagonal tiles
    tril'd), low-rank tiles expanded ``u v^T``.
    """
    grid = factors.meta.grid
    c = grid.c
    dense = factors.dense.cpu().numpy()
    ulr, vlr = factors.ulr.cpu().numpy(), factors.vlr.cpu().numpy()
    out = np.zeros((grid.t * c, grid.t * c), dense.dtype)
    for idx, (i, j) in enumerate(grid.dense_pairs):
        blk = dense[idx]
        if i == j:
            blk = np.tril(blk)
        out[i * c:(i + 1) * c, j * c:(j + 1) * c] = blk
    for idx, (i, j) in enumerate(grid.lr_pairs):
        out[i * c:(i + 1) * c, j * c:(j + 1) * c] = ulr[idx] @ vlr[idx].T
    return out
