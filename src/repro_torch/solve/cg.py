"""Batched H-matrix solve: multi-RHS block-Jacobi PCG for ``(A + sigma^2 I) C = F``.

Port of ``repro.solve.cg``.  The reference runs the whole solve as one
``lax.while_loop``; here it is a Python loop over the same body:

  * each of the R columns carries its own ``alpha`` / ``beta`` and an active
    flag; a column whose residual norm drops below ``tol`` freezes (its
    ``alpha``/``beta`` are masked to zero), and the loop ends when no column
    is active or ``max_iter`` is hit.  The host reads ``active.any()`` once
    per iteration, a small sync next to one H-apply;
  * the operator is :func:`repro_torch.core.hmatrix.apply_in_tree_order` on
    tree-ordered panels, so the Morton permutation is paid once per solve;
  * block Jacobi: the diagonal leaf blocks ``A_ii + sigma^2 I`` are
    Cholesky-factorised once (kernel ``batched_block_cholesky``) and every
    iteration applies ``z = M^{-1} r`` as B independent triangular solves
    (kernel ``batched_block_cholesky_solve``) on the reshaped panel;
  * or H-LU (``precond="hlu"``): an approximate H-Cholesky factorised once
    (``repro_torch.harith``), applied every iteration by two block sweeps
    (``harith.hlu.hlu_solve_panels``);
  * pad rows (``n_pad > n``) are masked out of the operator and the
    preconditioner, so the iteration runs on the leading (n, n) system;
  * the arithmetic of a trip lives in :class:`PCGIteration` (``init`` and
    ``step`` on a :class:`PCGState`), which the sharded solver
    (``repro_torch.parallel.hshard``) steps once per shard, in lockstep.
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from .._device import require_full_fp32
from ..core.clustering import permute_from_tree, permute_to_tree
from ..core.hmatrix import HMatrix, apply_in_tree_order, diagonal_blocks, operand
from ..harith.hlu import HLUFactors, hlu_solve_panels
from ..harith.precond import HLUPreconditioner, make_hlu_preconditioner


class SolveInfo:
    """LAZY convergence record of one solve.

    Holds the solver's device tensors as they are; the attributes fetch (and
    cache) host values on first access, under a lock so that concurrent
    readers fetch once.

    iterations:       loop trips until every column froze.
    iters_per_column: (R,) trips until each column froze.
    residual_norms:   (R,) final ``|b - (A + sigma^2 I) x|_2`` per column.
    converged:        all columns below ``tol`` within ``max_iter``.
    """

    __slots__ = ("_it", "_iters_col", "_res", "_tol", "_host", "_lock")

    def __init__(self, iterations, iters_per_column, residual_norms, tol: float):
        self._it = iterations
        self._iters_col = iters_per_column
        self._res = residual_norms
        self._tol = float(tol)
        self._host = None
        self._lock = threading.Lock()

    def fetch(self) -> "SolveInfo":
        """Materialise every field on the host and return self."""
        with self._lock:
            if self._host is None:
                self._host = (int(self._it), self._iters_col.cpu().numpy(),
                              self._res.cpu().numpy())
                self._it = self._iters_col = self._res = None
        return self

    @property
    def iterations(self) -> int:
        return self.fetch()._host[0]

    @property
    def iters_per_column(self) -> np.ndarray:
        return self.fetch()._host[1]

    @property
    def residual_norms(self) -> np.ndarray:
        return self.fetch()._host[2]

    @property
    def converged(self) -> bool:
        return bool(np.all(self.residual_norms < self._tol))

    def __repr__(self) -> str:
        if self._host is None:
            return "SolveInfo(<pending on device>)"
        return f"SolveInfo(iterations={self._host[0]}, converged={self.converged})"


def host_loop_cg(matmat: Callable, b: torch.Tensor, tol: float = 1e-5,
                 max_iter: int = 300):
    """Multi-RHS CG with one host residual check per iteration, stopping when
    ALL columns are below ``tol``.  b: (N, R) -> (x, iterations)."""
    x = torch.zeros_like(b)
    r = b - matmat(x)
    p, rs = r, (r * r).sum(0)
    for it in range(max_iter):
        ap = matmat(p)
        den = (p * ap).sum(0)
        alpha = torch.where(den > 0, rs / torch.where(den > 0, den, torch.ones_like(den)),
                            torch.zeros_like(den))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = (r * r).sum(0)
        if float(torch.sqrt(rs_new.max())) < tol:
            return x, it + 1
        beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, torch.ones_like(rs)),
                           torch.zeros_like(rs))
        p = r + beta[None, :] * p
        rs = rs_new
    return x, max_iter


def build_preconditioner(hm: HMatrix, sigma2: float, use_kernels: bool = True) -> torch.Tensor:
    """Lower Cholesky factors ``(n_leaf, c, c)`` of ``A_ii + sigma2 I`` per
    leaf cluster, in tree order.  The shift is added in place on the fresh
    diagonal blocks (no second copy of them)."""
    blocks = diagonal_blocks(hm)
    blocks.diagonal(dim1=1, dim2=2).add_(sigma2)
    if use_kernels:
        from ..kernels.batched_block_solve.ops import batched_block_cholesky
        return batched_block_cholesky(blocks)
    from ..kernels.batched_block_solve.ref import batched_block_cholesky_ref
    return batched_block_cholesky_ref(blocks)


class PCGState(NamedTuple):
    """The PCG's state between trips, on one device; every field is (R,)
    but ``x``, ``r``, ``p``, which are (n_pad, R)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor
    rr: torch.Tensor
    active: torch.Tensor
    iters_col: torch.Tensor


class PCGIteration:
    """The active-mask PCG's arithmetic on one device: the operator
    ``A + sigma2 I`` and the preconditioner, both with the pad rows masked
    out, and :meth:`init` / :meth:`step` on a :class:`PCGState`.

    ``tol2`` is the SQUARED absolute residual tolerance; ``chol`` the
    block-Jacobi factors, the H-LU factors (``HLUFactors``) or None.  The
    single-device loop (:func:`pcg_tree_ordered`) and the sharded solver
    (``repro_torch.parallel.hshard``), which steps one of these per shard in
    lockstep, share this arithmetic.
    """

    def __init__(self, tree, plan, kernel, k: int, use_kernels: bool, sigma2: float,
                 tol2: float, points: torch.Tensor, factors, groups: dict, chol,
                 device, dtype=torch.float32):
        self.tree, self.plan, self.kernel, self.k = tree, plan, kernel, k
        self.use_kernels = use_kernels
        self.sigma2, self.tol2 = sigma2, tol2
        self.points, self.factors, self.groups, self.chol = points, factors, groups, chol
        n, n_pad = tree.n, tree.n_pad
        self._pad_rows = (torch.arange(n_pad, device=device) < n)[:, None] \
            if n_pad > n else None
        self._zero = torch.zeros((), dtype=dtype, device=device)
        self._one = torch.ones((), dtype=dtype, device=device)

    def _mask(self, v):
        return v if self._pad_rows is None else torch.where(self._pad_rows, v, self._zero)

    def apply_op(self, v):
        z = apply_in_tree_order(self.tree, self.plan, self.kernel, self.k, self.use_kernels,
                                self.points, self.factors, self.groups, v)
        return self._mask(z + self.sigma2 * v)

    def prec(self, r):
        chol = self.chol
        if chol is None:
            return r
        if isinstance(chol, HLUFactors):
            return self._mask(hlu_solve_panels(chol, r))
        c = self.plan.c_leaf
        n_pad, r_width = r.shape
        rb = r.reshape(n_pad // c, c, r_width)
        if self.use_kernels:
            from ..kernels.batched_block_solve.ops import batched_block_cholesky_solve
            y = batched_block_cholesky_solve(chol, rb)
        else:
            from ..kernels.batched_block_solve.ref import batched_block_cholesky_solve_ref
            y = batched_block_cholesky_solve_ref(chol, rb)
        return self._mask(y.reshape(n_pad, r_width))

    def init(self, b_pad: torch.Tensor) -> PCGState:
        """The state at x0 = 0 for a tree-ordered panel ``b_pad: (n_pad, R)``."""
        r = b_pad
        p = self.prec(r)
        rr = (r * r).sum(0)
        return PCGState(x=torch.zeros_like(b_pad), r=r, p=p, rs=(r * p).sum(0), rr=rr,
                        active=rr > self.tol2,
                        iters_col=torch.zeros(b_pad.shape[1], dtype=torch.int32,
                                              device=b_pad.device))

    def step(self, s: PCGState, it: int) -> PCGState:
        """Trip ``it`` (from 0): frozen columns keep their state exactly."""
        zero, one = self._zero, self._one
        active = s.active
        ap = self.apply_op(s.p)
        den = (s.p * ap).sum(0)
        ok = active & (den > 0)
        alpha = torch.where(ok, s.rs / torch.where(ok, den, one), zero)
        x = s.x + alpha[None, :] * s.p
        r = s.r - alpha[None, :] * ap
        rr_new = torch.where(active, (r * r).sum(0), s.rr)
        z = self.prec(r)
        rs_new = (r * z).sum(0)
        still = active & (rr_new > self.tol2)
        beta = torch.where(still, rs_new / torch.where(active, s.rs, one), zero)
        p = torch.where(still[None, :], z + beta[None, :] * s.p, s.p)
        rs = torch.where(still, rs_new, s.rs)
        iters_col = torch.where(active, torch.full_like(s.iters_col, it + 1), s.iters_col)
        return PCGState(x=x, r=r, p=p, rs=rs, rr=rr_new, active=still, iters_col=iters_col)


def pcg_tree_ordered(tree, plan, kernel, k: int, use_kernels: bool, sigma2: float,
                     tol2: float, max_iter: int, points: torch.Tensor, factors,
                     groups: dict, chol, b_pad: torch.Tensor):
    """Active-mask PCG on a TREE-ordered panel ``b_pad: (n_pad, R)``.

    ``tol2`` is the SQUARED absolute residual tolerance; ``chol`` the
    block-Jacobi factors, the H-LU factors (``HLUFactors``) or None.
    Returns ``(x_pad, it, iters_col, rr)`` with ``rr`` the final squared
    residual norms; ``it == iters_col.max()``, as in the reference.
    """
    pcg = PCGIteration(tree, plan, kernel, k, use_kernels, sigma2, tol2, points, factors,
                       groups, chol, b_pad.device, b_pad.dtype)
    state = pcg.init(b_pad)
    it = 0
    while it < max_iter and bool(state.active.any()):
        state = pcg.step(state, it)
        it += 1
    return state.x, it, state.iters_col, state.rr


def make_solver(hm: HMatrix, sigma2: float, tol: float = 1e-5, max_iter: int = 300,
                precondition: bool = True, use_kernels: bool = True, mesh=None,
                precond: str | HLUPreconditioner | None = None,
                hlu_opts: dict | None = None) -> Callable:
    """Build the solver for ``(A + sigma2 I) C = F``.

    ``tol`` is the per-column ABSOLUTE residual tolerance.  ``precond`` is
    ``"bj"`` (block Jacobi, the default), ``"hlu"`` (an approximate
    H-Cholesky factorised here with ``make_hlu_preconditioner(**hlu_opts)``,
    ``tol`` and ``kp``), ``"none"``, or a prebuilt ``HLUPreconditioner``
    used as it is; the legacy ``precondition`` switch applies when
    ``precond`` is None.  The H-LU preconditioner is exposed as
    ``solve.preconditioner`` (None otherwise).  ``use_kernels`` routes the
    H-apply, the block solves and the factorization through the kernel
    wrappers.  Returns ``solve(F) -> (C, SolveInfo)`` for ``F: (N,)`` or
    ``(N, R)``.

    With a ``mesh`` (``repro_torch.parallel.make_panel_mesh``) the panel's
    columns are sharded over it and the shards iterate in lockstep
    (``repro_torch.parallel.hshard.make_sharded_solver``); only block Jacobi
    or no preconditioner.
    """
    pre = None
    if isinstance(precond, HLUPreconditioner):
        pre, precond = precond, "hlu"
    elif precond is None:
        precond = "bj" if precondition else "none"
    if precond not in ("bj", "hlu", "none"):
        raise ValueError(f"unknown precond {precond!r}; expected 'bj', 'hlu', 'none' or an "
                         "HLUPreconditioner")
    if mesh is not None:
        if precond == "hlu":
            raise ValueError(
                "precond='hlu' is single-device: the H-LU substitution sweeps are sequential "
                "across block rows, which defeats the mesh-sharded solver's column "
                "parallelism; shard RHS columns over tenants instead, or use precond='bj'")
        from ..parallel.hshard import make_sharded_solver
        return make_sharded_solver(hm, sigma2, mesh, tol=tol, max_iter=max_iter,
                                   precondition=precond == "bj", use_kernels=use_kernels)
    tree, plan = hm.tree, hm.plan
    tol2 = float(tol) * float(tol)
    if precond == "hlu":
        if pre is None:
            pre = make_hlu_preconditioner(hm, sigma2, use_kernels=use_kernels,
                                          **(hlu_opts or {}))
        chol = pre.factors
    elif precond == "bj":
        chol = build_preconditioner(hm, sigma2, use_kernels)
    else:
        chol = None

    def solve(f):
        require_full_fp32("solve", hm.device)
        f = operand(f, hm, "rhs")
        fp = f[:, None] if f.ndim == 1 else f
        x, it, iters_col, rr = pcg_tree_ordered(
            tree, plan, hm.kernel, hm.k, use_kernels, sigma2, tol2, max_iter,
            tree.points, hm.factors, hm.groups, chol, permute_to_tree(tree, fp))
        x = permute_from_tree(tree, x)
        info = SolveInfo(it, iters_col, torch.sqrt(rr), tol)
        return (x[:, 0] if f.ndim == 1 else x), info

    solve.preconditioner = pre
    return solve
