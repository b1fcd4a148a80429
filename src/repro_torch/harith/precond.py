"""H-LU preconditioning: the factorization as a PCG preconditioner.

Port of ``repro.harith.precond``.  Block Jacobi captures only the
inadmissible diagonal blocks; an approximate H-Cholesky captures the
off-diagonal structure at tolerance, trading a one-time factorization for
near-constant iteration counts.  :class:`HLUPreconditioner` packages the
factors with their setup time and bytes; ``repro_torch.solve.make_solver(...,
precond="hlu")`` uses it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .hlu import HLUFactors, factorize_hlu


@dataclass(frozen=True)
class HLUPreconditioner:
    """One factorized H-LU preconditioner and its costs.

    factors:        the packed :class:`HLUFactors`.
    setup_seconds:  wall time of the factorization, up to a device sync.
    tol, kp:        truncation tolerance and working width used.
    """

    factors: HLUFactors
    setup_seconds: float
    tol: float
    kp: int

    def nbytes(self) -> int:
        """Device bytes of the factor buffers."""
        return self.factors.nbytes()

    def report(self) -> dict:
        grid = self.factors.meta.grid
        sched = self.factors.meta.schedule
        return {
            "nbytes": self.nbytes(),
            "setup_seconds": self.setup_seconds,
            "tol": self.tol,
            "kp": self.kp,
            "tiles": {"t": grid.t, "dense": grid.n_dense, "low_rank": grid.n_lr,
                      "promoted": int(grid.promoted.size)},
            "schedule": {"steps": len(sched.steps), "runs": sched.n_runs},
            "ranks": self.factors.rank_stats(),
        }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_hlu_preconditioner(hm, sigma2: float, *, tol: float = 1e-3, kp: int | None = None,
                            use_kernels: bool = True) -> HLUPreconditioner:
    """Factorize ``A_hat ~= L L^T`` once and wrap it for the solver.

    The setup time runs up to a device sync, so the factorization's cost is
    not carried into the first solve.
    """
    dev = hm.device
    _sync(dev)
    t0 = time.perf_counter()
    factors = factorize_hlu(hm, sigma2, tol=tol, kp=kp, use_kernels=use_kernels)
    _sync(dev)
    return HLUPreconditioner(factors=factors, setup_seconds=time.perf_counter() - t0,
                             tol=float(tol), kp=int(factors.meta.kp))
