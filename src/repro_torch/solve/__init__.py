"""repro_torch.solve — multi-RHS H-matrix Krylov solves (paper §1, eq. 1).

Public API:
    make_solver      block-Jacobi, H-LU (or plain) active-mask PCG over the H-apply
    host_loop_cg     CG with a host residual check per iteration
    SolveInfo        lazy per-solve convergence record
    build_preconditioner, pcg_tree_ordered
                     setup / loop building blocks
"""
from .cg import (SolveInfo, build_preconditioner, host_loop_cg, make_solver,
                 pcg_tree_ordered)

__all__ = ["make_solver", "host_loop_cg", "SolveInfo",
           "build_preconditioner", "pcg_tree_ordered"]
