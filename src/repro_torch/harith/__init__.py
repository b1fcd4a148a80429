"""repro_torch.harith — task-DAG scheduled H-Cholesky and its triangular solves.

Port of ``repro.harith``.  The dependency DAG of the factorization is
derived from the block partition (:mod:`.taskgraph`, NumPy, equal to the
reference's), levelled into steps whose slots are padded batches, and run
step by step on the device (:mod:`.hlu`) through the kernels
``batched_block_cholesky`` (FACTOR), ``batched_trsm_panels`` (TRSM),
``batched_schur_dense`` and ``batched_recompress`` (SCHUR).  The factors
plug into the PCG as a preconditioner (:mod:`.precond`).

Public API:
    factorize_hlu, hlu_solve_panels, assemble_lower, HLUFactors, HLUMeta
    make_hlu_preconditioner, HLUPreconditioner
    build_tile_grid, build_taskgraph, build_schedule, build_solve_tables,
    TileGrid, HLUTaskGraph, HLUSchedule, ScheduleStep, SolveTables, Task
"""
from .hlu import HLUFactors, HLUMeta, assemble_lower, factorize_hlu, hlu_solve_panels
from .precond import HLUPreconditioner, make_hlu_preconditioner
from .taskgraph import (HLUSchedule, HLUTaskGraph, ScheduleStep, SolveTables, Task, TileGrid,
                        build_schedule, build_solve_tables, build_taskgraph, build_tile_grid)

__all__ = [
    "HLUFactors", "HLUMeta", "HLUPreconditioner", "HLUSchedule", "HLUTaskGraph",
    "ScheduleStep", "SolveTables", "Task", "TileGrid", "assemble_lower", "build_schedule",
    "build_solve_tables", "build_taskgraph", "build_tile_grid", "factorize_hlu",
    "hlu_solve_panels", "make_hlu_preconditioner",
]
