"""repro_torch — the H-matrix pipeline in PyTorch, with hand-written CUDA kernels.

A port of ``repro`` (JAX + Pallas) to PyTorch on an NVIDIA Hopper card.
The main path is the same as the reference's quickstart:

    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=256, precompute=True)
    z = make_apply(hm)(x)                     # Z = H X, x: (N,) or (N, R)
    c, info = make_solver(hm, sigma2)(f)      # block-Jacobi PCG

and beside it the memory tier (``build_hmatrix(..., recompress_tol=)``,
``core.recompress_store``, ``FactorStore.spill`` / ``reload``), the H-LU
preconditioner (``make_solver(hm, sigma2, precond="hlu")``, ``harith``), the
serving runtime (``serve.step.HMatrixServer`` / ``HMatrixSolveServer`` over
``serve.runtime``, multi-tenant serving in ``serve.tenancy``, fault
containment in ``serve.faults``) and LM serving with H-matrix attention
(``python -m repro_torch.launch.serve``; ``models``, ``serve.step``,
``core.hattention``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no CUDA card they raise ``RuntimeError``.  On a
CUDA tensor every kernel wrapper launches its kernel (built from
``csrc/`` with ``nvcc`` at first use); on a CPU tensor it runs the plain
PyTorch version of the same function.
"""
