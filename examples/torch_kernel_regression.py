"""Kernel ridge regression on the PyTorch port: an H-matrix operator and the
multi-RHS block-Jacobi PCG (paper §1, eq. 1).

The twin of ``examples/kernel_regression.py``, at its sizes and arguments:
a family of 8 targets f_j(y) = sin(a_j y_0) cos(b_j y_1) on N = 16384 Halton
points of a domain of side 32 (the kernel's length scale is 1), solving
(A + sigma^2 I) C = F with ``repro_torch.solve.make_solver`` (sigma^2 =
1e-2, tol = 1e-3, at most 300 iterations).  Each column carries its own
alpha / beta and freezes once converged; the loop reads one flag a trip
back to the host (queue 1 B1 of the ROADMAP).  On the card it runs kernels
#2 and #4 (every H-apply, P mode) and #5 / #6 (the block-Jacobi setup and
its solve every iteration).

    PYTHONPATH=src python examples/torch_kernel_regression.py [--device cpu] [--n 16384]
"""
import argparse
import time

import torch

from repro_torch.core import build_hmatrix, halton, make_apply, sinusoid_targets
from repro_torch.solve import make_solver

DOMAIN = 32.0  # domain side length (kernel length scale is 1)


def wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, n: int = 16384, targets: int = 8, sigma2: float = 1e-2,
        c_leaf: int = 256) -> dict:
    dev = torch.device(device or "cuda")
    pts = halton(n, 2, device=dev) * DOMAIN
    f = sinusoid_targets(pts, targets, DOMAIN)                  # (N, R)

    t0 = time.perf_counter()
    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=c_leaf, precompute=True, device=dev)
    wait(dev)
    setup_s = time.perf_counter() - t0
    print(f"setup: {setup_s:.2f}s   N={n}  targets={f.shape[1]}")

    solver = make_solver(hm, sigma2, tol=1e-3, max_iter=300, precondition=True)
    t0 = time.perf_counter()
    coef, info = solver(f)
    wait(dev)
    solve_s = time.perf_counter() - t0
    per_target = info.iters_per_column.tolist()
    print(f"PCG: {info.iterations} iterations, {solve_s:.2f}s "
          f"({solve_s / f.shape[1]:.2f}s amortized per target); "
          f"per-target iterations {per_target}")

    op = make_apply(hm)
    resid = float((torch.linalg.norm(op(coef) + sigma2 * coef - f)
                   / torch.linalg.norm(f)).cpu())
    print(f"relative residual: {resid:.2e}")
    return {"n": n, "setup_s": setup_s, "solve_s": solve_s, "iterations": info.iterations,
            "iters_per_column": per_target, "rel_residual": resid,
            "coef": coef.cpu().numpy(), "points": pts.cpu().numpy(), "targets": f.cpu().numpy()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=16384, help="number of points")
    args = ap.parse_args(argv)
    return run(args.device, n=args.n)


if __name__ == "__main__":
    main()
