#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # every phase, as the GPU check runs it

Phases (any failure ends the run with a non-zero exit code):
  0. setup: card name and power limit, torch version, fp32 matmul
     precision, build of every CUDA kernel from ``src/repro_torch/csrc``;
  1. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (block pairs, level groups and diagonal blocks
     taken from problems P and K; P's 2^20 points for the Morton encode; up
     to 8 blocks of every ACA level group of P and K, K's also on the unit
     square; the recompression on all level groups of P's store, on wide
     (8192, 256, 64) panels with a geometric sigma decay and on all-zero
     blocks; the panel triangular solve and the dense Schur update at H-LU's
     batch shapes), with times of kernel, plain version and the PyTorch
     library call that computes the same function (the ACA also on all
     level groups of P, as one build runs it);
  2. problem P, the paper's model problem (N = 2^20 Halton points on the
     unit square, gaussian, k = 16, c_leaf = 2048, eta = 1.5, P mode):
     build, apply to an (N, 8) panel and an (N,) vector, 512 sampled rows
     against the exact dense rows, two applies bit-identical, block-Jacobi
     setup and 10 PCG iterations;
  3. problem K, the regression solve (N = 2^15 Halton points scaled by 32,
     c_leaf = 256, sigma2 = 1e-2, tol = 1e-3, R = 8 sinusoid targets):
     block-Jacobi PCG to convergence through the kernels and through the
     plain path, residual checked with a separate apply, and the kernel
     path's spread of iteration counts when F changes by 1e-7;
  4. the device build (``build_hmatrix_device``, P mode) of P and K: plan
     and permutation equal to the host builder's, stage times beside the
     host build's, an apply of each against exact rows;
  5. NP mode (factors recomputed by the ACA kernel in every apply): P at
     full width, an (N, 8) panel and an (N,) vector against exact rows,
     two applies bit-identical, ms per apply; then K's block-Jacobi PCG to
     convergence, iterations held to the P-mode kernel path's;
  6. the memory tier on P (device-built store): ``recompress_store`` at tol
     1e-2 and 1e-3 (bytes, k per level, the report), 512 sampled rows of the
     recompressed apply against the flat store's within 5 tol, apply times,
     ``build_hmatrix_device(recompress_tol=1e-2)`` against recompressing the
     device-built store (equal ranks), and ``spill`` / ``reload`` (the apply
     after it bit-identical, seconds of each);
  7. H-LU on K: ``make_solver(precond="hlu", hlu_opts={"tol": 1e-3})`` to
     convergence in at most 3 iterations per column (``repro``: 1), residual
     checked with a separate apply, two solves bit-identical, the report
     (tile grid, steps, runs, ranks, bytes), setup split into the FACTOR,
     TRSM, SCHUR and re-truncation kernels' shares, ms per iteration; then
     the same factorization through the plain versions on the card, held
     buffer by buffer to the kernel path's.

Kernel launch counts are set to 0 before each of phases 2 to 7 and read
after it: each phase must have launched the kernels of its own path
(``PATH_KERNELS``), and every kernel must have run on the main path.  The
last lines are a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  A detailed record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FP32 = 67e12      # H100 SXM, FLOP/s outside the tensor cores (data sheet)
# integer operations: 64 INT32 lanes per SM against the 128 FP32 lanes whose
# fused multiply-adds count 2 operations each (Hopper white paper)
PEAK_INT32 = PEAK_FP32 / 4
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (data sheet)
SEED = 0
T_START = time.perf_counter()

# JAX reference, problem K (sigma2 = 1e-2, tol = 1e-3, R = 8): iterations
# per column of repro.solve.make_solver on the CPU, block Jacobi and H-LU
# (hlu_opts={"tol": 1e-3})
K_REFERENCE_ITERS = [145, 148, 143, 143, 143, 143, 147, 142]
K_HLU_REFERENCE_ITERS = [1] * 8
# K's H-LU tile grid and schedule (repro.harith on the plan of build_hmatrix)
K_HLU_TILES = {"t": 128, "dense": 2723, "low_rank": 5533, "promoted": 1593}
K_HLU_SCHEDULE = {"steps": 128, "runs": 64}
# K's H-LU through the kernels against the plain versions on the card, max
# abs difference: dense tiles, and low-rank tiles as u v^T
HLU_DENSE_LIMIT, HLU_LOWRANK_LIMIT = 1e-4, 1e-5

KERNELS = {
    "batched_kernel_matvec": ("src/repro_torch/csrc/dense_matmat.cu",
                              "src/repro/kernels/batched_dense_matvec/kernel.py:55"),
    "batched_kernel_matmat": ("src/repro_torch/csrc/dense_matmat.cu",
                              "src/repro/kernels/batched_dense_matvec/kernel.py:101"),
    "batched_aca": ("src/repro_torch/csrc/aca.cu",
                    "src/repro/kernels/batched_aca/kernel.py:98"),
    "batched_lowrank_matmat": ("src/repro_torch/csrc/lowrank_matmat.cu",
                               "src/repro/kernels/batched_aca/kernel.py:150"),
    "batched_block_cholesky": ("src/repro_torch/csrc/block_cholesky.cu",
                               "src/repro/kernels/batched_block_solve/kernel.py:69"),
    "batched_block_cholesky_solve": ("src/repro_torch/csrc/block_cholesky_solve.cu",
                                     "src/repro/kernels/batched_block_solve/kernel.py:119"),
    "morton_encode": ("src/repro_torch/csrc/morton.cu",
                      "src/repro/kernels/morton/kernel.py:54"),
    "batched_recompress": ("src/repro_torch/csrc/recompress.cu",
                           "src/repro/kernels/batched_recompress/kernel.py:170"),
    "batched_trsm_panels": ("src/repro_torch/csrc/trsm_panels.cu",
                            "src/repro/kernels/batched_trsm_lowrank/kernel.py:63"),
    "batched_schur_dense": ("src/repro_torch/csrc/schur_dense.cu",
                            "src/repro/kernels/batched_schur_update/kernel.py:48"),
}
# the kernels each main-path phase must launch itself
PATH_KERNELS = {
    "P": ("batched_kernel_matmat", "batched_kernel_matvec", "batched_lowrank_matmat",
          "batched_block_cholesky", "batched_block_cholesky_solve"),
    "K": ("batched_kernel_matmat", "batched_lowrank_matmat", "batched_block_cholesky",
          "batched_block_cholesky_solve"),
    "device_build": ("morton_encode", "batched_aca"),
    "np_mode": ("batched_aca", "batched_kernel_matmat", "batched_kernel_matvec",
                "batched_lowrank_matmat", "batched_block_cholesky",
                "batched_block_cholesky_solve"),
    "memory_tier": ("batched_recompress", "batched_lowrank_matmat", "morton_encode"),
    "hlu": ("batched_block_cholesky", "batched_recompress", "batched_trsm_panels",
            "batched_schur_dense", "batched_kernel_matmat", "batched_lowrank_matmat"),
}
P_BUILD = dict(kernel="gaussian", k=16, c_leaf=2048, eta=1.5)
K_BUILD = dict(kernel="gaussian", k=16, c_leaf=256, eta=1.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def bound_ms(bytes_moved: float, ops: float, peak_ops: float = PEAK_FP32) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def points_p() -> torch.Tensor:
    from repro_torch.core import halton
    return halton(1 << 20, 2, device="cuda")


def points_k() -> torch.Tensor:
    from repro_torch.core import halton
    return halton(1 << 15, 2, device="cuda") * 32.0


def build_problem_p():
    from repro_torch.core import build_hmatrix
    pts = points_p()
    hm, secs = wall_s(lambda: build_hmatrix(pts, precompute=True, **P_BUILD))
    return pts, hm, secs


def build_problem_k():
    from repro_torch.core import build_hmatrix
    pts = points_k()
    hm, secs = wall_s(lambda: build_hmatrix(pts, precompute=True, **K_BUILD))
    return pts, hm, secs


def plan_summary(hm) -> dict:
    return {"n": hm.tree.n, "n_pad": hm.tree.n_pad, "c_leaf": hm.plan.c_leaf,
            "dense_blocks": hm.plan.num_dense_blocks,
            "aca_levels": {int(lv): [int(b.shape[0]), hm.tree.n_pad >> lv]
                           for lv, b in sorted(hm.plan.aca_levels.items())},
            "factor_bytes": hm.memory_report()["factor_bytes"]}


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def dense_pairs(hm, count: int, rng):
    """Points of ``count`` real dense leaf blocks of ``hm``: (B, C, d) twice."""
    blocks = hm.plan.dense_blocks
    pick = np.sort(rng.choice(blocks.shape[0], size=min(count, blocks.shape[0]),
                              replace=False))
    c = hm.plan.c_leaf
    pts = hm.tree.points.reshape(hm.plan.n_pad // c, c, -1)
    rows = torch.from_numpy(blocks[pick, 0].astype(np.int64)).cuda()
    cols = torch.from_numpy(blocks[pick, 1].astype(np.int64)).cuda()
    return pts[rows].contiguous(), pts[cols].contiguous()


def randn(shape, rng) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()


def check_dense(hm_p, hm_k, rng, record):
    from repro_torch.kernels.batched_dense_matvec.kernel import batched_kernel_matmat_cuda
    from repro_torch.kernels.batched_dense_matvec.ref import batched_kernel_matmat_ref
    checks = []
    for name, hm in (("K", hm_k), ("P", hm_p)):
        rows, cols = dense_pairs(hm, 64, rng)
        for r in (1, 8):
            x = randn((rows.shape[0], rows.shape[1], r), rng)
            y = batched_kernel_matmat_cuda(rows, cols, x, "gaussian")
            y_ref = batched_kernel_matmat_ref(rows, cols, x, "gaussian")
            err = rel_err(y, y_ref)
            checks.append({"problem": name, "C": rows.shape[1], "R": r, "rel_err": err,
                           "max_abs_err": max_abs(y, y_ref)})
            require(err <= 1e-5, f"batched_kernel_matmat {name} R={r}: rel err {err}")
    # times at the main path's per-block shape: 64 blocks of P, C = 2048, R = 8
    rows, cols = dense_pairs(hm_p, 64, rng)
    x = randn((rows.shape[0], rows.shape[1], 8), rng)
    b, c, d = rows.shape
    ms = gpu_ms(lambda: batched_kernel_matmat_cuda(rows, cols, x, "gaussian"), 5)
    plain = gpu_ms(lambda: batched_kernel_matmat_ref(rows, cols, x, "gaussian"), 2)
    bms, by = bound_ms(4.0 * (2 * b * c * d + 2 * b * c * 8), b * c * c * ((3 * d - 1) + 1 + 2 * 8))
    # the kernel on all dense leaves of P in one launch, as an apply makes
    # it: the kernels' share of the apply's time (the rest is glue)
    g = hm_p.groups["dense"]
    leaf_pts = hm_p.tree.points.reshape(-1, c, d)
    rows, cols = leaf_pts[g.rows], leaf_pts[g.cols]
    x_blk = randn((hm_p.plan.n_pad, 8), rng).reshape(-1, c, 8)[g.cols]
    whole_ms = gpu_ms(lambda: batched_kernel_matmat_cuda(rows, cols, x_blk, "gaussian"), 3)
    record["batched_kernel_matmat"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"B={b} C={c} d={d} R=8 (blocks of problem P)",
        "whole_dense_group_ms": whole_ms, "whole_dense_group_blocks": int(g.rows.shape[0])}


def check_lowrank(hm_p, rng, record):
    from repro_torch.kernels.batched_aca.kernel import batched_lowrank_matmat_cuda
    from repro_torch.kernels.batched_aca.ref import batched_lowrank_matmat_ref
    checks, ms, plain, lib, nbytes, flops = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for level in sorted(hm_p.factors.keys()):
        u, v = hm_p.factors[level]
        b, m, k = u.shape
        x = randn((b, m, 8), rng)
        y = batched_lowrank_matmat_cuda(u, v, x)
        y_ref = batched_lowrank_matmat_ref(u, v, x)
        err = rel_err(y, y_ref)
        checks.append({"level": level, "B": b, "m": m, "rel_err": err,
                       "max_abs_err": max_abs(y, y_ref)})
        require(err <= 1e-5, f"batched_lowrank_matmat level {level}: rel err {err}")
        ms += gpu_ms(lambda: batched_lowrank_matmat_cuda(u, v, x), 5)
        plain += gpu_ms(lambda: batched_lowrank_matmat_ref(u, v, x), 5)
        lib += gpu_ms(lambda: torch.bmm(u, torch.bmm(v.transpose(1, 2), x)), 5)
        nbytes += 4.0 * (2 * b * m * k + 2 * b * m * 8)
        flops += 2.0 * b * k * 8 * 2 * m
    bms, by = bound_ms(nbytes, flops)
    record["batched_lowrank_matmat"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "timed_shape": "every level group of problem P, R=8 (sum over levels)"}


def shifted_diagonal(hm, sigma2: float, count: int | None):
    from repro_torch.core import diagonal_blocks
    a = diagonal_blocks(hm)
    if count is not None:
        a = a[:count].contiguous()
    a.diagonal(dim1=1, dim2=2).add_(sigma2)
    return a


def check_cholesky(hm_p, hm_k, rng, record):
    from repro_torch.kernels.batched_block_solve.kernel import (
        batched_block_cholesky_cuda, batched_block_cholesky_solve_cuda)
    from repro_torch.kernels.batched_block_solve.ref import (
        batched_block_cholesky_ref, batched_block_cholesky_solve_ref)
    chol_checks, solve_checks = [], []
    for name, hm, count in (("K", hm_k, None), ("P", hm_p, 32)):
        a = shifted_diagonal(hm, 1e-2, count)
        l_k = batched_block_cholesky_cuda(a)
        l_r = batched_block_cholesky_ref(a)
        err = rel_err(l_k, l_r)
        recon = rel_err(torch.bmm(l_k, l_k.transpose(1, 2)), a)
        upper_zero = bool((torch.triu(l_k, diagonal=1) == 0).all())
        chol_checks.append({"problem": name, "B": a.shape[0], "c": a.shape[1], "rel_err": err,
                            "max_abs_err": max_abs(l_k, l_r), "llt_rel_err": recon})
        require(err <= 1e-4, f"batched_block_cholesky {name}: rel err {err}")
        require(recon <= 1e-5, f"batched_block_cholesky {name}: |LL^T - A|/|A| = {recon}")
        require(upper_zero, f"batched_block_cholesky {name}: nonzero above the diagonal")
        x = randn((a.shape[0], a.shape[1], 8), rng)
        y_k = batched_block_cholesky_solve_cuda(l_k, x)
        y_r = batched_block_cholesky_solve_ref(l_k, x)
        err = rel_err(y_k, y_r)
        solve_checks.append({"problem": name, "B": a.shape[0], "c": a.shape[1], "R": 8,
                             "rel_err": err, "max_abs_err": max_abs(y_k, y_r)})
        require(err <= 1e-4, f"batched_block_cholesky_solve {name}: rel err {err}")
        if name == "P":
            b, c = a.shape[0], a.shape[1]
            ms = gpu_ms(lambda: batched_block_cholesky_cuda(a), 3)
            plain = gpu_ms(lambda: batched_block_cholesky_ref(a), 1)
            lib = gpu_ms(lambda: torch.linalg.cholesky(a), 3)
            bms, by = bound_ms(4.0 * 2 * b * c * c, b * c ** 3 / 3.0)
            record["batched_block_cholesky"] = {
                "checks": chol_checks, "max_abs_err": max(ch["max_abs_err"] for ch in chol_checks),
                "rel_err": max(ch["rel_err"] for ch in chol_checks), "ms": ms,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
                "timed_shape": f"B={b} c={c} (diagonal blocks of problem P)"}
            del a, l_r
    # the solve is timed at the PCG's own shape: all 512 blocks of problem P
    chol_p = batched_block_cholesky_cuda(shifted_diagonal(hm_p, 1e-2, None))
    b, c = chol_p.shape[0], chol_p.shape[1]
    x = randn((b, c, 8), rng)
    y_k = batched_block_cholesky_solve_cuda(chol_p, x)
    y_r = batched_block_cholesky_solve_ref(chol_p, x)
    err = rel_err(y_k, y_r)
    solve_checks.append({"problem": "P-all", "B": b, "c": c, "R": 8, "rel_err": err,
                         "max_abs_err": max_abs(y_k, y_r)})
    require(err <= 1e-4, f"batched_block_cholesky_solve P (all blocks): rel err {err}")
    ms = gpu_ms(lambda: batched_block_cholesky_solve_cuda(chol_p, x), 5)
    plain = gpu_ms(lambda: batched_block_cholesky_solve_ref(chol_p, x), 1)
    lib = gpu_ms(lambda: torch.cholesky_solve(x, chol_p), 5)
    bms, by = bound_ms(4.0 * (b * c * (c + 1) / 2 + 2 * b * c * 8), 2.0 * b * c * c * 8)
    record["batched_block_cholesky_solve"] = {
        "checks": solve_checks, "max_abs_err": max(ch["max_abs_err"] for ch in solve_checks),
        "rel_err": max(ch["rel_err"] for ch in solve_checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "timed_shape": f"B={b} c={c} R=8 (all diagonal blocks of problem P)"}


def check_matvec(hm_p, hm_k, rng, record):
    from repro_torch.kernels.batched_dense_matvec.kernel import batched_kernel_matvec_cuda
    from repro_torch.kernels.batched_dense_matvec.ref import batched_kernel_matvec_ref
    checks = []
    for name, hm in (("K", hm_k), ("P", hm_p)):
        rows, cols = dense_pairs(hm, 64, rng)
        x = randn((rows.shape[0], rows.shape[1]), rng)
        y = batched_kernel_matvec_cuda(rows, cols, x, "gaussian")
        y_ref = batched_kernel_matvec_ref(rows, cols, x, "gaussian")
        err = rel_err(y, y_ref)
        checks.append({"problem": name, "C": rows.shape[1], "rel_err": err,
                       "max_abs_err": max_abs(y, y_ref)})
        require(err <= 1e-5, f"batched_kernel_matvec {name}: rel err {err}")
    # timed at the main path's shape: 64 leaf blocks of P (C = 2048)
    b, c, d = rows.shape
    ms = gpu_ms(lambda: batched_kernel_matvec_cuda(rows, cols, x, "gaussian"), 5)
    plain = gpu_ms(lambda: batched_kernel_matvec_ref(rows, cols, x, "gaussian"), 2)
    bms, by = bound_ms(4.0 * (2 * b * c * d + 2 * b * c), b * c * c * ((3 * d - 1) + 1 + 2))
    record["batched_kernel_matvec"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"B={b} C={c} d={d} (blocks of problem P)"}


def unit_box(pts: torch.Tensor) -> torch.Tensor:
    lo, hi = pts.amin(dim=0), pts.amax(dim=0)
    return ((pts - lo) / torch.clamp(hi - lo, min=1e-30)).contiguous()


def check_morton(pts_p, record):
    from repro_torch.core.morton import bits_per_dim
    from repro_torch.kernels.morton.kernel import morton_encode_cuda
    from repro_torch.kernels.morton.ref import morton_encode_ref
    unit = unit_box(pts_p)
    codes = morton_encode_cuda(unit)
    same = bool(torch.equal(codes, morton_encode_ref(unit)))
    require(same, "morton_encode: codes differ from the plain version")
    n, d = unit.shape
    ms = gpu_ms(lambda: morton_encode_cuda(unit), 20)
    plain = gpu_ms(lambda: morton_encode_ref(unit), 3)
    # the fewest operations: a magic-number bit spread, ceil(log2 nb) steps of
    # shift, or and mask on a 64-bit word (2 int32 operations each) per
    # dimension, and one 64-bit or to merge it into the code
    spread_ops = 6 * math.ceil(math.log2(bits_per_dim(d))) + 2
    bms, by = bound_ms(4.0 * n * d + 8.0 * n, float(n * d * spread_ops), PEAK_INT32)
    record["morton_encode"] = {
        "codes_equal": same, "max_abs_err": 0.0 if same else None, "ms": ms,
        "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"N={n} d={d} (the points of problem P)"}


def aca_work(b: int, m: int, n: int, k: int) -> tuple[float, float]:
    """Bytes written (U and V once) and operations of the ACA of b blocks:
    per generated entry 3d - 1 for the distance (d = 2), 1 for phi, 1 for
    the residual, 1 to scale or compare, and 2r for the dot of step r.  The
    points a level group reads are counted once, by the caller: they are
    the same n_pad points for every group."""
    nbytes = 4.0 * b * (m + n) * k
    ops = float(b) * (m + n) * (k * (3 * 2 + 2) + k * (k - 1))
    return nbytes, ops


def sample_err(rows, cols, u, v, ri, ci) -> tuple[float, float]:
    """(max |phi - U V^T|, max |phi|) over the sampled rows ri and columns ci
    of every block."""
    from repro_torch.kernels.phi import phi_matrix
    exact = phi_matrix(rows[:, ri], cols[:, ci], "gaussian")
    return (float((exact - u[:, ri] @ v[:, ci].transpose(1, 2)).abs().max()),
            float(exact.abs().max()))


def kernel_pivots(points, rid, cid, m: int, k: int):
    """Row and column pivots (B, k) of the ACA kernel on clusters rid x cid,
    decoded from its pivot keys (low 32 bits: 2^32 - 1 - index)."""
    from repro_torch.kernels.batched_aca.kernel import _aca_launch
    _, _, keys = _aca_launch(points, rid, points, cid, m, m, "gaussian", k)
    idx = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    cols = torch.zeros_like(idx[0].t())
    cols[:, 1:] = idx[1, :-1].t()          # column key r is step r + 1's pivot
    return idx[0].t(), cols


def check_aca(hm_p, hm_k, rng, record):
    """The ACA kernel on up to 8 blocks of every level group of P and K,
    held by its sampled error relative to the group's largest sampled
    |phi| (K's coarse groups have entries near exp(-49): an absolute limit
    would pass zero factors there).  K's groups are also checked on the
    unit square (its points / 32, the same clusters), where the entries of
    its small blocks (m = 256 to 4096) are of order 1."""
    from functools import partial

    from repro_torch.core import batched_aca
    from repro_torch.kernels.batched_aca.kernel import batched_aca_level_cuda
    from repro_torch.kernels.batched_aca.ref import batched_aca_level_ref
    from repro_torch.kernels.phi import phi_matrix
    checks = []
    for name, hm, points in (("P", hm_p, hm_p.tree.points), ("K", hm_k, hm_k.tree.points),
                             ("K/32", hm_k, hm_k.tree.points / 32.0)):
        for level in sorted(hm.plan.aca_levels):
            g = hm.groups[level]
            count = min(8, g.rows.shape[0])
            pick = torch.from_numpy(np.sort(rng.choice(g.rows.shape[0], count,
                                                       replace=False))).cuda()
            rid, cid = g.rows[pick].contiguous(), g.cols[pick].contiguous()
            m = hm.tree.n_pad >> level
            u, v = batched_aca_level_cuda(points, rid, cid, level, "gaussian", hm.k)
            pr, pc = kernel_pivots(points, rid, cid, m, hm.k)
            pts = points.reshape(1 << level, m, -1)
            rows, cols = pts[rid], pts[cid]
            # the plain version (batched_aca_level_ref) with its pivots
            ur, vr, prr, pcr = batched_aca(rows, cols, partial(phi_matrix, kernel_name="gaussian"),
                                           hm.k, return_pivots=True)
            ri = torch.from_numpy(np.sort(rng.choice(m, min(256, m), replace=False))).cuda()
            ci = torch.from_numpy(np.sort(rng.choice(m, min(256, m), replace=False))).cuda()
            (err, scale), (err_ref, _) = (sample_err(rows, cols, u, v, ri, ci),
                                          sample_err(rows, cols, ur, vr, ri, ci))
            rel, rel_ref = ((e / scale if scale > 0 else (0.0 if e == 0 else math.inf))
                            for e in (err, err_ref))
            other = int(((pr != prr) | (pc != pcr)).any(dim=1).sum())
            # the two approximations of the sampled entries against each other
            vs_plain = max_abs(u[:, ri] @ v[:, ci].transpose(1, 2),
                               ur[:, ri] @ vr[:, ci].transpose(1, 2))
            checks.append({"problem": name, "level": level, "blocks": count, "m": m,
                           "sampled_max_abs_phi": scale, "sampled_max_err": err,
                           "plain_sampled_max_err": err_ref, "sampled_rel_err": rel,
                           "plain_sampled_rel_err": rel_ref,
                           "blocks_with_other_pivots": other, "max_abs_err": vs_plain})
            require(rel <= max(2.0 * rel_ref, 1e-4),
                    f"batched_aca {name} level {level}: sampled error {err} of max |phi| "
                    f"{scale} (relative {rel}) vs plain {err_ref} (relative {rel_ref})")
    # all level groups of P, as one build (or one NP apply) factors them
    ms = plain = ops = 0.0
    nbytes = 4.0 * hm_p.tree.points.numel()         # the points, read once
    per_level = {}
    for level in sorted(hm_p.plan.aca_levels):
        g = hm_p.groups[level]
        m = hm_p.tree.n_pad >> level
        t = gpu_ms(lambda: batched_aca_level_cuda(hm_p.tree.points, g.rows, g.cols, level,
                                                  "gaussian", hm_p.k), 3)
        tp = gpu_ms(lambda: batched_aca_level_ref(hm_p.tree.points, g.rows, g.cols, level,
                                                  "gaussian", hm_p.k), 1, warmup=0)
        per_level[level] = {"B": int(g.rows.shape[0]), "m": m, "ms": t, "plain_ms": tp}
        ms, plain = ms + t, plain + tp
        b_, o_ = aca_work(int(g.rows.shape[0]), m, m, hm_p.k)
        nbytes, ops = nbytes + b_, ops + o_
        torch.cuda.empty_cache()
    bms, by = bound_ms(nbytes, ops)
    record["batched_aca"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "sampled_max_err": max(ch["sampled_max_err"] for ch in checks),
        "sampled_rel_err": max(ch["sampled_rel_err"] for ch in checks),
        "blocks_with_other_pivots": sum(ch["blocks_with_other_pivots"] for ch in checks),
        "blocks_checked": sum(ch["blocks"] for ch in checks),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "bound_bytes": nbytes, "bound_ops": ops, "per_level_P": per_level,
        "timed_shape": "every level group of problem P, k=16 (sum over levels)"}


def lowrank_err(u, v, u2, v2, chunk: int = 512):
    """Per-block ``|U V^T - U2 V2^T|_F`` and ``|U V^T|_F`` (float64, from
    the panels' Gram matrices, so no (m, n) block is formed)."""
    errs, norms = [], []
    for b0 in range(0, u.shape[0], chunk):
        a, b, a2, b2 = (t[b0:b0 + chunk].double() for t in (u, v, u2, v2))
        def frob2(x, y, x2, y2):
            return ((x.transpose(1, 2) @ x2) * (y.transpose(1, 2) @ y2)).sum(dim=(1, 2))
        n2 = frob2(a, b, a, b)
        e2 = n2 - 2.0 * frob2(a, b, a2, b2) + frob2(a2, b2, a2, b2)
        errs.append(torch.sqrt(torch.clamp(e2, min=0.0)))
        norms.append(torch.sqrt(n2))
    return torch.cat(errs), torch.cat(norms)


def recompress_work(b: int, m: int, n: int, k: int, sweeps: float) -> tuple[float, float]:
    """Bytes (U and V read once, U' and V' written once) and operations of
    one recompression: the Grams (m + n) k (k + 1), the transforms
    2 (m + n) k^2, and per Jacobi sweep run k (k - 1) / 2 pairs of 3 dot
    products and 2 column rotations of M and Z (18 k)."""
    nbytes = 4.0 * 2 * b * (m + n) * k
    ops = float(b) * ((m + n) * k * (k + 1) + 2.0 * (m + n) * k * k) \
        + sweeps * k * (k - 1) / 2.0 * 18.0 * k
    return nbytes, ops


def check_recompress_group(u, v, tol: float):
    """#8 against its plain version on one batch: (record, Jacobi sweeps).
    Passes when every block's reconstruction error is within 2 tol of its
    Frobenius norm and, on every block of the plain version's rank, within
    0.1 tol of the plain version's own error (a block of another rank has
    parted from it at a singular value on the cut)."""
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    from repro_torch.kernels.batched_recompress.ref import batched_recompress_ref
    u2, v2, s, ranks, sweeps = batched_recompress_cuda(u, v, tol)
    ur, vr, rr = batched_recompress_ref(u, v, tol)
    err, norm = lowrank_err(u, v, u2, v2)
    err_ref, _ = lowrank_err(u, v, ur, vr)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    rel, rel_ref = err / safe, err_ref / safe
    same_rank = ranks == rr
    differ = int((~same_rank).sum())
    gap = float((rel - rel_ref).abs()[same_rank].max()) if bool(same_rank.any()) else 0.0
    trailing_zero = all(bool((u2[i, :, r:] == 0).all() and (v2[i, :, r:] == 0).all())
                        for i, r in enumerate(ranks.tolist()))
    rec = {"B": u.shape[0], "m": u.shape[1], "k": u.shape[2], "tol": tol,
           "blocks_with_other_rank": differ, "max_rel_err": float(rel.max()),
           "plain_max_rel_err": float(rel_ref.max()), "max_rel_err_gap_same_rank": gap,
           "max_abs_err": max_abs(u2 @ v2[:, :64].transpose(1, 2),
                                  ur @ vr[:, :64].transpose(1, 2)),
           "ranks_max": int(ranks.max()), "ranks_mean": float(ranks.double().mean()),
           "sweeps_mean": float(sweeps.double().mean()), "trailing_zero": trailing_zero,
           "finite": bool(torch.isfinite(u2).all() and torch.isfinite(v2).all())}
    require(rec["finite"] and trailing_zero, f"batched_recompress {rec}: non-finite output or "
            "nonzero columns past the rank")
    require(float(rel.max()) <= 2.0 * tol,
            f"batched_recompress B={u.shape[0]} m={u.shape[1]}: relative reconstruction error "
            f"{float(rel.max())} > 2 tol ({differ} blocks of another rank)")
    require(gap <= 0.1 * tol,
            f"batched_recompress B={u.shape[0]} m={u.shape[1]}: on blocks of the plain "
            f"version's rank the relative error parts from the plain version's by {gap} > 0.1 tol")
    return rec, sweeps


def check_recompress(hm_p, rng, record):
    """#8 on all 7 level groups of P's store (tol 1e-2 and 1e-3), on
    (8192, 256, 64) panels with a geometric sigma decay (H-LU's width) and
    on a batch with all-zero blocks."""
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    from repro_torch.kernels.batched_recompress.ref import batched_recompress_ref
    checks, per_level, totals = [], {}, {}
    for tol in (1e-2, 1e-3):
        ms = plain = nbytes = ops = 0.0
        for level in sorted(hm_p.factors.keys()):
            u, v = hm_p.factors[level]
            rec, sweeps = check_recompress_group(u, v, tol)
            rec["level"] = level
            checks.append(rec)
            t = gpu_ms(lambda: batched_recompress_cuda(u, v, tol), 3)
            tp = gpu_ms(lambda: batched_recompress_ref(u, v, tol), 1, warmup=0)
            b_, o_ = recompress_work(*u.shape[:2], v.shape[1], u.shape[2],
                                     float(sweeps.double().sum()))
            per_level[f"{tol}/{level}"] = {"B": u.shape[0], "m": u.shape[1], "ms": t,
                                           "plain_ms": tp}
            ms, plain, nbytes, ops = ms + t, plain + tp, nbytes + b_, ops + o_
            torch.cuda.empty_cache()
        totals[tol] = (ms, plain, nbytes, ops)
    # H-LU's width: (8192, 256, 64) with a geometric sigma decay, tol 1e-3
    scale = torch.from_numpy((0.35 ** np.arange(64)).astype(np.float32)).cuda()
    u = randn((8192, 256, 64), rng) * scale
    v = randn((8192, 256, 64), rng)
    rec, sweeps = check_recompress_group(u, v, 1e-3)
    rec["shape"] = "decaying"
    checks.append(rec)
    wide_ms = gpu_ms(lambda: batched_recompress_cuda(u, v, 1e-3), 3)
    wide_plain = gpu_ms(lambda: batched_recompress_ref(u, v, 1e-3), 1, warmup=0)
    wide_bytes, wide_ops = recompress_work(8192, 256, 256, 64, float(sweeps.double().sum()))
    # all-zero blocks (K's H-LU is mostly made of them) next to decaying ones
    u[::2], v[1::4] = 0.0, 0.0
    u_z, v_z = u[:256].contiguous(), v[:256].contiguous()
    rec, _ = check_recompress_group(u_z, v_z, 1e-3)
    _, _, _, ranks, _ = batched_recompress_cuda(u_z, v_z, 1e-3)
    zero = (u_z.abs().amax(dim=(1, 2)) == 0) | (v_z.abs().amax(dim=(1, 2)) == 0)
    rec["shape"] = "zero blocks"
    rec["zero_blocks"] = int(zero.sum())
    rec["zero_blocks_rank0"] = bool((ranks[zero] == 0).all())
    checks.append(rec)
    require(rec["zero_blocks_rank0"], "batched_recompress: an all-zero block kept a rank")
    del u, v, u_z, v_z
    ms, plain, nbytes, ops = totals[1e-2]
    bms, by = bound_ms(nbytes, ops)
    wide_bms, wide_by = bound_ms(wide_bytes, wide_ops)
    record["batched_recompress"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "blocks_with_other_rank": sum(ch["blocks_with_other_rank"] for ch in checks),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ms_tol_1e-3": totals[1e-3][0], "plain_ms_tol_1e-3": totals[1e-3][1],
        "bound_ms_tol_1e-3": bound_ms(totals[1e-3][2], totals[1e-3][3])[0],
        "per_level_P": per_level, "wide_ms": wide_ms, "wide_plain_ms": wide_plain,
        "wide_bound_ms": wide_bms, "wide_bound_by": wide_by,
        "timed_shape": "all 7 level groups of problem P's store, k=16, tol=1e-2 (sum); "
                       "wide_*: (8192, 256, 64) decaying panels, tol=1e-3"}


def k_lower_factor(hm_k) -> torch.Tensor:
    """One shifted diagonal block of K, factored by the Cholesky kernel:
    the L_tt an H-LU step hands to TRSM, (1, 256, 256)."""
    from repro_torch.kernels.batched_block_solve.kernel import batched_block_cholesky_cuda
    return batched_block_cholesky_cuda(shifted_diagonal(hm_k, 1e-2, 1))


def check_trsm(hm_k, rng, record):
    """#9 at H-LU's largest TRSM batches of K: (32, 256, 256) dense tiles and
    (128, 256, 32) low-rank V panels, one L_tt for the batch."""
    from repro_torch.kernels.batched_trsm_lowrank.kernel import batched_trsm_panels_cuda
    from repro_torch.kernels.batched_trsm_lowrank.ref import batched_trsm_panels_ref
    lmat = k_lower_factor(hm_k)
    c = lmat.shape[1]
    checks, ms, plain, lib, nbytes, ops = [], 0.0, 0.0, 0.0, 4.0 * c * c, 0.0
    for b, p in ((32, 256), (128, 32)):
        x = randn((b, c, p), rng)
        y = batched_trsm_panels_cuda(lmat, x)
        y_ref = batched_trsm_panels_ref(lmat, x)
        err = rel_err(y, y_ref)
        checks.append({"B": b, "c": c, "P": p, "rel_err": err, "max_abs_err": max_abs(y, y_ref)})
        require(err <= 1e-4, f"batched_trsm_panels B={b} P={p}: rel err {err}")
        ms += gpu_ms(lambda: batched_trsm_panels_cuda(lmat, x), 10)
        plain += gpu_ms(lambda: batched_trsm_panels_ref(lmat, x), 1)
        lib += gpu_ms(lambda: torch.linalg.solve_triangular(lmat, x, upper=False), 10)
        nbytes += 4.0 * 2 * b * c * p
        ops += float(b) * c * c * p
    bms, by = bound_ms(nbytes, ops)
    record["batched_trsm_panels"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "timed_shape": "(32, 256, 256) + (128, 256, 32), one L_tt of K (sum of the two)"}


def check_schur(rng, record):
    """#10 at H-LU's largest dense-target batches of K: sdd (512, 256, 256,
    p=256) and sll_d (4096, 256, 256, p=32)."""
    from repro_torch.kernels.batched_schur_update.kernel import batched_schur_dense_cuda
    from repro_torch.kernels.batched_schur_update.ref import batched_schur_dense_ref
    checks, ms, plain, lib, nbytes, ops = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for b, p in ((512, 256), (4096, 32)):
        cc, a, bb = randn((b, 256, 256), rng), randn((b, 256, p), rng), randn((b, 256, p), rng)
        y = batched_schur_dense_cuda(cc, a, bb)
        y_ref = batched_schur_dense_ref(cc, a, bb)
        err = rel_err(y, y_ref)
        checks.append({"B": b, "m": 256, "n": 256, "p": p, "rel_err": err,
                       "max_abs_err": max_abs(y, y_ref)})
        require(err <= 1e-5, f"batched_schur_dense B={b} p={p}: rel err {err}")
        ms += gpu_ms(lambda: batched_schur_dense_cuda(cc, a, bb), 5)
        plain += gpu_ms(lambda: batched_schur_dense_ref(cc, a, bb), 3)
        lib += gpu_ms(lambda: torch.baddbmm(cc, a, bb.transpose(1, 2), alpha=-1), 5)
        nbytes += 4.0 * b * (2 * 256 * 256 + 2 * 256 * p)
        ops += 2.0 * b * 256 * 256 * p
        del cc, a, bb, y, y_ref
    bms, by = bound_ms(nbytes, ops)
    record["batched_schur_dense"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "timed_shape": "(512, 256, 256, p=256) + (4096, 256, 256, p=32) (sum of the two)"}


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def exact_rows(pts: torch.Tensor, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the dense gaussian matrix times ``x``, 64 rows at a time."""
    from repro_torch.core import gaussian_kernel
    out = [gaussian_kernel(pts[idx[i:i + 64]], pts) @ x for i in range(0, idx.shape[0], 64)]
    return torch.cat(out)


def run_problem_p(pts, hm, rng, out):
    from repro_torch.core import make_apply
    from repro_torch.solve import make_solver
    apply_h = make_apply(hm)
    x = randn((hm.tree.n, 8), rng)
    z, t_first = wall_s(lambda: apply_h(x))
    apply_ms = gpu_ms(lambda: apply_h(x), 3, warmup=0)
    vec = x[:, 0].contiguous()
    z1 = apply_h(vec)
    apply_vec_ms = gpu_ms(lambda: apply_h(vec), 3, warmup=0)
    idx = torch.from_numpy(np.sort(rng.choice(hm.tree.n, 512, replace=False))).cuda()
    exact = exact_rows(pts, idx, x)
    err = rel_err(z[idx], exact)
    err_vec = rel_err(z1[idx], exact[:, 0])
    require(err <= 1e-4, f"problem P: rel err on 512 sampled rows {err}")
    require(err_vec <= 1e-4, f"problem P (vector): rel err on 512 sampled rows {err_vec}")
    z2 = apply_h(x)
    identical = bool(torch.equal(z, z2))
    require(identical, "problem P: two applies of one panel are not bit-identical")
    solver, t_setup = wall_s(lambda: make_solver(hm, 1e-2, tol=0.0, max_iter=10))
    (c_sol, info), t_pcg = wall_s(lambda: solver(x))
    require(info.iterations == 10, f"problem P: {info.iterations} PCG iterations, not 10")
    require(bool(torch.isfinite(c_sol).all()), "problem P: non-finite PCG iterate")
    out["P"] = {"plan": plan_summary(hm), "first_apply_s": t_first,
                "apply_ms_R8": apply_ms, "apply_ms_vector": apply_vec_ms,
                "sampled_rows_rel_err_R8": err, "sampled_rows_rel_err_vector": err_vec,
                "applies_bit_identical": identical, "solver_setup_s": t_setup,
                "pcg_10_iterations_s": t_pcg, "pcg_ms_per_iteration": t_pcg * 100.0,
                "pcg_residual_norms": info.residual_norms.tolist()}
    log(f"[P] apply R=8 {apply_ms:.3f} ms, vector {apply_vec_ms:.3f} ms; rel err "
        f"{err:.3e} (R=8) {err_vec:.3e} (vector); bit-identical {identical}")
    log(f"[P] block-Jacobi setup {t_setup:.3f} s; 10 PCG iterations {t_pcg:.3f} s "
        f"({t_pcg * 100.0:.3f} ms/iteration)")


def run_problem_k(pts, hm, out):
    from repro_torch.core import make_apply, sinusoid_targets
    from repro_torch.solve import make_solver
    sigma2 = 1e-2
    f = sinusoid_targets(pts, 8, 32.0)
    solver, t_setup = wall_s(lambda: make_solver(hm, sigma2, tol=1e-3, max_iter=300))
    (c_sol, info), t_solve = wall_s(lambda: solver(f))
    iters = info.iters_per_column.tolist()
    resid = rel_err(make_apply(hm)(c_sol) + sigma2 * c_sol, f)
    out["K"] = {"plan": plan_summary(hm), "setup_s": t_setup, "solve_s": t_solve,
                "iterations": info.iterations, "iters_per_column": iters,
                "converged": info.converged, "relative_residual": resid}
    log(f"[K] solve {t_solve:.3f} s (setup {t_setup:.3f} s); iterations per column "
        f"{iters}; relative residual {resid:.3e}")
    require(info.converged, "problem K: not every column converged")
    require(all(abs(a - b) <= 5 for a, b in zip(iters, K_REFERENCE_ITERS)),
            f"problem K: iterations {iters} not within 5 of the reference {K_REFERENCE_ITERS}")
    require(resid <= 1e-4, f"problem K: relative residual {resid}")
    return f, c_sol, iters


def run_problem_k_plain(hm, f, c_kern, iters_kern, out):
    """The same solve through the plain versions, and the kernel path's own
    spread of iteration counts when F changes by one part in 10^7: the scale
    of the differences that summing in another order can cause."""
    from repro_torch.solve import make_solver
    solver = make_solver(hm, 1e-2, tol=1e-3, max_iter=300, use_kernels=False)
    (c_sol, info), t_solve = wall_s(lambda: solver(f))
    iters = info.iters_per_column.tolist()
    diff = rel_err(c_kern, c_sol)
    kernel_solver = make_solver(hm, 1e-2, tol=1e-3, max_iter=300)
    perturbed = [kernel_solver(f * (1.0 + eps))[1].iters_per_column.tolist()
                 for eps in (1e-7, -1e-7)]
    spread = [max(col) - min(col) for col in zip(iters_kern, *perturbed)]
    out["K_plain"] = {"solve_s": t_solve, "iters_per_column": iters,
                      "converged": info.converged, "solution_rel_diff": diff,
                      "kernel_iters_f_times_1_plus_1e-7": perturbed[0],
                      "kernel_iters_f_times_1_minus_1e-7": perturbed[1],
                      "kernel_iters_spread_under_1e-7": spread}
    log(f"[K plain] solve {t_solve:.3f} s; iterations per column {iters}; solution "
        f"rel diff to the kernel path {diff:.3e}")
    log(f"[K] kernel path with F*(1+1e-7): {perturbed[0]}, F*(1-1e-7): {perturbed[1]}; "
        f"spread per column {spread}")
    require(info.converged, "problem K (plain path): not every column converged")
    require(diff <= 1e-3, f"problem K: kernel and plain solutions differ by {diff}")
    # +-2 per column, widened to spread + 1 where a change of F by 1e-7
    # alone moves the kernel path's count by more than that (this run)
    allowed = [max(2, sp + 1) for sp in spread]
    out["K_plain"]["iters_allowed_difference"] = allowed
    require(all(abs(a - b) <= lim for a, b, lim in zip(iters, iters_kern, allowed)),
            f"problem K: kernel path {iters_kern} and plain path {iters} differ by more "
            f"than {allowed} per column")
    return allowed


# ---------------------------------------------------------------------------
# phases 4 and 5: the device build and NP mode
# ---------------------------------------------------------------------------


def plans_equal(a, b) -> bool:
    return ((a.c_leaf, a.n_pad, a.n_levels, a.eta) == (b.c_leaf, b.n_pad, b.n_levels, b.eta)
            and sorted(a.aca_levels) == sorted(b.aca_levels)
            and all(np.array_equal(a.aca_levels[lv], b.aca_levels[lv]) for lv in a.aca_levels)
            and np.array_equal(a.dense_blocks, b.dense_blocks))


def sampled_apply_err(pts, apply_h, rng, r: int = 8) -> float:
    x = randn((pts.shape[0], r), rng)
    idx = torch.from_numpy(np.sort(rng.choice(pts.shape[0], 512, replace=False))).cuda()
    return rel_err(apply_h(x)[idx], exact_rows(pts, idx, x))


def run_device_build(name: str, pts, kw: dict, rng, out):
    """Host build (plan, then factors, timed apart) against the device build."""
    from repro_torch.core import (build_hmatrix, build_hmatrix_device_report, compute_factors,
                                  make_apply)
    host, t_plan = wall_s(lambda: build_hmatrix(pts, **kw))
    _, t_factors = wall_s(lambda: compute_factors(host.tree, host.plan, host.kernel, host.k,
                                                  host.groups))
    host_perm, host_plan = host.tree.perm, host.plan
    del host
    torch.cuda.empty_cache()
    (hm, report), t_dev = wall_s(lambda: build_hmatrix_device_report(pts, precompute=True,
                                                                     **kw))
    same_perm = bool(torch.equal(hm.tree.perm, host_perm))
    same_plan = plans_equal(hm.plan, host_plan)
    err = sampled_apply_err(pts, make_apply(hm), rng)
    out[f"{name}_device_build"] = {
        "host_plan_s": t_plan, "host_factors_s": t_factors, "host_total_s": t_plan + t_factors,
        "device_plan_s": report.plan_s, "device_factors_s": report.factors_s,
        "device_total_s": report.total_s, "device_wall_s": t_dev,
        "report_launches": report.launches, "aca_blocks": report.num_aca_blocks,
        "dense_blocks": report.num_dense_blocks, "perm_equal": same_perm,
        "plan_equal": same_plan, "sampled_rows_rel_err_R8": err}
    log(f"[{name} device build] plan {report.plan_s:.3f} s + factors {report.factors_s:.3f} s "
        f"= {report.total_s:.3f} s ({report.launches} kernel launches); host build plan "
        f"{t_plan:.3f} s + factors {t_factors:.3f} s; plan equal {same_plan}, perm equal "
        f"{same_perm}; rel err on 512 sampled rows {err:.3e}")
    require(same_perm, f"{name}: device-build permutation differs from the host build's")
    require(same_plan, f"{name}: device-build plan differs from the host build's")
    require(err <= 1e-4, f"{name} device build: rel err on 512 sampled rows {err}")


def run_np_mode(pts_p, pts_k, iters_kern, allowed, rng, out):
    """NP mode at full width: P applies, then K's block-Jacobi PCG."""
    from repro_torch.core import build_hmatrix_device, make_apply, sinusoid_targets
    from repro_torch.solve import make_solver
    hm = build_hmatrix_device(pts_p, **P_BUILD)
    require(hm.factors is None, "NP mode: the H-matrix holds factors")
    apply_h = make_apply(hm)
    x = randn((hm.tree.n, 8), rng)
    vec = x[:, 0].contiguous()
    z, t_first = wall_s(lambda: apply_h(x))
    z1 = apply_h(vec)
    identical = bool(torch.equal(z, apply_h(x)))
    idx = torch.from_numpy(np.sort(rng.choice(hm.tree.n, 512, replace=False))).cuda()
    exact = exact_rows(pts_p, idx, x)
    err, err_vec = rel_err(z[idx], exact), rel_err(z1[idx], exact[:, 0])
    apply_ms = gpu_ms(lambda: apply_h(x), 2, warmup=0)
    apply_vec_ms = gpu_ms(lambda: apply_h(vec), 2, warmup=0)
    out["P_np"] = {"first_apply_s": t_first, "apply_ms_R8": apply_ms,
                   "apply_ms_vector": apply_vec_ms, "sampled_rows_rel_err_R8": err,
                   "sampled_rows_rel_err_vector": err_vec, "applies_bit_identical": identical}
    log(f"[P NP] apply R=8 {apply_ms:.3f} ms, vector {apply_vec_ms:.3f} ms; rel err "
        f"{err:.3e} (R=8) {err_vec:.3e} (vector); bit-identical {identical}")
    require(err <= 1e-4, f"NP mode P: rel err on 512 sampled rows {err}")
    require(err_vec <= 1e-4, f"NP mode P (vector): rel err on 512 sampled rows {err_vec}")
    require(identical, "NP mode P: two applies of one panel are not bit-identical")
    del hm, apply_h, z, z1
    torch.cuda.empty_cache()

    sigma2 = 1e-2
    hm_k = build_hmatrix_device(pts_k, **K_BUILD)
    f = sinusoid_targets(pts_k, 8, 32.0)
    solver = make_solver(hm_k, sigma2, tol=1e-3, max_iter=300)
    (c_sol, info), t_solve = wall_s(lambda: solver(f))
    iters = info.iters_per_column.tolist()
    resid = rel_err(make_apply(hm_k)(c_sol) + sigma2 * c_sol, f)
    out["K_np"] = {"solve_s": t_solve, "iterations": info.iterations, "iters_per_column": iters,
                   "converged": info.converged, "relative_residual": resid,
                   "p_mode_kernel_iters": iters_kern, "iters_allowed_difference": allowed}
    log(f"[K NP] solve {t_solve:.3f} s; iterations per column {iters} (P mode {iters_kern}, "
        f"allowed difference {allowed}); relative residual {resid:.3e}")
    require(info.converged, "NP mode K: not every column converged")
    require(resid <= 1e-4, f"NP mode K: relative residual {resid}")
    require(all(abs(a - b) <= lim for a, b, lim in zip(iters, iters_kern, allowed)),
            f"NP mode K: iterations {iters} differ from the P-mode kernel path {iters_kern} "
            f"by more than {allowed} per column")


# ---------------------------------------------------------------------------
# phases 6 and 7: the memory tier and H-LU
# ---------------------------------------------------------------------------


def run_memory_tier(pts_p, rng, out):
    """P's device-built store: recompression at two tolerances, the
    recompressed apply against the flat one, the device build with
    recompress_tol, spill and reload."""
    import dataclasses

    from repro_torch.core import (FactorStore, build_hmatrix_device,
                                  build_hmatrix_device_report, make_apply, recompress_store)
    hm = build_hmatrix_device(pts_p, precompute=True, **P_BUILD)
    flat = hm.factors
    x = randn((hm.tree.n, 8), rng)
    idx = torch.from_numpy(np.sort(rng.choice(hm.tree.n, 512, replace=False))).cuda()
    z_flat = make_apply(hm)(x)[idx]
    flat_ms = gpu_ms(lambda: make_apply(hm)(x), 3)
    res = {"flat_bytes": flat.nbytes()["total"], "flat_apply_ms_R8": flat_ms}
    log(f"[memory tier] flat store {res['flat_bytes']} bytes, apply R=8 {flat_ms:.3f} ms")
    hm_1e2 = None
    for tol in (1e-2, 1e-3):
        store = FactorStore(dict(flat.levels), dict(flat.rank_tables))
        report, secs = wall_s(lambda: recompress_store(store, tol))
        hm_t = dataclasses.replace(hm, factors=store)
        apply_t = make_apply(hm_t)
        err = rel_err(apply_t(x)[idx], z_flat)
        ms = gpu_ms(lambda: apply_t(x), 3)
        res[f"tol_{tol}"] = {
            "bytes_before": report.bytes_before, "bytes_after": report.bytes_after,
            "ratio": report.ratio, "per_level_k": report.per_level_k,
            "recompress_store_s": secs, "apply_ms_R8": ms,
            "sampled_rows_rel_err_vs_flat": err,
            "ranks_mean": {lv: float(t.double().mean()) for lv, t in store.rank_tables.items()}}
        log(f"[memory tier] tol {tol}: {report.bytes_before} -> {report.bytes_after} bytes "
            f"(ratio {report.ratio:.4f}), k per level {report.per_level_k}, recompress_store "
            f"{secs:.3f} s; apply R=8 {ms:.3f} ms (flat {flat_ms:.3f}); rel err of 512 rows "
            f"vs the flat store {err:.3e}")
        require(err <= 5.0 * tol, f"memory tier tol {tol}: rel err {err} vs the flat store")
        if tol == 1e-2:
            hm_1e2 = hm_t
        torch.cuda.empty_cache()
    # the device build with recompress_tol: the same ranks as recompressing
    # the device-built store
    hm_d, report = build_hmatrix_device_report(pts_p, precompute=True, recompress_tol=1e-2,
                                               **P_BUILD)
    same = all(torch.equal(hm_d.factors.rank_table(lv), hm_1e2.factors.rank_table(lv))
               and hm_d.factors[lv][0].shape == hm_1e2.factors[lv][0].shape
               for lv in hm_1e2.factors.keys())
    res["device_build_recompress"] = {"recompress_s": report.recompress_s,
                                      "total_s": report.total_s, "ranks_equal": same}
    log(f"[memory tier] build_hmatrix_device(recompress_tol=1e-2): recompress "
        f"{report.recompress_s:.3f} s of {report.total_s:.3f} s; ranks equal to recompressing "
        f"the device-built store {same}")
    require(same, "memory tier: the device build's recompressed ranks differ")
    del hm_d
    # spill and reload of the recompressed store
    store = hm_1e2.factors
    apply_t = make_apply(hm_1e2)
    z0 = apply_t(x)
    freed, t_spill = wall_s(store.spill)
    raised = False
    try:                   # the refusal this check expects, not a failure
        apply_t(x)
    except RuntimeError as err:
        raised = "spilled" in str(err)
    restored, t_reload = wall_s(store.reload)
    identical = bool(torch.equal(apply_t(x), z0))
    res["spill_reload"] = {"bytes": freed, "spill_s": t_spill, "reload_s": t_reload,
                           "apply_on_spilled_raised": raised, "bit_identical_after": identical}
    log(f"[memory tier] spill {freed} bytes in {t_spill:.3f} s, reload {restored} in "
        f"{t_reload:.3f} s; apply on the spilled store raised {raised}; apply after reload "
        f"bit-identical {identical}")
    require(raised and identical and restored == freed, "memory tier: spill / reload failed")
    out["memory_tier"] = res


def timed_hlu_kernels(events: dict):
    """``harith.hlu._kernels`` with each kernel call bracketed by CUDA events
    (appended to ``events[name]``), for the setup's split by kernel."""
    from repro_torch.harith import hlu
    orig = hlu._kernels
    names = ("batched_block_cholesky", "batched_trsm_panels", "batched_schur_dense",
             "batched_recompress")

    def wrap(fn, name):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(*args)
            end.record()
            events.setdefault(name, []).append((start, end))
            return y
        return call

    return lambda use_kernels: tuple(wrap(f, n) for f, n in zip(orig(use_kernels), names))


def tf32_hlu_factorization(hm):
    """K's H-LU through the kernel path with TF32 matmuls on and the dense
    Schur update in TF32 ``torch.baddbmm``: the lower-precision control of
    the phase-7 limits."""
    from repro_torch.harith import factorize_hlu, hlu
    orig, tf32 = hlu._kernels, torch.backends.cuda.matmul.allow_tf32

    def schur_tf32(c, a, b):
        return torch.baddbmm(c, a, b.transpose(1, 2), alpha=-1.0)

    hlu._kernels = lambda use_kernels: (orig(use_kernels)[:2] + (schur_tf32,)
                                        + orig(use_kernels)[3:])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return factorize_hlu(hm, 1e-2, tol=1e-3)
    finally:
        hlu._kernels, torch.backends.cuda.matmul.allow_tf32 = orig, tf32


def compare_hlu_factors(fa, fb, chunk: int = 512) -> tuple[float, float]:
    """Max abs differences of two factorizations: dense tiles directly,
    low-rank tiles as u v^T (their factors are fixed up to signs)."""
    dense = max_abs(fa.dense, fb.dense)
    lowrank = 0.0
    for i0 in range(0, fa.ulr.shape[0], chunk):
        sl = slice(i0, i0 + chunk)
        lowrank = max(lowrank, max_abs(fa.ulr[sl] @ fa.vlr[sl].transpose(1, 2),
                                       fb.ulr[sl] @ fb.vlr[sl].transpose(1, 2)))
    return dense, lowrank


def run_hlu(pts_k, iters_bj, out):
    """K's regression solve with the H-LU preconditioner."""
    from repro_torch.core import build_hmatrix, make_apply, sinusoid_targets
    from repro_torch.solve import make_solver
    sigma2 = 1e-2
    hm = build_hmatrix(pts_k, precompute=True, **K_BUILD)
    f = sinusoid_targets(pts_k, 8, 32.0)
    solver, t_make = wall_s(lambda: make_solver(hm, sigma2, tol=1e-3, max_iter=300,
                                                precond="hlu", hlu_opts={"tol": 1e-3}))
    pre = solver.preconditioner
    (c_sol, info), t_solve = wall_s(lambda: solver(f))
    c_again, _ = solver(f)
    iters = info.iters_per_column.tolist()
    resid = rel_err(make_apply(hm)(c_sol) + sigma2 * c_sol, f)
    identical = bool(torch.equal(c_sol, c_again))
    rep = pre.report()
    res = {"setup_s": pre.setup_seconds, "make_solver_s": t_make, "solve_s": t_solve,
           "iterations": info.iterations, "iters_per_column": iters,
           "reference_iters_per_column": K_HLU_REFERENCE_ITERS,
           "block_jacobi_iters_per_column": iters_bj, "converged": info.converged,
           "relative_residual": resid, "solves_bit_identical": identical, "report": rep}
    out["hlu"] = res
    log(f"[H-LU] setup {pre.setup_seconds:.3f} s; solve {t_solve:.3f} s, iterations per column "
        f"{iters} (repro {K_HLU_REFERENCE_ITERS}, block Jacobi {iters_bj}); relative residual "
        f"{resid:.3e}; two solves bit-identical {identical}")
    log(f"[H-LU] report {rep}")
    require(info.converged, "H-LU: not every column converged")
    require(resid <= 1e-4, f"H-LU: relative residual {resid}")
    require(all(abs(a - b) <= 2 for a, b in zip(iters, K_HLU_REFERENCE_ITERS)),
            f"H-LU: iterations {iters} not within 2 of repro's {K_HLU_REFERENCE_ITERS}")
    require(identical, "H-LU: two solves are not bit-identical")
    require(rep["tiles"] == K_HLU_TILES and rep["schedule"] == K_HLU_SCHEDULE,
            f"H-LU: tile grid {rep['tiles']} / schedule {rep['schedule']} differ from "
            f"{K_HLU_TILES} / {K_HLU_SCHEDULE}")
    return hm, pre, f


def run_hlu_measurements(hm, pre, f, rng, out):
    """Outside the counted run: the setup split by kernel (a second, timed
    factorization, which must give the same buffers), the per-iteration
    parts, the factorization through the plain versions on the card (with
    the PCG iterations it gives) and a TF32 control of its limits."""
    from repro_torch.core import make_apply
    from repro_torch.core.clustering import permute_to_tree
    from repro_torch.harith import HLUPreconditioner, factorize_hlu, hlu, hlu_solve_panels
    from repro_torch.solve import make_solver
    res = out["hlu"]
    events: dict = {}
    orig = hlu._kernels
    hlu._kernels = timed_hlu_kernels(events)
    try:
        timed, t_timed = wall_s(lambda: factorize_hlu(hm, 1e-2, tol=1e-3))
    finally:
        hlu._kernels = orig
    split = {name: sum(s.elapsed_time(e) for s, e in evs) / 1e3 for name, evs in events.items()}
    calls = {name: len(evs) for name, evs in events.items()}
    same = all(torch.equal(a, b) for a, b in ((timed.dense, pre.factors.dense),
                                              (timed.ulr, pre.factors.ulr),
                                              (timed.vlr, pre.factors.vlr)))
    res["setup_split_s"] = split
    res["setup_split_calls"] = calls
    res["timed_factorization_s"] = t_timed
    res["factorizations_bit_identical"] = same
    log(f"[H-LU] timed factorization {t_timed:.3f} s; kernel seconds {split} over calls "
        f"{calls}; the rest is gathers, scatters and products around them; bit-identical to "
        f"the first {same}")
    require(same, "H-LU: two factorizations differ")
    del timed
    # per iteration: one H-LU solve and one apply on an (n_pad, 8) panel
    x = randn((hm.tree.n, 8), rng)
    r_pad = permute_to_tree(hm.tree, x)
    res["hlu_solve_panels_ms"] = gpu_ms(lambda: hlu_solve_panels(pre.factors, r_pad), 3)
    res["apply_ms_R8"] = gpu_ms(lambda: make_apply(hm)(x), 3)
    res["ms_per_iteration"] = res["hlu_solve_panels_ms"] + res["apply_ms_R8"]
    log(f"[H-LU] per iteration: hlu_solve_panels {res['hlu_solve_panels_ms']:.3f} ms + apply "
        f"{res['apply_ms_R8']:.3f} ms")
    # the plain versions on the card, buffer by buffer
    plain, t_plain = wall_s(lambda: factorize_hlu(hm, 1e-2, tol=1e-3, use_kernels=False))
    d_dense, d_lowrank = compare_hlu_factors(pre.factors, plain)
    res["plain"] = {"factorization_s": t_plain, "dense_max_abs_diff": d_dense,
                    "lowrank_uvT_max_abs_diff": d_lowrank,
                    "finite": bool(torch.isfinite(plain.dense).all()
                                   and torch.isfinite(plain.ulr).all())}
    plain_solver = make_solver(hm, 1e-2, tol=1e-3, max_iter=300,
                               precond=HLUPreconditioner(plain, t_plain, 1e-3, plain.meta.kp))
    plain_iters = plain_solver(f)[1].iters_per_column.tolist()
    res["plain"].update(iters_per_column=plain_iters, ranks=plain.rank_stats())
    log(f"[H-LU plain] factorization {t_plain:.3f} s; max abs difference to the kernel path: "
        f"dense tiles {d_dense:.3e}, low-rank tiles (u v^T) {d_lowrank:.3e}; PCG iterations "
        f"with it {plain_iters}; ranks {res['plain']['ranks']}")
    require(res["plain"]["finite"], "H-LU plain path: non-finite factors")
    # fp32 SIMT kernels against cuBLAS / cuSOLVER in fp32: the dense tiles
    # and u v^T part by fp32 rounding only (H100 readings 1.4e-5 and 4.1e-7)
    require(d_dense <= HLU_DENSE_LIMIT and d_lowrank <= HLU_LOWRANK_LIMIT,
            f"H-LU: kernel and plain factorizations differ by {d_dense} (dense tiles, limit "
            f"{HLU_DENSE_LIMIT}) and {d_lowrank} (u v^T, limit {HLU_LOWRANK_LIMIT})")
    # control: the kernel path with TF32 matmuls and the dense Schur update
    # through TF32 baddbmm, held to the same limits (recorded, not gated)
    control = tf32_hlu_factorization(hm)
    c_dense, c_lowrank = compare_hlu_factors(control, plain)
    res["tf32_control"] = {"dense_max_abs_diff": c_dense, "lowrank_uvT_max_abs_diff": c_lowrank,
                           "within_limits": c_dense <= HLU_DENSE_LIMIT
                           and c_lowrank <= HLU_LOWRANK_LIMIT}
    log(f"[H-LU TF32 control] max abs difference to the plain factorization: dense tiles "
        f"{c_dense:.3e}, low-rank tiles (u v^T) {c_lowrank:.3e}; within the limits "
        f"{res['tf32_control']['within_limits']}")


def main(record: dict) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="01234567",
                        help="phases to run (default all: 01234567); 0 is always run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU", file=sys.stderr)
        return 2

    from repro_torch import _build

    card = smi("name,power.limit")
    log(f"[0] card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    require(torch.get_float32_matmul_precision() == "highest",
            "fp32 matmul precision must be 'highest'")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off")
    info = _build.build_all()
    log(f"[0] kernels built in {info['seconds']:.1f} s into {info['dir']}")
    for name, rep in info["ptxas"].items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[0] ptxas {name}: {line.strip()}")
    record.update(card=card, torch=torch.__version__, build_s=info["seconds"])
    rng = np.random.RandomState(SEED)

    pts_p = pts_k = hm_p = hm_k = None
    if set(args.phases) & set("123"):
        pts_p, hm_p, t_p = build_problem_p()
        pts_k, hm_k, t_k = build_problem_k()
        log(f"[build] P {plan_summary(hm_p)} in {t_p:.2f} s")
        log(f"[build] K {plan_summary(hm_k)} in {t_k:.2f} s")
        record.update(build_p_s=t_p, build_k_s=t_k)

    if "1" in args.phases:
        check_dense(hm_p, hm_k, rng, record["kernels"])
        check_matvec(hm_p, hm_k, rng, record["kernels"])
        check_lowrank(hm_p, rng, record["kernels"])
        check_cholesky(hm_p, hm_k, rng, record["kernels"])
        check_morton(pts_p, record["kernels"])
        check_aca(hm_p, hm_k, rng, record["kernels"])
        check_recompress(hm_p, rng, record["kernels"])
        check_trsm(hm_k, rng, record["kernels"])
        check_schur(rng, record["kernels"])
        for name, rec in record["kernels"].items():
            log(f"[1] {name}: max abs err {rec['max_abs_err']:.3e}, kernel {rec['ms']:.3f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, library {rec['library_ms']}, bound "
                f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}); {rec['timed_shape']}")
        dense = record["kernels"]["batched_kernel_matmat"]
        log(f"[1] batched_kernel_matmat on all {dense['whole_dense_group_blocks']} dense "
            f"leaves of P, R=8: {dense['whole_dense_group_ms']:.3f} ms")
        aca = record["kernels"]["batched_aca"]
        for ch in aca["checks"]:
            log(f"[1] batched_aca {ch['problem']} level {ch['level']} ({ch['blocks']} x "
                f"{ch['m']}): sampled max error {ch['sampled_max_err']:.3e} of max |phi| "
                f"{ch['sampled_max_abs_phi']:.3e}, relative {ch['sampled_rel_err']:.3e} "
                f"(plain {ch['plain_sampled_rel_err']:.3e}); other pivots in "
                f"{ch['blocks_with_other_pivots']} blocks")
        log(f"[1] batched_aca: {aca['blocks_with_other_pivots']} of {aca['blocks_checked']} "
            "checked blocks chose another pivot sequence than the plain version")
        rc = record["kernels"]["batched_recompress"]
        for ch in rc["checks"]:
            log(f"[1] batched_recompress {ch.get('level', ch.get('shape'))} ({ch['B']} x "
                f"{ch['m']} x {ch['k']}, tol {ch['tol']}): {ch['blocks_with_other_rank']} blocks "
                f"of another rank than the plain version; max relative reconstruction error "
                f"{ch['max_rel_err']:.3e} (plain {ch['plain_max_rel_err']:.3e}; largest gap on "
                f"blocks of equal rank {ch['max_rel_err_gap_same_rank']:.3e}); ranks max "
                f"{ch['ranks_max']} mean {ch['ranks_mean']:.3f}; Jacobi sweeps mean "
                f"{ch['sweeps_mean']:.2f}")
        log(f"[1] batched_recompress on all groups of P at tol 1e-3: {rc['ms_tol_1e-3']:.3f} ms "
            f"(plain {rc['plain_ms_tol_1e-3']:.3f}); on (8192, 256, 64) panels: "
            f"{rc['wide_ms']:.3f} ms (plain {rc['wide_plain_ms']:.3f}, bound "
            f"{rc['wide_bound_ms']:.3f} by {rc['wide_bound_by']})")
        torch.cuda.empty_cache()

    launches = {name: 0 for name in _build.LAUNCHES}

    def count_launches(key: str) -> None:
        torch.cuda.synchronize()
        record.setdefault(key, {})["launches"] = dict(_build.LAUNCHES)
        record[key]["oracle_calls"] = dict(_build.ORACLE_CALLS)
        for name, count in _build.LAUNCHES.items():
            launches[name] += count
        log(f"[{key}] launches {record[key]['launches']}; oracle-route calls "
            f"{record[key]['oracle_calls']}")
        missing = [name for name in PATH_KERNELS[key] if _build.LAUNCHES[name] == 0]
        require(not missing, f"{key}: kernels of this path never launched: {missing}")
        # the QR + SVD route below the Gram floor is taken by neither phase
        require(not any(_build.ORACLE_CALLS.values()),
                f"{key}: the oracle route was taken: {_build.ORACLE_CALLS}")

    if "2" in args.phases:
        _build.reset_launches()
        run_problem_p(pts_p, hm_p, rng, record)
        count_launches("P")
    del hm_p
    torch.cuda.empty_cache()
    if "3" in args.phases:
        _build.reset_launches()
        f, c_kern, iters_kern = run_problem_k(pts_k, hm_k, record)
        count_launches("K")
        allowed = run_problem_k_plain(hm_k, f, c_kern, iters_kern, record)
    del hm_k
    torch.cuda.empty_cache()
    pts_p = points_p() if pts_p is None else pts_p
    pts_k = points_k() if pts_k is None else pts_k
    if "4" in args.phases:
        # PyTorch loads a kernel's module at its first use: a small device
        # build first, so that the stage times below are those of a warm process
        from repro_torch.core import build_hmatrix_device
        build_hmatrix_device(pts_k[:4096], **K_BUILD)
        _build.reset_launches()
        run_device_build("P", pts_p, P_BUILD, rng, record)
        torch.cuda.empty_cache()
        run_device_build("K", pts_k, K_BUILD, rng, record)
        count_launches("device_build")
        torch.cuda.empty_cache()
    if "5" in args.phases:
        require("3" in args.phases, "phase 5 holds NP mode to phase 3's iteration counts")
        _build.reset_launches()
        run_np_mode(pts_p, pts_k, iters_kern, allowed, rng, record)
        count_launches("np_mode")
        torch.cuda.empty_cache()
    if "6" in args.phases:
        _build.reset_launches()
        run_memory_tier(pts_p, rng, record)
        count_launches("memory_tier")
        torch.cuda.empty_cache()
    if "7" in args.phases:
        _build.reset_launches()
        hm_hlu, pre, f_k = run_hlu(pts_k, iters_kern if "3" in args.phases else None, record)
        count_launches("hlu")
        run_hlu_measurements(hm_hlu, pre, f_k, rng, record)
        del hm_hlu, pre
    if set("234567") <= set(args.phases):
        missing = [name for name, count in launches.items() if count == 0]
        require(not missing, f"kernels never launched on the main path: {missing}")
    record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    record["wall_s"] = time.perf_counter() - T_START
    log(f"[end] peak memory {record['peak_memory_gib']:.2f} GiB; wall {record['wall_s']:.1f} s")

    kernels_line = []
    for name, (source, replaces) in KERNELS.items():
        rec = record["kernels"].get(name, {})
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec.get("max_abs_err"),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms")})
    print(json.dumps({"kernels": kernels_line}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    RECORD: dict = {"kernels": {}}
    try:
        sys.exit(main(RECORD))
    finally:
        # the detailed record is kept even when a phase fails (the error
        # still ends the run with a non-zero exit code)
        if len(RECORD) > 1:
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
                json.dumps(RECORD, indent=1, default=float))
