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
     square), with times of kernel, plain version and the PyTorch library
     call that computes the same function (the ACA also on all level groups
     of P, as one build runs it);
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
     convergence, iterations held to the P-mode kernel path's.

Kernel launch counts are set to 0 before each of phases 2 to 5 and read
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

# JAX reference, problem K (sigma2 = 1e-2, tol = 1e-3, R = 8): iterations
# per column of repro.solve.make_solver on the CPU
K_REFERENCE_ITERS = [145, 148, 143, 143, 143, 143, 147, 142]

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


def main(record: dict) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="012345",
                        help="phases to run (default all: 012345); 0 is always run")
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
        torch.cuda.empty_cache()

    launches = {name: 0 for name in _build.LAUNCHES}

    def count_launches(key: str) -> None:
        torch.cuda.synchronize()
        record.setdefault(key, {})["launches"] = dict(_build.LAUNCHES)
        for name, count in _build.LAUNCHES.items():
            launches[name] += count
        log(f"[{key}] launches {record[key]['launches']}")
        missing = [name for name in PATH_KERNELS[key] if _build.LAUNCHES[name] == 0]
        require(not missing, f"{key}: kernels of this path never launched: {missing}")

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
    if set("2345") <= set(args.phases):
        missing = [name for name, count in launches.items() if count == 0]
        require(not missing, f"kernels never launched on the main path: {missing}")
    record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

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
