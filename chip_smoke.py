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
     largest batch shapes, at B = 1 (their latency floor) and, at each
     launch width the wrapper can pick, on H-LU's batch sizes; the
     H-attention near field at the serving shape (80, 16, 512, 128) and at
     one prefill_32k layer (40, 64, 512, 128)), with times
     of kernel, plain version and the PyTorch library call that computes the
     same function (the ACA also on all level groups of P, as one build runs
     it, with the route each group took; its two routes, resident at every
     cluster size that fits and streamed, held to the same bits on the
     sampled blocks of every group of P and K; the dense-leaf product on all
     leaves of P and K through the level entry, which reads points and panel
     in place, equal bit for bit to the gathered entry; the low-rank apply on
     every level group of P and K through its level entry, which reads the
     panel in place and adds each row cluster's blocks into Z, equal bit for
     bit to the gathered entry followed by ``_scatter_rows``, with both
     routes timed per group of P; the block-Jacobi solve on all 512 blocks of
     P and at K's shape (128, 256), with its two-sweep floor);
  2. problem P, the paper's model problem (N = 2^20 Halton points on the
     unit square, gaussian, k = 16, c_leaf = 2048, eta = 1.5, P mode):
     build, apply to an (N, 8) panel and an (N,) vector, 512 sampled rows
     against the exact dense rows, two applies bit-identical, block-Jacobi
     setup and 10 PCG iterations; after the count, one apply under
     ``torch.profiler`` split into #2, #3, #4 and the glue (and the gathers
     in it), as after phases 3, 5 and 6 (K's apply, P's NP apply, P's
     recompressed store's apply);
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
     convergence, iterations held to the P-mode kernel path's; after the
     count, one NP apply of P split under the profiler as in phase 2;
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
     TRSM, SCHUR and re-truncation kernels' shares (the re-truncation's
     calls with their blocks, all-zero blocks and Jacobi sweeps, and its
     bound over them), ms per iteration; then
     the same factorization through the plain versions on the card, held
     buffer by buffer to the kernel path's, and a TF32 control (TF32 on:
     ``factorize_hlu`` must raise, its body is then run behind the guard);
  8. LM serving: qwen2.5-14b-hmatrix at full width and depth (48 layers,
     bf16, random from a generator seeded on the card), one batch of 2
     prompts of 8,192 tokens, prefill and 15 greedy decode steps through
     ``repro_torch.launch.serve.generate``; #11 launched once per layer of
     each prefill, finite logits, a second prefill bit-identical; then,
     outside the count, one prefill and one decode step under
     ``torch.profiler`` (kernel time by name, device idle share), #11 on
     layer 0's real q, k, v against its plain version, and a 2-layer
     full-width fp32 model through the kernel and through the plain near
     field on the card (logits within 1e-3, layer 0's h_attention within
     1e-4 relative), and its rows below 2 c_leaf against exact causal
     attention (1e-4).

Kernel launch counts are set to 0 before each of phases 2 to 8 and read
after it: each phase must have launched the kernels of its own path
(``PATH_KERNELS``), and every kernel must have run on the main path.  The
last lines are a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  A detailed record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
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
    "hattention_nearfield": ("src/repro_torch/csrc/hattention_nearfield.cu",
                             "src/repro/kernels/hattention_block/kernel.py:74"),
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
    "lm_serve": ("hattention_nearfield",),
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
    from repro_torch.kernels.batched_dense_matvec.kernel import (
        batched_kernel_matmat_cuda, batched_kernel_matmat_level_cuda)
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
    # the kernel on all dense leaves of P (and of K) in one launch, as an
    # apply makes it, through the level entry (points and panel read in
    # place): the kernels' share of the apply's time (the rest is glue).
    # The gathered entry on the same leaves must give the same bits.
    whole = {}
    for name, hm in (("P", hm_p), ("K", hm_k)):
        g, cl = hm.groups["dense"], hm.plan.c_leaf
        x_pad = randn((hm.plan.n_pad, 8), rng)
        leaf_pts = hm.tree.points.reshape(-1, cl, d)
        rows, cols = leaf_pts[g.rows], leaf_pts[g.cols]
        x_blk = x_pad.reshape(-1, cl, 8)[g.cols]
        y_level = batched_kernel_matmat_level_cuda(hm.tree.points, g.rows, g.cols, x_pad, cl)
        same = bool(torch.equal(y_level, batched_kernel_matmat_cuda(rows, cols, x_blk)))
        require(same, f"batched_kernel_matmat {name}: the level entry differs from the "
                "gathered entry")
        nb = int(g.rows.shape[0])
        whole[name] = {
            "blocks": nb, "C": cl, "level_equals_gathered": same,
            "bound_ms": bound_ms(4.0 * (2 * nb * cl * d + 2 * nb * cl * 8),
                                 nb * cl * cl * ((3 * d - 1) + 1 + 2 * 8))[0],
            "level_ms": gpu_ms(lambda: batched_kernel_matmat_level_cuda(
                hm.tree.points, g.rows, g.cols, x_pad, cl), 3),
            "gathered_ms": gpu_ms(lambda: batched_kernel_matmat_cuda(rows, cols, x_blk), 3)}
        del rows, cols, x_blk, y_level
    record["batched_kernel_matmat"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"B={b} C={c} d={d} R=8 (blocks of problem P)",
        "whole_dense_group_ms": whole["P"]["level_ms"],
        "whole_dense_group_blocks": whole["P"]["blocks"], "whole_dense_group": whole}


def lowrank_bytes(b: int, m: int, k: int, r: int, level: bool, n_pad: int = 0) -> float:
    """Bytes #4 must move on one level group: U, V and the X slices read
    once; the gathered entry writes Y, the level entry reads and writes Z
    once (n_pad rows)."""
    out = 2.0 * n_pad * r if level else float(b) * m * r
    return 4.0 * (2 * b * m * k + b * m * r + out)


def check_lowrank(hm_p, hm_k, rng, record):
    """#4 on every level group of P (R = 8): the gathered entry against the
    plain version, then the level entry (X read in place, row clusters
    added into Z) against the gathered entry + ``_scatter_rows``, bit for
    bit, on every group of P and K, with times of both routes."""
    from repro_torch.core.hmatrix import _scatter_rows
    from repro_torch.kernels.batched_aca.kernel import (batched_lowrank_matmat_cuda,
                                                        batched_lowrank_matmat_level_cuda)
    from repro_torch.kernels.batched_aca.ref import batched_lowrank_matmat_ref
    checks, groups = [], []
    ms = plain = lib = nbytes = flops = level_bytes = 0.0
    for name, hm in (("P", hm_p), ("K", hm_k)):
        n_pad = hm.plan.n_pad
        x_pad = randn((n_pad, 8), rng)
        z_pad = randn((n_pad, 8), rng)
        for level in sorted(hm.factors.keys()):
            u, v = hm.factors[level]
            g = hm.groups[level]
            b, m, k = u.shape
            x = x_pad.reshape(-1, m, 8)[g.cols]
            y = batched_lowrank_matmat_cuda(u, v, x)
            z_want = _scatter_rows(z_pad.clone(), y, g)
            z_got = batched_lowrank_matmat_level_cuda(u, v, x_pad, g.cols, g, z_pad.clone())
            same = bool(torch.equal(z_got, z_want))
            require(same, f"batched_lowrank_matmat {name} level {level}: the level entry differs "
                    "from the gathered entry + _scatter_rows")
            row = {"problem": name, "level": level, "B": b, "m": m, "k": k,
                   "distinct_rows": int(g.out_rows.shape[0]), "table_width": int(g.table.shape[1]),
                   "level_equals_gathered": same}
            if name == "P":
                y_ref = batched_lowrank_matmat_ref(u, v, x)
                err = rel_err(y, y_ref)
                row.update(rel_err=err, max_abs_err=max_abs(y, y_ref))
                checks.append(row)
                require(err <= 1e-5, f"batched_lowrank_matmat level {level}: rel err {err}")
                row["ms"] = gpu_ms(lambda: batched_lowrank_matmat_cuda(u, v, x), 5)
                row["plain_ms"] = gpu_ms(lambda: batched_lowrank_matmat_ref(u, v, x), 5)
                row["library_ms"] = gpu_ms(
                    lambda: torch.bmm(u, torch.bmm(v.transpose(1, 2), x)), 5)
                row["gathered_route_ms"] = gpu_ms(lambda: _scatter_rows(
                    z_pad.clone(), batched_lowrank_matmat_cuda(
                        u, v, x_pad.reshape(-1, m, 8)[g.cols]), g), 5)
                ms += row["ms"]
                plain += row["plain_ms"]
                lib += row["library_ms"]
                nbytes += lowrank_bytes(b, m, k, 8, False)
                level_bytes += lowrank_bytes(b, m, k, 8, True, n_pad)
                flops += 2.0 * b * k * 8 * 2 * m
            z_work = z_pad.clone()
            row["level_ms"] = gpu_ms(lambda: batched_lowrank_matmat_level_cuda(
                u, v, x_pad, g.cols, g, z_work), 5)
            row["level_bound_ms"] = bound_ms(lowrank_bytes(b, m, k, 8, True, n_pad),
                                             2.0 * b * k * 8 * 2 * m)[0]
            groups.append(row)
            del x, y, z_want, z_got, z_work
        del x_pad, z_pad
    bms, by = bound_ms(nbytes, flops)
    record["batched_lowrank_matmat"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "level_ms": sum(g["level_ms"] for g in groups if g["problem"] == "P"),
        "level_bound_ms": bound_ms(level_bytes, flops)[0],
        "gathered_route_ms": sum(g["gathered_route_ms"] for g in groups if g["problem"] == "P"),
        "groups": groups,
        "timed_shape": "every level group of problem P, R=8 (sum over levels); gathered entry"}


def shifted_diagonal(hm, sigma2: float, count: int | None):
    from repro_torch.core import diagonal_blocks
    a = diagonal_blocks(hm)
    if count is not None:
        a = a[:count].contiguous()
    a.diagonal(dim1=1, dim2=2).add_(sigma2)
    return a


def solve_bound(b: int, c: int, r: int, sweeps: int = 1) -> tuple[float, str]:
    """#6's bound: the lower triangle read ``sweeps`` times (1: each input
    once, as every bound here counts; 2: the floor of any two-sweep solve),
    X read and Y written once, against 2 c^2 R flops a block."""
    return bound_ms(4.0 * (sweeps * b * c * (c + 1) / 2 + 2 * b * c * r), 2.0 * b * c * c * r)


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
        if name == "K":
            # problem K's PCG shape (128 blocks of 256, R = 8): latency-bound
            b, c = l_k.shape[0], l_k.shape[1]
            k_shape = {"B": b, "c": c, "R": 8,
                       "ms": gpu_ms(lambda: batched_block_cholesky_solve_cuda(l_k, x), 20),
                       "plain_ms": gpu_ms(lambda: batched_block_cholesky_solve_ref(l_k, x), 2),
                       "library_ms": gpu_ms(lambda: torch.cholesky_solve(x, l_k), 20),
                       "bound_ms": solve_bound(b, c, 8)[0],
                       "two_sweep_floor_ms": solve_bound(b, c, 8, sweeps=2)[0]}
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
    bms, by = solve_bound(b, c, 8)
    again = batched_block_cholesky_solve_cuda(chol_p, x)
    require(bool(torch.equal(again, y_k)), "batched_block_cholesky_solve P (all blocks): two "
            "solves are not bit-identical")
    record["batched_block_cholesky_solve"] = {
        "checks": solve_checks, "max_abs_err": max(ch["max_abs_err"] for ch in solve_checks),
        "rel_err": max(ch["rel_err"] for ch in solve_checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "two_sweep_floor_ms": solve_bound(b, c, 8, sweeps=2)[0], "K_shape": k_shape,
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


def aca_routes_equal(points, rid, cid, m: int, k: int, smem: int, name: str, level: int) -> dict:
    """#3's two routes on the same sampled blocks: the streamed route and the
    resident route on every cluster size whose CTAs fit must give the same
    U, V and pivot keys, bit for bit."""
    from repro_torch.kernels.batched_aca.kernel import (RESIDENT_CLUSTERS, _aca_launch,
                                                        resident_fits)
    d = points.shape[1]
    want = _aca_launch(points, rid, points, cid, m, m, "gaussian", k, "streamed")
    clusters = [cs for cs in RESIDENT_CLUSTERS if resident_fits(m, m, k, d, cs, smem)]
    equal = {cs: all(bool(torch.equal(a, w)) for a, w in
                     zip(_aca_launch(points, rid, points, cid, m, m, "gaussian", k, "resident",
                                     cs), want))
             for cs in clusters}
    require(all(equal.values()), f"batched_aca {name} level {level}: the resident route "
            f"(clusters {equal}) differs from the streamed route")
    return {"problem": name, "level": level, "blocks": int(rid.shape[0]), "m": m,
            "resident_clusters_equal_to_streamed": equal}


def check_aca(hm_p, hm_k, rng, record):
    """The ACA kernel on up to 8 blocks of every level group of P and K,
    held by its sampled error relative to the group's largest sampled
    |phi| (K's coarse groups have entries near exp(-49): an absolute limit
    would pass zero factors there).  K's groups are also checked on the
    unit square (its points / 32, the same clusters), where the entries of
    its small blocks (m = 256 to 4096) are of order 1."""
    from functools import partial

    from repro_torch.core import batched_aca
    from repro_torch.kernels.batched_aca.kernel import (aca_route, batched_aca_level_cuda,
                                                        smem_per_block)
    from repro_torch.kernels.batched_aca.ref import batched_aca_level_ref
    from repro_torch.kernels.phi import phi_matrix
    checks, routes = [], []
    smem = smem_per_block(hm_p.tree.points.device)
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
            if name != "K/32":
                routes.append(aca_routes_equal(points, rid, cid, m, hm.k, smem, name, level))
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
        route, cluster = aca_route(m, m, hm_p.k, hm_p.tree.points.shape[1], smem)
        per_level[level] = {"B": int(g.rows.shape[0]), "m": m, "route": route,
                            "cluster": cluster, "ms": t, "plain_ms": tp}
        if route == "resident":            # the other route, for the picker's record
            per_level[level]["streamed_ms"] = gpu_ms(lambda: batched_aca_level_cuda(
                hm_p.tree.points, g.rows, g.cols, level, "gaussian", hm_p.k, route="streamed"), 3)
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
        "bound_bytes": nbytes, "bound_ops": ops, "per_level_P": per_level, "routes": routes,
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


# H-LU's batch sizes on K (c = 256): TRSM dense tiles (B, 256, 256) and V
# panels (B, 256, 32); Schur products with p = 256 and p = 32
TRSM_SWEEP = ((32, 256), (16, 256), (8, 256), (1, 256),
              (128, 32), (64, 32), (32, 32), (16, 32), (1, 32))
SCHUR_SWEEP = ((512, 256), (128, 256), (64, 256), (32, 256), (1, 256),
               (4096, 32), (256, 32), (32, 32), (1, 32))


def sweep_widths(name: str, shapes, variants, make, launch, picked) -> dict:
    """A kernel at each of its launch widths (``variants``) on each shape,
    through the C entry point its wrapper calls, with the width given
    instead of chosen: device ms per width, the wrapper's pick and the
    fastest.  Every width must give the wrapper's bits."""
    from repro_torch import _build
    out = {}
    for shape in shapes:
        args, want = make(shape)
        row = {"picked": picked(shape), "ms": {}}
        for w in variants:
            y = torch.empty_like(want)
            def run(w=w, y=y):
                _build.check(launch(args, y, w), f"{name} at width {w}")
            run()
            require(torch.equal(y, want), f"{name} {shape}: width {w} differs from the wrapper")
            row["ms"][w] = gpu_ms(run, 20)
        row["fastest"] = min(row["ms"], key=row["ms"].get)
        out[str(shape)] = row
        del args, want
    return out


def sweep_trsm(lmat: torch.Tensor, gen: torch.Generator) -> dict:
    """#9 at every chunk width on H-LU's TRSM batch sizes (one L_tt)."""
    import ctypes
    from repro_torch import _build
    from repro_torch.kernels import sm_count, stream_handle
    from repro_torch.kernels.batched_trsm_lowrank.kernel import (
        CHUNK_COLS, batched_trsm_panels_cuda, chunk_cols)
    fn = _build.c_function("trsm_panels", "repro_trsm_panels",
                           [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    smem = _build.c_function("trsm_panels", "repro_trsm_smem_bytes", [ctypes.c_int] * 2,
                             ctypes.c_longlong)
    c, sms = lmat.shape[1], sm_count(lmat.device)

    def make(shape):
        x = torch.randn(*shape, device="cuda", generator=gen)
        return x, batched_trsm_panels_cuda(lmat, x)

    def launch(x, y, rc):
        return fn(lmat.data_ptr(), 0, x.data_ptr(), y.data_ptr(), x.shape[0], c, x.shape[2], rc,
                  stream_handle(x.device))

    shapes = [(b, c, p) for b, p in TRSM_SWEEP]
    return {"smem_bytes": {rc: smem(c, rc) for rc in CHUNK_COLS},
            "by_shape": sweep_widths("batched_trsm_panels", shapes, CHUNK_COLS, make, launch,
                                     lambda s: chunk_cols(*s, sms))}


def sweep_schur(gen: torch.Generator) -> dict:
    """#10 at both CTA tiles on H-LU's Schur batch sizes (m = n = 256)."""
    import ctypes
    from repro_torch import _build
    from repro_torch.kernels import sm_count, stream_handle
    from repro_torch.kernels.batched_schur_update.kernel import (
        SCHUR_TILES, batched_schur_dense_cuda, schur_tile)
    fn = _build.c_function("schur_dense", "repro_schur_dense",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    smem = _build.c_function("schur_dense", "repro_schur_smem_bytes", [ctypes.c_int],
                             ctypes.c_longlong)
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))

    def make(shape):
        b, p = shape[0], shape[3]
        cc, a, bb = (torch.randn(b, r, q, device="cuda", generator=gen)
                     for r, q in ((256, 256), (256, p), (256, p)))
        return (cc, a, bb), batched_schur_dense_cuda(cc, a, bb)

    def launch(args, y, tile):
        cc, a, bb = args
        return fn(cc.data_ptr(), a.data_ptr(), bb.data_ptr(), y.data_ptr(), cc.shape[0], 256,
                  256, a.shape[2], tile, stream_handle(cc.device))

    shapes = [(b, 256, 256, p) for b, p in SCHUR_SWEEP]
    return {"smem_bytes": {t: smem(t) for t in SCHUR_TILES},
            "by_shape": sweep_widths("batched_schur_dense", shapes, SCHUR_TILES, make, launch,
                                     lambda s: schur_tile(s[0], s[1], s[2], sms))}


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
    # the latency floor of H-LU's small TRSM calls: one panel (B = 1)
    rng1, b1 = np.random.RandomState(SEED + 1), {}
    for p in (256, 32):
        x = randn((1, c, p), rng1)
        err = rel_err(batched_trsm_panels_cuda(lmat, x), batched_trsm_panels_ref(lmat, x))
        require(err <= 1e-4, f"batched_trsm_panels B=1 P={p}: rel err {err}")
        b1[f"(1, {c}, {p})"] = {
            "ms": gpu_ms(lambda: batched_trsm_panels_cuda(lmat, x), 50), "rel_err": err,
            "library_ms": gpu_ms(lambda: torch.linalg.solve_triangular(lmat, x, upper=False),
                                 50)}
    record["batched_trsm_panels"] = {
        "widths": sweep_trsm(lmat, torch.Generator("cuda").manual_seed(SEED)),
        "checks": checks,
        "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib, "B1": b1,
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
    # the latency floor of H-LU's small Schur calls: one target tile (B = 1)
    rng1, b1 = np.random.RandomState(SEED + 1), {}
    for p in (256, 32):
        cc, a, bb = randn((1, 256, 256), rng1), randn((1, 256, p), rng1), randn((1, 256, p), rng1)
        err = rel_err(batched_schur_dense_cuda(cc, a, bb), batched_schur_dense_ref(cc, a, bb))
        require(err <= 1e-5, f"batched_schur_dense B=1 p={p}: rel err {err}")
        b1[f"(1, 256, 256, p={p})"] = {
            "ms": gpu_ms(lambda: batched_schur_dense_cuda(cc, a, bb), 50), "rel_err": err,
            "library_ms": gpu_ms(lambda: torch.baddbmm(cc, a, bb.transpose(1, 2), alpha=-1), 50)}
    record["batched_schur_dense"] = {
        "widths": sweep_schur(torch.Generator("cuda").manual_seed(SEED)), "checks": checks,
        "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib, "B1": b1,
        "timed_shape": "(512, 256, 256, p=256) + (4096, 256, 256, p=32) (sum of the two)"}


# H-attention near field (#11): the serving shape (2 prompts x 40 heads, 16
# leaves of 512) and one layer of prefill_32k (40 heads, 64 leaves)
NEARFIELD_SHAPES = {"serve": (80, 16, 512, 128), "prefill_32k_layer": (40, 64, 512, 128)}
NEARFIELD_M_LIMIT, NEARFIELD_REL_LIMIT = 1e-5, 1e-4


def nearfield_work(bh: int, nl: int, c: int, d: int) -> tuple[float, float]:
    """(bytes, flops) the near field needs: q, k, v read once, num, den and m
    written once; 2 c^2 D flops for leaf 0's causal half-block products,
    6 c^2 D for each later leaf (the previous block in full)."""
    nbytes = 4.0 * bh * nl * c * (4 * d + 2)
    flops = float(bh) * c * c * d * (2 + 6 * (nl - 1))
    return nbytes, flops


def check_nearfield_inputs(q, k, v, label: str) -> dict:
    """#11 against its plain version on the card on one set of inputs."""
    from repro_torch.kernels.hattention_block.kernel import hattention_nearfield_cuda
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    num, den, m = hattention_nearfield_cuda(q, k, v)
    num_r, den_r, m_r = hattention_nearfield_ref(q, k, v)
    torch.cuda.synchronize()
    ch = {"inputs": label, "shape": list(q.shape), "m_max_abs_err": max_abs(m, m_r),
          "num_rel_err": rel_err(num, num_r), "den_rel_err": rel_err(den, den_r),
          "max_abs_err": max_abs(num, num_r)}
    del num_r, den_r, m_r
    again = hattention_nearfield_cuda(q, k, v)
    ch["bit_identical"] = all(torch.equal(a, b) for a, b in zip(again, (num, den, m)))
    log(f"[1] hattention_nearfield {label} {tuple(q.shape)}: m max abs err "
        f"{ch['m_max_abs_err']:.3e}, num rel err {ch['num_rel_err']:.3e}, den rel err "
        f"{ch['den_rel_err']:.3e}, max abs err of num {ch['max_abs_err']:.3e}, "
        f"bit-identical {ch['bit_identical']}")
    require(ch["m_max_abs_err"] <= NEARFIELD_M_LIMIT and ch["num_rel_err"] <= NEARFIELD_REL_LIMIT
            and ch["den_rel_err"] <= NEARFIELD_REL_LIMIT,
            f"hattention_nearfield {label}: {ch}")
    require(ch["bit_identical"], f"hattention_nearfield {label}: two launches differ")
    return ch


def sdpa_band(q, k, v):
    """The band of the near field as one ``scaled_dot_product_attention``
    call over (c, 2c) key windows [leaf i-1 | leaf i] with a boolean mask
    (previous leaf visible, own leaf causal).  A timing note only: leaf 0
    sees zero keys in its window, and SDPA returns normalised rows, not
    (num, den, m)."""
    import torch.nn.functional as F
    c = q.shape[2]
    kk = torch.cat([torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], 1), k], 2)
    vv = torch.cat([torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], 1), v], 2)
    ii = torch.arange(c, device=q.device)
    mask = torch.cat([torch.ones(c, c, dtype=torch.bool, device=q.device),
                      ii[:, None] >= ii[None, :]], 1)
    return lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask, scale=1.0)


def check_nearfield(record):
    """#11 on random q, k, v scaled as in tests/test_hattention_kernel.py, at
    the serving shape (timed, with the plain version and the SDPA note) and
    at one prefill_32k layer (timed)."""
    from repro_torch.kernels.hattention_block.kernel import hattention_nearfield_cuda
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rec = record.setdefault("hattention_nearfield", {"checks": []})
    for label, (bh, nl, c, d) in NEARFIELD_SHAPES.items():
        q = torch.randn(bh, nl, c, d, generator=gen, device="cuda") / math.sqrt(d)
        k = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
        v = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
        rec["checks"].append(check_nearfield_inputs(q, k, v, f"random, {label}"))
        nbytes, flops = nearfield_work(bh, nl, c, d)
        bms, by = bound_ms(nbytes, flops)
        ms = gpu_ms(lambda: hattention_nearfield_cuda(q, k, v), 5)
        rec[f"{label}_ms"], rec[f"{label}_bound_ms"], rec[f"{label}_gflop"] = ms, bms, flops / 1e9
        if label == "serve":
            rec.update(ms=ms, bound_ms=bms, bound_by=by, library_ms=None,
                       plain_ms=gpu_ms(lambda: hattention_nearfield_ref(q, k, v), 2),
                       sdpa_note_ms=gpu_ms(sdpa_band(q, k, v), 5),
                       timed_shape=f"serve {(bh, nl, c, d)}")
        log(f"[1] hattention_nearfield {label} {(bh, nl, c, d)}: {ms:.3f} ms, bound {bms:.3f} "
            f"ms ({by}, {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.2f} GB)")
        del q, k, v
        torch.cuda.empty_cache()
    rec["max_abs_err"] = max(ch["max_abs_err"] for ch in rec["checks"])
    log(f"[1] hattention_nearfield serve: plain {rec['plain_ms']:.3f} ms; SDPA on the same "
        f"band (note, not a library equivalent) {rec['sdpa_note_ms']:.3f} ms")


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
    del apply_h, z, z1
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
    return hm


# kernels of an apply by the names the profiler gives them (csrc/*.cu; #4
# clears its split counters with a memset, the apply's only one); the rest
# of the device time is the glue of core/hmatrix.py
APPLY_PARTS = {"#2 dense leaves": ("dense_matmat_kernel",),
               "#3 ACA": ("aca_resident_kernel", "aca_stream_"),
               "#4 low-rank": ("lowrank_vtx_kernel", "lowrank_ut_kernel", "Memset")}
GATHER_NAMES = ("index", "gather")


def apply_split(hm, rng) -> dict:
    """One apply of an (N, 8) panel under ``torch.profiler`` (after a warm
    one): device ms of #2, #3, #4 and the glue, launches of each, the
    glue's largest kernels, and the gathers (index kernels) in it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import make_apply
    apply_h = make_apply(hm)
    x = randn((hm.tree.n, 8), rng)
    apply_h(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = wall_s(lambda: apply_h(x))
    parts = {name: [0.0, 0] for name in list(APPLY_PARTS) + ["glue"]}
    glue, gathers = [], [0.0, 0]
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.device_time_total <= 0:
            continue
        part = next((name for name, keys in APPLY_PARTS.items()
                     if any(key in e.key for key in keys)), "glue")
        parts[part][0] += e.device_time_total / 1e3
        parts[part][1] += e.count
        if part == "glue":
            glue.append({"name": e.key[:100], "ms": e.device_time_total / 1e3, "calls": e.count})
            if any(g in e.key.lower() for g in GATHER_NAMES):
                gathers[0] += e.device_time_total / 1e3
                gathers[1] += e.count
    glue.sort(key=lambda g: -g["ms"])
    device_ms = sum(v[0] for v in parts.values())
    return {"host_ms": secs * 1e3, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / 1e3 / secs),
            "parts_ms": {k: v[0] for k, v in parts.items()},
            "parts_launches": {k: v[1] for k, v in parts.items()},
            "glue_gathers_ms": gathers[0], "glue_gathers_launches": gathers[1],
            "glue_top": glue[:8]}


def log_apply_split(key: str, split: dict) -> None:
    parts = ", ".join(f"{k} {v:.3f} ms ({split['parts_launches'][k]} launches)"
                      for k, v in split["parts_ms"].items())
    log(f"[{key} profile] one apply R=8: host {split['host_ms']:.3f} ms, device "
        f"{split['device_ms']:.3f} ms (idle {split['idle_share']:.3f}): {parts}; gathers in the "
        f"glue {split['glue_gathers_ms']:.3f} ms ({split['glue_gathers_launches']} launches)")
    for g in split["glue_top"]:
        log(f"[{key} profile]   glue {g['ms']:9.3f} ms {g['calls']:5d}x  {g['name']}")


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
    return hm_1e2


def timed_hlu_kernels(events: dict, retruncations: list):
    """``harith.hlu._kernels`` with each kernel call bracketed by CUDA events
    (appended to ``events[name]``), for the setup's split by kernel.  The
    re-truncation calls #8's wrapper itself (the route of
    ``batched_schur_retruncate`` for CUDA operands above the Gram floor) so
    that its sweep counts are kept: ``retruncations`` gets (B, m, n, k, the
    all-zero blocks, the sweeps) of every call."""
    from repro_torch.harith import hlu
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    from repro_torch.kernels.batched_recompress.ops import GRAM_TOL_FLOOR
    orig = hlu._kernels
    names = ("batched_block_cholesky", "batched_trsm_panels", "batched_schur_dense")

    def wrap(fn, name):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(*args)
            end.record()
            events.setdefault(name, []).append((start, end))
            return y
        return call

    def retruncate(u, v, tol, kp):
        require(tol >= GRAM_TOL_FLOOR, f"H-LU re-truncation at tol {tol} takes the oracle route")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        u2, v2, _, _, sweeps = batched_recompress_cuda(u, v, tol)
        end.record()
        events.setdefault("batched_recompress", []).append((start, end))
        zero = (u.abs().amax(dim=(1, 2)) == 0) | (v.abs().amax(dim=(1, 2)) == 0)
        retruncations.append((u.shape[0], u.shape[1], v.shape[1], u.shape[2], zero, sweeps))
        return u2[:, :, :kp], v2[:, :, :kp]

    return lambda use_kernels: (tuple(wrap(f, n) for f, n in zip(orig(use_kernels), names))
                                + (retruncate,))


def retruncation_work(retruncations: list) -> dict:
    """#8's H-LU calls: blocks, all-zero blocks, the sweeps the real blocks
    ran, and the bound from ``recompress_work`` over this run's calls (the
    zero blocks read and write their panels and need no operations)."""
    rows, nbytes, ops = [], 0.0, 0.0
    for b, m, n, k, zero, sweeps in retruncations:
        z = int(zero.sum())
        sw = float(sweeps[~zero].double().sum())
        b_, o_ = recompress_work(b - z, m, n, k, sw)
        nbytes += b_ + 4.0 * 2 * z * (m + n) * k
        ops += o_
        rows.append({"B": b, "real": b - z, "zero": z,
                     "sweeps_mean": sw / (b - z) if b > z else 0.0})
    real = sum(r["real"] for r in rows)
    bms, by = bound_ms(nbytes, ops)
    return {"calls": len(rows), "blocks": sum(r["B"] for r in rows), "real": real,
            "zero": sum(r["zero"] for r in rows),
            "sweeps_mean_real": sum(r["sweeps_mean"] * r["real"] for r in rows) / max(real, 1),
            "bound_s": bms / 1e3, "bound_by": by, "bound_bytes": nbytes, "bound_ops": ops,
            "per_call": rows}


def tf32_hlu_factorization(hm):
    """K's H-LU through the kernel path with TF32 matmuls on and the dense
    Schur update in TF32 ``torch.baddbmm``: the lower-precision control of
    the phase-7 limits.  ``factorize_hlu`` itself must refuse to run while
    TF32 is on (its guard); the control calls the body behind the guard.
    Returns (factors, whether the guard refused)."""
    from repro_torch.harith import factorize_hlu, hlu
    orig, tf32 = hlu._kernels, torch.backends.cuda.matmul.allow_tf32

    def schur_tf32(c, a, b):
        return torch.baddbmm(c, a, b.transpose(1, 2), alpha=-1.0)

    hlu._kernels = lambda use_kernels: (orig(use_kernels)[:2] + (schur_tf32,)
                                        + orig(use_kernels)[3:])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        refused = False
        try:
            factorize_hlu(hm, 1e-2, tol=1e-3)
        except RuntimeError as err:        # the guard this control expects
            refused = "TF32" in str(err)
        return hlu._factorize_hlu(hm, 1e-2, tol=1e-3, kp=None, use_kernels=True), refused
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
    retruncations: list = []
    orig = hlu._kernels
    hlu._kernels = timed_hlu_kernels(events, retruncations)
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
    res["retruncation"] = rt = retruncation_work(retruncations)
    log(f"[H-LU] #8 re-truncation: {rt['calls']} calls, {rt['blocks']} blocks ({rt['real']} "
        f"real, {rt['zero']} all-zero), Jacobi sweeps mean {rt['sweeps_mean_real']:.3f} on the "
        f"real blocks; {split['batched_recompress']:.4f} s against a bound of "
        f"{rt['bound_s']:.4f} s ({rt['bound_by']})")
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
    control, refused = tf32_hlu_factorization(hm)
    c_dense, c_lowrank = compare_hlu_factors(control, plain)
    res["tf32_control"] = {"dense_max_abs_diff": c_dense, "lowrank_uvT_max_abs_diff": c_lowrank,
                           "within_limits": c_dense <= HLU_DENSE_LIMIT
                           and c_lowrank <= HLU_LOWRANK_LIMIT,
                           "factorize_hlu_refused_tf32": refused}
    require(refused, "H-LU: factorize_hlu ran with TF32 on instead of raising")
    log(f"[H-LU TF32 control] max abs difference to the plain factorization: dense tiles "
        f"{c_dense:.3e}, low-rank tiles (u v^T) {c_lowrank:.3e}; within the limits "
        f"{res['tf32_control']['within_limits']}; factorize_hlu refused TF32 {refused}")


# ---------------------------------------------------------------------------
# phase 8: LM serving (qwen2.5-14b-hmatrix)
# ---------------------------------------------------------------------------

LM_ARCH, LM_BATCH, LM_PROMPT, LM_TOKENS = "qwen2.5-14b-hmatrix", 2, 8192, 16
LM_PARAMS = 14_770_033_664
LM_LOGITS_LIMIT, LM_HATT_LIMIT, LM_EXACT_LIMIT = 1e-3, 1e-4, 1e-4


@contextlib.contextmanager
def plain_nearfield():
    """Within the block, ``h_attention``'s near field runs its plain version
    on the card (``kernels/hattention_block/ref.py``) instead of #11."""
    from repro_torch.core import hattention
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref
    orig = hattention.hattention_nearfield_op
    hattention.hattention_nearfield_op = hattention_nearfield_ref
    try:
        yield
    finally:
        hattention.hattention_nearfield_op = orig


def layer0_qkv(params, cfg, prompts):
    """Layer 0's q, k, v (after RoPE) for ``prompts``, as attention_block forms them."""
    from repro_torch.models.layers import _proj_qkv, apply_norm, apply_rope, embed_tokens
    with torch.inference_mode():
        x = embed_tokens(params.embed, prompts)
        h = apply_norm(cfg.norm_type, params.layers[0].ln1, x)
        q, k, v = _proj_qkv(params.layers[0].attn, cfg, h)
        pos = torch.arange(prompts.shape[1], device=prompts.device)
        return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def exact_causal_attention(q, k, v):
    """Plain fp32 causal softmax attention with grouped KV heads."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, d) / math.sqrt(d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=q.device))
    p = torch.softmax(torch.where(mask, sc, torch.full_like(sc, -1e30)), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def run_lm_serve(out):
    """The main path of phase 8: the 48-layer model serves one batch.  Returns
    the model and prompts for the checks after the launch count."""
    from repro_torch import _build
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import count_params, get_model
    from repro_torch.serve.step import make_prefill_step
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params, t_init = wall_s(lambda: model["init_params"](gen))
    n_params = count_params(params)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res = generate(params, cfg, prompts, LM_TOKENS)
    launches_first = _build.LAUNCHES["hattention_nearfield"]
    (logits2, caches2), t_prefill2 = wall_s(lambda: make_prefill_step(cfg)(params, prompts))
    launches_both = _build.LAUNCHES["hattention_nearfield"]
    identical = bool(torch.equal(logits2, res["prefill_logits"])) and all(
        torch.equal(k2, k[:, :LM_PROMPT]) and torch.equal(v2, v[:, :LM_PROMPT])
        for (k2, v2), (k, v) in zip(caches2, res["caches"]))
    finite = bool(torch.isfinite(res["prefill_logits"]).all() and torch.isfinite(logits2).all()
                  and torch.isfinite(res["logits"]).all())
    tokens = res["tokens"]
    n_tok = LM_BATCH * LM_PROMPT
    cache_bytes = sum(k.numel() * k.element_size() * 2 for k, _ in res["caches"])
    rec = {"arch": LM_ARCH, "layers": cfg.n_layers, "params": n_params, "dtype": cfg.dtype,
           "batch": LM_BATCH, "prompt_len": LM_PROMPT, "tokens_generated": LM_TOKENS,
           "init_s": t_init, "prefill_s_first": res["prefill_s"], "prefill_s": t_prefill2,
           "prefill_tok_per_s": n_tok / t_prefill2,
           "prefill_tok_per_s_first": n_tok / res["prefill_s"],
           "decode_ms_per_step": res["decode_s"] / (LM_TOKENS - 1) * 1e3,
           "nearfield_launches_first_prefill": launches_first,
           "nearfield_launches_two_prefills": launches_both,
           "prefills_bit_identical": identical, "logits_finite": finite,
           "kv_cache_bytes": cache_bytes,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_row_tokens": tokens[0].tolist()}
    out["lm_serve"] = rec
    log(f"[lm] {LM_ARCH}: {n_params:,} parameters ({cfg.n_layers} layers, {cfg.dtype}) made in "
        f"{t_init:.2f} s; prefill {LM_BATCH} x {LM_PROMPT}: first {res['prefill_s']:.3f} s, "
        f"again {t_prefill2:.3f} s ({rec['prefill_tok_per_s']:.0f} tok/s); decode "
        f"{rec['decode_ms_per_step']:.2f} ms per step; #11 launches {launches_first} then "
        f"{launches_both}; prefills bit-identical {identical}; logits finite {finite}; KV "
        f"cache {cache_bytes / 1e9:.2f} GB; peak {rec['peak_memory_gib']:.2f} GiB")
    log(f"[lm] generated (first row): {rec['first_row_tokens']}")
    require(n_params == LM_PARAMS, f"lm: {n_params} parameters, expected {LM_PARAMS}")
    require(launches_first == cfg.n_layers and launches_both == 2 * cfg.n_layers,
            f"lm: #11 launched {launches_first} / {launches_both} times, expected one per "
            f"layer of each prefill ({cfg.n_layers})")
    require(finite, "lm: non-finite logits")
    require(identical, "lm: two prefills differ")
    require(tokens.shape == (LM_BATCH, LM_TOKENS) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size, f"lm: bad tokens {tuple(tokens.shape)}")
    rec["main_path_s"] = time.perf_counter() - t_phase
    return {"params": params, "cfg": cfg, "prompts": prompts, "t_phase": t_phase}


def device_profile(fn, top: int = 12) -> dict:
    """``fn()`` under ``torch.profiler``: host seconds (ending in a sync),
    the summed device time of every kernel, the device's idle share of the
    host time, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = wall_s(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    total_ms = sum(e.device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.device_time_total)
    return {"host_s": secs, "device_ms": total_ms, "kernel_launches": sum(e.count for e in kernels),
            "idle_share": max(0.0, 1.0 - total_ms / 1e3 / secs),
            "top": [{"name": e.key[:120], "ms": e.device_time_total / 1e3,
                     "calls": e.count} for e in kernels[:top]]}


def profile_lm(params, cfg, prompts, rec):
    """One prefill and one decode step of the 48-layer model under the
    profiler (outside the counted run)."""
    from repro_torch.launch.serve import grow_caches
    from repro_torch.serve.step import greedy_sample, make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    rec["profile"] = {"prefill": device_profile(lambda: out.update(
        zip(("logits", "caches"), prefill(params, prompts))))}
    caches = grow_caches(out.pop("caches"), 2)
    tok = greedy_sample(out.pop("logits"), cfg.vocab_size)
    decode(params, tok, caches, LM_PROMPT)
    rec["profile"]["decode_step"] = device_profile(
        lambda: decode(params, tok, caches, LM_PROMPT + 1))
    for name, prof in rec["profile"].items():
        log(f"[lm profile] {name}: host {prof['host_s'] * 1e3:.2f} ms, "
            f"{prof['kernel_launches']} kernels {prof['device_ms']:.2f} ms, device idle "
            f"{prof['idle_share']:.3f}")
        for k in prof["top"]:
            log(f"[lm profile]   {k['ms']:10.3f} ms  {k['calls']:6d}x  {k['name']}")


def run_lm_checks(state: dict, record):
    """After the launch count: #11 on layer 0's real q, k, v against its
    plain version, then the 2-layer full-width fp32 model through the kernel
    and through the plain near field, and against exact attention.  Takes
    the 48-layer model out of ``state`` and frees it first."""
    from repro_torch.core.hattention import h_attention, leaf_blocks
    from repro_torch.models.api import get_model
    from repro_torch.serve.step import make_prefill_step
    rec = record["lm_serve"]
    params, cfg, prompts = state.pop("params"), state["cfg"], state["prompts"]
    profile_lm(params, cfg, prompts, rec)
    q, k, v = layer0_qkv(params, cfg, prompts)
    _, _, _, ql, kl, vl = leaf_blocks(q, k, v, cfg.h_c_leaf)
    nf = record["kernels"].setdefault("hattention_nearfield", {"checks": []})
    nf["checks"].append(check_nearfield_inputs(ql, kl, vl, "layer 0 of the 48-layer model"))
    nf["max_abs_err"] = max(ch["max_abs_err"] for ch in nf["checks"])
    del params, q, k, v, ql, kl, vl
    torch.cuda.empty_cache()

    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    params2 = get_model(cfg2)["init_params"](torch.Generator(device="cuda").manual_seed(SEED))
    prefill = make_prefill_step(cfg2)
    logits_k, _ = prefill(params2, prompts)
    q, k, v = layer0_qkv(params2, cfg2, prompts)
    with torch.inference_mode():
        att_k = h_attention(q, k, v, c_leaf=cfg2.h_c_leaf, rank=cfg2.h_rank)
        with plain_nearfield():
            logits_p, _ = prefill(params2, prompts)
            att_p = h_attention(q, k, v, c_leaf=cfg2.h_c_leaf, rank=cfg2.h_rank)
        n_ex = 2 * cfg2.h_c_leaf
        exact = exact_causal_attention(q[:, :n_ex], k[:, :n_ex], v[:, :n_ex])
    fp32 = {"logits_rel_err": rel_err(logits_k, logits_p),
            "h_attention_rel_err": rel_err(att_k, att_p),
            "exact_rows": n_ex, "exact_max_abs_err": max_abs(att_k[:, :n_ex], exact),
            "exact_max_abs_err_plain": max_abs(att_p[:, :n_ex], exact),
            "logits_finite": bool(torch.isfinite(logits_k).all())}
    rec["fp32_2_layers"] = fp32
    log(f"[lm fp32, 2 layers] kernel vs plain near field: last-position logits rel err "
        f"{fp32['logits_rel_err']:.3e} (limit {LM_LOGITS_LIMIT}), layer-0 h_attention rel err "
        f"{fp32['h_attention_rel_err']:.3e} (limit {LM_HATT_LIMIT}); rows < {n_ex} against "
        f"exact attention: max abs err {fp32['exact_max_abs_err']:.3e} (plain route "
        f"{fp32['exact_max_abs_err_plain']:.3e}, limit {LM_EXACT_LIMIT})")
    require(fp32["logits_finite"], "lm fp32: non-finite logits")
    require(fp32["logits_rel_err"] <= LM_LOGITS_LIMIT and fp32["h_attention_rel_err"] <= LM_HATT_LIMIT,
            f"lm fp32: kernel and plain routes differ: {fp32}")
    require(fp32["exact_max_abs_err"] <= LM_EXACT_LIMIT,
            f"lm fp32: rows below 2 c_leaf differ from exact attention: {fp32}")
    rec["phase_s"] = time.perf_counter() - state["t_phase"]
    log(f"[lm] phase 8 wall {rec['phase_s']:.1f} s (main path {rec['main_path_s']:.1f} s)")


def main(record: dict) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="012345678",
                        help="phases to run (default all: 012345678); 0 is always run")
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
    # the LM's bf16 products accumulate in fp32, as the reference's XLA programs do
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    info = _build.build_all()
    log(f"[0] kernels built in {info['seconds']:.1f} s into {info['dir']}")
    for name, rep in info["ptxas"].items():
        for line in rep.splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
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
        check_lowrank(hm_p, hm_k, rng, record["kernels"])
        check_cholesky(hm_p, hm_k, rng, record["kernels"])
        check_morton(pts_p, record["kernels"])
        check_aca(hm_p, hm_k, rng, record["kernels"])
        check_recompress(hm_p, rng, record["kernels"])
        check_trsm(hm_k, rng, record["kernels"])
        check_schur(rng, record["kernels"])
        check_nearfield(record["kernels"])
        for name, rec in record["kernels"].items():
            log(f"[1] {name}: max abs err {rec['max_abs_err']:.3e}, kernel {rec['ms']:.3f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, library {rec['library_ms']}, bound "
                f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}); {rec['timed_shape']}")
        lowrank = record["kernels"]["batched_lowrank_matmat"]
        for g in lowrank["groups"]:
            times = (f"gathered {g['ms']:.3f} ms (with gather + _scatter_rows "
                     f"{g['gathered_route_ms']:.3f} ms), " if "ms" in g else "")
            log(f"[1] batched_lowrank_matmat {g['problem']} level {g['level']} ({g['B']} x "
                f"{g['m']}, k={g['k']}, {g['distinct_rows']} row clusters, table width "
                f"{g['table_width']}): {times}level entry {g['level_ms']:.3f} ms (bound "
                f"{g['level_bound_ms']:.3f}); level equals gathered + scatter "
                f"{g['level_equals_gathered']}")
        log(f"[1] batched_lowrank_matmat P, all groups: level entry {lowrank['level_ms']:.3f} ms "
            f"(bound {lowrank['level_bound_ms']:.3f}), gathered route "
            f"{lowrank['gathered_route_ms']:.3f} ms")
        ks = record["kernels"]["batched_block_cholesky_solve"]["K_shape"]
        log(f"[1] batched_block_cholesky_solve at K's shape ({ks['B']}, {ks['c']}, R=8): kernel "
            f"{ks['ms']:.4f} ms, plain {ks['plain_ms']:.3f}, library {ks['library_ms']:.4f}, "
            f"bound {ks['bound_ms']:.4f} (two sweeps {ks['two_sweep_floor_ms']:.4f})")
        dense = record["kernels"]["batched_kernel_matmat"]
        for name, w in dense["whole_dense_group"].items():
            log(f"[1] batched_kernel_matmat on all {w['blocks']} dense leaves of {name} (C="
                f"{w['C']}, R=8): level entry {w['level_ms']:.3f} ms, gathered entry "
                f"{w['gathered_ms']:.3f} ms, bound {w['bound_ms']:.3f} ms (operations); equal "
                f"bit for bit {w['level_equals_gathered']}")
        for name in ("batched_trsm_panels", "batched_schur_dense"):
            widths = record["kernels"][name]["widths"]
            log(f"[1] {name} dynamic shared memory by width: {widths['smem_bytes']}")
            for shape, row in widths["by_shape"].items():
                times = ", ".join(f"{w}: {t:.4f}" for w, t in row["ms"].items())
                log(f"[1] {name} at {shape}: ms by width {{{times}}}; wrapper picks "
                    f"{row['picked']}, fastest {row['fastest']}")
            for shape, row in record["kernels"][name]["B1"].items():
                log(f"[1] {name} at {shape}: kernel {row['ms']:.4f} ms, library "
                    f"{row['library_ms']:.4f} ms, rel err {row['rel_err']:.3e}")
        aca = record["kernels"]["batched_aca"]
        for ch in aca["checks"]:
            log(f"[1] batched_aca {ch['problem']} level {ch['level']} ({ch['blocks']} x "
                f"{ch['m']}): sampled max error {ch['sampled_max_err']:.3e} of max |phi| "
                f"{ch['sampled_max_abs_phi']:.3e}, relative {ch['sampled_rel_err']:.3e} "
                f"(plain {ch['plain_sampled_rel_err']:.3e}); other pivots in "
                f"{ch['blocks_with_other_pivots']} blocks")
        log(f"[1] batched_aca: {aca['blocks_with_other_pivots']} of {aca['blocks_checked']} "
            "checked blocks chose another pivot sequence than the plain version")
        for rt in aca["routes"]:
            log(f"[1] batched_aca routes {rt['problem']} level {rt['level']} ({rt['blocks']} x "
                f"{rt['m']}): resident clusters equal to streamed "
                f"{rt['resident_clusters_equal_to_streamed']}")
        for level, row in aca["per_level_P"].items():
            log(f"[1] batched_aca P level {level} ({row['B']} x {row['m']}): {row['route']} "
                f"(cluster {row['cluster']}) {row['ms']:.3f} ms"
                + (f", streamed {row['streamed_ms']:.3f} ms" if "streamed_ms" in row else "")
                + f"; plain {row['plain_ms']:.3f} ms")
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
        record["P"]["apply_split"] = apply_split(hm_p, rng)
        log_apply_split("P", record["P"]["apply_split"])
    del hm_p
    torch.cuda.empty_cache()
    if "3" in args.phases:
        _build.reset_launches()
        f, c_kern, iters_kern = run_problem_k(pts_k, hm_k, record)
        count_launches("K")
        record["K"]["apply_split"] = apply_split(hm_k, rng)
        log_apply_split("K", record["K"]["apply_split"])
        allowed = run_problem_k_plain(hm_k, f, c_kern, iters_kern, record)
    del hm_k
    torch.cuda.empty_cache()
    if set(args.phases) & set("4567"):
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
        hm_np = run_np_mode(pts_p, pts_k, iters_kern, allowed, rng, record)
        count_launches("np_mode")
        record["P_np"]["apply_split"] = apply_split(hm_np, rng)
        log_apply_split("P NP", record["P_np"]["apply_split"])
        del hm_np
        torch.cuda.empty_cache()
    if "6" in args.phases:
        _build.reset_launches()
        hm_1e2 = run_memory_tier(pts_p, rng, record)
        count_launches("memory_tier")
        record["memory_tier"]["apply_split_tol_1e-2"] = apply_split(hm_1e2, rng)
        log_apply_split("memory tier 1e-2", record["memory_tier"]["apply_split_tol_1e-2"])
        del hm_1e2
        torch.cuda.empty_cache()
    if "7" in args.phases:
        _build.reset_launches()
        hm_hlu, pre, f_k = run_hlu(pts_k, iters_kern if "3" in args.phases else None, record)
        count_launches("hlu")
        run_hlu_measurements(hm_hlu, pre, f_k, rng, record)
        del hm_hlu, pre
    if "8" in args.phases:
        del pts_p, pts_k
        torch.cuda.empty_cache()
        _build.reset_launches()
        lm_state = run_lm_serve(record)
        count_launches("lm_serve")
        run_lm_checks(lm_state, record)
        del lm_state
        torch.cuda.empty_cache()
    if set("2345678") <= set(args.phases):
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
