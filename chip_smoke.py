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
     one prefill_32k layer (40, 64, 512, 128); its backward #11b from #11's
     outputs at the training shape (40, 8, 512, 128), at the serving shape,
     with tied row maxima, with near-tie rows (a key two ulps below the
     row's max) and with scores up to about +-30, against the plain
     derivative, timed beside autograd through SDPA on the same band, its
     registers, spills, shared bytes and CTAs an SM, and the tensor-core
     instructions in its SASS), with times
     of kernel, plain version and the PyTorch library call that computes the
     same function (the ACA also on all level groups of P, as one build runs
     it, with the route each group took; its two routes, resident at every
     cluster size that fits and streamed, held to the same bits on the
     sampled blocks of every group of P and K; the dense-leaf product on all
     leaves of P and K through the level entry, which reads points and panel
     in place, equal bit for bit to the gathered entry, and at the
     benchmark's widths R = 16, 32 and 64 (its wide route) on 64 blocks and
     on all dense leaves of both benchmark configurations, the Gaussian 2-D (P)
     and the Matern 3-D at N = 2^20; the low-rank apply on
     every level group of P and K through its level entry, which reads the
     panel in place and adds each row cluster's blocks into Z, equal bit for
     bit to the gathered entry followed by ``_scatter_rows``, with both
     routes timed per group of P; the block-Jacobi solve on all 512 blocks of
     P and at K's shape (128, 256), with its two-sweep floor; the block
     Cholesky on 32 of P's blocks (its wide route, also split into diagonal
     tiles, panels and trailing updates by CUDA events), on all of K's
     (128, 256) and at B = 1 (its shared-memory route), each also through
     the wrapper back to back, and on all 512 of P's blocks, beside
     ``torch.linalg.cholesky``, two calls
     bit-identical, and a block with row and column 40 zeroed (a clamped
     pivot) on both routes; the Morton encode also on edge points);
  2. problem P, the paper's model problem (N = 2^20 Halton points on the
     unit square, gaussian, k = 16, c_leaf = 2048, eta = 1.5, P mode):
     build, apply to an (N, 8) panel and an (N,) vector, 512 sampled rows
     against the exact dense rows, two applies bit-identical, block-Jacobi
     setup and 10 PCG iterations; after the count, the block-Jacobi setup
     split into ``diagonal_blocks`` and the factorisation (as after phase 3
     for K), and one apply under ``torch.profiler`` split into #2, #3, #4
     and the glue (and the gathers in it), as after phases 3, 5 and 6 (K's
     apply, P's NP apply, P's recompressed store's apply);
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
     attention (1e-4);
  f. the other LM families (run after phase 8): mixtral-8x7b (8 of its 32
     layers: 32 need 93.4 GB), granite-moe-1b-a400m, zamba2-7b, xlstm-1.3b,
     whisper-tiny, gemma-7b, smollm-135m, phi3-medium-14b and chameleon-34b
     (24 of 48 layers: 48 need 68.6 GB) at their published widths, bf16,
     random from a generator seeded on the card; 2 prompts (8,192 tokens for
     mixtral, past its 4,096 window; 2,048 for xlstm, whose sLSTM layers step
     per token; 1,024 frames and tokens for whisper; 4,096 otherwise), one
     prefill and 15 greedy decode steps through ``generate``: finite logits,
     a second prefill bit-identical (logits, caches and states), prefill s and
     tok/s, decode ms per step, peak memory, parameters; mixtral's, zamba2's
     and xlstm's prefill under ``torch.profiler``; then per model a
     full-width fp32 model of small depth (2 layers; one period of zamba2 and
     xlstm; 2 + 2 for whisper; capacity factor 8): the decode step after a
     prefill of 300 tokens within 1e-3 relative of the train-mode forward's
     logits at position 300.  No hand-written kernel runs here: ``repro``
     runs these families outside any ``pallas_call``.  Everything is freed
     before phase t;
  9. serving (run after phase 3, on the H-matrices of setup):
     ``HMatrixServer(hm_p, max_batch=64)``, precompiled, on 150 requests
     made from the seed (panels of 64, 64 and 32): ``serve()`` and
     ``serve_async()`` bit-identical, panel 1 equal to ``make_apply`` on its
     64 columns, 8 results on 512 sampled rows against exact dense rows,
     requests/s both ways, host pack ms per panel, and the device idle share
     of one async burst under ``torch.profiler``;
     ``HMatrixSolveServer(hm_k, 1e-2, tol=1e-3, max_batch=8)`` on 20
     sinusoid targets (panels of 8, 8 and 4): sync and async bit-identical,
     iterations per column within 5 of the reference's, residual by a
     separate apply; K's apply server under ``transient=0.3:1,nan=0.1,seed=7``
     with output validation on 64 requests: no future fails, every panel
     bit-identical to the chaos-free ``serve()`` (a NaN panel is relaunched
     once through the same kernels), the relaunches and retries counted;
     then a ``MultiTenantRuntime`` with
     P (weight 2), a K solve tenant and a K apply tenant onboarded from raw
     coordinates by the device build, under a device-bytes budget below P's
     and K's stores together: every result within 1e-5 of its solo server,
     P against the K apply tenant at 2:1 in the launch order while both are
     backlogged (every request is queued before the first pick), P's store
     spilled and reloaded (``reload_s``).  Outside the chaos step no
     retry, panel failure or fallback launch is allowed;
  d. device discipline (run after phase 9, on the H-matrices of setup):
     which operations ``torch.cuda.set_sync_debug_mode("error")`` rejects on
     the card (``.item()``, a pageable ``.cpu()``, a pinned ``non_blocking``
     copy, ``bool(t)``, ``torch.nonzero``, ``Event.synchronize``,
     ``Stream.synchronize`` and the runtime's own fetch and upload); K's
     apply server on a burst of 64 requests with ``REPRO_STRICT_TRANSFERS=1``
     while 4 client threads fetch, bit-identical to the same burst without
     it, and the same under the chaos schedule of phase 9 (NaN relaunches
     run on the fetching threads); one panel of K's solve server (the PCG's
     documented host read is let through); a launch with an injected
     ``.item()`` fails its futures through the lane's failure path and none
     hangs; the mode is 0 afterwards.  Then ``examples/torch_quickstart.py``,
     ``torch_kernel_regression.py`` and ``torch_long_context_hattention.py``
     in process at their default sizes, each counted apart (#3, #4 and #2's
     vector entry; #2, #4, #5 and #6; #11);
  m. sharding (run after phase 9, on the H-matrices of setup), over a mesh of
     four logical shards of card 0 (``make_panel_mesh(devices=("cuda:0",) *
     4)``; also over every card where there are several): P's P-mode apply
     column-sharded at R = 8 and 5 and on an (N,) vector, row-sharded at R =
     8 and 1, and P's NP-mode apply row-sharded at R = 1, each within 1e-5
     relative of the unsharded kernel apply on the same X; K's
     column-sharded block-Jacobi solve (R = 8) within 1e-5 and with equal
     iterations per column of the unsharded solves of the shards' column
     slices, and against the unsharded solve of the whole panel within 1e-5
     and equal counts where the bits are equal, else (PyTorch's column sums
     on the card round by the panel's width) within 1e-3 and fault 3's
     max(2, spread + 1); ``HMatrixServer(K, max_batch=6)`` (row shards) on
     11 requests within rtol 1e-4 / atol 1e-5 of the unsharded apply and
     ``HMatrixSolveServer(K, max_batch=3)`` (width 4) on 6 targets within
     rtol 1e-2 / atol 1e-4 of the unsharded solve; every call twice
     bit-identical; sharded and unsharded times side by side, the servers'
     beside unsharded servers on the same requests.
  p. the parallel and tooling layer (run after phase m): GPipe
     (``parallel.pipeline.pipeline_apply``) over qwen2.5-14b-hmatrix's layers
     at full width and 8 layers, bf16, random from a generator seeded on the
     card, 4 stages of 2 layers on a ``"stage"`` axis of four logical shards
     of card 0 (of cards 0-3 where there are four), 4 microbatches of 1 x
     4,096 embedded tokens, a train-mode forward under ``no_grad``: bit for
     bit the 8-layer stack applied to each microbatch in turn on one device,
     #11 launched 32 times (8 layers x 4 microbatches), the pipeline's ms
     beside the sequential stack's and the peak memory; ``use_mesh`` on a
     (2, 2) debug mesh of card 0, ``constrain`` returning its input, and
     ``moe_parallel_mode`` for mixtral and granite at tp = 16; then the dry
     run's records (``launch.dryrun`` on fake tensors, on the host) over
     ``dryrun_cells()`` on the (16, 16) and (2, 16, 16) meshes: each cell's
     traced and model FLOPs, bytes per device and dominant roofline term,
     and the sweep's seconds.  The sweep runs in one worker process of this
     script, started (spawn) right after the build, so that its minute on
     one host core overlaps the kernel checks; phase p waits for it;

  t. training (run after phase f): qwen2.5-14b-hmatrix at full width and 8 layers
     (6 if the peak passes 72 GiB), bf16, random from a generator seeded on
     the card; 3 AdamW steps of 2 x 4,096 tokens in 2 microbatches with
     remat through ``make_train_step`` from ``make_batch``: finite loss and
     grad norm, #11 launched twice per layer and microbatch and #11b once,
     seconds a step, tokens/s, peak memory; then, outside the count, one
     step under ``torch.profiler`` (device time by part, idle share), one
     split into stages by CUDA events, step 1 again from the same state
     (loss and parameters bit-identical), a 2-layer full-width fp32 model's
     gradients through #11 / #11b against the plain near field and its plain
     backward on the card (1e-3 relative per parameter tensor), the flash
     VJP at S = 512 against autograd through the plain loop (1e-4), and on
     the smoke config 4 steps straight against 2, a save, a fresh restore
     and 2 more (bit for bit), and ``launch/train.py --smoke`` resuming from
     its directory; and the flash VJP without the causal mask (fp32, S =
     512) against autograd through the plain loop (1e-4);
  g. the other families trained (run after phase t): granite-moe-1b-a400m
     (24 layers), mixtral-8x7b (2 of 32; 1 if the peak passes 72 GiB),
     zamba2-7b (24 of 81: 4 periods), xlstm-1.3b (8 of 48: one period),
     whisper-tiny (4 + 4) and smollm-135m (30) at their published widths,
     bf16, random from a generator seeded on the card; 3 AdamW steps of 2 x
     4,096 tokens (xlstm 2,048; whisper 4,096 frames and tokens) in 2
     microbatches with remat through ``make_train_step`` from ``make_batch``
     (with frame embeds for whisper): finite loss and grad norm, seconds a
     step (the median of steps 2-3), tokens/s, MFU (``analysis.flops``' count
     over the dense bf16 rate), peak memory, no kernel launched; then, outside
     the count, one step of mixtral, zamba2 and xlstm (2 x 32 tokens) under
     ``torch.profiler`` (device time by part, idle share), step 1 again from
     the same state (loss and parameters bit-identical), each smoke config's
     fp32 gradients on the card within 1e-4 relative of the CPU's, and
     ``launch/train.py --arch whisper-tiny --smoke`` resuming from its
     directory.

Kernel launch counts are set to 0 before each of phases 2 to 9, d, f, m, p and t
(and each model of phase g and each example of phase d) and read after it: each phase must have launched the kernels of its own path
(``PATH_KERNELS``), and every kernel must have run on the main path.
Kernel, plain and library times are device times: CUDA events around calls
enqueued behind a device-side sleep (``gpu_ms``), so that a wrapper's host
cost per call is not counted; path times (applies, iterations) are calls
made back to back (``stream_ms``).  The
last lines are a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  A detailed record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
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
    # no pallas_call: repro takes this gradient by jax.grad of its einsum near field
    "hattention_nearfield_bwd": ("src/repro_torch/csrc/hattention_nearfield_bwd.cu",
                                 "src/repro/core/hattention.py:178"),
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
    # none: repro runs the other families outside any pallas_call, and
    # trains them by jax.grad of plain jnp code
    "families": (),
    "families_train": (),
    "train": ("hattention_nearfield", "hattention_nearfield_bwd"),
    "serve": ("batched_kernel_matmat", "batched_lowrank_matmat", "batched_block_cholesky",
              "batched_block_cholesky_solve"),
    "mesh": ("batched_kernel_matmat", "batched_kernel_matvec", "batched_lowrank_matmat",
             "batched_aca", "batched_block_cholesky", "batched_block_cholesky_solve"),
    "pipeline": ("hattention_nearfield",),
    "discipline": ("batched_kernel_matmat", "batched_lowrank_matmat", "batched_block_cholesky",
                   "batched_block_cholesky_solve"),
    "example_quickstart": ("batched_aca", "batched_lowrank_matmat", "batched_kernel_matvec"),
    "example_regression": ("batched_kernel_matmat", "batched_lowrank_matmat",
                           "batched_block_cholesky", "batched_block_cholesky_solve"),
    "example_hattention": ("hattention_nearfield",),
}
P_BUILD = dict(kernel="gaussian", k=16, c_leaf=2048, eta=1.5)
K_BUILD = dict(kernel="gaussian", k=16, c_leaf=256, eta=1.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events
    around calls enqueued behind a device-side sleep: the host's cost per
    call (ctypes, checks, allocation) is hidden, so that a kernel shorter
    than that cost is timed on the device alone.  Every kernel's time."""
    return _events_ms(fn, reps, warmup, queued=True)


def stream_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean time of ``fn()`` over ``reps`` calls made back to back, by CUDA
    events: the host's cost per call is counted where it exceeds the
    device's.  End-to-end path times, and a wrapper's host-bound rate."""
    return _events_ms(fn, reps, warmup, queued=False)


def _events_ms(fn, reps: int, warmup: int, queued: bool) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(2e6 + reps * 1e5))
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


# operations of phi after the squared distance (one instruction each; the
# Matern count is csrc/phi.cuh's small-argument branch, as the benchmark's
# yardstick hbench/harness/work.py counts it)
PHI_OPS = {"gaussian": 1, "matern": 42}


def dense_work(b: int, c: int, d: int, r: int, kernel: str = "gaussian") -> tuple[float, float]:
    """(bytes, operations) of #2 on b blocks of c x c on r columns: the
    points and the panel slices read once and Y written once; per entry a
    direct squared distance (3d - 1), phi and 2r for the multiply-adds."""
    return (4.0 * (2 * b * c * d + 2 * b * c * r),
            float(b) * c * c * ((3 * d - 1) + PHI_OPS[kernel] + 2 * r))


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
    bms, by = bound_ms(*dense_work(b, c, d, 8))
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
            "bound_ms": bound_ms(*dense_work(nb, cl, d, 8))[0],
            "level_ms": gpu_ms(lambda: batched_kernel_matmat_level_cuda(
                hm.tree.points, g.rows, g.cols, x_pad, cl), 3),
            "gathered_ms": gpu_ms(lambda: batched_kernel_matmat_cuda(rows, cols, x_blk), 3)}
        del rows, cols, x_blk, y_level
    wide = check_dense_wide(hm_p, rng)
    record["batched_kernel_matmat"] = {
        "checks": checks, "max_abs_err": max(ch["max_abs_err"] for ch in checks),
        "rel_err": max(ch["rel_err"] for ch in checks), "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"B={b} C={c} d={d} R=8 (blocks of problem P)",
        "whole_dense_group_ms": whole["P"]["level_ms"],
        "whole_dense_group_blocks": whole["P"]["blocks"], "whole_dense_group": whole,
        "wide": wide}


def ptxas_resources(source: str, kernel: str) -> dict | None:
    """Registers and spilled bytes of the kernel whose mangled name holds
    ``kernel``, from ``nvcc -Xptxas -v``'s report of ``source`` (None when
    this process did not build it)."""
    import re
    from repro_torch import _build
    report = _build.BUILD_INFO.get("ptxas", {}).get(source)
    if not report:
        return None
    lines = report.splitlines()
    at = next((i for i, line in enumerate(lines) if "Compiling entry" in line and kernel in line),
              None)
    if at is None:
        return None
    out = {}
    for line in lines[at + 1:at + 4]:
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            out["spill_store_bytes"], out["spill_load_bytes"] = map(int, m.groups())
        if m := re.search(r"Used (\d+) registers", line):
            out["registers"] = int(m.group(1))
    return out


def check_dense_wide(hm_p, rng) -> dict:
    """#2 at the benchmark's widths R = 16, 32 and 64 (the kernel's wide
    route, one instance each) on both benchmark configurations: the Gaussian
    2-D (problem P) and the Matern 3-D at N = 2^20 (its tree and plan alone,
    no factors).  On 64 of each one's dense blocks against the plain version
    and timed, then on all of its dense leaves through the level entry, as an
    apply of a panel of that width launches it."""
    from repro_torch import _build
    from repro_torch.core import build_hmatrix, halton
    from repro_torch.kernels.batched_dense_matvec.kernel import (
        batched_kernel_matmat_cuda, batched_kernel_matmat_level_cuda)
    from repro_torch.kernels.batched_dense_matvec.ref import batched_kernel_matmat_ref
    out = {}
    hm_m = build_hmatrix(halton(1 << 20, 3, device="cuda"), "matern", k=16, c_leaf=2048,
                         eta=1.5)
    for name, hm in (("gauss2d", hm_p), ("matern3d", hm_m)):
        kname = hm.kernel_name
        rows, cols = dense_pairs(hm, 64, rng)
        b, c, d = rows.shape
        g, cl = hm.groups["dense"], hm.plan.c_leaf
        nb = int(g.rows.shape[0])
        kid = 0 if kname == "gaussian" else 1
        for r in (16, 32, 64):
            x = randn((b, c, r), rng)
            wide_before = _build.LAUNCHES["batched_kernel_matmat_wide"]
            y = batched_kernel_matmat_cuda(rows, cols, x, kname)
            require(_build.LAUNCHES["batched_kernel_matmat_wide"] == wide_before + 1,
                    f"batched_kernel_matmat {name} R={r}: the wide route was not taken")
            y_ref = batched_kernel_matmat_ref(rows, cols, x, kname)
            err = rel_err(y, y_ref)
            require(err <= 1e-5, f"batched_kernel_matmat {name} R={r}: rel err {err}")
            ms = gpu_ms(lambda: batched_kernel_matmat_cuda(rows, cols, x, kname), 5)
            x_pad = randn((hm.plan.n_pad, r), rng)
            level_ms = gpu_ms(lambda: batched_kernel_matmat_level_cuda(
                hm.tree.points, g.rows, g.cols, x_pad, cl, kname), 2)
            out[f"{name}.R{r}"] = {
                "kernel": kname, "d": d, "R": r, "rel_err": err,
                "max_abs_err": max_abs(y, y_ref), "ms": ms,
                "resources": ptxas_resources(
                    "dense_matmat", f"dense_matmat_kernel_wideILi{d}ELi{kid}ELi{r}E"),
                "bound_ms": bound_ms(*dense_work(b, c, d, r, kname))[0],
                "timed_shape": f"B={b} C={c} d={d} R={r}", "leaves": nb,
                "all_leaves_ms": level_ms,
                "all_leaves_bound_ms": bound_ms(*dense_work(nb, cl, d, r, kname))[0]}
            del x, y, y_ref, x_pad
            torch.cuda.empty_cache()
        del rows, cols
    del hm_m
    torch.cuda.empty_cache()
    return out


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


CHOL_PARTS = ("diagonal", "panel", "update")   # the kinds of #5's launches


def cholesky_work(b: int, c: int) -> tuple[float, str]:
    """#5's bound: A's lower triangle read and L written once, against
    c^3 / 3 flops a block."""
    return bound_ms(4.0 * b * (c * (c + 1) / 2 + c * c), b * c ** 3 / 3.0)


def cholesky_split(a: torch.Tensor, want: torch.Tensor, reps: int = 3) -> dict:
    """Route L's device time by part (diagonal tiles, panels, trailing
    updates): CUDA events around each launch of a call, made one by one
    through the C entry ``repro_block_cholesky_part`` (which names each
    launch's kind, -1 past the last), summed by kind, mean over ``reps``
    calls; the launches in order must give the wrapper's bits ``want``."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    b, c = a.shape[0], a.shape[1]
    lmat, dinv, kind = torch.empty_like(a), torch.empty((b, c), device=a.device), ctypes.c_int()
    fn = _build.c_function("block_cholesky", "repro_block_cholesky_part",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                           + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    stream = stream_handle(a.device)
    events = {part: [] for part in CHOL_PARTS}
    for rep in range(reps + 1):
        for index in itertools.count():
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            _build.check(fn(a.data_ptr(), lmat.data_ptr(), dinv.data_ptr(), b, c, index,
                            ctypes.byref(kind), stream), f"batched_block_cholesky launch {index}")
            end.record()
            if kind.value < 0:
                break
            if rep:                                       # the first call warms up
                events[CHOL_PARTS[kind.value]].append((start, end))
    torch.cuda.synchronize()
    split = {part: sum(s.elapsed_time(e) for s, e in ev) / reps for part, ev in events.items()}
    split["launches_per_call"] = sum(len(ev) for ev in events.values()) // reps
    split["parts_equal_wrapper_bits"] = bool(torch.equal(lmat, want))
    require(split["parts_equal_wrapper_bits"], "batched_block_cholesky: the parts launched one "
            "by one do not give the wrapper's bits")
    return split


def cholesky_times(a: torch.Tensor, reps: int, plain_reps: int) -> dict:
    from repro_torch.kernels.batched_block_solve.kernel import batched_block_cholesky_cuda
    from repro_torch.kernels.batched_block_solve.ref import batched_block_cholesky_ref
    b, c = a.shape[0], a.shape[1]
    bms, by = cholesky_work(b, c)
    return {"B": b, "c": c, "ms": gpu_ms(lambda: batched_block_cholesky_cuda(a), reps),
            "wrapper_back_to_back_ms": stream_ms(lambda: batched_block_cholesky_cuda(a), reps),
            "plain_ms": gpu_ms(lambda: batched_block_cholesky_ref(a), plain_reps),
            "library_ms": gpu_ms(lambda: torch.linalg.cholesky(a), reps),
            "bound_ms": bms, "bound_by": by}


def check_cholesky(hm_p, hm_k, rng, record):
    from repro_torch.kernels.batched_block_solve.kernel import (
        batched_block_cholesky_cuda, batched_block_cholesky_solve_cuda)
    from repro_torch.kernels.batched_block_solve.ref import (
        batched_block_cholesky_ref, batched_block_cholesky_solve_ref)
    chol_checks, solve_checks, shapes, clamped = [], [], {}, []
    for name, hm, count in (("K", hm_k, None), ("P", hm_p, 32)):
        a = shifted_diagonal(hm, 1e-2, count)
        l_k = batched_block_cholesky_cuda(a)
        l_r = batched_block_cholesky_ref(a)
        err = rel_err(l_k, l_r)
        recon = rel_err(torch.bmm(l_k, l_k.transpose(1, 2)), a)
        upper_zero = bool((torch.triu(l_k, diagonal=1) == 0).all())
        same = bool(torch.equal(l_k, batched_block_cholesky_cuda(a)))
        chol_checks.append({"problem": name, "B": a.shape[0], "c": a.shape[1], "rel_err": err,
                            "max_abs_err": max_abs(l_k, l_r), "llt_rel_err": recon,
                            "two_calls_bit_identical": same})
        require(err <= 1e-4, f"batched_block_cholesky {name}: rel err {err}")
        require(recon <= 1e-5, f"batched_block_cholesky {name}: |LL^T - A|/|A| = {recon}")
        require(upper_zero, f"batched_block_cholesky {name}: nonzero above the diagonal")
        require(same, f"batched_block_cholesky {name}: two calls are not bit-identical")
        # B = 1, as H-LU's FACTOR runs it
        one = a[:1].contiguous()
        l_one = batched_block_cholesky_cuda(one)
        err_one = rel_err(l_one, batched_block_cholesky_ref(one))
        recon_one = rel_err(torch.bmm(l_one, l_one.transpose(1, 2)), one)
        chol_checks.append({"problem": f"{name} B=1", "B": 1, "c": a.shape[1],
                            "rel_err": err_one, "max_abs_err": max_abs(l_one, l_k[:1]),
                            "llt_rel_err": recon_one})
        require(err_one <= 1e-4 and recon_one <= 1e-5,
                f"batched_block_cholesky {name} B=1: rel err {err_one}, |LL^T - A|/|A| "
                f"{recon_one}")
        # a clamped pivot: row and column 40 of the first block zeroed
        z = a[:1].clone()
        z[:, 40, :] = 0.0
        z[:, :, 40] = 0.0
        lz, lz_r = batched_block_cholesky_cuda(z), batched_block_cholesky_ref(z)
        row = {"problem": name, "c": z.shape[1], "rel_err": rel_err(lz, lz_r),
               "max_abs_err": max_abs(lz, lz_r), "finite": bool(torch.isfinite(lz).all()),
               "column_40_zero": bool((lz[:, :, 40] == 0).all())}
        clamped.append(row)
        require(row["finite"] and row["column_40_zero"] and row["rel_err"] <= 1e-4,
                f"batched_block_cholesky {name}, clamped pivot: {row}")
        if name == "K":
            shapes["K"] = cholesky_times(a, 20, 2)
            shapes["K_B1"] = cholesky_times(one, 50, 2)
            x = randn((a.shape[0], a.shape[1], 8), rng)
        else:
            shapes["P_32"] = cholesky_times(a, 3, 1)
            split = cholesky_split(a, l_k)
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
        del a, l_r, z
    timed = shapes["P_32"]
    record["batched_block_cholesky"] = {
        "checks": chol_checks, "max_abs_err": max(ch["max_abs_err"] for ch in chol_checks),
        "rel_err": max(ch["rel_err"] for ch in chol_checks), "ms": timed["ms"],
        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": timed["library_ms"], "shapes": shapes,
        "split_P_32": split, "clamped_pivot": clamped,
        "timed_shape": f"B={timed['B']} c={timed['c']} (diagonal blocks of problem P)"}
    # all 512 of P's blocks: the factorization beside torch.linalg.cholesky
    # (both queued behind the device-side sleep), then the solve at the
    # PCG's own shape
    a_all = shifted_diagonal(hm_p, 1e-2, None)
    chol_p = batched_block_cholesky_cuda(a_all)
    b, c = chol_p.shape[0], chol_p.shape[1]
    bms, by = cholesky_work(b, c)
    record["batched_block_cholesky"]["P_all"] = {
        "B": b, "c": c, "ms": gpu_ms(lambda: batched_block_cholesky_cuda(a_all), 3),
        "library_ms": gpu_ms(lambda: torch.linalg.cholesky(a_all), 3),
        "bound_ms": bms, "bound_by": by}
    del a_all
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
    # the level entry a one-column apply calls (points and vector read in
    # place by leaf id) on all of K's dense leaves: within 1e-5 of its plain
    # version, and #2's code at R = 1, so the gathered matmat's bits
    from repro_torch.kernels.batched_dense_matvec.kernel import (
        batched_kernel_matmat_cuda, batched_kernel_matvec_level_cuda)
    from repro_torch.kernels.batched_dense_matvec.ref import batched_kernel_matvec_level_ref
    g, cl, pts = hm_k.groups["dense"], hm_k.plan.c_leaf, hm_k.tree.points
    x_pad = randn((hm_k.plan.n_pad,), np.random.RandomState(SEED + 11))
    y_level = batched_kernel_matvec_level_cuda(pts, g.rows, g.cols, x_pad, cl)
    y_plain = batched_kernel_matvec_level_ref(pts, g.rows, g.cols, x_pad, cl)
    leaf_pts = pts.reshape(-1, cl, pts.shape[1])
    same = bool(torch.equal(y_level, batched_kernel_matmat_cuda(
        leaf_pts[g.rows], leaf_pts[g.cols], x_pad.reshape(-1, cl, 1)[g.cols])[:, :, 0]))
    err = rel_err(y_level, y_plain)
    checks.append({"problem": "K, level entry", "C": cl, "blocks": int(g.rows.shape[0]),
                   "rel_err": err, "max_abs_err": max_abs(y_level, y_plain),
                   "level_equals_gathered_matmat": same})
    require(err <= 1e-5, f"batched_kernel_matvec K level entry: rel err {err}")
    require(same, "batched_kernel_matvec K: the level entry differs from #2's gathered entry")
    del y_level, y_plain, leaf_pts
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
    # edge points: 0, 1, the float just below 1, outside the box, the
    # nb >= 25 clamp at d = 1; N odd (two points a thread); a base that is
    # not 16-byte aligned
    below = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    edge_checks = []
    for d in (1, 2, 3):
        edges = torch.tensor([[0.0] * d, [1.0] * d, [below] * d, [-0.5] * d, [2.0] * d,
                              [1.0] + [0.0] * (d - 1), [0.0] * (d - 1) + [below]],
                             device=unit.device)
        pts = torch.cat([edges, unit[:1001, :1].repeat(1, d)])       # N = 1008
        for label, view in (("N=1008", pts), ("N=1007", pts[:-1]),
                            ("unaligned base", torch.cat([edges[:1], pts])[1:])):
            equal = bool(torch.equal(morton_encode_cuda(view), morton_encode_ref(view)))
            edge_checks.append({"d": d, "case": label, "codes_equal": equal})
            require(equal, f"morton_encode: edge points d={d} ({label}) differ from the plain "
                    "version")
    odd = unit[:-1]
    same_odd = bool(torch.equal(morton_encode_cuda(odd), codes[:-1]))
    edge_checks.append({"d": 2, "case": f"P's points less one (N={odd.shape[0]})",
                        "codes_equal": same_odd})
    require(same_odd, "morton_encode: P's points less one differ from the plain version")
    n, d = unit.shape
    ms = gpu_ms(lambda: morton_encode_cuda(unit), 50)
    wrapper_ms = stream_ms(lambda: morton_encode_cuda(unit), 20)
    plain = gpu_ms(lambda: morton_encode_ref(unit), 3)
    # the fewest operations: a magic-number bit spread, ceil(log2 nb) steps of
    # shift, or and mask on a 64-bit word (2 int32 operations each) per
    # dimension, and one 64-bit or to merge it into the code
    spread_ops = 6 * math.ceil(math.log2(bits_per_dim(d))) + 2
    bms, by = bound_ms(4.0 * n * d + 8.0 * n, float(n * d * spread_ops), PEAK_INT32)
    record["morton_encode"] = {
        "codes_equal": same, "edge_checks": edge_checks,
        "max_abs_err": 0.0 if same else None, "ms": ms, "wrapper_back_to_back_ms": wrapper_ms,
        "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_shape": f"N={n} d={d} (the points of problem P)"}


def log_cholesky_morton(kernels: dict, card: str) -> None:
    """Phase 1's lines for #5 (times at every shape, the split, the checks)
    and #7 (edge points), each time with the card."""
    chol = kernels["batched_block_cholesky"]
    for label, row in chol["shapes"].items():
        log(f"[1] batched_block_cholesky {label} (B={row['B']}, c={row['c']}): "
            f"{row['ms']:.4f} ms of device time, through the wrapper back to back "
            f"{row['wrapper_back_to_back_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {card}")
    pa = chol["P_all"]
    log(f"[1] batched_block_cholesky on all {pa['B']} of P's blocks (c={pa['c']}): "
        f"{pa['ms']:.3f} ms of device time, library (torch.linalg.cholesky) "
        f"{pa['library_ms']:.3f} ms, bound {pa['bound_ms']:.3f} ms ({pa['bound_by']}); {card}")
    sp = chol["split_P_32"]
    log(f"[1] batched_block_cholesky P (32 blocks) by part: diagonal tiles "
        f"{sp['diagonal']:.4f} ms, panels {sp['panel']:.4f} ms, trailing updates "
        f"{sp['update']:.4f} ms ({sp['launches_per_call']} launches a call; the parts give "
        f"the wrapper's bits: {sp['parts_equal_wrapper_bits']}); {card}")
    for ch in chol["checks"]:
        log(f"[1] batched_block_cholesky {ch['problem']} (B={ch['B']}, c={ch['c']}): rel err "
            f"{ch['rel_err']:.3e}, |LL^T - A|/|A| {ch['llt_rel_err']:.3e}, two calls "
            f"bit-identical {ch.get('two_calls_bit_identical', '-')}")
    for row in chol["clamped_pivot"]:
        log(f"[1] batched_block_cholesky {row['problem']} block 0 with row and column 40 "
            f"zeroed (c={row['c']}): rel err {row['rel_err']:.3e} against the plain version, "
            f"finite {row['finite']}, column 40 zero {row['column_40_zero']}")
    mo = kernels["morton_encode"]
    log(f"[1] morton_encode on P's points: {mo['ms']:.4f} ms of device time, "
        f"{mo['wrapper_back_to_back_ms']:.4f} ms through the wrapper back to back (host-bound), "
        f"bound {mo['bound_ms']:.4f} ms; {card}")
    log(f"[1] morton_encode edge points: "
        + ", ".join(f"d={e['d']} {e['case']} {e['codes_equal']}"
                    for e in kernels["morton_encode"]["edge_checks"]))


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
            "wrapper_back_to_back_ms": stream_ms(lambda: batched_trsm_panels_cuda(lmat, x), 50),
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
            "wrapper_back_to_back_ms": stream_ms(lambda: batched_schur_dense_cuda(cc, a, bb),
                                                 50),
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


def band_operands(k, v):
    """Keys and values of the near field's band as (c, 2c) windows [leaf i-1
    | leaf i] (zeros before leaf 0), and the boolean mask (previous leaf
    visible, own leaf causal)."""
    c = k.shape[2]
    kk = torch.cat([torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], 1), k], 2)
    vv = torch.cat([torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], 1), v], 2)
    ii = torch.arange(c, device=k.device)
    mask = torch.cat([torch.ones(c, c, dtype=torch.bool, device=k.device),
                      ii[:, None] >= ii[None, :]], 1)
    return kk, vv, mask


def sdpa_band(q, k, v):
    """The band of the near field as one ``scaled_dot_product_attention``
    call (``band_operands``).  A timing note only: leaf 0 sees zero keys in
    its window, and SDPA returns normalised rows, not (num, den, m)."""
    import torch.nn.functional as F
    kk, vv, mask = band_operands(k, v)
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


# #11b, the near field's backward: the training shape (2 x 4,096 tokens in
# microbatches of one sequence: 40 heads, 8 leaves) and the serving shape
NEARFIELD_BWD_SHAPES = {"train": (40, 8, 512, 128), "serve": (80, 16, 512, 128)}
NEARFIELD_BWD_REL_LIMIT = 1e-4
# the phase-1 cases: (shape, inputs)
NEARFIELD_BWD_CASES = (("train", "random"), ("serve", "random"), ("train", "tied maxima"),
                       ("train", "near-tie rows"), ("train", "large scores"))
PEAK_TF32 = 495e12     # H100 SXM, dense TF32 on the tensor cores (data sheet)
# #11b's products run as 3xTF32 (three tensor-core products each): its bound
# is the operations at a third of the TF32 rate
PEAK_3XTF32 = PEAK_TF32 / 3


def nearfield_bwd_work(bh: int, nl: int, c: int, d: int) -> tuple[float, float]:
    """(bytes, flops) #11b needs: q, k, v, num, gnum read once (and den, m,
    gden, gm), dq, dk, dv written once; 10 D flops per visible (row, key)
    pair (s, gnum . v and the three sums), c (c + 1) / 2 pairs in a leaf's
    own block and c^2 in the previous leaf's."""
    nbytes = 4.0 * bh * nl * c * (8 * d + 4)
    pairs = float(bh) * (nl * c * (c + 1) / 2 + (nl - 1) * c * c)
    return nbytes, 10.0 * d * pairs


def nearfield_bwd_inputs(shape, gen, kind: str = "random"):
    """q, k, v as check_nearfield draws them and random cotangents.
    ``tied maxima``: rows whose max is attained by several keys (key 5 of
    every leaf a copy of key 3, key 7 of leaf n - 1 a copy of leaf n's key
    3, and rows 9, 40 and c - 1 of every leaf aligned with key 3), leaf 0
    without a previous block among them.  ``near-tie rows``: rows 9, 40 and
    c - 1 are 2 e_0 and key 3 is 17 e_0 (their max, 34), key 5 is key 3
    times (1 - 2^-22): its score lies two ulps below m and is no tie (every
    score of keys 3 and 5 is one rounded product, the same in any order).
    ``large scores``: q scaled by 7.5 (scores to about +-30)."""
    bh, nl, c, d = shape
    q = torch.randn(bh, nl, c, d, generator=gen, device="cuda") / math.sqrt(d)
    k = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
    v = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
    if kind == "tied maxima":
        k[:, :, 5] = k[:, :, 3]
        k[:, :-1, 7] = k[:, 1:, 3]
        for r in (9, 40, c - 1):
            q[:, :, r] = k[:, :, 3] / math.sqrt(d)
    elif kind == "near-tie rows":
        for r in (9, 40, c - 1):
            q[:, :, r] = 0.0
            q[:, :, r, 0] = 2.0
        k[:, :, 3] = 0.0
        k[:, :, 3, 0] = 17.0
        k[:, :, 5] = k[:, :, 3] * (1.0 - 2.0 ** -22)
    elif kind == "large scores":
        q *= 7.5
    gnum = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
    gden = torch.randn(bh, nl, c, generator=gen, device="cuda")
    gm = torch.randn(bh, nl, c, generator=gen, device="cuda")
    return q, k, v, gnum, gden, gm


def fma_order_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last dim as #11 takes a score: one fp32 fma chain over
    d ascending, each step rounded once.  Emulated exactly in float64: the
    product of two floats is exact there, TwoSum keeps what rounding the sum
    dropped, and that remainder settles the one case where rounding the
    float64 sum to fp32 would round twice (an exact midpoint)."""
    s = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    inf = torch.tensor(float("inf"), device=a.device)
    for i in range(a.shape[-1]):
        p = a[..., i].double() * b[..., i].double()
        c = s.double()
        tot = p + c
        bp = tot - c
        rest = (p - bp) + (c - (tot - bp))
        r = tot.float()
        diff = tot - r.double()
        other = torch.nextafter(r, torch.where(diff > 0, inf, -inf))
        mid = (diff != 0) & (2.0 * diff.abs() == (other.double() - r.double()).abs())
        s = torch.where(mid & (rest != 0) & ((rest > 0) == (diff > 0)), other, r)
    return s


def other_tie_set_rows(q, k, m) -> torch.Tensor:
    """(bh, nl, c) bool: the rows whose arg-max set differs between the
    plain derivative and #11b.  The plain version takes the entries equal
    to their block's max in its own einsum scores (in the blocks that attain
    the row's max); #11b the visible entries whose score in #11's fma order
    equals #11's m.  The two orders round apart, so a row whose two largest
    scores lie within a rounding can differ; the fma-order scores are
    computed for the entries within 2^-10 |q| |k| of m (and the plain
    version's set)."""
    bh, nl, c, d = q.shape
    ii = torch.arange(c, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[None, None]
    kp = torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], dim=1)
    s_diag = torch.einsum("bncd,bnkd->bnck", q, k)
    s_diag = torch.where(causal, s_diag, torch.full_like(s_diag, -1e30))
    s_prev = torch.einsum("bncd,bnkd->bnck", q, kp)
    first = (torch.arange(nl, device=q.device) == 0)[None, :, None, None]
    s_prev = torch.where(first, torch.full_like(s_prev, -1e30), s_prev)
    md, ms = s_diag.amax(-1, keepdim=True), s_prev.amax(-1, keepdim=True)
    mm = torch.maximum(md, ms)
    plain_set = torch.cat([(s_prev == ms) & (ms == mm), (s_diag == md) & (md == mm)], -1)
    vis = torch.cat([~first.expand(bh, nl, c, c), causal.expand(bh, nl, c, c)], -1)
    keys = torch.cat([kp, k], 2)
    scale = torch.linalg.vector_norm(q, dim=-1)[..., None] * \
        torch.linalg.vector_norm(keys, dim=-1)[..., None, :]
    near = vis & (torch.cat([s_prev, s_diag], -1) >= m[..., None] - 2.0 ** -10 * scale)
    del s_diag, s_prev, scale
    at = (near | plain_set).nonzero(as_tuple=True)
    kernel_set = torch.zeros_like(plain_set)
    kernel_set[at] = vis[at] & (fma_order_dots(q[at[:3]], keys[at[0], at[1], at[3]])
                                == m[at[:3]])
    return (kernel_set != plain_set).any(-1)


def sdpa_band_backward(q, k, v, gout):
    """Autograd's backward through ``sdpa_band`` (a timing note, as #11's)."""
    import torch.nn.functional as F
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    kk, vv, mask = band_operands(leaves[1], leaves[2])
    out = F.scaled_dot_product_attention(leaves[0], kk, vv, attn_mask=mask, scale=1.0)
    return lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)


def sass_opcodes(lib: str, kernel: str, prefix: str = "HMMA") -> dict:
    """Counts of the SASS instructions starting with ``prefix`` in the
    function of ``lib`` whose (mangled) name holds ``kernel``
    (``cuobjdump -sass``)."""
    import re
    from repro_torch import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass) if kernel in f.split("\n")[0])
    counts: dict = {}
    for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(" + prefix + r"[\w.]*)", body):
        counts[op] = counts.get(op, 0) + 1
    return counts


def nearfield_bwd_resources(rec) -> None:
    """#11b's registers, spills, shared bytes and CTAs an SM at every head
    dim (the C side's occupancy query), and the tensor-core instructions of
    its dq and dk/dv kernels at D = 128 in the built library's SASS."""
    from repro_torch import _build
    from repro_torch.kernels.hattention_block.kernel import (HEAD_DIMS,
                                                             hattention_nearfield_bwd_info)
    rec["resources"] = {str(d): hattention_nearfield_bwd_info(d) for d in HEAD_DIMS}
    lib = str(Path(_build.BUILD_INFO["dir"]) / "libhattention_nearfield_bwd.so")
    rec["sass_mma_D128"] = {name: sass_opcodes(lib, f"{name}_kernelILi128E")
                            for name in ("dq", "dkv")}
    for d, row in rec["resources"].items():
        log(f"[1] hattention_nearfield_bwd D = {d}: " + "; ".join(
            f"{name} {r['registers']} registers, {r['spill_bytes']} B spilled, "
            f"{r['shared_bytes']} B shared, {r['ctas_per_sm']} CTAs an SM"
            for name, r in row.items()))
    log(f"[1] hattention_nearfield_bwd SASS at D = 128: {rec['sass_mma_D128']}")
    require(all(any(k.startswith("HMMA") for k in ops) for ops in rec["sass_mma_D128"].values()),
            f"hattention_nearfield_bwd: no tensor-core instruction in {rec['sass_mma_D128']}")


def check_nearfield_bwd(record):
    """#11b against its plain derivative on the card, from #11's (num, den,
    m): at the training shape, at the serving shape, and at the training
    shape with tied maxima, near-tie rows and large scores (every shape
    holds leaf 0, which has no previous block); two launches bit-identical;
    kernel, plain and SDPA-backward times at the training shape, the
    kernel's also at the serving shape, beside the bound (3xTF32 on the
    tensor cores) and the fp32 rate's; then its resources and SASS
    (``nearfield_bwd_resources``).  The rows whose arg-max set the plain
    version's einsum order takes otherwise than #11's fma order
    (``other_tie_set_rows``) are counted and left out of the comparison:
    their cotangents are zeroed, so that they add nothing to dq, dk, dv on
    either side; the rows the tie cases build are never among them."""
    from repro_torch.kernels.hattention_block.kernel import (hattention_nearfield_bwd_cuda,
                                                             hattention_nearfield_cuda)
    from repro_torch.kernels.hattention_block.ref import hattention_nearfield_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rec = record.setdefault("hattention_nearfield_bwd", {"checks": []})
    for label, kind in NEARFIELD_BWD_CASES:
        shape = NEARFIELD_BWD_SHAPES[label]
        q, k, v, gnum, gden, gm = nearfield_bwd_inputs(shape, gen, kind)
        num, den, m = hattention_nearfield_cuda(q, k, v)
        other = other_tie_set_rows(q, k, m)
        gnum[other], gden[other], gm[other] = 0.0, 0.0, 0.0
        ch = {"inputs": f"{label}, {kind}", "shape": list(shape),
              "rows_with_another_tie_set": int(other.sum())}
        if kind in ("tied maxima", "near-tie rows"):
            built = other[:, :, [9, 40, shape[2] - 1]]
            require(not bool(built.any()), f"hattention_nearfield_bwd {kind}: a built row's "
                    "arg-max set differs between the plain version and #11")
        del other
        got = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
        want = hattention_nearfield_bwd_ref(q, k, v, num, den, m, gnum, gden, gm)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            ch[f"{name}_rel_err"] = rel_err(a, b)
        ch["max_abs_err"] = max(max_abs(a, b) for a, b in zip(got, want))
        del want
        if kind == "near-tie rows":
            s9 = torch.einsum("bnd,bnkd->bnk", q[:, :, 9], k[:, :, :10])
            ch["near_tie_present"] = bool((s9[..., 3] == m[:, :, 9]).all()
                                          and (s9[..., 5] < s9[..., 3]).all()
                                          and (s9[..., 5] >= s9[..., 3] - 2.0 ** -16).all())
            require(ch["near_tie_present"], "hattention_nearfield_bwd: no near-tie rows")
        if kind == "large scores":
            ch["max_abs_score"] = float(m.abs().amax())
        again = hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)
        ch["bit_identical"] = all(torch.equal(a, b) for a, b in zip(again, got))
        rec["checks"].append(ch)
        log(f"[1] hattention_nearfield_bwd {ch['inputs']} {shape}: dq rel err "
            f"{ch['dq_rel_err']:.3e}, dk {ch['dk_rel_err']:.3e}, dv {ch['dv_rel_err']:.3e}, "
            f"max abs err {ch['max_abs_err']:.3e}, bit-identical {ch['bit_identical']}, "
            f"rows left out (another tie set) {ch['rows_with_another_tie_set']}"
            + (f", largest row max {ch['max_abs_score']:.2f}" if "max_abs_score" in ch else ""))
        require(all(ch[f"{n}_rel_err"] <= NEARFIELD_BWD_REL_LIMIT for n in ("dq", "dk", "dv")),
                f"hattention_nearfield_bwd {ch['inputs']}: {ch}")
        require(ch["bit_identical"],
                f"hattention_nearfield_bwd {ch['inputs']}: two launches differ")
        if kind == "random":
            nbytes, flops = nearfield_bwd_work(*shape)
            bms, by = bound_ms(nbytes, flops, PEAK_3XTF32)
            simt_ms, _ = bound_ms(nbytes, flops)
            args = (q, k, v, num, den, m, gnum, gden, gm)
            ms = gpu_ms(lambda: hattention_nearfield_bwd_cuda(*args), 5)
            rec[f"{label}_ms"], rec[f"{label}_bound_ms"] = ms, bms
            rec[f"{label}_fp32_rate_ms"] = simt_ms
            rec[f"{label}_gflop"] = flops / 1e9
            if label == "train":
                rec.update(ms=ms, bound_ms=bms, bound_by=by, library_ms=None,
                           library_note="none: no single call returns this gradient",
                           plain_ms=gpu_ms(lambda: hattention_nearfield_bwd_ref(*args), 2),
                           sdpa_backward_note_ms=gpu_ms(sdpa_band_backward(q, k, v, gnum), 5),
                           timed_shape=f"train {shape}")
            log(f"[1] hattention_nearfield_bwd {label} {shape}: {ms:.3f} ms, bound {bms:.3f} ms "
                f"({by}: {flops / 1e9:.1f} GFLOP as 3xTF32 on the tensor cores, "
                f"{nbytes / 1e9:.2f} GB); the same operations at the fp32 rate {simt_ms:.3f} ms")
        del q, k, v, gnum, gden, gm, num, den, m, got, again
        torch.cuda.empty_cache()
    rec["max_abs_err"] = max(ch["max_abs_err"] for ch in rec["checks"])
    log(f"[1] hattention_nearfield_bwd train: plain {rec['plain_ms']:.3f} ms; autograd through "
        f"SDPA on the same band (note, not a library equivalent) "
        f"{rec['sdpa_backward_note_ms']:.3f} ms")
    nearfield_bwd_resources(rec)


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
    apply_ms = stream_ms(lambda: apply_h(x), 3, warmup=0)
    vec = x[:, 0].contiguous()
    z1 = apply_h(vec)
    apply_vec_ms = stream_ms(lambda: apply_h(vec), 3, warmup=0)
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
    apply_ms = stream_ms(lambda: apply_h(x), 2, warmup=0)
    apply_vec_ms = stream_ms(lambda: apply_h(vec), 2, warmup=0)
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


def setup_split(hm) -> dict:
    """The block-Jacobi setup (``build_preconditioner``) in its two parts on
    the host clock, after the phase's own setup: the shifted diagonal blocks
    (``diagonal_blocks``) and their factorisation (#5 through its dispatch)."""
    from repro_torch.core import diagonal_blocks
    from repro_torch.kernels.batched_block_solve.ops import batched_block_cholesky
    blocks, t_blocks = wall_s(lambda: diagonal_blocks(hm))
    blocks.diagonal(dim1=1, dim2=2).add_(1e-2)
    _, t_chol = wall_s(lambda: batched_block_cholesky(blocks))
    return {"B": blocks.shape[0], "c": blocks.shape[1], "diagonal_blocks_s": t_blocks,
            "cholesky_s": t_chol}


def log_setup_split(key: str, split: dict, card: str) -> None:
    log(f"[{key} setup] block-Jacobi setup by part ({split['B']} blocks of {split['c']}): "
        f"diagonal_blocks {split['diagonal_blocks_s']:.4f} s, batched_block_cholesky "
        f"{split['cholesky_s']:.4f} s; {card}")


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
    flat_ms = stream_ms(lambda: make_apply(hm)(x), 3)
    res = {"flat_bytes": flat.nbytes()["total"], "flat_apply_ms_R8": flat_ms}
    log(f"[memory tier] flat store {res['flat_bytes']} bytes, apply R=8 {flat_ms:.3f} ms")
    hm_1e2 = None
    for tol in (1e-2, 1e-3):
        store = FactorStore(dict(flat.levels), dict(flat.rank_tables))
        report, secs = wall_s(lambda: recompress_store(store, tol))
        hm_t = dataclasses.replace(hm, factors=store)
        apply_t = make_apply(hm_t)
        err = rel_err(apply_t(x)[idx], z_flat)
        ms = stream_ms(lambda: apply_t(x), 3)
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
    res["hlu_solve_panels_ms"] = stream_ms(lambda: hlu_solve_panels(pre.factors, r_pad), 3)
    res["apply_ms_R8"] = stream_ms(lambda: make_apply(hm)(x), 3)
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
    """Within the block, ``h_attention``'s near field and its backward run
    their plain versions on the card (``kernels/hattention_block/ref.py``)
    instead of #11 and #11b."""
    from repro_torch.kernels.hattention_block import ops
    from repro_torch.kernels.hattention_block.ref import (hattention_nearfield_bwd_ref,
                                                          hattention_nearfield_ref)
    orig = ops.hattention_nearfield_op, ops.hattention_nearfield_bwd_op
    ops.hattention_nearfield_op = hattention_nearfield_ref
    ops.hattention_nearfield_bwd_op = hattention_nearfield_bwd_ref
    try:
        yield
    finally:
        ops.hattention_nearfield_op, ops.hattention_nearfield_bwd_op = orig


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
    del res["prefill_caches"]      # the grown caches' first LM_PROMPT slots hold the same
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
    the summed device time of every kernel and copy, the time the device was
    busy (the union of their intervals: work on several streams overlaps),
    the device's idle share of the host time, and the kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = wall_s(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    total_ms = sum(e.device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.device_time_total)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"host_s": secs, "device_ms": total_ms, "busy_ms": busy_us / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "idle_share": max(0.0, 1.0 - busy_us / 1e6 / secs),
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
    caches = grow_caches(out.pop("caches"), 2, cfg)
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


# ---------------------------------------------------------------------------
# phase f: the other LM families (serving)
# ---------------------------------------------------------------------------

# (arch, layers run, prompt tokens): published widths; the depth is cut only
# where the bf16 weights would not leave room on one card (mixtral's 32
# layers need 93.4 GB, chameleon's 48 need 68.6 GB); xlstm's prompts are
# shorter because its sLSTM layers run one step per token
FAMILY_RUNS = (("mixtral-8x7b", 8, 8192), ("granite-moe-1b-a400m", 24, 4096),
               ("zamba2-7b", 81, 4096), ("xlstm-1.3b", 48, 2048), ("whisper-tiny", 4, 1024),
               ("gemma-7b", 28, 4096), ("smollm-135m", 30, 4096), ("phi3-medium-14b", 40, 4096),
               ("chameleon-34b", 24, 4096))
FAMILY_BATCH, FAMILY_TOKENS = 2, 16
# the fp32 decode-consistency check: full width, a small depth (2 layers; one
# period of zamba2 and xlstm; 2 + 2 for whisper), S = 300 (no multiple of
# ssm_chunk), repro's own test's capacity factor so that no assignment drops
FAMILY_CHECK_LAYERS = {"zamba2-7b": 6, "xlstm-1.3b": 8}
FAMILY_CHECK_SEQ, FAMILY_CHECK_CF, FAMILY_CHECK_LIMIT = 300, 8.0, 1e-3
# prefills profiled (MoE dispatch and banded chunks, the SSD chunks); xlstm's
# sLSTM loop is profiled on one layer over its first FAMILY_SLSTM_STEPS
# tokens (a whole prefill is ~330,000 launches, too many to trace here)
FAMILY_PROFILED = ("mixtral-8x7b", "zamba2-7b")
FAMILY_SLSTM_STEPS = 256
FAMILY_DEV = "cuda"    # a CPU rehearsal of the phase's control flow sets "cpu"


def cache_tensors(tree) -> list:
    """The tensors of a cache tree (lists, tuples and dicts of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in cache_tensors(tree[key])]
    return [t for sub in tree for t in cache_tensors(sub)]


def family_inputs(cfg, batch: int, seq: int, gen):
    """Prompts and, for an encoder-decoder, as many encoder frames."""
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=FAMILY_DEV)
    frames = (torch.randn((batch, seq, cfg.d_model), generator=gen, device=FAMILY_DEV)
              if cfg.is_encoder_decoder else None)
    return prompts, frames


def run_family(name: str, layers: int, prompt: int, out: dict) -> None:
    """One model of phase f: bf16 at published widths, one prefill and 15
    greedy decode steps through ``generate``, then a second prefill that
    must give the same bits."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import count_params, get_model
    from repro_torch.models.xlstm import slstm_block
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    t_model = time.perf_counter()
    cfg = get_arch(name).replace(n_layers=layers)
    gen = torch.Generator(device=FAMILY_DEV).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params, t_init = wall_s(lambda: get_model(cfg, FAMILY_DEV)["init_params"](gen))
    prompts, frames = family_inputs(cfg, FAMILY_BATCH, prompt, gen)
    res = generate(params, cfg, prompts, FAMILY_TOKENS, frames)
    (logits2, caches2), t_prefill2 = wall_s(
        lambda: make_prefill_step(cfg)(params, prompts, frames))
    first, second = cache_tensors(res["prefill_caches"]), cache_tensors(caches2)
    identical = (torch.equal(logits2, res["prefill_logits"]) and len(first) == len(second)
                 and all(torch.equal(a, b) for a, b in zip(first, second)))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (res["prefill_logits"], logits2, res["logits"]))
    tokens = res["tokens"]
    n_tok = FAMILY_BATCH * prompt
    rec = {"layers": layers, "published_layers": get_arch(name).n_layers,
           "params": count_params(params), "dtype": cfg.dtype, "batch": FAMILY_BATCH,
           "prompt_len": prompt, "init_s": t_init, "prefill_s_first": res["prefill_s"],
           "prefill_s": t_prefill2, "prefill_tok_per_s": n_tok / t_prefill2,
           "decode_ms_per_step": res["decode_s"] / (FAMILY_TOKENS - 1) * 1e3,
           "cache_bytes": sum(t.numel() * t.element_size() for t in cache_tensors(res["caches"])),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "prefills_bit_identical": identical, "logits_finite": finite,
           "first_row_tokens": tokens[0].tolist()}
    out[name] = rec
    log(f"[families] {name}: {rec['params']:,} parameters ({layers} of "
        f"{rec['published_layers']} layers, bf16) made in {t_init:.2f} s; prefill "
        f"{FAMILY_BATCH} x {prompt}: first {res['prefill_s']:.3f} s, again {t_prefill2:.3f} s "
        f"({rec['prefill_tok_per_s']:.0f} tok/s); decode {rec['decode_ms_per_step']:.2f} ms per "
        f"step; caches {rec['cache_bytes'] / 1e9:.3f} GB; peak {rec['peak_memory_gib']:.2f} GiB; "
        f"prefills bit-identical {identical}; logits finite {finite}")
    require(finite, f"families {name}: non-finite logits")
    require(identical, f"families {name}: two prefills differ")
    require(tokens.shape == (FAMILY_BATCH, FAMILY_TOKENS) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size, f"families {name}: bad tokens")
    # outside the checked run: one more decode step (slot prompt + 15 is free)
    # and the prefill or the sLSTM loop, under the profiler
    caches, tok = res["caches"], tokens[:, -1:]
    profiles = {"decode_step": device_profile(
        lambda: make_decode_step(cfg)(params, tok, caches, prompt + FAMILY_TOKENS - 1), top=8)}
    del res, caches2, logits2, first, second
    if name in FAMILY_PROFILED:
        profiles["prefill"] = device_profile(
            lambda: make_prefill_step(cfg)(params, prompts, frames), top=8)
    if "slstm" in cfg.layer_kinds:
        block = params.layers[cfg.layer_kinds.index("slstm")]
        x = torch.randn((FAMILY_BATCH, FAMILY_SLSTM_STEPS, cfg.d_model), generator=gen,
                        device=FAMILY_DEV).to(getattr(torch, cfg.dtype))
        with torch.inference_mode():
            slstm_block(block.slstm, cfg, x, mode="prefill")       # warm
            profiles["slstm_layer"] = device_profile(
                lambda: slstm_block(block.slstm, cfg, x, mode="prefill"), top=8)
        sl = profiles["slstm_layer"]
        sl["steps"] = FAMILY_SLSTM_STEPS
        sl["host_us_per_step"] = sl["host_s"] / FAMILY_SLSTM_STEPS * 1e6
        sl["device_us_per_step"] = sl["busy_ms"] / FAMILY_SLSTM_STEPS * 1e3
        sl["launches_per_step"] = sl["kernel_launches"] / FAMILY_SLSTM_STEPS
    rec["profile"] = profiles
    for part, prof in profiles.items():
        log(f"[families profile] {name} {part}: host {prof['host_s'] * 1e3:.2f} ms, "
            f"{prof['kernel_launches']} kernels {prof['device_ms']:.2f} ms, device idle "
            f"{prof['idle_share']:.3f}")
        for k in prof["top"]:
            log(f"[families profile]   {k['ms']:10.3f} ms  {k['calls']:7d}x  {k['name']}")
    rec["main_wall_s"] = time.perf_counter() - t_model


def check_family_decode(name: str, out: dict) -> None:
    """A full-width fp32 model of small depth: the decode step after a
    prefill of S = 300 tokens against the train-mode forward's logits at
    position 300, within 1e-3 relative."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import grow_caches
    from repro_torch.models.api import get_model
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    t_check = time.perf_counter()
    arch = get_arch(name)
    if arch.is_encoder_decoder:
        depth = {"n_layers": 2, "n_enc_layers": 2}
    else:
        depth = {"n_layers": FAMILY_CHECK_LAYERS.get(name, 2)}
    cfg = arch.replace(dtype="float32", moe_capacity_factor=FAMILY_CHECK_CF, **depth)
    model = get_model(cfg, FAMILY_DEV)
    gen = torch.Generator(device=FAMILY_DEV).manual_seed(SEED)
    params = model["init_params"](gen)
    s = FAMILY_CHECK_SEQ
    tokens, frames = family_inputs(cfg, FAMILY_BATCH, s + 1, gen)
    frames = None if frames is None else frames[:, :s]
    with torch.inference_mode():
        train_logits, _ = model["forward"](params, tokens=tokens, embeds=frames, mode="train")
        _, caches = make_prefill_step(cfg)(params, tokens[:, :s], frames)
        caches = grow_caches(caches, 1, cfg)
        dec_logits, _ = make_decode_step(cfg)(params, tokens[:, s:], caches, s)
    err = rel_err(dec_logits[:, 0], train_logits[:, s])
    out[name]["fp32_decode"] = {"layers": cfg.n_layers, "seq": s, "rel_err": err,
                                "finite": bool(torch.isfinite(dec_logits).all()),
                                "wall_s": time.perf_counter() - t_check}
    log(f"[families fp32] {name} ({cfg.n_layers} layers, full width): decode logits at "
        f"position {s} against the train-mode forward: rel err {err:.3e} (limit "
        f"{FAMILY_CHECK_LIMIT}); model wall {out[name]['main_wall_s']:.1f} s, check "
        f"{out[name]['fp32_decode']['wall_s']:.1f} s")
    require(out[name]["fp32_decode"]["finite"] and err <= FAMILY_CHECK_LIMIT,
            f"families {name}: fp32 decode differs from the forward: {err}")


def run_families(record) -> None:
    """Phase f: the nine other assigned architectures served on the card;
    everything they allocate is freed before the next phase."""
    t_phase = time.perf_counter()
    out = record.setdefault("families", {})
    for name, layers, prompt in FAMILY_RUNS:
        run_family(name, layers, prompt, out)
        gc.collect()
        torch.cuda.empty_cache()
        check_family_decode(name, out)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[families] phase f wall {out['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase t: training (qwen2.5-14b-hmatrix)
# ---------------------------------------------------------------------------

# full width, depth cut to 8 layers (6 if the peak passes 72 GiB): the
# training state is 16 bytes a parameter (bf16 weights and gradients, f32
# accumulator and AdamW moments); train_4k's sequence, its batch of 256 cut to 2
TRAIN_LAYERS, TRAIN_LAYERS_CUT, TRAIN_PEAK_LIMIT_GIB = 8, 6, 72.0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 2, 4096, 2, 3
TRAIN_PARAMS_LAYER, TRAIN_PARAMS_REST = 275_268_608, 1_557_140_480
TRAIN_GRAD_LIMIT, TRAIN_FLASH_LIMIT = 1e-3, 1e-4
PEAK_BF16 = 989e12     # H100 SXM, dense bf16 tensor-core FLOP/s (data sheet)
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke_train"
TRAIN_DEV = "cuda"     # a CPU rehearsal of the phase's control flow sets "cpu"


def train_opt_cfg():
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)


def train_matmul_flops(cfg, tokens: int) -> float:
    """bf16 matmul FLOPs of one train step: the blocks' projections four
    times (forward, the remat forward, and the two products of the
    backward), the LM head three times."""
    d, hd = cfg.d_model, cfg.head_dim_
    block = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d \
        + 3 * d * cfg.d_ff
    return 2.0 * tokens * (4 * cfg.n_layers * block + 3 * d * cfg.padded_vocab)


# parts of a train step's device time, by kernel name (first match): cuBLAS
# runs the bf16 products as nvjet kernels and the far field's fp32 products
# (no TF32) as gemv / gemm kernels, the only fp32 products of the bf16 model
TRAIN_PARTS = (("#11 near field", ("nearfield_kernel",)),
               ("#11b near-field backward", ("dq_kernel", "dkv_kernel", "fix_kernel")),
               ("bf16 GEMM (projections, head)", ("nvjet", "bf16")),
               ("fp32 products (far field ACA, forward and backward)", ("gemv", "gemm")),
               ("gathers and scatters (index kernels)", ("index", "scatter", "gather")))
TRAIN_OTHER = "other (elementwise, reductions, copies: norms, loss, AdamW, ACA glue)"


def train_profile_split(kernels: list, parts=TRAIN_PARTS, other: str = TRAIN_OTHER) -> dict:
    """Device ms by part of a profiled step, from every kernel's name."""
    split = {name: 0.0 for name, _ in parts}
    split[other] = 0.0
    for k in kernels:
        name = k["name"].lower()
        part = next((part for part, keys in parts if any(key in name for key in keys)), other)
        split[part] += k["ms"]
    return split


def train_stage_split(state, batch, opt_cfg) -> dict:
    """One train step's stages timed by CUDA events, as ``train_step`` runs
    them: per microbatch the forward to the logits, the loss, the backward
    (with the blocks' remat forward) and the f32 accumulation, then AdamW."""
    from repro_torch.models.lm import cross_entropy_loss
    from repro_torch.train.optimizer import apply_updates
    params, cfg = state["params"], state["params"].cfg
    names, plist = zip(*params.named_parameters())
    ev = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)

    size = batch["tokens"].shape[0] // TRAIN_MICRO
    acc = None
    mark()
    for i in range(TRAIN_MICRO):
        mb = {key: val[i * size:(i + 1) * size] for key, val in batch.items()}
        logits, _ = params(mb["tokens"], mb.get("embeds"), mode="train", remat=True)
        mark()
        loss = cross_entropy_loss(logits, mb["labels"], cfg.vocab_size)
        mark()
        grads = torch.autograd.grad(loss, plist)
        del logits
        mark()
        if acc is None:
            acc = [g.float() / TRAIN_MICRO for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float() / TRAIN_MICRO)
        del grads, loss
        mark()
    apply_updates(params, dict(zip(names, acc)), state["opt"], state["step"], opt_cfg)
    state["step"] += 1
    mark()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    out = {"forward_to_logits": 0.0, "loss": 0.0, "backward_with_remat": 0.0,
           "accumulate_f32": 0.0}
    for i in range(TRAIN_MICRO):
        for j, key in enumerate(out):
            out[key] += ms[4 * i + j]
    out["optimizer"] = ms[-1]
    out["step"] = sum(ms)
    return out


def run_train(layers: int, record) -> dict:
    """The main path of phase t: ``TRAIN_STEPS`` AdamW steps of the
    full-width model at ``layers`` layers through ``make_train_step``, from
    ``make_batch``.  Returns what the checks after the launch count need."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import count_params
    from repro_torch.train.step import make_train_step
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH).replace(n_layers=layers)
    opt_cfg = train_opt_cfg()
    init_state, train_step = make_train_step(cfg, opt_cfg, microbatches=TRAIN_MICRO, remat=True,
                                             device=TRAIN_DEV)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      seed=SEED)
    batches = [make_batch(dcfg, s, device=TRAIN_DEV) for s in range(TRAIN_STEPS + 2)]
    gen = torch.Generator(device=TRAIN_DEV).manual_seed(SEED)
    state, t_init = wall_s(lambda: init_state(gen))
    n_params = count_params(state["params"])
    torch.cuda.reset_peak_memory_stats()
    steps, first = [], None
    for s in range(TRAIN_STEPS):
        (state, metrics), secs = wall_s(lambda: train_step(state, batches[s]))
        loss, gnorm, lr = torch.stack([metrics["loss"], metrics["grad_norm"],
                                       metrics["lr"]]).tolist()
        steps.append({"step": s, "loss": loss, "grad_norm": gnorm, "lr": lr, "seconds": secs})
        log(f"[train] {layers} layers, step {s}: loss {loss:.6f}, grad norm {gnorm:.4f}, lr "
            f"{lr:.3e}, {secs:.3f} s")
        if s == 0:
            first = {"loss": metrics["loss"].cpu(),
                     "params": [p.detach().to("cpu", copy=True)
                                for p in state["params"].parameters()]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = [st["seconds"] for st in steps[1:]]
    rec = {"arch": LM_ARCH, "layers": layers, "params": n_params, "dtype": cfg.dtype,
           "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
           "remat": True, "init_s": t_init, "steps": steps, "peak_memory_gib": peak,
           "s_per_step": sum(warm) / len(warm), "tok_per_s": tokens * len(warm) / sum(warm),
           "bf16_matmul_tflop_per_step": train_matmul_flops(cfg, tokens) / 1e12,
           "bf16_matmul_bound_s": train_matmul_flops(cfg, tokens) / PEAK_BF16}
    record.setdefault("train", {})[f"main_{layers}_layers"] = rec
    log(f"[train] {LM_ARCH} at {layers} layers: {n_params:,} parameters ({cfg.dtype}) made in "
        f"{t_init:.2f} s; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_MICRO} "
        f"microbatches with remat: {rec['s_per_step']:.3f} s a step after the first "
        f"({rec['tok_per_s']:.0f} tok/s); bf16 matmuls {rec['bf16_matmul_tflop_per_step']:.1f} "
        f"TFLOP a step, {rec['bf16_matmul_bound_s']:.3f} s at the bf16 peak; peak memory "
        f"{peak:.2f} GiB")
    require(n_params == layers * TRAIN_PARAMS_LAYER + TRAIN_PARAMS_REST,
            f"train: {n_params} parameters at {layers} layers")
    require(all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]) for st in steps),
            f"train: a non-finite loss or grad norm: {steps}")
    return {"cfg": cfg, "state": state, "train_step": train_step, "init_state": init_state,
            "batches": batches, "first": first, "rec": rec, "t_phase": t_phase}


def check_train_launches(st: dict) -> None:
    """#11 twice per layer and microbatch (forward and the remat forward of
    the backward), #11b once, in every step of the counted run."""
    from repro_torch import _build
    per_step = st["cfg"].n_layers * TRAIN_MICRO
    want = {"hattention_nearfield": 2 * per_step * TRAIN_STEPS,
            "hattention_nearfield_bwd": per_step * TRAIN_STEPS}
    got = {name: _build.LAUNCHES[name] for name in want}
    st["rec"]["launches_expected"] = want
    require(got == want, f"train: launches {got}, expected {want}")


def train_grads(params, batch, loss_fn):
    names, plist = zip(*params.named_parameters())
    loss = loss_fn(params, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, plist)))


def grads_rel(a: dict, b: dict) -> dict:
    return {name: rel_err(a[name].float(), b[name].float()) for name in a}


def run_train_checks(st: dict, record) -> None:
    """After the launch count: one step under the profiler and one split by
    stage, step 1 again from the same state (bit-identical loss and
    parameters), the 2-layer fp32 gradients through the kernels against the
    plain near field, the flash VJP against autograd through the plain
    loop, and resume and the launcher on the smoke config."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.api import get_model
    from repro_torch.train.step import make_loss_fn
    rec = st["rec"]
    state, train_step, batches = st["state"], st["train_step"], st["batches"]
    # the stage split before the profiled step, each after a collection, so
    # that neither pays for the other's (or the profiler's) Python objects
    gc.collect()
    rec["stages_ms"] = train_stage_split(state, batches[TRAIN_STEPS], train_opt_cfg())
    log("[train stages] " + ", ".join(f"{k} {v:.1f} ms" for k, v in rec["stages_ms"].items()))
    gc.collect()
    prof = device_profile(lambda: train_step(state, batches[TRAIN_STEPS + 1]), top=10 ** 6)
    prof["split"] = train_profile_split(prof["top"])
    prof["top"] = prof["top"][:15]
    rec["profile"] = prof
    log(f"[train profile] one step: host {prof['host_s'] * 1e3:.1f} ms, "
        f"{prof['kernel_launches']} kernels {prof['device_ms']:.1f} ms, device idle "
        f"{prof['idle_share']:.3f}")
    for part, ms in prof["split"].items():
        log(f"[train profile]   {ms:10.2f} ms  {part}")
    for k in prof["top"]:
        log(f"[train profile]   {k['ms']:10.3f} ms  {k['calls']:6d}x  {k['name']}")
    del prof
    gc.collect()
    del state
    st.pop("state")
    torch.cuda.empty_cache()

    # step 1 again from the same (re-made) state
    state = st["init_state"](torch.Generator(device=TRAIN_DEV).manual_seed(SEED))
    state, metrics = train_step(state, batches[0])
    first = st.pop("first")
    same_loss = torch.equal(metrics["loss"].cpu(), first["loss"])
    same_params = all(torch.equal(p.detach(), h.to(TRAIN_DEV))
                      for p, h in zip(state["params"].parameters(), first["params"]))
    rec["step1_twice_bit_identical"] = {"loss": same_loss, "params": same_params}
    log(f"[train] step 1 twice from the same state: loss bit-identical {same_loss}, parameters "
        f"bit-identical {same_params}")
    require(same_loss and same_params, "train: step 1 twice from the same state differs")
    del state, first, metrics
    torch.cuda.empty_cache()

    # the 2-layer full-width fp32 model: kernels against the plain near field
    cfg2 = get_arch(LM_ARCH).replace(n_layers=2, dtype="float32")
    gen = torch.Generator(device=TRAIN_DEV).manual_seed(SEED)
    params2 = get_model(cfg2, TRAIN_DEV)["init_params"](gen)
    batch2 = make_batch(DataConfig(vocab_size=cfg2.vocab_size, seq_len=TRAIN_SEQ,
                                   global_batch=1, seed=SEED), 0, device=TRAIN_DEV)
    loss_fn = make_loss_fn(cfg2, remat=True)
    loss_k, g_k = train_grads(params2, batch2, loss_fn)
    with plain_nearfield():
        loss_p, g_p = train_grads(params2, batch2, loss_fn)
    rel = grads_rel(g_k, g_p)
    norms = {name: float(torch.linalg.vector_norm(g)) for name, g in g_k.items()}
    del g_k, g_p
    worst = max(rel, key=rel.get)
    largest = sorted(norms, key=norms.get, reverse=True)[:5]
    rec["fp32_2_layers"] = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                            "grad_rel_err": rel, "worst": [worst, rel[worst]],
                            "grad_norms": norms}
    log(f"[train fp32, 2 layers, 1 x {TRAIN_SEQ}] kernels against the plain near field and its "
        f"plain backward: loss {float(loss_k):.7f} / {float(loss_p):.7f}; largest gradient rel "
        f"err {rel[worst]:.3e} ({worst}; limit {TRAIN_GRAD_LIMIT}); largest gradient norms "
        + ", ".join(f"{name} {norms[name]:.4g}" for name in largest))
    require(all(math.isfinite(v) and v <= TRAIN_GRAD_LIMIT for v in rel.values()),
            f"train fp32: kernel and plain gradients differ: {rel}")

    # the flash VJP at S = 512 <= c_leaf (chunked_attention), 2 layers, fp32
    batch3 = make_batch(DataConfig(vocab_size=cfg2.vocab_size, seq_len=cfg2.h_c_leaf,
                                   global_batch=1, seed=SEED), 0, device=TRAIN_DEV)

    def plain_chunked(q, k, v, *, causal=True, window=0, chunk=1024, q_offset=0):
        b, sq, h, d = q.shape
        out, _, _ = lm_layers._flash_fwd(q, k, v, causal, window, min(chunk, k.shape[1]),
                                         q_offset)
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)

    _, g_f = train_grads(params2, batch3, loss_fn)
    orig = lm_layers.chunked_attention
    lm_layers.chunked_attention = plain_chunked
    try:
        _, g_a = train_grads(params2, batch3, loss_fn)
    finally:
        lm_layers.chunked_attention = orig
    rel = grads_rel(g_f, g_a)
    worst = max(rel, key=rel.get)
    rec["flash_vjp"] = {"seq": cfg2.h_c_leaf, "grad_rel_err": rel, "worst": [worst, rel[worst]]}
    log(f"[train flash VJP, 2 layers fp32, 1 x {cfg2.h_c_leaf}] custom VJP against autograd "
        f"through the plain loop: largest gradient rel err {rel[worst]:.3e} ({worst}; limit "
        f"{TRAIN_FLASH_LIMIT})")
    require(all(math.isfinite(v) and v <= TRAIN_FLASH_LIMIT for v in rel.values()),
            f"train: flash VJP against autograd through the loop: {rel}")
    del params2, g_f, g_a
    torch.cuda.empty_cache()
    rec["flash_vjp_noncausal"] = check_flash_noncausal()
    run_train_resume(rec)
    rec["phase_s"] = time.perf_counter() - st["t_phase"]
    log(f"[train] phase t wall {rec['phase_s']:.1f} s")


def check_flash_noncausal(seq: int = 512) -> dict:
    """The flash VJP without the causal mask (whisper's encoder and its
    cross-attention run so), fp32 on the card: q, k, v gradients of
    ``chunked_attention(causal=False)`` against autograd through the plain
    loop ``_flash_fwd``, within TRAIN_FLASH_LIMIT relative."""
    from repro_torch.models import layers as lm_layers
    gen = torch.Generator(device=TRAIN_DEV).manual_seed(SEED)
    q = torch.randn((1, seq, 8, 64), generator=gen, device=TRAIN_DEV)
    k = torch.randn((1, seq, 4, 64), generator=gen, device=TRAIN_DEV)
    v = torch.randn((1, seq, 4, 64), generator=gen, device=TRAIN_DEV)
    gout = torch.randn((1, seq, 8, 64), generator=gen, device=TRAIN_DEV)

    def grads(fn):
        inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad((fn(*inputs) * gout).sum(), inputs)

    def plain(q, k, v):
        out, _, _ = lm_layers._flash_fwd(q, k, v, False, 0, seq, 0)
        return out.permute(0, 3, 1, 2, 4).reshape(q.shape)

    got = grads(lambda q, k, v: lm_layers.chunked_attention(q, k, v, causal=False))
    want = grads(plain)
    rel = {name: rel_err(a, b) for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    log(f"[train flash VJP, non-causal, fp32, 1 x {seq}, 8 / 4 heads of 64] custom VJP against "
        f"autograd through the plain loop: " + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
        + f" (limit {TRAIN_FLASH_LIMIT})")
    require(all(math.isfinite(e) and e <= TRAIN_FLASH_LIMIT for e in rel.values()),
            f"train: non-causal flash VJP against autograd through the loop: {rel}")
    return {"seq": seq, "grad_rel_err": rel}


def launcher_resumes(argv: list, steps: tuple = (2, 3)) -> tuple[bool, list]:
    """``launch/train.py`` run twice on one checkpoint directory: the second
    run must resume from the first's last step.  Returns (resumed, outputs)."""
    import io
    from repro_torch.launch import train as train_launch
    outs = []
    for n in steps:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            final = train_launch.main(argv + ["--steps", str(n)])
        outs.append(buf.getvalue())
    resumed = f"[restore] resumed from step {steps[0]}" in outs[1] and final["step"] == steps[1]
    return resumed, outs


def run_train_resume(rec) -> None:
    """On the smoke config on the card: 4 steps straight against 2 steps, a
    save, a fresh restore and 2 more, bit for bit; then ``launch/train.py
    --smoke`` run twice on one checkpoint directory (the second resumes)."""
    import shutil
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.runtime.checkpoint import CheckpointManager, flatten_state
    from repro_torch.train.step import make_train_step
    cfg = get_smoke(LM_ARCH).replace(dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2, seed=SEED)
    init_state, train_step = make_train_step(cfg, train_opt_cfg(), microbatches=2,
                                             device=TRAIN_DEV)
    straight = init_state(torch.Generator(device=TRAIN_DEV).manual_seed(SEED))
    for s in range(4):
        straight, _ = train_step(straight, make_batch(dcfg, s, device=TRAIN_DEV))
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(TRAIN_CKPT_DIR / "resume", async_save=True)
    part = init_state(torch.Generator(device=TRAIN_DEV).manual_seed(SEED))
    for s in range(2):
        part, _ = train_step(part, make_batch(dcfg, s, device=TRAIN_DEV))
    mgr.save(2, part, extra={"data_step": 2})
    mgr.wait()
    del part
    resumed, manifest = mgr.restore(init_state(torch.Generator(device=TRAIN_DEV).manual_seed(1)))
    for s in range(manifest["extra"]["data_step"], 4):
        resumed, _ = train_step(resumed, make_batch(dcfg, s, device=TRAIN_DEV))
    a, b = flatten_state(resumed), flatten_state(straight)
    equal = [p for p, _ in a] == [p for p, _ in b] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(a, b))
    argv = ["--arch", LM_ARCH, "--smoke", "--device", TRAIN_DEV, "--batch", "2",
            "--seq-len", "256", "--microbatches", "2", "--log-every", "1", "--ckpt-dir",
            str(TRAIN_CKPT_DIR / "launcher")]
    resumed_launch, outs = launcher_resumes(argv)
    rec["resume"] = {"straight_equals_resumed": equal, "launcher_resumed": resumed_launch,
                     "launcher_output": outs}
    log(f"[train resume, smoke config] 4 steps straight equal 2 + save + restore + 2 bit for "
        f"bit: {equal}; launch/train.py --smoke resumed from its directory: {resumed_launch}")
    for line in outs[1].splitlines():
        log(f"[train launcher] {line}")
    require(equal, "train: resume differs from the straight run")
    require(resumed_launch, f"train: the launcher did not resume: {outs}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase g: the other LM families trained (run after phase t)
# ---------------------------------------------------------------------------

# (arch, layers run, sequence): published widths, bf16; train_4k's sequence
# with its batch of 256 cut to 2, in 2 microbatches with remat; AdamW as in
# phase t.  The training state is 16 bytes a parameter: mixtral runs 2 of its
# 32 layers (1 if the peak passes 72 GiB), zamba2 24 of 81 (4 periods),
# xlstm 8 of 48 (one period) at 2,048 tokens (its sLSTM layer steps per token)
FAMILY_TRAIN_RUNS = (("granite-moe-1b-a400m", 24, 4096), ("mixtral-8x7b", 2, 4096),
                     ("zamba2-7b", 24, 4096), ("xlstm-1.3b", 8, 2048),
                     ("whisper-tiny", 4, 4096), ("smollm-135m", 30, 4096))
FAMILY_TRAIN_CUT = {"mixtral-8x7b": 1}
# one step of each under the profiler (the trace costs ~1 ms of host time a
# kernel to read); xlstm's at a cut sequence: a whole step is ~600,000
# launches, too many to trace within the run's time limit
FAMILY_TRAIN_PROFILED = {"mixtral-8x7b": None, "zamba2-7b": None, "xlstm-1.3b": 32}
FAMILY_TRAIN_GRAD_LIMIT = 1e-4     # card against CPU, smoke configs, fp32
FAMILY_TRAIN_ZERO = 1e-6           # a gradient zero in exact arithmetic, of the global norm
FAMILY_TRAIN_SMOKE_SEQ = 64
FAMILY_TRAIN_DEV = "cuda"          # a CPU rehearsal of the phase's control flow sets "cpu"
# parts of a family's train step by kernel name (first match)
FAMILY_TRAIN_PARTS = (("bf16 GEMM (projections, experts, head)", ("nvjet", "bf16")),
                      ("fp32 products (band, SSD, mLSTM, attention)", ("gemm", "gemv")),
                      ("gathers and scatters (index kernels)", ("index", "scatter", "gather")),
                      ("scans (cumsum: MoE slots, SSD decays)", ("scan", "cumsum")))
FAMILY_TRAIN_OTHER = "other (elementwise, reductions, copies: norms, gates, loss, AdamW)"


def family_train_flops(cfg, seq: int) -> float:
    """``analysis.flops``' count of one train step of 2 x ``seq`` tokens."""
    from repro_torch.analysis.flops import attention_extra_flops, model_flops
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("train", seq, TRAIN_BATCH, "train")
    return model_flops(cfg, shape) + attention_extra_flops(cfg, shape)


def family_train_setup(name: str, layers: int, seq: int, n_batches: int):
    """The model's ``make_train_step`` pair, its batches (with frame embeds
    for a stub audio frontend) and its config."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.step import make_train_step
    cfg = get_arch(name).replace(n_layers=layers)
    init_state, train_step = make_train_step(cfg, train_opt_cfg(), microbatches=TRAIN_MICRO,
                                             remat=True, device=FAMILY_TRAIN_DEV)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=TRAIN_BATCH,
                      seed=SEED)
    batches = [make_batch(dcfg, s, d_model=cfg.d_model, with_embeds=cfg.frontend == "audio_stub",
                          device=FAMILY_TRAIN_DEV) for s in range(n_batches)]
    return cfg, init_state, train_step, batches


def family_train_main(name: str, layers: int, seq: int) -> dict:
    """The main path of one model: TRAIN_STEPS steps through ``make_train_step``
    from ``make_batch``.  Returns what the checks after it need."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import count_params, count_params_analytic
    cfg, init_state, train_step, batches = family_train_setup(name, layers, seq, TRAIN_STEPS)
    gen = torch.Generator(device=FAMILY_TRAIN_DEV).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    state, t_init = wall_s(lambda: init_state(gen))
    steps, first = [], None
    for s in range(TRAIN_STEPS):
        (state, metrics), secs = wall_s(lambda: train_step(state, batches[s]))
        loss, gnorm, lr = torch.stack([metrics["loss"], metrics["grad_norm"],
                                       metrics["lr"]]).tolist()
        steps.append({"step": s, "loss": loss, "grad_norm": gnorm, "lr": lr, "seconds": secs})
        log(f"[families train] {name} ({layers} layers), step {s}: loss {loss:.6f}, grad norm "
            f"{gnorm:.4f}, {secs:.3f} s")
        if s == 0:
            first = {"loss": metrics["loss"].cpu(),
                     "params": [p.detach().to("cpu", copy=True)
                                for p in state["params"].parameters()]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_step = statistics.median(st["seconds"] for st in steps[1:])
    flop = family_train_flops(cfg, seq)
    rec = {"layers": layers, "published_layers": get_arch(name).n_layers,
           "params": count_params(state["params"]),
           "params_analytic": count_params_analytic(cfg)["total"], "dtype": cfg.dtype,
           "global_batch": TRAIN_BATCH, "seq_len": seq, "microbatches": TRAIN_MICRO,
           "remat": True, "init_s": t_init, "steps": steps, "s_per_step": s_step,
           "tok_per_s": TRAIN_BATCH * seq / s_step, "peak_memory_gib": peak,
           "model_flop_per_step": flop, "mfu": flop / (s_step * PEAK_BF16),
           "mfu_peak_flops": PEAK_BF16}
    log(f"[families train] {name}: {rec['params']:,} parameters ({layers} of "
        f"{rec['published_layers']} layers, bf16) made in {t_init:.2f} s; {TRAIN_BATCH} x {seq} "
        f"tokens a step in {TRAIN_MICRO} microbatches with remat: {s_step:.3f} s a step (median "
        f"of steps 2-{TRAIN_STEPS}), {rec['tok_per_s']:.0f} tok/s; analysis.flops "
        f"{flop / 1e12:.2f} TFLOP a step, MFU {rec['mfu']:.4f} of the dense bf16 "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s; peak memory {peak:.2f} GiB")
    require(all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]) for st in steps),
            f"families train {name}: a non-finite loss or grad norm: {steps}")
    return {"cfg": cfg, "state": state, "train_step": train_step, "init_state": init_state,
            "batches": batches, "first": first, "rec": rec}


def family_train_checks(name: str, st: dict) -> None:
    """After the launch count: one step under the profiler (a cut sequence
    for xlstm), then step 1 again from the same (re-made) state: loss and
    every parameter bit-identical."""
    rec, cfg = st["rec"], st["cfg"]
    state, train_step = st.pop("state"), st["train_step"]
    if name in FAMILY_TRAIN_PROFILED:
        seq = FAMILY_TRAIN_PROFILED[name] or rec["seq_len"]
        if seq == rec["seq_len"]:
            batch = st["batches"][0]
        else:
            batch = family_train_setup(name, cfg.n_layers, seq, 1)[3][0]
        gc.collect()
        prof, wall = wall_s(lambda: device_profile(lambda: train_step(state, batch), top=10 ** 6))
        prof["wall_s"] = wall          # the step and the reading of its trace
        prof["split"] = train_profile_split(prof["top"], FAMILY_TRAIN_PARTS, FAMILY_TRAIN_OTHER)
        prof["top"] = prof["top"][:12]
        prof["seq_len"] = seq
        prof["launches_per_token"] = prof["kernel_launches"] / (TRAIN_BATCH * seq)
        rec["profile"] = prof
        log(f"[families train profile] {name}, one step of {TRAIN_BATCH} x {seq}: host "
            f"{prof['host_s'] * 1e3:.1f} ms, {prof['kernel_launches']} kernels "
            f"({prof['launches_per_token']:.1f} a token) {prof['device_ms']:.1f} ms, device "
            f"idle {prof['idle_share']:.3f}; with the trace read {wall:.1f} s")
        for part, ms in prof["split"].items():
            log(f"[families train profile]   {ms:10.2f} ms  {part}")
        for k in prof["top"]:
            log(f"[families train profile]   {k['ms']:10.3f} ms  {k['calls']:7d}x  {k['name']}")
        del prof, batch
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state = st["init_state"](torch.Generator(device=FAMILY_TRAIN_DEV).manual_seed(SEED))
    state, metrics = train_step(state, st["batches"][0])
    first = st.pop("first")
    same_loss = torch.equal(metrics["loss"].cpu(), first["loss"])
    same_params = all(torch.equal(p.detach(), h.to(FAMILY_TRAIN_DEV))
                      for p, h in zip(state["params"].parameters(), first["params"]))
    rec["step1_twice_bit_identical"] = {"loss": same_loss, "params": same_params}
    log(f"[families train] {name}: step 1 twice from the same state: loss bit-identical "
        f"{same_loss}, parameters bit-identical {same_params}")
    require(same_loss and same_params, f"families train {name}: step 1 twice differs")
    del state, metrics, first


def family_train_grads(params, batch, loss_fn) -> tuple:
    names, plist = zip(*params.named_parameters())
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, plist)
    return float(loss.detach()), dict(zip(names, grads))


def family_train_card_vs_cpu(name: str) -> dict:
    """The smoke config in fp32 from one state and one batch: the loss and
    every parameter's gradient on the card within FAMILY_TRAIN_GRAD_LIMIT
    relative of the port's own CPU run (the run the tier-1 tests hold against
    ``repro``); a gradient zero in exact arithmetic (whisper's key biases,
    without RoPE) is held below FAMILY_TRAIN_ZERO of the global norm on both."""
    import copy
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.api import get_model
    from repro_torch.train.step import make_loss_fn
    cfg = get_smoke(name).replace(dtype="float32")
    params_cpu = get_model(cfg, "cpu")["init_params"](torch.Generator().manual_seed(SEED))
    params_dev = copy.deepcopy(params_cpu).to(FAMILY_TRAIN_DEV)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=FAMILY_TRAIN_SMOKE_SEQ,
                                  global_batch=TRAIN_BATCH, seed=SEED), 0, d_model=cfg.d_model,
                       with_embeds=cfg.is_encoder_decoder, device="cpu")
    loss_fn = make_loss_fn(cfg, remat=True)
    loss_c, g_c = family_train_grads(params_cpu, batch, loss_fn)
    loss_d, g_d = family_train_grads(
        params_dev, {k: v.to(FAMILY_TRAIN_DEV) for k, v in batch.items()}, loss_fn)
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_c.values())))
    rel, zero = {}, {}
    for n, g in g_c.items():
        gd = g_d[n].cpu()
        if float(torch.linalg.vector_norm(g)) <= FAMILY_TRAIN_ZERO * norm:
            zero[n] = max(float(torch.linalg.vector_norm(g)),
                          float(torch.linalg.vector_norm(gd))) / norm
        else:
            rel[n] = rel_err(gd, g)
    worst = max(rel, key=rel.get)
    out = {"loss_card": loss_d, "loss_cpu": loss_c, "loss_rel_err": abs(loss_d - loss_c) / loss_c,
           "grad_rel_err_max": rel[worst], "worst": worst, "zero_in_exact": zero,
           "tensors": len(g_c)}
    log(f"[families train card vs CPU] {name}-smoke fp32, {TRAIN_BATCH} x "
        f"{FAMILY_TRAIN_SMOKE_SEQ}: loss {loss_d:.7f} / {loss_c:.7f}; largest gradient rel err "
        f"{rel[worst]:.3e} ({worst}) over {len(rel)} tensors (limit {FAMILY_TRAIN_GRAD_LIMIT})"
        + (f"; {len(zero)} zero in exact arithmetic, below {max(zero.values()):.1e} of the "
           f"global norm" if zero else ""))
    require(out["loss_rel_err"] <= FAMILY_TRAIN_GRAD_LIMIT
            and all(math.isfinite(e) and e <= FAMILY_TRAIN_GRAD_LIMIT for e in rel.values())
            and all(e <= FAMILY_TRAIN_ZERO for e in zero.values()),
            f"families train {name}: card and CPU gradients differ: {out}")
    return out


def run_families_train(record, count) -> None:
    """Phase g: the six families trained on the card, one at a time; the
    launch counts are set to 0 before each model's main path and read by
    ``count()`` after it (no kernel may launch), then the model is checked
    and freed.  Then the smoke configs' gradients on the card against the
    CPU and whisper's launcher resuming."""
    import shutil
    from repro_torch import _build
    t_phase = time.perf_counter()
    out = record.setdefault("families_train", {})
    for name, layers, seq in FAMILY_TRAIN_RUNS:
        t_model = time.perf_counter()
        depths = (layers, FAMILY_TRAIN_CUT[name]) if name in FAMILY_TRAIN_CUT else (layers,)
        for depth in depths:
            _build.reset_launches()
            st = family_train_main(name, depth, seq)
            count()
            if st["rec"]["peak_memory_gib"] <= TRAIN_PEAK_LIMIT_GIB or depth == depths[-1]:
                break
            log(f"[families train] {name}: peak {st['rec']['peak_memory_gib']:.2f} GiB at {depth} "
                f"layers passes {TRAIN_PEAK_LIMIT_GIB} GiB: the depth is cut to "
                f"{FAMILY_TRAIN_CUT[name]}")
            del st
            gc.collect()
            torch.cuda.empty_cache()
        out[name] = st["rec"]
        family_train_checks(name, st)
        del st
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["wall_s"] = time.perf_counter() - t_model
    t_checks = time.perf_counter()
    out["card_vs_cpu"] = {name: family_train_card_vs_cpu(name) for name, _, _ in FAMILY_TRAIN_RUNS}
    ckpt = TRAIN_CKPT_DIR / "whisper_launcher"
    shutil.rmtree(ckpt, ignore_errors=True)
    resumed, outs = launcher_resumes(
        ["--arch", "whisper-tiny", "--smoke", "--device", FAMILY_TRAIN_DEV, "--batch", "2",
         "--seq-len", "256", "--microbatches", "2", "--log-every", "1", "--ckpt-dir", str(ckpt)])
    out["whisper_launcher"] = {"resumed": resumed, "output": outs}
    log(f"[families train] launch/train.py --arch whisper-tiny --smoke resumed from its "
        f"directory: {resumed}")
    for line in outs[1].splitlines():
        log(f"[families train launcher] {line}")
    require(resumed, f"families train: the whisper launcher did not resume: {outs}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    out["checks_s"] = time.perf_counter() - t_checks
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[families train] phase g wall {out['phase_s']:.1f} s (checks after the models "
        f"{out['checks_s']:.1f} s)")


# ---------------------------------------------------------------------------
# phase 9: serving (run after phase 3, on the H-matrices of setup)
# ---------------------------------------------------------------------------

SERVE_P_REQUESTS = 150          # panels of 64, 64 and a tail of 22 (the 32 bucket)
SERVE_K_TARGETS = 20            # panels of 8, 8 and a tail of 4
SERVE_CHAOS = "transient=0.3:1,nan=0.1,seed=7"
SERVE_CHAOS_REQUESTS = 64       # 8 panels of 8
TENANT_P_REQUESTS, TENANT_KRAW_REQUESTS = 96, 48    # 12 and 6 panels of 8
K_SIGMA2 = 1e-2


def host_requests(n: int, count: int, seed: int) -> list:
    """``count`` request vectors of length ``n`` from a seeded generator on the
    card, brought to the host once: contiguous float32 rows, as a client
    submits them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return list(torch.randn((count, n), generator=gen, device="cuda").cpu().numpy())


def on_card(rows: list) -> torch.Tensor:
    """Host vectors as the columns of an (N, count) tensor on the card."""
    return torch.from_numpy(np.stack(rows, axis=1)).cuda()


def bit_identical(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def served(srv, batch):
    """The batch through ``serve()`` and through ``serve_async()`` (results
    fetched), in turns twice, each timed on the host clock: (sync results,
    async results, [sync s, async s, sync s, async s])."""
    times = []
    for _ in range(2):
        sync, t_sync = wall_s(lambda: srv.serve(batch))
        outs, t_async = wall_s(lambda: [f.result(timeout=600) for f in srv.serve_async(batch)])
        times += [t_sync, t_async]
    return sync, outs, times


def require_clean(stats: dict, what: str) -> None:
    require(stats["retries"] == 0 and stats["panel_failures"] == 0
            and stats["fallback_launches"] == 0,
            f"{what}: {stats['retries']} retries, {stats['panel_failures']} panel failures, "
            f"{stats['fallback_launches']} fallback launches without chaos")


def serve_apply_p(pts_p, hm_p, rng, rec) -> dict:
    """HMatrixServer on P: sync and async bit-identical, panel 1 equal to
    make_apply, 8 results against exact dense rows, one profiled burst."""
    from repro_torch.core import make_apply
    from repro_torch.serve.step import HMatrixServer
    qs = host_requests(hm_p.tree.n, SERVE_P_REQUESTS, SEED + 1)
    srv = HMatrixServer(hm_p, max_batch=64)
    _, t_pre = wall_s(srv.precompile)
    sync, outs, times = served(srv, qs)
    t_sync, t_async = times[2], times[3]
    srv.runtime.drain()             # the stats of the last panel are in
    stats = srv.runtime.stats()
    identical = bit_identical(sync, outs)
    panel1 = bool(torch.equal(on_card(sync[:64]), make_apply(hm_p)(on_card(qs[:64]))))
    idx = torch.from_numpy(np.sort(rng.choice(hm_p.tree.n, 512, replace=False))).cuda()
    err = rel_err(on_card(sync[:8])[idx], exact_rows(pts_p, idx, on_card(qs[:8])))
    prof = device_profile(lambda: [f.result(timeout=600) for f in srv.serve_async(qs)])
    srv.close()
    pack_ms = [s * 1e3 for s in stats["pack_s"]]
    rec["P_apply"] = {
        "requests": len(qs), "precompile_s": t_pre, "sync_s": t_sync, "async_s": t_async,
        "in_turns_s": times,
        "sync_requests_per_s": len(qs) / t_sync, "async_requests_per_s": len(qs) / t_async,
        "launched_widths": stats["launched_widths"], "host_pack_ms_per_panel": pack_ms,
        "async_bit_identical_to_sync": identical, "panel1_bit_identical_to_make_apply": panel1,
        "sampled_rows_rel_err_8_results": err, "async_burst_profile": prof,
        "retries": stats["retries"], "panel_failures": stats["panel_failures"],
        "fallback_launches": stats["fallback_launches"]}
    log(f"[serve P] {len(qs)} requests, panels {stats['launched_widths']}: sync {t_sync:.3f} s "
        f"({len(qs) / t_sync:.1f} requests/s), async {t_async:.3f} s ({len(qs) / t_async:.1f} "
        f"requests/s); host pack ms per panel {[round(m, 3) for m in pack_ms]}; precompile "
        f"{t_pre:.3f} s")
    log(f"[serve P] async burst under the profiler: host {prof['host_s']:.3f} s, device "
        f"{prof['device_ms']:.3f} ms in {prof['kernel_launches']} kernels and copies, busy "
        f"{prof['busy_ms']:.3f} ms, device idle share {prof['idle_share']:.3f}; async == sync "
        f"bit for bit {identical}, panel 1 == make_apply {panel1}, 8 results on 512 rows rel "
        f"err {err:.3e}")
    for row in prof["top"][:6]:
        log(f"[serve P]   {row['ms']:.3f} ms in {row['calls']} calls: {row['name'][:80]}")
    require(identical, "serve P: async results differ from serve()")
    require(panel1, "serve P: panel 1 of serve() differs from make_apply on its 64 columns")
    require(err <= 1e-4, f"serve P: rel err on 512 sampled rows {err}")
    require(stats["launched_widths"] == [64, 64, 32] * 2,
            f"serve P: launched widths {stats['launched_widths']}")
    require_clean(stats, "serve P")
    return {"srv": srv, "queries": qs, "sync": sync}


def serve_solve_k(pts_k, hm_k, rec) -> dict:
    """HMatrixSolveServer on K: sync and async bit-identical, iterations per
    column within phase 3's spread of the reference, residual by an apply."""
    from repro_torch.core import make_apply, sinusoid_targets
    from repro_torch.serve.step import HMatrixSolveServer
    f = sinusoid_targets(pts_k, SERVE_K_TARGETS, 32.0)
    targets = list(f.t().contiguous().cpu().numpy())
    srv = HMatrixSolveServer(hm_k, K_SIGMA2, tol=1e-3, max_iter=300, max_batch=8)
    srv.precompile()
    sync, t_sync = wall_s(lambda: srv.serve(targets))
    iters = [info.iters_per_column.tolist() for info in srv.last_info]
    outs, t_async = wall_s(lambda: [fut.result(timeout=600) for fut in srv.serve_async(targets)])
    times = [t_sync, t_async]
    for _ in range(2):                      # in turns once more, warm
        t_sync = wall_s(lambda: srv.serve(targets))[1]
        t_async = wall_s(lambda: [fut.result(timeout=600)
                                  for fut in srv.serve_async(targets)])[1]
        times += [t_sync, t_async]
    srv.close()
    stats = srv.runtime.stats()
    identical = bit_identical(sync, outs)
    c = on_card(sync)
    resid = rel_err(make_apply(hm_k)(c) + K_SIGMA2 * c, f)
    flat = [it for panel in iters for it in panel]
    # targets repeat the 8 sinusoids of phase 3, column j is target j % 8
    off = [abs(it - K_REFERENCE_ITERS[j % 8]) for j, it in enumerate(flat)]
    n = len(targets)
    rec["K_solve"] = {
        "targets": n, "sync_s": t_sync, "async_s": t_async, "in_turns_s": times,
        "sync_requests_per_s": n / t_sync, "async_requests_per_s": n / t_async,
        "launched_widths": stats["launched_widths"], "iters_per_panel": iters,
        "max_iters_off_reference": max(off), "relative_residual": resid,
        "async_bit_identical_to_sync": identical,
        "host_pack_ms_per_panel": [s * 1e3 for s in stats["pack_s"]],
        "retries": stats["retries"], "panel_failures": stats["panel_failures"],
        "fallback_launches": stats["fallback_launches"]}
    log(f"[serve K solve] {n} targets, panels {stats['launched_widths']}: sync {t_sync:.3f} s "
        f"({n / t_sync:.2f} requests/s), async {t_async:.3f} s ({n / t_async:.2f} requests/s; "
        f"the PCG reads active.any() on the host every iteration); iterations per panel "
        f"{iters}; relative residual {resid:.3e}; async == sync bit for bit {identical}")
    require(identical, "serve K solve: async results differ from serve()")
    require(max(off) <= 5, f"serve K solve: iterations {iters} not within 5 of the reference "
            f"{K_REFERENCE_ITERS}")
    require(resid <= 1e-4, f"serve K solve: relative residual {resid}")
    require(stats["launched_widths"] == [8, 8, 4] * 3,
            f"serve K solve: launched widths {stats['launched_widths']}")
    require_clean(stats, "serve K solve")
    return {"targets": targets, "sync": sync}


def serve_chaos_k(hm_k, rec) -> None:
    """K's apply server under injected transient faults and NaN panels: no
    future fails and every panel keeps the chaos-free bits.  A retried panel
    re-enters the queue; a poisoned one is relaunched once, counted, through
    the server's own launch, so both cost launches, not bits."""
    from repro_torch.serve.faults import ResiliencePolicy
    from repro_torch.serve.step import HMatrixServer
    qs = host_requests(hm_k.tree.n, SERVE_CHAOS_REQUESTS, SEED + 2)
    with HMatrixServer(hm_k, max_batch=8, chaos="") as clean:
        want = clean.serve(qs)
    srv = HMatrixServer(hm_k, max_batch=8, chaos=SERVE_CHAOS,
                        resilience=ResiliencePolicy(validate_outputs=True))
    outs = [f.result(timeout=600) for f in srv.serve_async(qs)]
    srv.close()
    stats = srv.runtime.stats()
    injected = stats["faults_injected"]
    panels = [(outs[i:i + 8], want[i:i + 8]) for i in range(0, len(qs), 8)]
    other = [i for i, (got, ref) in enumerate(panels) if not bit_identical(got, ref)]
    rec["K_chaos"] = {
        "spec": SERVE_CHAOS, "requests": len(qs), "faults_injected": injected,
        "retries": stats["retries"], "fallback_launches": stats["fallback_launches"],
        "panel_failures": stats["panel_failures"], "panels_with_other_bits": other,
        "events": [kind for _, kind, _ in stats["events"]]}
    log(f"[serve K chaos] {SERVE_CHAOS}: injected {injected}; retries {stats['retries']}, "
        f"relaunches {stats['fallback_launches']}, panel failures "
        f"{stats['panel_failures']}; panels off the chaos-free bits {other}")
    require(stats["panel_failures"] == 0, "serve K chaos: a panel failed")
    require(injected["nan"] >= 1 and injected["transient"] >= 1,
            f"serve K chaos: the schedule injected {injected}")
    require(stats["fallback_launches"] == injected["nan"],
            f"serve K chaos: {stats['fallback_launches']} fallback launches for "
            f"{injected['nan']} NaN panels")
    require(stats["retries"] >= injected["transient"],
            f"serve K chaos: {stats['retries']} retries for {injected['transient']} transient "
            f"faults")
    require(not other, f"serve K chaos: panels {other} differ from the chaos-free serve()")


def serve_tenants(pts_k, hm_p, hm_k, p_served: dict, k_served: dict, rec) -> None:
    """Three tenants behind one MultiTenantRuntime under a device-bytes budget
    below P's and K's stores together: every result within 1e-5 relative of
    its solo server, the launch order at the 2:1 weights, P's store spilled
    by K's panels and reloaded by its own."""
    from repro_torch.core import build_hmatrix_device
    from repro_torch.serve.step import HMatrixServer
    from repro_torch.serve.tenancy import MultiTenantRuntime, apply_tenant, solve_tenant
    p_bytes = hm_p.factors.nbytes()["total"]
    k_bytes = hm_k.factors.nbytes()["total"]
    budget = p_bytes + k_bytes - 1
    kr_qs = host_requests(hm_k.tree.n, TENANT_KRAW_REQUESTS, SEED + 3)
    with HMatrixServer(build_hmatrix_device(pts_k, precompute=True, **K_BUILD),
                       max_batch=8) as solo:
        kr_want = solo.serve(kr_qs)
    p_qs = p_served["queries"][:TENANT_P_REQUESTS]
    targets = k_served["targets"]
    mtr = MultiTenantRuntime(device_bytes_budget=budget)
    tp = mtr.add_tenant("P", p_served["srv"].tenant_spec(weight=2.0, store=hm_p.factors),
                        max_batch=8)
    ts = mtr.add_tenant("K_solve", solve_tenant(hm_k, K_SIGMA2, tol=1e-3, max_iter=300))
    (kr_spec, t_onboard) = wall_s(lambda: apply_tenant(
        pts_k.cpu().numpy(), max_batch=8, build=dict(precompute=True, **K_BUILD)))
    tk = mtr.add_tenant("K_raw", kr_spec)
    t0 = time.perf_counter()
    # the scheduler takes the runtime's lock to pick a panel: holding it while
    # every tenant submits makes the first pick one among three backlogged
    # tenants, whatever the order of the submits
    with mtr._cv:
        fs = [ts.submit(q) for q in targets]
        fk = [tk.submit(q) for q in kr_qs]
        fp = [tp.submit(q) for q in p_qs]
    mtr.flush()
    got_p = [f.result(timeout=600) for f in fp]
    got_s = [f.result(timeout=600) for f in fs]
    got_k = [f.result(timeout=600) for f in fk]
    t_serve = time.perf_counter() - t0
    mtr.close()
    glob, per = mtr.stats(), {h.name: h.stats() for h in (tp, ts, tk)}
    errs = {"P": rel_err(on_card(got_p), on_card(p_served["sync"][:TENANT_P_REQUESTS])),
            "K_solve": rel_err(on_card(got_s), on_card(k_served["sync"])),
            "K_raw": rel_err(on_card(got_k), on_card(kr_want))}
    order = list(glob["launch_order"])
    # P (weight 2) against K_raw (weight 1) while both have panels queued:
    # from the first launch, when both queues are full, to the first of the
    # two tenants' last launches
    apply_order = [name for name in order if name != "K_solve"]
    window = apply_order[:min(len(apply_order) - apply_order[::-1].index(name)
                              for name in ("P", "K_raw"))]
    counts = {name: window.count(name) for name in ("P", "K_raw")}
    rec["tenants"] = {
        "budget_bytes": budget, "p_store_bytes": p_bytes, "k_store_bytes": k_bytes,
        "weights": {"P": 2.0, "K_solve": 1.0, "K_raw": 1.0}, "serve_s": t_serve,
        "onboard_wall_s": t_onboard, "onboard_s": glob["onboard_s"],
        "rel_err_vs_solo": errs, "launch_order": order, "contended_window_counts": counts,
        "evictions": glob["evictions"], "reloads": glob["reloads"],
        "per_tenant": {name: {key: st[key] for key in
                              ("panels_launched", "spills", "reloads", "reload_s", "nbytes",
                               "retries", "panel_failures", "fallback_launches")}
                       for name, st in per.items()}}
    log(f"[serve tenants] budget {budget} bytes (P {p_bytes} + K {k_bytes} - 1); {t_serve:.3f} s "
        f"for {len(p_qs)} + {len(targets)} + {len(kr_qs)} requests; K_raw onboarded from raw "
        f"coordinates in {glob['onboard_s'].get('K_raw', 0.0):.3f} s (device build)")
    letters = "".join(name[0] if name == "P" else name[2] for name in order)
    log(f"[serve tenants] launch order {letters} (P, s = K_solve, r = K_raw); contended window "
        f"{counts}; evictions "
        f"{glob['evictions']}, reloads {glob['reloads']}; P spills {per['P']['spills']}, "
        f"reloads {per['P']['reloads']}, last reload_s {per['P']['reload_s']}")
    log(f"[serve tenants] rel err against the solo servers {errs}")
    require(all(e <= 1e-5 for e in errs.values()), f"serve tenants: results off their solo "
            f"servers by {errs}")
    require(abs(counts["P"] - 2 * counts["K_raw"]) <= 2 and per["K_solve"]["panels_launched"] == 3,
            f"serve tenants: the launch order {order} does not follow the 2:1 weights")
    require(per["P"]["spills"] >= 1 and per["P"]["reloads"] >= 1
            and per["P"]["reload_s"] is not None,
            f"serve tenants: P's store was not spilled and reloaded: {per['P']}")
    for name, st in per.items():
        require_clean(st, f"serve tenants {name}")
    require(glob["device_store_bytes"] <= budget, "serve tenants: the budget does not hold")


def run_serving(pts_p, pts_k, hm_p, hm_k, record) -> None:
    rec = record.setdefault("serve", {})
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 9)       # the other phases' draws stay as they were
    p_served = serve_apply_p(pts_p, hm_p, rng, rec)
    k_served = serve_solve_k(pts_k, hm_k, rec)
    serve_chaos_k(hm_k, rec)
    serve_tenants(pts_k, hm_p, hm_k, p_served, k_served, rec)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase 9 wall {rec['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase d: device discipline (the strict-transfer guard) and the examples
# ---------------------------------------------------------------------------

STRICT_REQUESTS = 64            # 8 panels of 8
STRICT_FETCHERS = 4
# operations timed under the sync-debug mode; each either raises or not
SYNC_TABLE_RAISES = {"item": True, "pageable_cpu": True, "bool": True, "nonzero": True,
                     "stream_synchronize": True, "pinned_non_blocking_copy": False,
                     "event_synchronize": False, "to_host": False,
                     "pinned_non_blocking_upload": False}
DISCIPLINE_DEV = "cuda"         # a CPU rehearsal of the phase's control flow sets "cpu"
EXAMPLES = (("example_quickstart", "torch_quickstart"),
            ("example_regression", "torch_kernel_regression"),
            ("example_hattention", "torch_long_context_hattention"))


def sync_table() -> dict:
    """Which operations raise inside a sync-debug window on this card."""
    from repro_torch._device import sync_debug_window, to_host
    x = torch.randn(4096, device="cuda")
    side = torch.cuda.Stream()
    pinned = torch.zeros(4096, pin_memory=True)

    def pinned_copy():
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)

    def event_sync():
        done = torch.cuda.Event()
        done.record()
        done.synchronize()

    ops = {"item": lambda: x.sum().item(), "pageable_cpu": lambda: x.cpu(),
           "bool": lambda: bool(x.sum() > 0), "nonzero": lambda: torch.nonzero(x > 0),
           "stream_synchronize": side.synchronize, "pinned_non_blocking_copy": pinned_copy,
           "event_synchronize": event_sync, "to_host": lambda: to_host(x),
           "pinned_non_blocking_upload": lambda: pinned.to("cuda", non_blocking=True),
           "device_synchronize": torch.cuda.synchronize}
    table = {}
    for name, op in ops.items():
        try:
            with sync_debug_window("cuda"):
                op()
            table[name] = "passes"
        except RuntimeError as exc:
            table[name] = f"raises: {str(exc).splitlines()[0][:60]}"
        torch.cuda.synchronize()
    return table


def fetch_in_threads(futures: list, threads: int) -> list:
    """Every future's result, fetched by ``threads`` client threads at once
    (thread t takes futures t, t + threads, ...)."""
    out = [None] * len(futures)
    errors = []

    def fetch(t):
        try:
            for i in range(t, len(futures), threads):
                out[i] = futures[i].result(timeout=300)
        except Exception as exc:          # noqa: BLE001 - reported below
            errors.append(exc)

    workers = [threading.Thread(target=fetch, args=(t,)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    require(not errors, f"a client thread's fetch failed: {errors[:1]}")
    return out


@contextlib.contextmanager
def strict_env(on: bool):
    old = os.environ.pop("REPRO_STRICT_TRANSFERS", None)
    if on:
        os.environ["REPRO_STRICT_TRANSFERS"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_STRICT_TRANSFERS", None)
        if old is not None:
            os.environ["REPRO_STRICT_TRANSFERS"] = old


def strict_bursts(pts_k, hm_k, rec) -> None:
    """K's apply server, its chaos run and one solve panel, each with and
    without ``REPRO_STRICT_TRANSFERS=1``, fetched by client threads."""
    from repro_torch.core import sinusoid_targets
    from repro_torch.serve.faults import ResiliencePolicy
    from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer
    qs = host_requests(hm_k.tree.n, STRICT_REQUESTS, SEED + 12)
    runs = {}
    for strict in (False, True):
        with strict_env(strict):
            with HMatrixServer(hm_k, max_batch=8, chaos="") as srv:
                srv.precompile()
                t0 = time.perf_counter()
                runs[("apply", strict)] = fetch_in_threads(srv.serve_async(qs), STRICT_FETCHERS)
                runs[("apply_s", strict)] = time.perf_counter() - t0
                stats = srv.runtime.stats()
                require_clean(stats, f"strict {strict} apply burst")
            with HMatrixServer(hm_k, max_batch=8, chaos=SERVE_CHAOS,
                               resilience=ResiliencePolicy(validate_outputs=True)) as srv:
                runs[("chaos", strict)] = fetch_in_threads(srv.serve_async(qs), STRICT_FETCHERS)
                srv.runtime.drain()
                runs[("chaos_stats", strict)] = srv.runtime.stats()
            f = sinusoid_targets(pts_k, 8, 32.0)
            targets = list(f.t().contiguous().cpu().numpy())
            with HMatrixSolveServer(hm_k, K_SIGMA2, tol=1e-3, max_iter=300, max_batch=8) as srv:
                runs[("solve", strict)] = fetch_in_threads(srv.serve_async(targets), 2)
                runs[("solve_iters", strict)] = srv.last_info[-1].iters_per_column.tolist()
    chaos = runs[("chaos_stats", True)]
    rec["strict"] = {
        "requests": len(qs), "fetch_threads": STRICT_FETCHERS,
        "apply_bit_identical": bit_identical(runs[("apply", False)], runs[("apply", True)]),
        "apply_s": {"plain": runs[("apply_s", False)], "strict": runs[("apply_s", True)]},
        "chaos_bit_identical": bit_identical(runs[("chaos", False)], runs[("chaos", True)]),
        "chaos_faults_injected": chaos["faults_injected"],
        "chaos_fallback_launches": chaos["fallback_launches"], "chaos_retries": chaos["retries"],
        "chaos_panel_failures": chaos["panel_failures"],
        "solve_bit_identical": bit_identical(runs[("solve", False)], runs[("solve", True)]),
        "solve_iters": runs[("solve_iters", True)]}
    r = rec["strict"]
    log(f"[discipline] K apply server, {len(qs)} requests, {STRICT_FETCHERS} fetching threads: "
        f"strict == plain bit for bit {r['apply_bit_identical']} (host s plain "
        f"{r['apply_s']['plain']:.3f}, strict {r['apply_s']['strict']:.3f}); under chaos "
        f"{r['chaos_bit_identical']} (injected {r['chaos_faults_injected']}, relaunches "
        f"{r['chaos_fallback_launches']}, retries {r['chaos_retries']}); one solve panel "
        f"{r['solve_bit_identical']}, iterations {r['solve_iters']}")
    require(r["apply_bit_identical"], "strict: the apply burst differs from the plain one")
    require(r["chaos_bit_identical"] and r["chaos_panel_failures"] == 0
            and chaos["faults_injected"]["nan"] >= 1,
            f"strict: the chaos burst differs or failed ({chaos['faults_injected']})")
    require(r["solve_bit_identical"], "strict: the solve panel differs from the plain one")
    require(runs[("solve_iters", False)] == r["solve_iters"],
            "strict: the solve's iteration counts moved")


def injected_sync(rec) -> None:
    """A launch with an injected ``.item()``: under the variable it raises in
    the window, every future of the burst fails through the lane's failure
    path (none hangs), and the runtime serves on."""
    from repro_torch.serve.runtime import PanelRuntime

    def syncing_launch(panel):
        scale = panel.abs().max().item()          # the injected host read
        return panel * 0.0 + scale

    with strict_env(True):
        rt = PanelRuntime(256, 4, syncing_launch, device=DISCIPLINE_DEV)
        futs = [rt.submit(np.ones(256, np.float32)) for _ in range(8)]
        rt.flush()
        failed = []
        for f in futs:
            try:
                f.result(timeout=60)
            except TimeoutError:
                raise AssertionError("injected sync: a future hung") from None
            except RuntimeError as exc:
                failed.append(str(exc).splitlines()[0][:80])
        stats = rt.stats()
        rt.close()
    with strict_env(False):
        with PanelRuntime(256, 4, syncing_launch, device=DISCIPLINE_DEV) as rt:
            plain = rt.submit(np.ones(256, np.float32))
            rt.flush()
            ok = float(plain.result(timeout=60)[0]) == 1.0
    rec["injected_sync"] = {"futures": len(futs), "failed": len(failed),
                            "error": failed[0] if failed else None,
                            "panel_failures": stats["panel_failures"],
                            "same_launch_without_the_variable_serves": ok}
    log(f"[discipline] injected .item(): {len(failed)} of {len(futs)} futures failed "
        f"({failed[0] if failed else None}); panel failures {stats['panel_failures']}; "
        f"without the variable it serves: {ok}")
    require(len(failed) == len(futs) and "synchronizing" in failed[0],
            f"injected sync: {len(failed)} of {len(futs)} futures failed: {failed[:1]}")
    require(ok, "injected sync: the launch fails without the variable")


def run_discipline(pts_k, hm_k, record) -> None:
    rec = record.setdefault("discipline", {})
    t_phase = time.perf_counter()
    # phase 9's memory tier may leave K's store spilled
    rec["store_reloaded_bytes"] = hm_k.factors.reload()
    table = sync_table()
    rec["sync_table"] = table
    for name, outcome in table.items():
        log(f"[discipline] under set_sync_debug_mode('error'): {name}: {outcome}")
    wrong = {n: table[n] for n, raises in SYNC_TABLE_RAISES.items()
             if table[n].startswith("raises") != raises}
    require(not wrong, f"sync table: {wrong} is not what the runtime's design rests on")
    strict_bursts(pts_k, hm_k, rec)
    injected_sync(rec)
    rec["mode_after"] = torch.cuda.get_sync_debug_mode()
    log(f"[discipline] sync-debug mode afterwards: {rec['mode_after']}")
    require(rec["mode_after"] == 0, f"the sync-debug mode was left at {rec['mode_after']}")
    rec["strict_s"] = time.perf_counter() - t_phase


def run_example(key: str, module: str, record) -> None:
    """One of the port's examples in process at its default size."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        example = __import__(module)
    finally:
        sys.path.pop(0)
    t0 = time.perf_counter()
    out = example.run(DISCIPLINE_DEV)
    wall = time.perf_counter() - t0
    keep = {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
    record.setdefault("discipline", {}).setdefault("examples", {})[key] = dict(keep, wall_s=wall)
    log(f"[{key}] {module}.py at its default size in {wall:.1f} s")
    if key == "example_quickstart":
        require(out["rel_err"] <= 1e-4, f"quickstart: rel err {out['rel_err']}")
    elif key == "example_regression":
        require(out["rel_residual"] <= 1e-4 and out["iterations"] < 300,
                f"regression: {out['iterations']} iterations, residual {out['rel_residual']}")
    else:
        require(out["rel_agreement"] <= 1e-4 and out["finite"],
                f"long-context H-attention: agreement {out['rel_agreement']}, finite "
                f"{out['finite']}")


# ---------------------------------------------------------------------------
# phase m: the sharded apply, solve and servers over a mesh
# ---------------------------------------------------------------------------

MESH_TOL = 1e-5                 # sharded against unsharded, relative (tests/test_shard.py)
# two converged K solves whose bits differ (phase 3: kernel against plain path)
K_OTHER_BITS_TOL = 1e-3


def mesh_meshes() -> list:
    """Four logical shards of card 0, and every visible card where there are
    several: (label, mesh)."""
    from repro_torch.parallel import make_panel_mesh
    meshes = [("4 x cuda:0", make_panel_mesh(devices=("cuda:0",) * 4))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"cuda:0..{torch.cuda.device_count() - 1}", make_panel_mesh()))
    return meshes


def mesh_apply_check(name: str, sharded, plain, x, rec) -> None:
    """One sharded apply against the unsharded one on the same X: relative
    error, two calls bit-identical, both timed back to back."""
    z, z_plain = sharded(x), plain(x)
    err = rel_err(z, z_plain)
    identical = bool(torch.equal(z, sharded(x)))
    ms, plain_ms = stream_ms(lambda: sharded(x), 2), stream_ms(lambda: plain(x), 2)
    rec[name] = {"rel_err": err, "bit_identical_run_to_run": identical,
                 "equal_to_unsharded_bits": bool(torch.equal(z, z_plain)), "sharded_ms": ms,
                 "unsharded_ms": plain_ms}
    log(f"[mesh] {name}: rel err {err:.3e} against the unsharded apply (bits equal "
        f"{rec[name]['equal_to_unsharded_bits']}); sharded {ms:.3f} ms, unsharded "
        f"{plain_ms:.3f} ms (stream_ms); two calls bit-identical {identical}")
    require(err < MESH_TOL, f"mesh {name}: rel err {err} against the unsharded apply")
    require(identical, f"mesh {name}: two sharded applies are not bit-identical")


def mesh_solve_k(pts_k, hm_k, mesh, rec) -> None:
    """K's column-sharded block-Jacobi solve (R = 8).

    Against the unsharded kernel solves of the shards' own column slices:
    the same bits, within 1e-5 and with the same iterations per column (each
    column's arithmetic is the single-device solver's).  Against the
    unsharded solve of the whole panel: PyTorch's column sums on the card
    round by the panel's width, so the bits may differ; then the iterations
    per column are held to fault 3's max(2, spread + 1) of the unsharded
    solve's F * (1 +- 1e-7) spread and the solution to phase 3's 1e-3 for
    two converged K solves of other bits (beside the distance the 1e-7
    change of F alone moves it), else to equal counts and 1e-5."""
    from repro_torch.core import sinusoid_targets
    from repro_torch.solve import make_solver
    f = sinusoid_targets(pts_k, 8, 32.0)
    kw = dict(tol=1e-3, max_iter=300)
    solver = make_solver(hm_k, K_SIGMA2, **kw)
    sharded = make_solver(hm_k, K_SIGMA2, mesh=mesh, **kw)
    (c0, info0), t0 = wall_s(lambda: solver(f))
    (c1, info1), t1 = wall_s(lambda: sharded(f))
    (c2, info2), t2 = wall_s(lambda: sharded(f))
    t0b = wall_s(lambda: solver(f))[1]
    it0, it1 = info0.iters_per_column.tolist(), info1.iters_per_column.tolist()
    width = f.shape[1] // len(mesh.devices)
    slices = [solver(f[:, j:j + width]) for j in range(0, f.shape[1], width)]
    c_w = torch.cat([c for c, _ in slices], dim=1)
    it_w = [it for _, info in slices for it in info.iters_per_column.tolist()]
    err, err_w = rel_err(c1, c0), rel_err(c1, c_w)
    same_bits, same_bits_w = bool(torch.equal(c1, c0)), bool(torch.equal(c1, c_w))
    identical = bool(torch.equal(c1, c2)) and info2.iters_per_column.tolist() == it1
    pert_err = None
    if same_bits:
        allowed, tol_r8 = [0] * len(it0), MESH_TOL
        held = "equal bits: equal counts, rel err < 1e-5"
    else:
        perturbed = [(eps, solver(f * (1.0 + eps))) for eps in (1e-7, -1e-7)]
        spread = [max(col) - min(col) for col in
                  zip(it0, *[info.iters_per_column.tolist() for _, (_, info) in perturbed])]
        pert_err = max(rel_err(c / (1.0 + eps), c0) for eps, (c, _) in perturbed)
        allowed, tol_r8 = [max(2, sp + 1) for sp in spread], K_OTHER_BITS_TOL
        held = "other bits: max(2, spread + 1), rel err <= 1e-3"
    rec["K_solve"] = {"rel_err": err, "equal_to_unsharded_bits": same_bits,
                      "bit_identical_run_to_run": identical, "iters_unsharded": it0,
                      "iters_sharded": it1, "iterations_sharded": info1.iterations,
                      "iters_allowed_difference": allowed, "which_held": held,
                      "shard_width_rel_err": err_w, "shard_width_equal_bits": same_bits_w,
                      "shard_width_iters": it_w, "rel_err_of_f_times_1_pm_1e-7": pert_err,
                      "sharded_s": [t1, t2], "unsharded_s": [t0, t0b]}
    log(f"[mesh] K solve R=8: rel err {err:.3e} against the unsharded kernel solve; "
        f"iterations {it1} (unsharded {it0}; {held}: allowed {allowed}); sharded {t1:.3f} / "
        f"{t2:.3f} s, unsharded {t0:.3f} / {t0b:.3f} s (wall_s); two calls bit-identical "
        f"{identical}")
    log(f"[mesh] K solve R=8 against the unsharded solves of the shards' {width}-column "
        f"slices: rel err {err_w:.3e}, bits equal {same_bits_w}, iterations {it_w}; the "
        f"unsharded solve moved by {pert_err} when F changed by 1e-7")
    require(info1.converged, "mesh K solve: not every column converged")
    require(info1.iterations == max(it1), "mesh K solve: iterations != iters_per_column.max()")
    require(err < tol_r8, f"mesh K solve: rel err {err} against the unsharded solve ({held})")
    require(all(abs(a - b) <= lim for a, b, lim in zip(it1, it0, allowed)),
            f"mesh K solve: iterations {it1} against {it0} beyond {allowed} ({held})")
    require(err_w < MESH_TOL and it_w == it1,
            f"mesh K solve: rel err {err_w}, iterations {it1} against the shards' slices "
            f"solved unsharded ({it_w})")
    require(identical, "mesh K solve: two sharded solves are not bit-identical")


def mesh_servers_k(pts_k, hm_k, mesh, rec) -> None:
    """The meshed servers on K: the apply server's row shards at its own
    width, the solve server's width rounded up to the shard count; results
    against the unsharded executors, two serves bit-identical, serve times
    beside unsharded servers' on the same requests."""
    from repro_torch.core import make_apply, sinusoid_targets
    from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer
    from repro_torch.solve import make_solver
    qs = host_requests(hm_k.tree.n, 11, SEED + 4)
    with HMatrixServer(hm_k, max_batch=6, mesh=mesh) as srv:
        require(srv.max_batch == 6, f"mesh server: max_batch {srv.max_batch}, not 6")
        outs, t_serve = wall_s(lambda: srv.serve(qs))
        again, t_again = wall_s(lambda: srv.serve(qs))
        widths = srv.widths
    with HMatrixServer(hm_k, max_batch=6) as plain_srv:
        t_plain = [wall_s(lambda: plain_srv.serve(qs))[1] for _ in range(2)]
    want = make_apply(hm_k)(on_card(qs))
    got = on_card(outs)
    apply_ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5))
    apply_err = rel_err(got, want)
    f = sinusoid_targets(pts_k, 6, 32.0)
    targets = list(f.t().contiguous().cpu().numpy())
    with HMatrixSolveServer(hm_k, K_SIGMA2, tol=1e-3, max_iter=300, max_batch=3,
                            mesh=mesh) as ssrv:
        require(ssrv.max_batch == 4, f"mesh solve server: max_batch {ssrv.max_batch}, not 4")
        souts, t_solve = wall_s(lambda: ssrv.serve(targets))
        iters = [info.iters_per_column.tolist() for info in ssrv.last_info]
        sagain, t_solve_again = wall_s(lambda: ssrv.serve(targets))
    with HMatrixSolveServer(hm_k, K_SIGMA2, tol=1e-3, max_iter=300, max_batch=3) as plain_ssrv:
        t_solve_plain = [wall_s(lambda: plain_ssrv.serve(targets))[1] for _ in range(2)]
    # each target alone through the unsharded solver, as tests/test_shard.py
    # holds them: a shard of the width-4 panel is one column too
    solver = make_solver(hm_k, K_SIGMA2, tol=1e-3, max_iter=300)
    c_want = torch.stack([solver(f[:, j])[0] for j in range(f.shape[1])], dim=1)
    solve_ok = bool(torch.allclose(on_card(souts), c_want, rtol=1e-2, atol=1e-4))
    solve_err = rel_err(on_card(souts), c_want)
    identical = bit_identical(outs, again) and bit_identical(souts, sagain)
    rec["servers"] = {"apply_widths": list(widths), "apply_rel_err": apply_err,
                      "apply_within_rtol_1e-4_atol_1e-5": apply_ok,
                      "apply_serve_s": [t_serve, t_again], "apply_serve_unsharded_s": t_plain,
                      "solve_rel_err": solve_err, "solve_within_rtol_1e-2_atol_1e-4": solve_ok,
                      "solve_iters_per_panel": iters, "solve_serve_s": [t_solve, t_solve_again],
                      "solve_serve_unsharded_s": t_solve_plain,
                      "bit_identical_run_to_run": identical}
    log(f"[mesh] HMatrixServer(K, max_batch=6, row shards), 11 requests, widths {widths}: rel "
        f"err {apply_err:.3e}, within rtol 1e-4 / atol 1e-5 {apply_ok}; serve {t_serve:.4f} / "
        f"{t_again:.4f} s, unsharded server {t_plain[0]:.4f} / {t_plain[1]:.4f} s (wall_s)")
    log(f"[mesh] HMatrixSolveServer(K, max_batch=3 -> 4), 6 targets: rel err {solve_err:.3e}, "
        f"within rtol 1e-2 / atol 1e-4 {solve_ok}; iterations per panel {iters}; serve "
        f"{t_solve:.3f} / {t_solve_again:.3f} s, unsharded server (width 3) "
        f"{t_solve_plain[0]:.3f} / {t_solve_plain[1]:.3f} s (wall_s); two serves "
        f"bit-identical {identical}")
    require(apply_ok, f"mesh server: results off the unsharded apply by {apply_err}")
    require(solve_ok, f"mesh solve server: results off the unsharded solve by {solve_err}")
    require(identical, "mesh servers: two serves are not bit-identical")


def run_mesh(pts_k, hm_p, hm_k, record) -> None:
    """Phase m: P's applies (P mode by columns at R = 8, 5 and the vector,
    by rows at R = 8 and 1, NP mode by rows at R = 1), K's column-sharded solve and the meshed
    servers on K, over four logical shards of card 0 (and over every card
    where there are several)."""
    from repro_torch.core import make_apply
    from repro_torch.parallel import make_sharded_apply
    t_phase = time.perf_counter()
    # phase 9's memory tier may leave a store spilled; a sharded executor
    # captures the store when it is made, and refuses a spilled one
    reloaded = {name: hm.factors.reload() for name, hm in (("P", hm_p), ("K", hm_k))}
    gen = np.random.RandomState(SEED + 21)
    hm_np = dataclasses.replace(hm_p, factors=None)         # the same plan, NP mode
    plain_p, plain_np = make_apply(hm_p), make_apply(hm_np)
    out = record.setdefault("mesh", {})
    out["stores_reloaded_bytes"] = reloaded
    log(f"[mesh] factor bytes reloaded after phase 9 {reloaded}")
    for label, mesh in mesh_meshes():
        rec = out.setdefault(label, {"devices": [str(d) for d in mesh.devices]})
        log(f"[mesh] mesh {label}: {len(mesh.devices)} shards on {rec['devices']}")
        cols = make_sharded_apply(hm_p, mesh, shard="columns")
        rows = make_sharded_apply(hm_p, mesh, shard="rows")
        for r in (8, 5):
            x = randn((hm_p.tree.n, r), gen)
            mesh_apply_check(f"P columns R={r}", cols, plain_p, x, rec)
            if r == 8:
                mesh_apply_check("P rows R=8", rows, plain_p, x, rec)
        x1 = randn((hm_p.tree.n, 1), gen)
        mesh_apply_check("P columns vector", cols, plain_p, x1[:, 0].contiguous(), rec)
        mesh_apply_check("P rows R=1", rows, plain_p, x1, rec)
        mesh_apply_check("P NP rows R=1", make_sharded_apply(hm_np, mesh, shard="rows"),
                         plain_np, x1, rec)
        del cols, rows
        torch.cuda.empty_cache()
        mesh_solve_k(pts_k, hm_k, mesh, rec)
        mesh_servers_k(pts_k, hm_k, mesh, rec)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase m wall {out['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase p: the parallel and tooling layer
# ---------------------------------------------------------------------------

PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 8, 4, 4, 4096
PIPE_DEV = "cuda"      # a CPU rehearsal of the phase's control flow sets "cpu"


def dryrun_cells() -> list:
    """The dry run's cells in phase p: every admitted prefill and decode
    cell and qwen2.5-14b-hmatrix's train cell (the other train cells take
    the CLI: their traces run minutes on the host, ``PERF.md``)."""
    from repro_torch.configs.registry import iter_cells
    return ([(arch.name, shape.name) for arch, shape, runs, _ in iter_cells()
             if runs and shape.kind != "train"] + [(LM_ARCH, "train_4k")])


def dryrun_sweep(cells: list) -> tuple:
    """``(records, seconds)`` of the dry run over ``cells`` on both production
    meshes; the body of the worker process that phase p reads."""
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)           # fake tensors compute nothing
    t0 = time.perf_counter()
    recs = dryrun.run(cells, (False, True), save=False, log=lambda _msg: None)
    return recs, time.perf_counter() - t0


def start_dryrun_sweep():
    """The dry-run sweep in one worker process (spawn: the parent holds a
    CUDA context and threads); returns (pool, pending result)."""
    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, pool.apply_async(dryrun_sweep, (dryrun_cells(),))


def pipeline_devices() -> tuple:
    n = torch.cuda.device_count() if PIPE_DEV == "cuda" else 1
    if n >= PIPE_STAGES:
        return tuple(torch.device("cuda", i) for i in range(PIPE_STAGES))
    return (torch.device(PIPE_DEV, 0) if PIPE_DEV == "cuda" else torch.device("cpu"),) \
        * PIPE_STAGES


def pipeline_stage_fn(cfg):
    """A stage: its blocks in order, train mode, no caches."""
    from repro_torch.models import lm

    def run(blocks, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for block in blocks:
            x, _ = lm.apply_block(block, cfg, "dense", x, mode="train", cache=None,
                                  cache_len=None, positions=positions)
        return x
    return run


def run_pipeline(record, count, sweep) -> None:
    """Phase p (see the module docstring); ``count(key)`` reads and checks
    the kernel counts of the main path, the pipeline; ``sweep`` is the
    pending result of ``start_dryrun_sweep``."""
    from repro_torch import _build
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models import lm
    from repro_torch.models.moe import moe_parallel_mode
    from repro_torch.parallel.mesh_ctx import PanelMesh, constrain, current_mesh, use_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    t_phase = time.perf_counter()
    out = record.setdefault("pipeline", {})
    cfg = get_arch(LM_ARCH).replace(n_layers=PIPE_LAYERS)
    require(set(cfg.layer_kinds) == {"dense"}, f"pipeline: {LM_ARCH} has other kinds")
    gen = torch.Generator(device=PIPE_DEV).manual_seed(SEED + 26)
    params, t_init = wall_s(lambda: lm.init_params(gen, cfg))
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, PIPE_SEQ), generator=gen,
                           device=PIPE_DEV)
    stage_fn = pipeline_stage_fn(cfg)
    per = PIPE_LAYERS // PIPE_STAGES
    stages = [params.layers[i * per:(i + 1) * per] for i in range(PIPE_STAGES)]
    devices = pipeline_devices()
    mesh = PanelMesh(devices, ("stage",))
    # the weights, and whatever earlier phases left allocated
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        xs = lm.embed_tokens(params.embed, tokens)              # (micro, 1, S, D)

        def sequential():
            return torch.stack([stage_fn(params.layers, x) for x in xs])

        def pipelined():
            with use_mesh(mesh):
                return pipeline_apply(stages, xs, axis="stage", n_stages=PIPE_STAGES,
                                      stage_fn=stage_fn)

        want = sequential()
        seq_ms = stream_ms(sequential, reps=2, warmup=0)
        _build.reset_launches()
        got, pipe_s = wall_s(pipelined)       # puts each stage on its device
        count("pipeline")
        nearfield = _build.LAUNCHES["hattention_nearfield"]
        require(nearfield == PIPE_LAYERS * PIPE_MICRO,
                f"pipeline: #11 launched {nearfield} times, not {PIPE_LAYERS * PIPE_MICRO}")
        same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        finite = bool(torch.isfinite(got).all())
        pipe_ms = stream_ms(pipelined, reps=2, warmup=0)
        for stage in stages:                  # back on one device (a no-op on one card)
            stage.to(devices[0])
        seq_ms_2 = stream_ms(sequential, reps=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = smi("name,power.limit")
    out.update(arch=LM_ARCH, layers=PIPE_LAYERS, stages=PIPE_STAGES, microbatches=PIPE_MICRO,
               seq=PIPE_SEQ, devices=[str(d) for d in devices], init_s=t_init,
               first_pipeline_s=pipe_s, nearfield_launches=nearfield, bit_identical=same,
               finite=finite, sequential_ms=[seq_ms, seq_ms_2], pipeline_ms=pipe_ms,
               peak_memory_gib=peak, allocated_before_forward_gib=base, card=card)
    log(f"[pipeline] {LM_ARCH} at {PIPE_LAYERS} layers in {PIPE_STAGES} stages on "
        f"{out['devices']}, {PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}: #11 launched "
        f"{nearfield} times; bit-identical to the sequential stack {same}; pipeline "
        f"{pipe_ms:.2f} ms, sequential {seq_ms:.2f} / {seq_ms_2:.2f} ms (first pipeline call "
        f"{pipe_s:.2f} s); peak {peak:.2f} GiB ({base:.2f} GiB allocated before the forward "
        f"passes, weights included); {card}")
    require(same and finite, "pipeline: the output is not the sequential stack's bits")
    del params, stages, xs, got, want
    torch.cuda.empty_cache()

    # the mesh calls
    debug = make_debug_mesh(2, 2, device=PIPE_DEV)
    x = torch.ones(4, 8, 16, device=PIPE_DEV)
    with use_mesh(debug):
        require(current_mesh() is debug, "pipeline: use_mesh did not activate the mesh")
        require(constrain(x, ("pod", "data"), None, "model") is x,
                "pipeline: constrain did not return its input")
    require(current_mesh() is None, "pipeline: the mesh outlived its use_mesh block")
    with use_mesh(make_production_mesh()):
        modes = {name: moe_parallel_mode(get_arch(name))
                 for name in ("mixtral-8x7b", "granite-moe-1b-a400m")}
    require(modes == {"mixtral-8x7b": "tp", "granite-moe-1b-a400m": "ep"},
            f"pipeline: moe_parallel_mode at tp = 16: {modes}")
    out["moe_parallel_mode_tp16"] = modes
    log(f"[pipeline] use_mesh on {debug.shape} of {debug.devices[0]}, constrain returns its "
        f"input; moe_parallel_mode at tp = 16: {modes}")

    # the dry run
    cells = dryrun_cells()
    t0 = time.perf_counter()
    recs, sweep_s = sweep.get(timeout=900)
    waited_s = time.perf_counter() - t0
    for r in recs:
        log(f"[dryrun] {r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
            f"{dryrun.status_line(r)}")
    bad = [(r["arch"], r["shape"], r["mesh"]) for r in recs if "error" in r or r.get("skipped")]
    require(not bad, f"dryrun: cells failed or were skipped: {bad}")
    require(len(recs) == 2 * len(cells), f"dryrun: {len(recs)} records for {len(cells)} cells")
    require(all(math.isfinite(r["roofline"]["step_time_s"]) and r["traced"]["dot_flops"] > 0
                for r in recs), "dryrun: a non-finite or empty count")
    out["dryrun"] = {"cells": len(cells), "sweep_s": sweep_s, "waited_s": waited_s,
                     "records": recs, "torch": torch.__version__}
    log(f"[dryrun] {len(cells)} cells x 2 meshes in {sweep_s:.1f} s on one host core (torch "
        f"{torch.__version__}; phase p waited {waited_s:.1f} s for it); {card}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[pipeline] phase p wall {out['phase_s']:.1f} s")


def main(record: dict) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="0123456789fmptgd",
                        help="phases to run (default all: 0123456789fmptgd); 0 is always run")
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
    sweep_pool = sweep = None
    if "p" in args.phases:
        sweep_pool, sweep = start_dryrun_sweep()
    try:
        return run_phases(args, record, card, info, sweep)
    finally:
        if sweep_pool is not None:
            sweep_pool.terminate()
            sweep_pool.join()


def run_phases(args, record: dict, card: str, info: dict, sweep) -> int:
    """Every phase after the build (see the module docstring)."""
    from repro_torch import _build
    log(f"[0] kernels built in {info['seconds']:.1f} s into {info['dir']}")
    for name, rep in info["ptxas"].items():
        for line in rep.splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
                log(f"[0] ptxas {name}: {line.strip()}")
    record.update(card=card, torch=torch.__version__, build_s=info["seconds"])
    rng = np.random.RandomState(SEED)

    pts_p = pts_k = hm_p = hm_k = None
    if set(args.phases) & set("1239md"):
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
        check_nearfield_bwd(record["kernels"])
        for name, rec in record["kernels"].items():
            log(f"[1] {name}: max abs err {rec['max_abs_err']:.3e}, kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, library {rec['library_ms']}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); {rec['timed_shape']}; {card}")
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
        log_cholesky_morton(record["kernels"], card)
        dense = record["kernels"]["batched_kernel_matmat"]
        for name, w in dense["whole_dense_group"].items():
            log(f"[1] batched_kernel_matmat on all {w['blocks']} dense leaves of {name} (C="
                f"{w['C']}, R=8): level entry {w['level_ms']:.3f} ms, gathered entry "
                f"{w['gathered_ms']:.3f} ms, bound {w['bound_ms']:.3f} ms (operations); equal "
                f"bit for bit {w['level_equals_gathered']}")
        for name, w in dense["wide"].items():
            log(f"[1] batched_kernel_matmat at R={w['R']} (wide route), {name} ({w['kernel']}, "
                f"d={w['d']}): {w['timed_shape']} {w['ms']:.3f} ms (bound {w['bound_ms']:.3f}, "
                f"rel err {w['rel_err']:.2e}); all {w['leaves']} dense leaves "
                f"{w['all_leaves_ms']:.3f} ms (bound {w['all_leaves_bound_ms']:.3f}); "
                f"ptxas {w['resources']}")
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
        record["P"]["setup_split"] = setup_split(hm_p)
        log_setup_split("P", record["P"]["setup_split"], card)
        torch.cuda.empty_cache()
        record["P"]["apply_split"] = apply_split(hm_p, rng)
        log_apply_split("P", record["P"]["apply_split"])
    torch.cuda.empty_cache()
    if "3" in args.phases:
        _build.reset_launches()
        f, c_kern, iters_kern = run_problem_k(pts_k, hm_k, record)
        count_launches("K")
        record["K"]["setup_split"] = setup_split(hm_k)
        log_setup_split("K", record["K"]["setup_split"], card)
        record["K"]["apply_split"] = apply_split(hm_k, rng)
        log_apply_split("K", record["K"]["apply_split"])
        allowed = run_problem_k_plain(hm_k, f, c_kern, iters_kern, record)
    if "9" in args.phases:
        # serving runs here, on the H-matrices of setup, before they are freed
        _build.reset_launches()
        run_serving(pts_p, pts_k, hm_p, hm_k, record)
        count_launches("serve")
    if "d" in args.phases:
        t_phase_d = time.perf_counter()
        # device discipline on K of setup, then the examples, each counted
        torch.cuda.empty_cache()
        _build.reset_launches()
        run_discipline(pts_k, hm_k, record)
        count_launches("discipline")
        for key, module in EXAMPLES:
            _build.reset_launches()
            run_example(key, module, record)
            count_launches(key)
        record["discipline"]["phase_s"] = time.perf_counter() - t_phase_d
        log(f"[discipline] phase d wall {record['discipline']['phase_s']:.1f} s; {card}")
    if "m" in args.phases:
        # the sharded executors, on the H-matrices of setup too
        torch.cuda.empty_cache()
        _build.reset_launches()
        run_mesh(pts_k, hm_p, hm_k, record)
        count_launches("mesh")
    del hm_p, hm_k
    torch.cuda.empty_cache()
    if "p" in args.phases:
        # the parallel and tooling layer, after phase m
        run_pipeline(record, count_launches, sweep)
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
    if set(args.phases) & set("8ftg"):
        pts_p = pts_k = None
        torch.cuda.empty_cache()
    if "8" in args.phases:
        _build.reset_launches()
        lm_state = run_lm_serve(record)
        count_launches("lm_serve")
        run_lm_checks(lm_state, record)
        del lm_state
        torch.cuda.empty_cache()
    if "f" in args.phases:
        _build.reset_launches()
        run_families(record)
        count_launches("families")
        torch.cuda.empty_cache()
    if "t" in args.phases:
        for layers in (TRAIN_LAYERS, TRAIN_LAYERS_CUT):
            _build.reset_launches()
            train_state = run_train(layers, record)
            count_launches("train")
            check_train_launches(train_state)
            peak = train_state["rec"]["peak_memory_gib"]
            if peak <= TRAIN_PEAK_LIMIT_GIB:
                break
            log(f"[train] peak {peak:.2f} GiB at {layers} layers passes "
                f"{TRAIN_PEAK_LIMIT_GIB} GiB: the depth is cut to {TRAIN_LAYERS_CUT}")
            del train_state
            torch.cuda.empty_cache()
        record["train"]["layers"] = layers
        run_train_checks(train_state, record)
        del train_state
        torch.cuda.empty_cache()
    if "g" in args.phases:
        def count_families_train() -> None:
            count_launches("families_train")
            launched = {name: n for name, n in _build.LAUNCHES.items() if n}
            require(not launched, f"families_train: kernels launched on a path with none: "
                    f"{launched}")
        gc.collect()
        torch.cuda.empty_cache()
        run_families_train(record, count_families_train)
    if set("2345678t") <= set(args.phases):
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
        if "wide" in rec:
            # the route every served panel wider than 8 columns takes
            kernels_line[-1]["wide"] = {
                shape: {k: w[k] for k in ("timed_shape", "ms", "bound_ms", "max_abs_err",
                                          "all_leaves_ms", "all_leaves_bound_ms")}
                for shape, w in rec["wide"].items()}
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
