#!/usr/bin/env python3
"""Hold this checkout's batched ACA (#3), dense-leaf product (#2), low-rank
apply (#4), block Cholesky (#5), block-Jacobi solve (#6), Morton encode
(#7), recompression (#8), H-attention near field (#11) and its backward
(#11b) against an earlier checkout's, on the card: bits, ranks or values,
and times.

    python3 scripts/compare_parent_kernels.py PARENT_DIR \
        [--kernels 2,3,4,5,6,7,8,11,11b] [--end-to-end] [--train-grads]

PARENT_DIR is another checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``).  The
picked kernels' sources among its ``src/repro_torch/csrc/aca.cu``,
``dense_matmat.cu``, ``lowrank_matmat.cu``, ``block_cholesky.cu``,
``block_cholesky_solve.cu``, ``morton.cu``, ``recompress.cu``,
``hattention_nearfield.cu`` and ``hattention_nearfield_bwd.cu`` are built with nvcc into
``build/parent_kernels/`` and called through their own C entries
(``repro_batched_aca`` with a ``(B, m)`` residual scratch and no route;
``repro_dense_matmat`` on gathered blocks; ``repro_lowrank_matmat`` on
gathered blocks with its split scratch; ``repro_block_cholesky`` with a
``(B, c)`` scratch; ``repro_block_cholesky_solve``, ``repro_morton_encode``,
``repro_batched_recompress`` and ``repro_hattention_nearfield``, whose
signatures are this checkout's; ``repro_hattention_nearfield_bwd`` without
this checkout's ``stash``).
``--kernels`` picks the kernels compared (default all nine).  On problems P
(N = 2^20, c_leaf = 2048) and K (N = 2^15 x 32, c_leaf = 256):

* #3, every level group: U, V and the pivot keys of up to 8 sampled blocks
  from the parent's kernel and from this checkout's, on the picked route
  and on each route forced, must be equal bit for bit; then each group of
  P is timed whole, parent and this checkout in turns (parent, new, new,
  parent), with the picked route and the other route where it fits, and
  every group of P and K on each route and cluster size that fits;
* #2, all dense leaves of P and of K at R = 8 and at R = 32 and 64 (the
  kernel's wide route): the parent's gathered launch, this
  checkout's gathered launch and its level entry (reading the tree-ordered
  points and panel in place), timed in turns; the level entry must equal
  the gathered entry bit for bit and both must lie within 1e-5 (relative)
  of the parent's (whether they equal it bit for bit is recorded); the SM
  clock is sampled (``nvidia-smi``) while P's
  leaves are timed, and the SASS of this checkout's kernel
  (``cuobjdump -sass``) gives the instructions it issues per block entry:
  the length of its innermost loop over the MUFU.EX2 (one exp per entry)
  in it (for the wide route, the phi loop's);
* #8, parent and this checkout in turns, on P's 7 factor-store groups at
  tol 1e-2 (as the memory tier runs them), on one (2048, 256, 64) batch
  with half its blocks zero (H-LU's typical re-truncation) and on the wide
  (8192, 256, 64) check, both with a geometric sigma decay at tol 1e-3:
  the ranks must be the parent's on every block away from the cut (no
  singular value within 5% of tol x sigma_0, from a float64 QR + SVD);
* #11, parent and this checkout in turns, at both ``NEARFIELD_SHAPES`` of
  ``chip_smoke.py`` on random q, k, v: m within 1e-5 of the parent's, num
  and den within 1e-4 (relative);
* #11b, parent and this checkout in turns, at the training shape (40, 8,
  512, 128) and the serving shape of ``chip_smoke.NEARFIELD_BWD_SHAPES``,
  from this checkout's #11 outputs on random q, k, v and cotangents: dq,
  dk and dv within 1e-5 (relative) of the parent's;
* #4, every level group of P and K at R = 8 (the factors of a P-mode
  build): the parent's route (gather the X slices, the parent's kernel,
  ``_scatter_rows``) against this checkout's level entry, within 1e-5
  (relative, on what the group adds to Z), timed in turns, and the
  parent's gathered kernel against this checkout's gathered entry;
* #6 on all 512 shifted diagonal blocks of P (c = 2048) and all 128 of K
  (c = 256), R = 8: within 1e-4 (relative) of the parent's, timed in turns;
* #5 on the shifted diagonal blocks (sigma2 = 1e-2) of P, 32 and all 512,
  all 128 of K's and K's first alone (B = 1, as H-LU's FACTOR runs it):
  the blocks with a clamped pivot (a diagonal entry of L at or below
  1e-15, or not finite) must be the same set in this checkout's kernel,
  its plain version and the parent's kernel; on the other blocks L must
  lie within 1e-4 (relative) of the parent's and of the plain version's,
  and two calls must give the same bits; the parent's distance to the
  plain version, and each of the three factors' distance to the float64
  factor of the same blocks (``torch.linalg.cholesky``) are recorded; both C entries timed in turns,
  beside this checkout's wrapper and ``torch.linalg.cholesky`` at the same
  shape (not at P's 512);
* #7 on P's 2^20 points scaled to the unit box: the codes of the parent's
  kernel bit for bit, both C entries timed in turns, beside the wrapper;
* with ``--end-to-end``, each in its own process on the parent's package
  and on this checkout's, in turns: for #4 and #6, P's apply of an (N, 8)
  panel and of a vector, its PCG iteration (10 iterations after a first
  solve), the apply of its store recompressed at tol 1e-2, its NP-mode
  apply, and K's block-Jacobi solve (seconds and iterations); for #8 and
  #11, K's H-LU setup (a timed ``factorize_hlu`` after a first one, with
  #8's share by CUDA events around each re-truncation) and the LM's prefill
  of 2 x 8,192 tokens (qwen2.5-14b-hmatrix, 48 layers, bf16, random
  weights; a timed prefill after a first one); for #11b, cell T's train
  step (``chip_smoke.py`` phase t: 8 layers at full width, 2 x 4,096
  tokens in 2 microbatches with remat, AdamW; two timed steps after a
  first one, #11b's device ms in a third under ``torch.profiler``, and the
  losses of the first three steps again with the near field's plain
  backward);
  for #5 and #7, P's and K's block-Jacobi setup (``make_solver`` after a
  first one), K's block-Jacobi solve (seconds and iterations), K's H-LU
  setup and P's device-build plan stage (``BuildReport.plan_s`` after a
  first build).

With ``--train-grads`` (and #11b picked), parent and this checkout once each
(one process each): cell T's step-0 gradients with the kernel's backward
against those with the near field's plain backward: the worst parameter
tensor's relative error, the whole gradient's, and the share of components
whose sign differs.

Device times are ``chip_smoke.gpu_ms``: CUDA events around calls enqueued
behind a device-side sleep, so that the host's cost per call is hidden
(the wrappers of #5 and #7 are also timed back to back, ``stream_ms``).  Exits non-zero on a
difference.  Writes ``chiprun_out/compare_parent_kernels.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import (NEARFIELD_BWD_SHAPES, NEARFIELD_SHAPES, gpu_ms,  # noqa: E402
                        nearfield_bwd_inputs, stream_ms)
SEED = 0
_OLD_ACA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_RECOMPRESS_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
_NEARFIELD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_NEARFIELD_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_OLD_LOWRANK_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SOLVE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CHOL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_MORTON_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


# the parent's C entries each kernel number needs: source, entry, argtypes
_PARENT_ENTRIES = {
    "3": [("aca", "aca", "repro_batched_aca", _OLD_ACA_ARGTYPES)],
    "2": [("dense", "dense_matmat", "repro_dense_matmat", _DENSE_ARGTYPES)],
    "4": [("lowrank", "lowrank_matmat", "repro_lowrank_matmat", _OLD_LOWRANK_ARGTYPES),
          ("lowrank_splits", "lowrank_matmat", "repro_lowrank_splits", [ctypes.c_int])],
    "5": [("chol", "block_cholesky", "repro_block_cholesky", _CHOL_ARGTYPES)],
    "6": [("solve", "block_cholesky_solve", "repro_block_cholesky_solve", _SOLVE_ARGTYPES)],
    "7": [("morton", "morton", "repro_morton_encode", _MORTON_ARGTYPES)],
    "8": [("recompress", "recompress", "repro_batched_recompress", _RECOMPRESS_ARGTYPES),
          ("splits", "recompress", "repro_recompress_splits", [ctypes.c_int, ctypes.c_int])],
    "11": [("nearfield", "hattention_nearfield", "repro_hattention_nearfield",
            _NEARFIELD_ARGTYPES)],
    "11b": [("nearfield_bwd", "hattention_nearfield_bwd", "repro_hattention_nearfield_bwd",
             _NEARFIELD_BWD_ARGTYPES)],
}


def build_parent(parent: Path, picked: set) -> dict:
    """Build the parent's sources of the picked kernels (one nvcc each, all
    at once) and return their C entries by short name."""
    from repro_torch import _build
    out = ROOT / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "csrc"
    entries = [e for num in sorted(picked) for e in _PARENT_ENTRIES.get(num, [])]
    procs = {src: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                                    str(out / f"lib{src}.so"), str(csrc / f"{src}.cu")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in {e[1] for e in entries}}
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of the parent's {src}.cu failed:\n{log}")
        libs[src] = ctypes.CDLL(str(out / f"lib{src}.so"))
    fns = {}
    for short, src, entry, argtypes in entries:
        fn = getattr(libs[src], entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[short] = fn
    return fns


def parent_aca(fn, points, rid, cid, m, k):
    """The parent's kernel: (U, V, keys (2, k, B)) as ``_aca_launch`` returns them."""
    from repro_torch import _build
    from repro_torch.core.geometry import matern_norm
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.phi import kernel_id
    b, d = rid.shape[0], points.shape[1]
    u = torch.empty((b, m, k), device=points.device)
    v = torch.empty((b, m, k), device=points.device)
    keys = torch.zeros((2, k, b), dtype=torch.int64, device=points.device)
    uhat = torch.empty((b, m), device=points.device)
    err = fn(points.data_ptr(), rid.data_ptr(), points.data_ptr(), cid.data_ptr(), u.data_ptr(),
             v.data_ptr(), uhat.data_ptr(), keys.data_ptr(), b, m, m, points.shape[0] // m,
             points.shape[0] // m, d, k, kernel_id("gaussian"), matern_norm(d),
             stream_handle(points.device))
    _build.check(err, "parent batched_aca")
    return u, v, keys


def in_turns(a, b, reps: int = 3) -> tuple[float, float]:
    """Mean device ms of a and b, timed a, b, b, a."""
    ta1, tb1, tb2, ta2 = gpu_ms(a, reps), gpu_ms(b, reps), gpu_ms(b, reps), gpu_ms(a, reps)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def compare_aca(parent, name, hm, rng, rec) -> bool:
    from repro_torch.kernels.batched_aca.kernel import (RESIDENT_CLUSTERS, _aca_launch,
                                                        aca_route, batched_aca_level_cuda,
                                                        resident_fits, smem_per_block)
    pts, ok = hm.tree.points, True
    limit = smem_per_block(pts.device)
    for level in sorted(hm.plan.aca_levels):
        g = hm.groups[level]
        m = hm.tree.n_pad >> level
        route, cluster = aca_route(m, m, hm.k, pts.shape[1], limit)
        pick = torch.from_numpy(np.sort(rng.choice(g.rows.shape[0], min(8, g.rows.shape[0]),
                                                   replace=False))).cuda()
        rid, cid = g.rows[pick].contiguous(), g.cols[pick].contiguous()
        want = parent_aca(parent["aca"], pts, rid, cid, m, hm.k)
        routes = {"picked": (None, None), "streamed": ("streamed", None)}
        if route == "resident":
            routes["resident"] = ("resident", None)
        equal = {}
        for label, (rt, cs) in routes.items():
            got = _aca_launch(pts, rid, pts, cid, m, m, "gaussian", hm.k, rt, cs)
            equal[label] = all(bool(torch.equal(a, w)) for a, w in zip(got, want))
            ok &= equal[label]
        row = {"B": int(g.rows.shape[0]), "m": m, "route": route, "cluster": cluster,
               "sampled_blocks": int(pick.shape[0]), "equal_to_parent": equal}
        if name == "P":
            def par():
                parent_aca(parent["aca"], pts, g.rows, g.cols, m, hm.k)

            def new():
                batched_aca_level_cuda(pts, g.rows, g.cols, level, "gaussian", hm.k)
            row["parent_ms"], row["ms"] = in_turns(par, new)
            other = "streamed" if route == "resident" else None
            if other:
                row["streamed_ms"] = gpu_ms(lambda: batched_aca_level_cuda(
                    pts, g.rows, g.cols, level, "gaussian", hm.k, route=other))
            torch.cuda.empty_cache()
        # every route and cluster size that fits, timed whole (the picker's record)
        row["sweep_ms"] = {"streamed": gpu_ms(lambda: batched_aca_level_cuda(
            pts, g.rows, g.cols, level, "gaussian", hm.k, route="streamed"))}
        for cs in RESIDENT_CLUSTERS:
            if resident_fits(m, m, hm.k, pts.shape[1], cs, limit):
                row["sweep_ms"][f"resident/{cs}"] = gpu_ms(lambda: batched_aca_level_cuda(
                    pts, g.rows, g.cols, level, "gaussian", hm.k, route="resident", cluster=cs))
        torch.cuda.empty_cache()
        rec[f"{name}/{level}"] = row
        print(f"[#3 {name} level {level}] {row}", flush=True)
    return ok


def sass_per_entry(lib: Path, kernel: str) -> dict:
    """Instructions per block entry of ``kernel``'s innermost loop: of the
    loops (backward branches) with no loop inside, the one that holds the
    most MUFU.EX2, its length over its MUFU.EX2 count."""
    import re
    cuobjdump = Path(_nvcc_dir()) / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass) if kernel in f.split("\n")[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    back = []
    for addr, text in ins:
        target = re.search(r"BRA\s+0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            back.append((int(target.group(1), 16), addr))
    loops = []
    for lo, hi in back:
        if any(lo <= a < b < hi or lo < a < b <= hi for a, b in back if (a, b) != (lo, hi)):
            continue                    # holds another loop
        span = [t for a, t in ins if lo <= a <= hi]
        loops.append((sum("MUFU.EX2" in t for t in span), len(span)))
    exps, length = max(loops)
    return {"loop_instructions": length, "exp_per_loop": exps,
            "instructions_per_entry": length / exps}


def _nvcc_dir() -> str:
    from repro_torch import _build
    return str(Path(_build._nvcc()).parent)


def compare_dense(parent, name, hm, rng, rec) -> bool:
    ok = True
    for r in (8, 32, 64):
        ok &= compare_dense_at(parent, name, hm, rng, rec, r)
        torch.cuda.empty_cache()
    return ok


def compare_dense_at(parent, name, hm, rng, rec, r: int) -> bool:
    from repro_torch.core.geometry import matern_norm
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.batched_dense_matvec.kernel import (
        batched_kernel_matmat_cuda, batched_kernel_matmat_level_cuda)
    from repro_torch.kernels.phi import kernel_id
    c, g = hm.plan.c_leaf, hm.groups["dense"]
    d = hm.tree.points.shape[1]
    x_pad = torch.from_numpy(rng.standard_normal((hm.plan.n_pad, r)).astype(np.float32)).cuda()
    leaf = hm.tree.points.reshape(-1, c, d)
    rows, cols = leaf[g.rows].contiguous(), leaf[g.cols].contiguous()
    x_blk = x_pad.reshape(-1, c, r)[g.cols].contiguous()
    y_par = torch.empty_like(x_blk)

    def par():
        err = parent["dense"](rows.data_ptr(), cols.data_ptr(), x_blk.data_ptr(), y_par.data_ptr(),
                              rows.shape[0], c, d, r, kernel_id("gaussian"), matern_norm(d),
                              stream_handle(rows.device))
        assert err == 0, err

    def level():
        return batched_kernel_matmat_level_cuda(hm.tree.points, g.rows, g.cols, x_pad, c)

    par()
    y_level = level()
    y_gath = batched_kernel_matmat_cuda(rows, cols, x_blk)
    rel = float(torch.linalg.vector_norm((y_level - y_par).double())
                / torch.linalg.vector_norm(y_par.double()))
    same = bool(torch.equal(y_level, y_gath))
    clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                              "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t_par, t_level = in_turns(par, level)
    clock.terminate()
    clocks = [int(v) for v in clock.communicate()[0].split() if v.isdigit()]
    _, t_gath = in_turns(par, lambda: batched_kernel_matmat_cuda(rows, cols, x_blk))
    key = f"dense_{name}" if r == 8 else f"dense_{name}_R{r}"
    rec[key] = {"blocks": int(rows.shape[0]), "C": c, "R": r, "parent_ms": t_par,
                "level_ms": t_level, "gathered_ms": t_gath,
                "level_equals_gathered": same, "rel_err_vs_parent": rel,
                "equal_to_parent": bool(torch.equal(y_level, y_par)),
                "sm_clock_mhz_samples": clocks}
    print(f"[#2 {name} R={r}] {rec[key]}", flush=True)
    return same and rel <= 1e-5


def parent_lowrank(parent, u, v, x):
    """The parent's #4 on gathered blocks: (B, m, R)."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    b, m, k = u.shape
    n, r = v.shape[1], x.shape[2]
    y = torch.empty((b, m, r), device=u.device)
    part = torch.empty((b * parent["lowrank_splits"](n) * k * r,), device=u.device)
    tmat = torch.empty((b * k * r,), device=u.device)
    _build.check(parent["lowrank"](u.data_ptr(), v.data_ptr(), x.data_ptr(), y.data_ptr(),
                                   part.data_ptr(), tmat.data_ptr(), b, m, n, k, r,
                                   stream_handle(u.device)), "parent batched_lowrank_matmat")
    return y


def rel(a, b) -> float:
    """Relative difference of a to b; where b is all zero (K's coarse far
    field underflows to exact zeros), 0 if a is too, else inf."""
    diff = float(torch.linalg.vector_norm((a - b).double()))
    ref = float(torch.linalg.vector_norm(b.double()))
    return diff / ref if ref > 0 else (0.0 if diff == 0 else float("inf"))


def compare_lowrank(parent, name, hm, rng, rec) -> bool:
    """#4 on every level group: the parent's route (gather, its kernel,
    _scatter_rows) against the level entry, and the two gathered kernels,
    timed in turns."""
    from repro_torch.core.hmatrix import _scatter_rows
    from repro_torch.kernels.batched_aca.kernel import (batched_lowrank_matmat_cuda,
                                                        batched_lowrank_matmat_level_cuda)
    n_pad, ok = hm.plan.n_pad, True
    x_pad = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32)).cuda()
    z_pad = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32)).cuda()
    total = {"parent_route_ms": 0.0, "level_ms": 0.0, "parent_ms": 0.0, "gathered_ms": 0.0}
    for level in sorted(hm.factors.keys()):
        u, v = hm.factors[level]
        g = hm.groups[level]
        m = u.shape[1]

        def par_route(z):
            return _scatter_rows(z, parent_lowrank(parent, u, v, x_pad.reshape(-1, m, 8)[g.cols]),
                                 g)

        def level_route(z):
            return batched_lowrank_matmat_level_cuda(u, v, x_pad, g.cols, g, z)
        want = par_route(z_pad.clone()) - z_pad
        got = level_route(z_pad.clone()) - z_pad
        x_blk = x_pad.reshape(-1, m, 8)[g.cols].contiguous()
        row = {"B": int(u.shape[0]), "m": m, "rel_diff_vs_parent": rel(got, want)}
        ok &= row["rel_diff_vs_parent"] <= 1e-5
        z_work = z_pad.clone()
        row["parent_route_ms"], row["level_ms"] = in_turns(lambda: par_route(z_work),
                                                           lambda: level_route(z_work))
        row["parent_ms"], row["gathered_ms"] = in_turns(
            lambda: parent_lowrank(parent, u, v, x_blk),
            lambda: batched_lowrank_matmat_cuda(u, v, x_blk))
        for key in total:
            total[key] += row[key]
        rec[f"lowrank_{name}/{level}"] = row
        print(f"[#4 {name} level {level}] {row}", flush=True)
        del x_blk, z_work, want, got
    rec[f"lowrank_{name}"] = total
    print(f"[#4 {name}, all groups] {total}", flush=True)
    return ok


def compare_solve(parent, name, lmat, gen, rec) -> bool:
    """#6 against the parent's at R = 8: within 1e-4, times in turns."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.batched_block_solve.kernel import batched_block_cholesky_solve_cuda
    b, c = lmat.shape[0], lmat.shape[1]
    x = torch.randn(b, c, 8, generator=gen, device="cuda")
    y_par = torch.empty_like(x)

    def par():
        _build.check(parent["solve"](lmat.data_ptr(), x.data_ptr(), y_par.data_ptr(), b, c, 8,
                                     stream_handle(x.device)), "parent block_cholesky_solve")
    par()
    got = batched_block_cholesky_solve_cuda(lmat, x)
    row = {"B": b, "c": c, "R": 8, "rel_diff_vs_parent": rel(got, y_par)}
    row["parent_ms"], row["ms"] = in_turns(par, lambda: batched_block_cholesky_solve_cuda(lmat, x))
    rec[f"solve_{name}"] = row
    print(f"[#6 {name}] {row}", flush=True)
    return row["rel_diff_vs_parent"] <= 1e-4


def clamped_blocks(lmat: torch.Tensor) -> list:
    """Blocks with a clamped pivot: a diagonal entry of L at or below 1e-15
    (d <= 1e-30 gives L_jj = d rsqrt(1e-30)), or not finite."""
    diag = lmat.diagonal(dim1=1, dim2=2)
    return torch.nonzero(~(diag > 1e-15).all(dim=1)).flatten().tolist()


def rel_kept(x, y, keep, chunk: int = 32) -> float:
    """Relative difference of x to y over the blocks where keep is set, a
    chunk of blocks at a time (P's 512 blocks fill 8 GiB each)."""
    diff = ref = 0.0
    for i0 in range(0, x.shape[0], chunk):
        k = keep[i0:i0 + chunk]
        xs, ys = x[i0:i0 + chunk][k].double(), y[i0:i0 + chunk][k].double()
        diff += float(((xs - ys) ** 2).sum())
        ref += float((ys ** 2).sum())
    return (diff / ref) ** 0.5 if ref > 0 else (0.0 if diff == 0 else float("inf"))


def float64_rel_errs(a, factors: dict, keep, chunk: int = 32) -> dict:
    """Relative distance of each float32 factor to A's float64 Cholesky
    factor, over the blocks where keep is set and the float64 factorisation
    succeeds (their count beside), a chunk of blocks at a time."""
    diff, ref, failed = dict.fromkeys(factors, 0.0), 0.0, 0
    for i0 in range(0, a.shape[0], chunk):
        l64, info = torch.linalg.cholesky_ex(a[i0:i0 + chunk].double())
        failed += int((info != 0).sum())
        k = keep[i0:i0 + chunk] & (info == 0)
        l64 = l64[k]
        ref += float((l64 ** 2).sum())
        for name, lmat in factors.items():
            diff[name] += float(((lmat[i0:i0 + chunk][k].double() - l64) ** 2).sum())
    out = {name: (d / ref) ** 0.5 for name, d in diff.items()}
    out["float64_failed_blocks"] = failed
    return out


def compare_cholesky(parent, label, a, reps, rec) -> bool:
    """#5 against the parent's kernel and the plain version: the same
    clamped blocks, values within 1e-4 on the others, two calls
    bit-identical; the three factors' distances to each other and to the
    float64 factor; times in turns."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.batched_block_solve.kernel import batched_block_cholesky_cuda
    from repro_torch.kernels.batched_block_solve.ref import batched_block_cholesky_ref
    b, c = a.shape[0], a.shape[1]
    l_par = torch.empty_like(a)
    scratch = torch.empty((b, c), device=a.device)

    def par():
        _build.check(parent["chol"](a.data_ptr(), l_par.data_ptr(), scratch.data_ptr(), b, c,
                                    stream_handle(a.device)), "parent block_cholesky")
    par()
    got = batched_block_cholesky_cuda(a)
    same_bits = bool(torch.equal(got, batched_block_cholesky_cuda(a)))
    plain = batched_block_cholesky_ref(a)
    sets = {"kernel": clamped_blocks(got), "plain": clamped_blocks(plain),
            "parent": clamped_blocks(l_par)}
    keep = torch.ones(b, dtype=torch.bool, device=a.device)
    keep[sorted(set(sets["kernel"]) | set(sets["parent"]) | set(sets["plain"]))] = False
    row = {"B": b, "c": c, "clamped_blocks": sets, "two_calls_bit_identical": same_bits,
           "compared_blocks": int(keep.sum()),
           "rel_diff_vs_parent": rel_kept(got, l_par, keep),
           "rel_diff_vs_plain": rel_kept(got, plain, keep),
           "rel_diff_parent_vs_plain": rel_kept(l_par, plain, keep),
           "rel_err_vs_float64": float64_rel_errs(a, {"kernel": got, "parent": l_par,
                                                      "plain": plain}, keep)}
    del plain
    torch.cuda.empty_cache()
    l_new = torch.empty_like(a)
    entry = _build.c_function("block_cholesky", "repro_block_cholesky", _CHOL_ARGTYPES)

    def new():
        _build.check(entry(a.data_ptr(), l_new.data_ptr(), scratch.data_ptr(), b, c,
                           stream_handle(a.device)), "block_cholesky")
    row["parent_ms"], row["ms"] = in_turns(par, new, reps)
    row["wrapper_back_to_back_ms"] = stream_ms(lambda: batched_block_cholesky_cuda(a), reps)
    row["library_ms"] = gpu_ms(lambda: torch.linalg.cholesky(a), reps) if b * c <= 65536 else None
    rec[f"cholesky_{label}"] = row
    print(f"[#5 {label}] {row}", flush=True)
    return (same_bits and sets["kernel"] == sets["plain"] == sets["parent"]
            and row["rel_diff_vs_parent"] <= 1e-4 and row["rel_diff_vs_plain"] <= 1e-4)


def compare_morton(parent, pts, rec) -> bool:
    """#7 on P's points in the unit box: the parent's codes bit for bit."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.morton.kernel import morton_encode_cuda
    lo, hi = pts.amin(dim=0), pts.amax(dim=0)
    unit = ((pts - lo) / torch.clamp(hi - lo, min=1e-30)).contiguous()
    n, d = unit.shape
    codes_par = torch.empty(n, dtype=torch.int64, device=pts.device)

    def par():
        _build.check(parent["morton"](unit.data_ptr(), codes_par.data_ptr(), n, d,
                                      stream_handle(pts.device)), "parent morton_encode")
    codes_new = torch.empty_like(codes_par)
    entry = _build.c_function("morton", "repro_morton_encode", _MORTON_ARGTYPES)

    def new():
        _build.check(entry(unit.data_ptr(), codes_new.data_ptr(), n, d,
                           stream_handle(pts.device)), "morton_encode")
    par()
    equal = bool(torch.equal(morton_encode_cuda(unit), codes_par))
    row = {"N": n, "d": d, "codes_equal_to_parent": equal}
    row["parent_ms"], row["ms"] = in_turns(par, new, 50)
    row["wrapper_back_to_back_ms"] = stream_ms(lambda: morton_encode_cuda(unit), 50)
    rec["morton_P"] = row
    print(f"[#7 P] {row}", flush=True)
    return equal


def parent_recompress(parent, u, v, tol):
    """The parent's #8 through its C entry: (u2, v2, s, ranks, sweeps)."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    b, m, k = u.shape
    n, dev = v.shape[1], u.device
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    s = torch.empty((b, k), device=dev)
    ranks = torch.empty((b,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    part = torch.empty((2 * b * parent["splits"](m, n) * k * k,), device=dev)
    tmat = torch.empty((2 * b * k * k,), device=dev)
    err = parent["recompress"](u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
                               s.data_ptr(), ranks.data_ptr(), sweeps.data_ptr(),
                               part.data_ptr(), tmat.data_ptr(), b, m, n, k, float(tol),
                               stream_handle(dev))
    _build.check(err, "parent batched_recompress")
    return u2, v2, s, ranks, sweeps


def near_cut(u, v, tol: float, margin: float = 0.05, chunk: int = 256) -> torch.Tensor:
    """Blocks with a singular value of U V^T within ``margin`` (relative) of
    tol x sigma_0, from a float64 QR + SVD: their rank may fall either way."""
    out = []
    for b0 in range(0, u.shape[0], chunk):
        _, ru = torch.linalg.qr(u[b0:b0 + chunk].double())
        _, rv = torch.linalg.qr(v[b0:b0 + chunk].double())
        s = torch.linalg.svdvals(ru @ rv.transpose(1, 2))
        rel = s / s[:, :1].clamp_min(1e-300)
        out.append(((rel > tol / (1 + margin)) & (rel < tol * (1 + margin))).any(dim=1))
    return torch.cat(out)


def compare_recompress(parent, label, u, v, tol, rec) -> bool:
    """#8 against the parent's on one batch: ranks away from the cut, times
    in turns."""
    from repro_torch.kernels.batched_recompress.kernel import batched_recompress_cuda
    _, _, _, r_par, sw_par = parent_recompress(parent, u, v, tol)
    _, _, _, r_new, sw_new = batched_recompress_cuda(u, v, tol)
    cut = near_cut(u, v, tol)
    same = r_par == r_new
    t_par, t_new = in_turns(lambda: parent_recompress(parent, u, v, tol),
                            lambda: batched_recompress_cuda(u, v, tol))
    zero = (u.abs().amax(dim=(1, 2)) == 0) | (v.abs().amax(dim=(1, 2)) == 0)
    row = {"B": int(u.shape[0]), "m": int(u.shape[1]), "k": int(u.shape[2]), "tol": tol,
           "zero_blocks": int(zero.sum()), "near_cut": int(cut.sum()),
           "other_rank_away_from_cut": int((~same & ~cut).sum()),
           "other_rank_near_cut": int((~same & cut).sum()),
           "sweeps_mean_parent": float(sw_par.double().mean()),
           "sweeps_mean": float(sw_new.double().mean()), "parent_ms": t_par, "ms": t_new}
    rec[f"recompress_{label}"] = row
    print(f"[#8 {label}] {row}", flush=True)
    return row["other_rank_away_from_cut"] == 0


def decaying(b: int, m: int, k: int, gen) -> tuple:
    scale = 0.35 ** torch.arange(k, device="cuda", dtype=torch.float32)
    return (torch.randn(b, m, k, device="cuda", generator=gen) * scale,
            torch.randn(b, m, k, device="cuda", generator=gen))


def compare_nearfield(parent, label, shape, gen, rec) -> bool:
    """#11 against the parent's on random q, k, v: m within 1e-5, num and den
    within 1e-4 (relative), times in turns."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.hattention_block.kernel import hattention_nearfield_cuda
    bh, nl, c, d = shape
    q = torch.randn(bh, nl, c, d, generator=gen, device="cuda") / d ** 0.5
    k = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
    v = torch.randn(bh, nl, c, d, generator=gen, device="cuda")
    num, den, m = torch.empty_like(q), q.new_empty((bh, nl, c)), q.new_empty((bh, nl, c))

    def par():
        _build.check(parent["nearfield"](q.data_ptr(), k.data_ptr(), v.data_ptr(), num.data_ptr(),
                                         den.data_ptr(), m.data_ptr(), bh, nl, c, d,
                                         stream_handle(q.device)), "parent hattention_nearfield")

    par()
    got = hattention_nearfield_cuda(q, k, v)

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))
    row = {"shape": list(shape), "m_max_abs_diff": float((got[2] - m).abs().max()),
           "num_rel_diff": rel(got[0], num), "den_rel_diff": rel(got[1], den)}
    row["parent_ms"], row["ms"] = in_turns(par, lambda: hattention_nearfield_cuda(q, k, v))
    rec[f"nearfield_{label}"] = row
    print(f"[#11 {label}] {row}", flush=True)
    return (row["m_max_abs_diff"] <= 1e-5 and row["num_rel_diff"] <= 1e-4
            and row["den_rel_diff"] <= 1e-4)


def compare_nearfield_bwd(parent, label, shape, gen, rec) -> bool:
    """#11b against the parent's, from this checkout's #11 outputs on random
    q, k, v and cotangents: dq, dk, dv within 1e-5 (relative), times in turns."""
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.hattention_block.kernel import (hattention_nearfield_bwd_cuda,
                                                             hattention_nearfield_cuda)
    bh, nl, c, d = shape
    q, k, v, gnum, gden, gm = nearfield_bwd_inputs(shape, gen)
    num, den, m = hattention_nearfield_cuda(q, k, v)
    outs = [torch.empty_like(q) for _ in range(3)]
    scratch = q.new_empty((3, bh, nl, c))
    ties = torch.empty((bh, nl, c), dtype=torch.int32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, num, den, m, gnum, gden, gm, *outs, scratch, ties)]

    def par():
        _build.check(parent["nearfield_bwd"](*ptrs, bh, nl, c, d, stream_handle(q.device)),
                     "parent hattention_nearfield_bwd")

    def new():
        return hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm)

    par()
    got = new()
    row = {"shape": list(shape)}
    for name, a, b in zip(("dq", "dk", "dv"), got, outs):
        row[f"{name}_rel_diff"] = rel(a, b)
    row["parent_ms"], row["ms"] = in_turns(par, new)
    rec[f"nearfield_bwd_{label}"] = row
    print(f"[#11b {label}] {row}", flush=True)
    return all(row[f"{name}_rel_diff"] <= 1e-5 for name in ("dq", "dk", "dv"))


# One process's end-to-end measurement, run with PYTHONPATH at one
# checkout's src/ and that checkout as the working directory (its kernels
# build under its own build/): prints one JSON line.  For #4 and #6: P's
# applies and PCG iteration, K's block-Jacobi solve.
_APPLY_PCG = r"""
import dataclasses, json, time, torch
from repro_torch.core import (FactorStore, build_hmatrix, build_hmatrix_device, halton,
                              make_apply, recompress_store, sinusoid_targets)
from repro_torch.solve import make_solver

def wall(fn):
    torch.cuda.synchronize(); t0 = time.perf_counter(); out = fn(); torch.cuda.synchronize()
    return out, time.perf_counter() - t0

def ms(fn, reps=3):
    fn(); torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record(); torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

gen = torch.Generator(device="cuda").manual_seed(0)
pts = halton(1 << 20, 2, device="cuda")
hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=2048, eta=1.5, precompute=True)
apply_h = make_apply(hm)
x = torch.randn(hm.tree.n, 8, device="cuda", generator=gen)
vec = x[:, 0].contiguous()
out = {"apply_ms_R8": ms(lambda: apply_h(x)), "apply_ms_vector": ms(lambda: apply_h(vec))}
solver = make_solver(hm, 1e-2, tol=0.0, max_iter=10)
solver(x)
_, secs = wall(lambda: solver(x))
out["pcg_ms_per_iteration"] = secs * 100.0
store = FactorStore(dict(hm.factors.levels), dict(hm.factors.rank_tables))
recompress_store(store, 1e-2)
apply_t = make_apply(dataclasses.replace(hm, factors=store))
out["recompressed_apply_ms_R8"] = ms(lambda: apply_t(x))
del hm, apply_h, solver, store, apply_t
torch.cuda.empty_cache()
apply_np = make_apply(build_hmatrix_device(pts, kernel="gaussian", k=16, c_leaf=2048, eta=1.5))
out["np_apply_ms_R8"] = ms(lambda: apply_np(x), 2)
del apply_np
torch.cuda.empty_cache()
pk = halton(1 << 15, 2, device="cuda") * 32.0
hk = build_hmatrix(pk, "gaussian", k=16, c_leaf=256, eta=1.5, precompute=True)
f = sinusoid_targets(pk, 8, 32.0)
solver = make_solver(hk, 1e-2, tol=1e-3, max_iter=300)
solver(f)
(_, info), out["K_solve_s"] = wall(lambda: solver(f))
out["K_iters_per_column"] = info.iters_per_column.tolist()
print(json.dumps(out))
"""

# For #8 and #11: K's H-LU setup and the LM's prefill.
_HLU_PREFILL = r"""
import json, time, torch
from repro_torch.core import build_hmatrix, halton
from repro_torch.harith import factorize_hlu, hlu

def wall(fn):
    torch.cuda.synchronize(); t0 = time.perf_counter(); out = fn(); torch.cuda.synchronize()
    return out, time.perf_counter() - t0

hm = build_hmatrix(halton(1 << 15, 2, device="cuda") * 32.0, "gaussian", k=16, c_leaf=256,
                   eta=1.5, precompute=True)
factorize_hlu(hm, 1e-2, tol=1e-3)
events = []
orig = hlu._kernels

def timed(use_kernels):
    fns = orig(use_kernels)

    def retruncate(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(); out = fns[3](*args); end.record()
        events.append((start, end))
        return out
    return fns[:3] + (retruncate,)

hlu._kernels = timed
_, setup_s = wall(lambda: factorize_hlu(hm, 1e-2, tol=1e-3))
hlu._kernels = orig
recompress_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
del hm
torch.cuda.empty_cache()
from repro_torch.configs.registry import get_arch
from repro_torch.models.api import get_model
from repro_torch.serve.step import make_prefill_step
cfg = get_arch("qwen2.5-14b-hmatrix")
gen = torch.Generator(device="cuda").manual_seed(0)
params = get_model(cfg)["init_params"](gen)
prompts = torch.randint(0, cfg.vocab_size, (2, 8192), generator=gen, device="cuda")
prefill = make_prefill_step(cfg)
wall(lambda: prefill(params, prompts))
_, prefill_s = wall(lambda: prefill(params, prompts))
print(json.dumps({"hlu_setup_s": setup_s, "hlu_recompress_s": recompress_s,
                  "hlu_recompress_calls": len(events), "prefill_s": prefill_s}))
"""


# For #5 and #7: the block-Jacobi setups, K's solve, K's H-LU setup and P's
# device-build plan stage.
_SETUP = r"""
import json, time, torch
from repro_torch.core import (build_hmatrix, build_hmatrix_device_report, halton,
                              sinusoid_targets)
from repro_torch.harith import factorize_hlu
from repro_torch.solve import make_solver

def wall(fn):
    torch.cuda.synchronize(); t0 = time.perf_counter(); out = fn(); torch.cuda.synchronize()
    return out, time.perf_counter() - t0

out = {}
pts = halton(1 << 20, 2, device="cuda")
build_hmatrix_device_report(pts, kernel="gaussian", k=16, c_leaf=2048, eta=1.5)
torch.cuda.empty_cache()
_, report = build_hmatrix_device_report(pts, kernel="gaussian", k=16, c_leaf=2048, eta=1.5)
out["P_device_plan_s"] = report.plan_s
hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=2048, eta=1.5, precompute=True)
make_solver(hm, 1e-2, tol=0.0, max_iter=10)
torch.cuda.empty_cache()
_, out["P_block_jacobi_setup_s"] = wall(lambda: make_solver(hm, 1e-2, tol=0.0, max_iter=10))
del hm
torch.cuda.empty_cache()
pk = halton(1 << 15, 2, device="cuda") * 32.0
hk = build_hmatrix(pk, "gaussian", k=16, c_leaf=256, eta=1.5, precompute=True)
f = sinusoid_targets(pk, 8, 32.0)
make_solver(hk, 1e-2, tol=1e-3, max_iter=300)
solver, out["K_block_jacobi_setup_s"] = wall(lambda: make_solver(hk, 1e-2, tol=1e-3,
                                                                  max_iter=300))
solver(f)
(_, info), out["K_solve_s"] = wall(lambda: solver(f))
out["K_iters_per_column"] = info.iters_per_column.tolist()
factorize_hlu(hk, 1e-2, tol=1e-3)
_, out["K_hlu_setup_s"] = wall(lambda: factorize_hlu(hk, 1e-2, tol=1e-3))
print(json.dumps(out))
"""


# For #11b: cell T's train step (chip_smoke.py phase t's configuration).
_TRAIN_STEP = r"""
import json, time, torch
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_step

def wall(fn):
    torch.cuda.synchronize(); t0 = time.perf_counter(); out = fn(); torch.cuda.synchronize()
    return out, time.perf_counter() - t0

cfg = get_arch("qwen2.5-14b-hmatrix").replace(n_layers=8)
init_state, train_step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1,
                                                          total_steps=100),
                                         microbatches=2, remat=True, device="cuda")
dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=4096, global_batch=2, seed=0)
batches = [make_batch(dcfg, s, device="cuda") for s in range(4)]
state = init_state(torch.Generator(device="cuda").manual_seed(0))
steps, losses = [], []
for s in range(3):
    (state, metrics), secs = wall(lambda: train_step(state, batches[s]))
    steps.append(secs)
    losses.append(float(metrics["loss"]))
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    state, _ = train_step(state, batches[3])
    torch.cuda.synchronize()
bwd_us = calls = 0
for e in prof.key_averages():
    if any(key in e.key for key in ("dq_kernel", "dkv_kernel", "fix_kernel")):
        bwd_us += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        calls += e.count
# the same steps from the same state with the near field's plain backward:
# where two kernels' losses part, how far the plain derivative's lie from each
del state, prof
torch.cuda.empty_cache()
from repro_torch.kernels.hattention_block import ops
from repro_torch.kernels.hattention_block.ref import hattention_nearfield_bwd_ref
ops.hattention_nearfield_bwd_op = hattention_nearfield_bwd_ref
state = init_state(torch.Generator(device="cuda").manual_seed(0))
plain = []
for s in range(3):
    state, metrics = train_step(state, batches[s])
    plain.append(float(metrics["loss"]))
print(json.dumps({"step_s": steps[1:], "first_step_s": steps[0], "losses": losses,
                  "losses_plain_backward": plain, "nearfield_bwd_profiled_ms": bwd_us / 1e3,
                  "nearfield_bwd_kernel_calls": calls}))
"""


# For #11b: cell T's gradients at step 0 (the first microbatch pair of
# phase t's state and data, 8 layers, bf16) with the kernel's backward and
# with the near field's plain backward, both summed over the 2 microbatches
# in float32 as the train step sums them: the relative error of each
# parameter tensor's gradient, the worst tensor's, the whole gradient's,
# and the share of components whose sign differs (AdamW's first step moves
# each parameter by about lr along the sign of its gradient).  Controls
# take the same readings for the plain backward with each component of its
# dq, dk, dv moved by 2^-21 and by 2^-20 of itself (the sign drawn from a
# seeded generator): what a change at the scale of fp32 rounding (the
# kernels lie 4e-7 to 9e-7 from the plain derivative) does to the
# gradients on its own.
_TRAIN_GRADS = r"""
import json, torch
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.api import get_model
from repro_torch.train.step import make_loss_fn

cfg = get_arch("qwen2.5-14b-hmatrix").replace(n_layers=8)
params = get_model(cfg, "cuda")["init_params"](torch.Generator(device="cuda").manual_seed(0))
batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=4096, global_batch=2, seed=0),
                   0, device="cuda")
loss_fn = make_loss_fn(cfg, remat=True)
names, plist = zip(*params.named_parameters())

def grads():
    acc, losses = None, []
    for i in range(2):
        mb = {key: batch[key][i:i + 1] for key in ("tokens", "labels")}
        loss = loss_fn(params, mb)
        g = torch.autograd.grad(loss, plist)
        if acc is None:
            acc = [x.float() / 2 for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x.float() / 2)
        losses.append(float(loss.detach()))
        del g, loss
    return acc, losses

def apart(g, g_plain):
    rel, flips, total, diff2, ref2 = {}, 0, 0, 0.0, 0.0
    for name, a, b in zip(names, g, g_plain):
        d2, b2 = float(((a - b).double() ** 2).sum()), float((b.double() ** 2).sum())
        rel[name] = (d2 / b2) ** 0.5 if b2 > 0 else float(d2 > 0)
        diff2, ref2 = diff2 + d2, ref2 + b2
        flips += int((torch.sign(a) != torch.sign(b)).sum())
        total += a.numel()
    worst = max(rel, key=rel.get)
    return {"worst_leaf": worst, "worst_leaf_rel_err": rel[worst],
            "whole_gradient_rel_err": (diff2 / ref2) ** 0.5, "sign_differs_share": flips / total,
            "components": total, "rel_err_by_leaf": rel}

from repro_torch.kernels.hattention_block import ops
from repro_torch.kernels.hattention_block.ref import hattention_nearfield_bwd_ref
g_kernel, loss_kernel = grads()
ops.hattention_nearfield_bwd_op = hattention_nearfield_bwd_ref
g_plain, loss_plain = grads()
out = {"losses_kernel": loss_kernel, "losses_plain_backward": loss_plain,
       **apart(g_kernel, g_plain)}
del g_kernel
for e in (21, 20):
    gen = torch.Generator(device="cuda").manual_seed(1)

    def nudged(*args):
        return tuple(x * (1.0 + 2.0 ** -e * (2.0 * torch.randint(0, 2, x.shape, generator=gen,
                                                                  device=x.device) - 1.0))
                     for x in hattention_nearfield_bwd_ref(*args))

    ops.hattention_nearfield_bwd_op = nudged
    g_nudged, _ = grads()
    out[f"control_plain_nudged_2^-{e}"] = apart(g_nudged, g_plain)
    del g_nudged
print(json.dumps(out))
"""


def end_to_end(parent_dir: Path, script: str, key: str, rec,
               turns=("parent", "new", "new", "parent")) -> None:
    """One end-to-end script, parent and this checkout in ``turns`` (by
    default parent, new, new, parent), one process each."""
    import os
    runs = []
    for label in turns:
        root = parent_dir if label == "parent" else ROOT
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                             check=True, capture_output=True, text=True).stdout
        row = json.loads(out.strip().splitlines()[-1])
        row["checkout"] = label
        runs.append(row)
        print(f"[end to end {key} {label}] {row}", flush=True)
    rec[key] = runs


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent_dir")
    parser.add_argument("--kernels", default="2,3,4,5,6,7,8,11,11b")
    parser.add_argument("--end-to-end", action="store_true")
    parser.add_argument("--train-grads", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    picked = set(args.kernels.split(","))
    from repro_torch.core import build_hmatrix, halton
    parent = build_parent(Path(args.parent_dir).resolve(), picked)
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    from repro_torch import _build
    rec = {"card": torch.cuda.get_device_name(0)}
    info = _build.build_all()
    if "2" in picked:
        rec["dense_sass"] = sass_per_entry(Path(info["dir"]) / "libdense_matmat.so",
                                           "dense_matmat_kernelILi2ELi0ELi8E")
        rec["dense_wide_sass"] = sass_per_entry(Path(info["dir"]) / "libdense_matmat.so",
                                                "dense_matmat_kernel_wideILi2ELi0ELi64E")
        print(f"[#2 SASS] {rec['dense_sass']}; wide route's phi loop {rec['dense_wide_sass']}",
              flush=True)
    ok = True
    problems = (("P", 1 << 20, 1.0, 2048), ("K", 1 << 15, 32.0, 256))
    for name, n, scale, c_leaf in problems if picked & {"2", "3", "4", "5", "6", "7", "8"} else ():
        if name == "K" and not picked & {"2", "3", "4", "5", "6"}:
            continue
        pts = halton(n, 2, device="cuda") * scale
        if "7" in picked and name == "P":
            ok &= compare_morton(parent, pts, rec)
        hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=c_leaf, eta=1.5,
                           precompute="4" in picked or ("8" in picked and name == "P"))
        del pts
        if "5" in picked:
            from repro_torch.core import diagonal_blocks
            a = diagonal_blocks(hm)
            a.diagonal(dim1=1, dim2=2).add_(1e-2)
            shapes = ((("32", 32, 3), ("all", a.shape[0], 2)) if name == "P"
                      else (("all", a.shape[0], 20), ("B1", 1, 50)))
            for label, count, reps in shapes:
                ok &= compare_cholesky(parent, f"{name}_{label}", a[:count].contiguous(), reps,
                                       rec)
                torch.cuda.empty_cache()
            del a
            torch.cuda.empty_cache()
        if "4" in picked:
            ok &= compare_lowrank(parent, name, hm, rng, rec)
            torch.cuda.empty_cache()
        if "6" in picked:
            from repro_torch.solve.cg import build_preconditioner
            ok &= compare_solve(parent, name, build_preconditioner(hm, 1e-2), gen, rec)
            torch.cuda.empty_cache()
        if "3" in picked:
            ok &= compare_aca(parent, name, hm, rng, rec)
        if "2" in picked:
            ok &= compare_dense(parent, name, hm, rng, rec)
        if "8" in picked and name == "P":
            par_ms = new_ms = 0.0
            for level in sorted(hm.factors.keys()):
                u, v = hm.factors[level]
                ok &= compare_recompress(parent, f"P_level_{level}", u, v, 1e-2, rec)
                par_ms += rec[f"recompress_P_level_{level}"]["parent_ms"]
                new_ms += rec[f"recompress_P_level_{level}"]["ms"]
                torch.cuda.empty_cache()
            rec["recompress_P_store"] = {"parent_ms": par_ms, "ms": new_ms}
            print(f"[#8 P store, 7 groups] parent {par_ms:.3f} ms, this checkout {new_ms:.3f} ms",
                  flush=True)
        del hm
        torch.cuda.empty_cache()
    if "8" in picked:
        u, v = decaying(2048, 256, 64, gen)
        u[1::2] = 0.0
        ok &= compare_recompress(parent, "hlu_B2048_half_zero", u, v, 1e-3, rec)
        u, v = decaying(8192, 256, 64, gen)
        ok &= compare_recompress(parent, "wide_8192", u, v, 1e-3, rec)
        del u, v
        torch.cuda.empty_cache()
    if "11" in picked:
        for label, shape in NEARFIELD_SHAPES.items():
            ok &= compare_nearfield(parent, label, shape, gen, rec)
            torch.cuda.empty_cache()
    if "11b" in picked:
        for label in ("train", "serve"):
            ok &= compare_nearfield_bwd(parent, label, NEARFIELD_BWD_SHAPES[label], gen, rec)
            torch.cuda.empty_cache()
    if args.end_to_end and picked & {"4", "6"}:
        end_to_end(Path(args.parent_dir).resolve(), _APPLY_PCG, "end_to_end_apply_pcg", rec)
    if args.end_to_end and picked & {"8", "11"}:
        end_to_end(Path(args.parent_dir).resolve(), _HLU_PREFILL, "end_to_end", rec)
    if args.end_to_end and "11b" in picked:
        end_to_end(Path(args.parent_dir).resolve(), _TRAIN_STEP, "end_to_end_train", rec)
    if args.train_grads and "11b" in picked:
        end_to_end(Path(args.parent_dir).resolve(), _TRAIN_GRADS, "train_grads", rec,
                   turns=("parent", "new"))
    if args.end_to_end and picked & {"5", "7"}:
        end_to_end(Path(args.parent_dir).resolve(), _SETUP, "end_to_end_setup", rec)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "compare_parent_kernels.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
