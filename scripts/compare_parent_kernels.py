#!/usr/bin/env python3
"""Hold this checkout's batched ACA (#3) and dense-leaf product (#2) against
an earlier checkout's, on the card: bits and times.

    python3 scripts/compare_parent_kernels.py PARENT_DIR

PARENT_DIR is another checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``).  Its
``src/repro_torch/csrc/aca.cu`` and ``dense_matmat.cu`` are built with nvcc
into ``build/parent_kernels/`` and called through their own C entries
(``repro_batched_aca`` with a ``(B, m)`` residual scratch and no route;
``repro_dense_matmat`` on gathered blocks).  On problems P (N = 2^20,
c_leaf = 2048) and K (N = 2^15 x 32, c_leaf = 256):

* #3, every level group: U, V and the pivot keys of up to 8 sampled blocks
  from the parent's kernel and from this checkout's, on the picked route
  and on each route forced, must be equal bit for bit; then each group of
  P is timed whole, parent and this checkout in turns (parent, new, new,
  parent), with the picked route and the other route where it fits, and
  every group of P and K on each route and cluster size that fits;
* #2, all dense leaves of P and of K at R = 8: the parent's gathered launch, this
  checkout's gathered launch and its level entry (reading the tree-ordered
  points and panel in place), timed in turns; the level entry must equal
  the gathered entry bit for bit and both must lie within 1e-5 (relative)
  of the parent's; the SM clock is sampled (``nvidia-smi``) while P's
  leaves are timed, and the SASS of this checkout's kernel
  (``cuobjdump -sass``) gives the instructions it issues per block entry:
  the length of its innermost loop over the MUFU.EX2 (one exp per entry)
  in it.

Exits non-zero on a difference.  Writes ``chiprun_out/compare_parent_kernels.json``.
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
SEED = 0
_OLD_ACA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def build_parent(parent: Path) -> dict:
    from repro_torch import _build
    out = ROOT / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "csrc"
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                                     str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in ("aca", "dense_matmat")}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of the parent's {name}.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    fn = libs["aca"].repro_batched_aca
    fn.argtypes, fn.restype = _OLD_ACA_ARGTYPES, ctypes.c_int
    dense = libs["dense_matmat"].repro_dense_matmat
    dense.argtypes, dense.restype = _DENSE_ARGTYPES, ctypes.c_int
    return {"aca": fn, "dense": dense}


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


def gpu_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(a, b) -> tuple[float, float]:
    """Mean device ms of a and b, timed a, b, b, a."""
    ta1, tb1, tb2, ta2 = gpu_ms(a), gpu_ms(b), gpu_ms(b), gpu_ms(a)
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
    from repro_torch.core.geometry import matern_norm
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.batched_dense_matvec.kernel import (
        batched_kernel_matmat_cuda, batched_kernel_matmat_level_cuda)
    from repro_torch.kernels.phi import kernel_id
    c, g = hm.plan.c_leaf, hm.groups["dense"]
    d = hm.tree.points.shape[1]
    x_pad = torch.from_numpy(rng.standard_normal((hm.plan.n_pad, 8)).astype(np.float32)).cuda()
    leaf = hm.tree.points.reshape(-1, c, d)
    rows, cols = leaf[g.rows].contiguous(), leaf[g.cols].contiguous()
    x_blk = x_pad.reshape(-1, c, 8)[g.cols].contiguous()
    y_par = torch.empty_like(x_blk)

    def par():
        err = parent["dense"](rows.data_ptr(), cols.data_ptr(), x_blk.data_ptr(), y_par.data_ptr(),
                              rows.shape[0], c, d, 8, kernel_id("gaussian"), matern_norm(d),
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
    rec[f"dense_{name}"] = {"blocks": int(rows.shape[0]), "C": c, "R": 8, "parent_ms": t_par,
                      "level_ms": t_level, "gathered_ms": t_gath,
                      "level_equals_gathered": same, "rel_err_vs_parent": rel,
                      "sm_clock_mhz_samples": clocks}
    print(f"[#2 {name}] {rec[f'dense_{name}']}", flush=True)
    return same and rel <= 1e-5


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    from repro_torch.core import build_hmatrix, halton
    parent = build_parent(Path(sys.argv[1]).resolve())
    rng = np.random.RandomState(SEED)
    from repro_torch import _build
    rec = {"card": torch.cuda.get_device_name(0)}
    info = _build.build_all()
    rec["dense_sass"] = sass_per_entry(Path(info["dir"]) / "libdense_matmat.so",
                                       "dense_matmat_kernelILi2ELi0ELi8E")
    print(f"[#2 SASS] {rec['dense_sass']}", flush=True)
    ok = True
    for name, n, scale, c_leaf in (("P", 1 << 20, 1.0, 2048), ("K", 1 << 15, 32.0, 256)):
        hm = build_hmatrix(halton(n, 2, device="cuda") * scale, "gaussian", k=16,
                           c_leaf=c_leaf, eta=1.5)
        ok &= compare_aca(parent, name, hm, rng, rec)
        ok &= compare_dense(parent, name, hm, rng, rec)
        del hm
        torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "compare_parent_kernels.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
