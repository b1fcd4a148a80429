#!/usr/bin/env python3
"""Where #11b's time goes: the kernel's source with one part taken out at a
time, each built with nvcc and timed on the card at the training shape.

    python3 scripts/nearfield_bwd_variants.py [--shape 40,8,512,128]

Each variant is ``src/repro_torch/csrc/hattention_nearfield_bwd.cu`` with
text replaced (every replaced text must occur exactly once): only the dq
pass, only the dk/dv pass, without the products over D (gnum v^T and the
scores), without the exact arg-max test of the candidates, without the
products over the streamed tile (ds K, ds^T Q, p^T gnum: what only feeds
them goes too), with a shared-memory request that leaves one CTA an SM,
with the dk/dv products issued 2 column tiles at a time instead of 4,
with the tile products summed in the tensor cores' accumulators instead
of from zero a step, and with one-pass TF32 in place of 3xTF32.  A variant
computes something else than #11b: the times say what each part costs,
the outputs are not checked.  Device ms by ``chip_smoke.gpu_ms``; the
variants are timed in turns with the unchanged source (base, variant,
variant, base).
Writes ``chiprun_out/nearfield_bwd_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import gpu_ms, nearfield_bwd_inputs  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "hattention_nearfield_bwd.cu"
LAUNCH_FIX = "  fix_kernel<D><<<(unsigned)fix_blocks"
LAUNCH_DQ = "  dq_kernel<D><<<(unsigned)blocks"
LAUNCH_DKV = "  dkv_kernel<D><<<(unsigned)blocks"
VARIANTS = {
    "base": [],
    "dq_pass_only": [(LAUNCH_FIX, "  return 0;\n" + LAUNCH_FIX)],
    "dkv_pass_only": [(LAUNCH_DQ, "  if (0)" + LAUNCH_DQ), (LAUNCH_FIX, "  if (0)" + LAUNCH_FIX)],
    "no_products_over_d": [("  for (int ks = 0; ks < Layout<D>::NK; ++ks) {",
                            "  for (int ks = 0; ks < 0; ++ks) {")],
    "no_exact_test": [("exact_ties<D>(cand, Qs", "exact_ties<D>(0u, Qs")],
    "no_products_over_tile": [("    for (int nb = 0; nb < NN; nb += G) {",
                               "    for (int nb = 0; nb < 0; nb += G) {")],
    "one_cta_per_sm": [("  static constexpr int XCH = (OWN / 16) * 4 * 32 * 16;",
                        "  static constexpr int XCH = (OWN / 16) * 4 * 32 * 16 + 61440;"),
                       ("  static constexpr int DKV_BYTES = (4 * STR_T + 2 * (NT / 32) * 16 * 32)"
                        " * (int)sizeof(float);",
                        "  static constexpr int DKV_BYTES = (4 * STR_T + 2 * (NT / 32) * 16 * 32)"
                        " * (int)sizeof(float) + 92160;")],
    "dkv_groups_of_2": [("  constexpr int NK = L::NK, G = NK < 4 ? NK : 4;", "  constexpr int NK = L::NK, G = 2;")],
    "one_pass_tf32": [
        ("    for (int j = 0; j < 2; ++j) mma_tf32(small[j], al, b[j].hi[0], b[j].hi[1]);\n", ""),
        ("    for (int j = 0; j < 2; ++j) mma_tf32(small[j], ah, b[j].lo[0], b[j].lo[1]);\n", ""),
        ("        mma_tf32(tmp[i], al, b[i].hi[0], b[i].hi[1]);\n", ""),
        ("      for (int i = 0; i < G; ++i) mma_tf32(tmp[i], ah, b[i].lo[0], b[i].lo[1]);\n", "")],
    "tensor_core_accumulation": [
        ("        for (int e = 0; e < 4; ++e) out[nb + i][e] += tmp[i][e];",
         "        for (int e = 0; e < 4; ++e) out[nb + i][e] = tmp[i][e];"),
        ("        tmp[i][0] = tmp[i][1] = tmp[i][2] = tmp[i][3] = 0.0f;",
         "        for (int e = 0; e < 4; ++e) tmp[i][e] = out[nb + i][e];")],
}


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not occur exactly once: {old!r}")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    from repro_torch import _build
    out = ROOT / "build" / "nearfield_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out / f"{name}.cu"
        src.write_text(variant_source(VARIANTS[name]))
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                                        str(SOURCE.parent), "-o", str(out / f"lib{name}.so"),
                                        str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).repro_hattention_nearfield_bwd
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", default="40,8,512,128")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("nearfield_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.kernels import stream_handle
    from repro_torch.kernels.hattention_block.kernel import hattention_nearfield_cuda
    shape = tuple(int(x) for x in args.shape.split(","))
    bh, nl, c, d = shape
    fns = build(list(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, gnum, gden, gm = nearfield_bwd_inputs(shape, gen)
    num, den, m = hattention_nearfield_cuda(q, k, v)
    outs = [torch.empty_like(q) for _ in range(3)]
    scratch = q.new_empty((3, bh, nl, c))
    ties = torch.empty((bh, nl, c), dtype=torch.int32, device=q.device)
    stash = q.new_empty((2, bh, nl, c, 2 * c))
    ptrs = [t.data_ptr() for t in (q, k, v, num, den, m, gnum, gden, gm, *outs, scratch, ties,
                                   stash)]

    def call(name):
        return lambda: _build.check(fns[name](*ptrs, bh, nl, c, d, stream_handle(q.device)),
                                    f"variant {name}")

    rec = {"card": torch.cuda.get_device_name(0), "shape": list(shape), "ms": {}}
    for name in VARIANTS:
        if name == "base":
            continue
        b1, v1, v2, b2 = (gpu_ms(call(x), 5) for x in ("base", name, name, "base"))
        rec["ms"][name] = {"base": (b1 + b2) / 2, "variant": (v1 + v2) / 2}
        print(f"[#11b variant {name}] {shape}: {(v1 + v2) / 2:.3f} ms, unchanged source "
              f"{(b1 + b2) / 2:.3f} ms", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "nearfield_bwd_variants.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
