"""Quickstart on the PyTorch port: build an H-matrix and run the fast matvec
(the paper's core), held against the O(N^2) dense product.

The twin of ``examples/quickstart.py``, at its sizes and arguments: N = 8192
Halton points in 2-D, the Gaussian kernel, k = 16, c_leaf = 256, eta = 1.5,
in NP mode (the factors are recomputed in every apply).  On the card the
apply runs kernels #3 (the batched ACA), #4 (the low-rank products) and #2's
vector entry (the dense leaves).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--n 8192]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import build_hmatrix, dense_matvec_oracle, halton, make_matvec


def wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, n: int = 8192, d: int = 2, c_leaf: int = 256) -> dict:
    dev = torch.device(device or "cuda")
    print(f"Halton point set: N={n}, d={d}, Gaussian kernel")
    pts = halton(n, d, device=dev)

    t0 = time.perf_counter()
    hm = build_hmatrix(pts, kernel="gaussian", k=16, c_leaf=c_leaf, eta=1.5, device=dev)
    wait(dev)
    setup_s = time.perf_counter() - t0
    print(f"H-matrix setup: {setup_s:.3f}s  ({hm.plan.num_aca_blocks} low-rank blocks, "
          f"{hm.plan.num_dense_blocks} dense blocks)")

    matvec = make_matvec(hm)
    x = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).to(dev)
    matvec(x)  # warm-up (builds the kernels on the card)
    wait(dev)
    t0 = time.perf_counter()
    z = matvec(x)
    wait(dev)
    matvec_s = time.perf_counter() - t0
    print(f"H-matvec: {matvec_s:.4f}s (vs O(N^2) dense product)")

    z_ref = dense_matvec_oracle(pts, "gaussian", x, device=dev)
    rel = float((torch.linalg.norm(z - z_ref) / torch.linalg.norm(z_ref)).cpu())
    print(f"relative error vs dense oracle: {rel:.2e}")

    rep = hm.memory_report()
    print(f"metadata bytes: {rep['meta_bytes']:,}  "
          f"dense-equivalent: {rep['dense_equivalent_bytes']:,}")
    return {"n": n, "setup_s": setup_s, "matvec_s": matvec_s, "rel_err": rel,
            "aca_blocks": hm.plan.num_aca_blocks, "dense_blocks": hm.plan.num_dense_blocks,
            "memory": rep, "z": z.cpu().numpy()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=8192, help="number of points")
    args = ap.parse_args(argv)
    return run(args.device, n=args.n)


if __name__ == "__main__":
    main()
