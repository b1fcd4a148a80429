"""The paper's technique inside the LM, on the PyTorch port: H-matrix
attention against exact attention.

The twin of ``examples/long_context_hattention.py``, at its sizes and
arguments: output agreement and score-entry budget of ``h_attention``
(c_leaf = 256, rank 16) against exact causal attention on a 4,096-token
sequence with a smooth attention landscape (2 query heads on 1 key-value
head of 32), then a forward pass of the qwen2.5-14b-hmatrix smoke config
(float32, c_leaf 128) at 1,024 tokens.  On the card the near field runs
kernel #11.

    PYTHONPATH=src python examples/torch_long_context_hattention.py [--device cpu] [--seq 4096]
"""
import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.core.hattention import causal_hmatrix_plan, h_attention
from repro_torch.models.api import get_model


def wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smooth_qkv(s: int, d: int = 32):
    """q (1, s, 2, d), k and v (1, s, 1, d) as float32 numpy: smooth q / k,
    so that the far field is genuinely low-rank (the reference's draw)."""
    rng = np.random.RandomState(0)
    t = np.linspace(0, 6 * np.pi, s)
    feats = np.stack([np.sin(t * (i + 1) / d) for i in range(d)], -1) * 2.0
    q = (feats[None, :, None, :] + 0.01 * rng.randn(1, s, 2, d)).astype(np.float32)
    k = (feats[None, :, None, :] + 0.01 * rng.randn(1, s, 1, d)).astype(np.float32)
    v = rng.randn(1, s, 1, d).astype(np.float32)
    return q, k, v


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact causal attention, 2 query heads on one key-value head."""
    s, d = q.shape[1], q.shape[3]
    qf = q.reshape(1, s, 1, 2, d) / math.sqrt(d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = torch.where(causal[None, None, None], sc, torch.full_like(sc, -1e30))
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(sc, -1), v)
    return o.permute(0, 3, 1, 2, 4).reshape(1, s, 2, d)


def timed(fn, dev: torch.device):
    fn()
    wait(dev)
    t0 = time.perf_counter()
    out = fn()
    wait(dev)
    return out, time.perf_counter() - t0


def run(device=None, s: int = 4096, c_leaf: int = 256, rank: int = 16,
        model_seq: int = 1024, model_c_leaf: int = 128) -> dict:
    dev = torch.device(device or "cuda")
    plan = causal_hmatrix_plan(s, c_leaf)
    n_adm = sum(len(r) for r, _ in plan["levels"].values())
    dense_cells = plan["n_leaf"] * (2 * c_leaf * c_leaf) - c_leaf * c_leaf
    adm_cells = sum(len(r) * (s >> lv) ** 2 for lv, (r, _) in plan["levels"].items())
    print(f"S={s}, c_leaf={c_leaf}: {n_adm} admissible blocks, "
          f"{plan['n_leaf'] * 2 - 1} dense leaf blocks")
    print(f"score-entry budget: dense {dense_cells:,} + rank-{rank} ACA on "
          f"{adm_cells:,} far-field cells (vs {s * s:,} full)")

    q, k, v = (torch.from_numpy(a).to(dev) for a in smooth_qkv(s))
    with torch.no_grad():
        out_h, h_s = timed(lambda: h_attention(q, k, v, c_leaf=c_leaf, rank=rank), dev)
        print(f"h_attention: {h_s:.3f}s")
        out_f, f_s = timed(lambda: full_attention(q, k, v), dev)
        print(f"full attention: {f_s:.3f}s")
    rel = float((torch.linalg.norm(out_h - out_f) / torch.linalg.norm(out_f)).cpu())
    print(f"relative agreement: {rel:.3e}")

    # whole-model forward with the hmatrix backend
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype="float32", h_c_leaf=model_c_leaf)
    model = get_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model["init_params"](gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, model_seq), generator=gen, device=dev)
    with torch.no_grad():
        logits, _ = model["forward"](params=params, tokens=tokens, mode="train")
    finite = bool(torch.isfinite(logits).all().cpu())
    print(f"qwen2.5-14b-hmatrix smoke forward at S={model_seq}: logits "
          f"{tuple(logits.shape)}, finite={finite}")
    return {"s": s, "admissible_blocks": n_adm, "dense_cells": dense_cells,
            "far_field_cells": adm_cells, "h_attention_s": h_s, "full_attention_s": f_s,
            "rel_agreement": rel, "logits_shape": tuple(logits.shape), "finite": finite,
            "out_h": out_h.cpu().numpy()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--seq", type=int, default=4096, help="sequence length of the comparison")
    args = ap.parse_args(argv)
    return run(args.device, s=args.seq)


if __name__ == "__main__":
    main()
