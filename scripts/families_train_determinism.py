#!/usr/bin/env python3
"""Which operations of the families' train steps have no deterministic
implementation on the card: one ``make_train_step`` step of each family's
smoke config (bf16, and fp32) under ``torch.use_deterministic_algorithms(True,
warn_only=True)``, the warnings collected by operation.  A diagnostic only:
the port's own path never sets that flag.

    python3 scripts/families_train_determinism.py      # on the GPU, ~1 min

Prints one line per config and a JSON summary as its last line.
"""
from __future__ import annotations

import json
import os
import sys
import warnings
from pathlib import Path

# cuBLAS needs a fixed workspace for deterministic products; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b", "zamba2-7b", "xlstm-1.3b", "whisper-tiny",
         "smollm-135m")


def step_warnings(name: str, dtype: str) -> list[str]:
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step
    cfg = get_smoke(name).replace(dtype=dtype)
    init_state, train_step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=10),
                                             microbatches=2)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2), 0,
                       d_model=cfg.d_model, with_embeds=cfg.is_encoder_decoder)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train_step(state, batch)
        torch.cuda.synchronize()
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})


def main() -> int:
    if not torch.cuda.is_available():
        print("families_train_determinism: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for name in ARCHS:
        for dtype in ("bfloat16", "float32"):
            found = step_warnings(name, dtype)
            out[f"{name}/{dtype}"] = found
            print(f"{name} {dtype}: {len(found)} operation(s) without a deterministic "
                  f"implementation" + "".join(f"\n  {m}" for m in found), flush=True)
    print(json.dumps({"nondeterministic": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
