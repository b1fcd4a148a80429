"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b-hmatrix \
        --smoke --device cpu --steps 3                      # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b-hmatrix \
        --smoke --steps 200 --ckpt-dir build/ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b --smoke \
        --device cpu                                          # any registry name

Wires together the config registry, the deterministic data pipeline, the
train step (remat, microbatch accumulation, AdamW), the checkpoint manager
(atomic, async, keep-k), the preemption handler, the straggler monitor and
the restart supervisor, as ``repro.launch.train`` does.  Every registry
config trains; a config with the ``audio_stub`` frontend (whisper-tiny)
gets frame embeddings in its batches, as in ``repro``.  The flags are
``repro``'s plus ``--device`` (default: the CUDA card; raises without one).
``--smoke`` runs the reduced config in float32.  Parameters are random
from a ``torch.Generator`` seeded with ``--seed`` on the device; the
checkpoints go to ``--ckpt-dir`` (default ``build/train_ckpt`` at the root
of the checkout), and a run resumes from the latest one there.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from .._device import resolve_device
from ..configs.registry import get_arch, get_smoke, list_archs
from ..data.pipeline import DataConfig, make_batch
from ..runtime.checkpoint import CheckpointManager
from ..runtime.fault_tolerance import PreemptionHandler
from ..serve.faults import StragglerMonitor, run_with_restarts
from ..train.optimizer import AdamWConfig
from ..train.step import make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def train_loop(cfg, args, device: torch.device):
    """Steps ``[start, args.steps)``, ``start`` from the latest checkpoint
    in ``args.ckpt_dir`` (0 without one).  Returns the final state."""
    init_state, train_step = make_train_step(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                    compression="bf16_ef" if args.compress_grads else "none"),
        microbatches=args.microbatches, device=device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
    preempt = PreemptionHandler().install()
    straggler = StragglerMonitor()

    state = init_state(torch.Generator(device=device).manual_seed(args.seed))
    start = 0
    if mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["extra"]["data_step"]
        print(f"[restore] resumed from step {start}")

    with_embeds = cfg.frontend == "audio_stub"
    t_last = time.perf_counter()
    try:
        for step in range(start, args.steps):
            batch = make_batch(dcfg, step, d_model=cfg.d_model, with_embeds=with_embeds,
                               device=device)
            state, metrics = train_step(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                # one device read for every logged scalar
                loss, lr, gnorm = torch.stack(
                    [metrics["loss"], metrics["lr"], metrics["grad_norm"]]).cpu().tolist()
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                slow = straggler.record("host0", dt)
                print(f"step {step:6d}  loss {loss:.4f}  lr {lr:.2e}  gnorm {gnorm:.2f}"
                      f"  {dt:.2f}s{'  [STRAGGLER]' if slow else ''}", flush=True)
            if step > 0 and step % args.ckpt_every == 0:
                mgr.save(step + 1, state, extra={"data_step": step + 1})
            if preempt.preempted:
                print("[preempt] SIGTERM received -> final checkpoint")
                mgr.wait()
                mgr.save(step + 1, state, extra={"data_step": step + 1})
                mgr.wait()
                return state
        mgr.wait()
        mgr.save(args.steps, state, extra={"data_step": args.steps})
        mgr.wait()
    finally:
        preempt.uninstall()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config, float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # bf16 products accumulate in fp32, as the reference's XLA programs do;
    # TF32 is left as it is: h_attention refuses CUDA operands while it is on
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    return run_with_restarts(lambda: train_loop(cfg, args, device),
                             max_restarts=args.max_restarts,
                             on_restart=lambda n, e: print(f"[restart {n}] after: {e}"))


if __name__ == "__main__":
    main()
