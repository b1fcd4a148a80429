"""Serving launcher: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b-hmatrix \
        --batch 2 --prompt-len 8192 --decode-steps 16          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b-hmatrix \
        --smoke --device cpu --prompt-len 256                   # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device cpu

``--arch`` takes every name of ``configs.registry.list_archs()``: the ten
assigned architectures and qwen2.5-14b-hmatrix.  The flags are
``repro.launch.serve``'s plus ``--device`` (default: the CUDA card; raises
without one) and ``--dtype`` (default: the config's, float32 with
``--smoke`` as in ``repro``).  Parameters, prompts and (encoder-decoder
configs) the encoder frames, as many as prompt tokens as in ``repro``, are
random from a ``torch.Generator`` seeded with ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from .._device import resolve_device
from ..configs.registry import get_arch, get_smoke, list_archs
from ..models.api import get_model
from ..models.lm import ATTN_KINDS
from ..serve.step import greedy_sample, make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grow_caches(caches: list, extra: int, cfg) -> list:
    """Caches of capacity S -> S + ``extra`` for decoding: zero slots appended
    to the self-attention K / V only (the attention kinds' entries of a
    decoder-only model, the ``"self"`` K / V of an encoder-decoder).  The
    recurrent states and the cross-attention K / V are passed on as they are.
    ``repro.launch.serve`` pads every array whose third-from-last axis is S,
    cross K / V included; its models' own forward is the reference here
    (ROADMAP §3)."""
    def grow(t):
        out = t.new_zeros((t.shape[0], t.shape[1] + extra) + tuple(t.shape[2:]))
        out[:, :t.shape[1]] = t
        return out

    if cfg.is_encoder_decoder:
        return [{"self": tuple(grow(t) for t in c["self"]), "cross": c["cross"]} for c in caches]
    return [tuple(grow(t) for t in c) if kind in ATTN_KINDS else c
            for c, kind in zip(caches, cfg.layer_kinds)]


def generate(params, cfg, prompts: torch.Tensor, decode_steps: int, frames=None) -> dict:
    """One prefill of ``prompts`` (B, S) (and, for an encoder-decoder, its
    encoder ``frames`` (B, S_enc, D)) and ``decode_steps - 1`` greedy decode
    steps, as ``repro.launch.serve`` runs them.  Returns the tokens (B,
    decode_steps), the prefill's last-position logits and caches, the caches
    after decoding, the last step's logits, and host-clock seconds of
    prefill (with growing the caches) and of the decode steps, each ending
    in a device synchronisation."""
    dev = prompts.device
    b, s = prompts.shape
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, prefill_caches = prefill(params, prompts, frames)
    caches = grow_caches(prefill_caches, decode_steps, cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits
    tok = greedy_sample(logits, cfg.vocab_size)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        logits, caches = decode(params, tok, caches, s + i)
        tok = greedy_sample(logits, cfg.vocab_size)
        generated.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1), "prefill_logits": prefill_logits,
            "prefill_caches": prefill_caches, "logits": logits, "caches": caches,
            "prefill_s": t_prefill, "decode_s": t_dec, "batch": b, "prompt_len": s,
            "decode_steps": decode_steps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="parameter and activation dtype (default: the config's; "
                         "float32 with --smoke)")
    args = ap.parse_args(argv)
    # fp32 products in full fp32 and bf16 products accumulated in fp32, as
    # the reference's XLA programs compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dtype = args.dtype or ("float32" if args.smoke else cfg.dtype)
    cfg = cfg.replace(dtype=dtype)
    dev = resolve_device(args.device)
    model = get_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model["init_params"](gen)
    b, s = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    frames = (torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
              if cfg.is_encoder_decoder else None)

    out = generate(params, cfg, prompts, args.decode_steps, frames)
    print(f"prefill: {b}x{s} tokens in {out['prefill_s']:.3f}s "
          f"({b * s / out['prefill_s']:.0f} tok/s)")
    print(f"decode: {args.decode_steps - 1} steps in {out['decode_s']:.3f}s "
          f"({b * (args.decode_steps - 1) / max(out['decode_s'], 1e-9):.0f} tok/s)")
    print("generated token ids (first row):", out["tokens"][0].cpu().tolist())
    return out


if __name__ == "__main__":
    main()
