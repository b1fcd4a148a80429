"""AdamW with optional bf16-compressed gradients and error feedback
(``repro.train.optimizer`` in PyTorch).

Parameters are an ``nn.Module`` (or a dict of tensors), the optimizer state
``{"m": {name: tensor}, "v": {...}[, "err": {...}]}`` keyed by parameter
name, moments in float32 whatever the parameters' dtype.  ``apply_updates``
updates parameters and state in place (``repro``'s returns new pytrees),
with ``repro``'s arithmetic in the same order, elementwise over pieces of
at most ``CHUNK`` elements so that its float32 temporaries stay small
beside the largest parameter (the 778M-entry embedding at full width).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

CHUNK = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # gradient compression: "none" | "bf16_ef" (bf16 reduce + error feedback)
    compression: str = "none"


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` of the peak, in
    float32 as ``repro`` computes it; ``step`` a number or a tensor."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def named_tensors(params) -> dict[str, torch.Tensor]:
    """{name: tensor} of an ``nn.Module``'s parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for name, p in named_tensors(params).items()}
    state = {"m": zeros(), "v": zeros()}
    if cfg.compression == "bf16_ef":
        state["err"] = zeros()
    return state


def _pieces(*tensors):
    """Matching flat pieces of at most CHUNK elements of same-shaped tensors."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for lo in range(0, n, CHUNK):
        yield tuple(f[lo:lo + CHUNK] for f in flat)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (float32), summed tensor by
    tensor in order."""
    total = None
    for t in tensors:
        part = sum(torch.sum(torch.square(x.float())) for (x,) in _pieces(t))
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads: dict, opt_state: dict, step, cfg: AdamWConfig):
    """One AdamW update of ``params`` from float32 ``grads`` ({name: tensor};
    consumed: clipped and, with ``bf16_ef``, compressed in place) at
    0-based ``step``.  Returns (params, opt_state, metrics) — the same
    objects, updated in place — with metrics ``grad_norm`` and ``lr`` as
    0-dim float32 tensors on the parameters' device."""
    named = named_tensors(params)
    names = list(named)
    dev = named[names[0]].device
    g = [grads[n] for n in names]

    if cfg.compression == "bf16_ef":
        # error feedback: quantise (g + carried error) to bf16; the carried
        # residual keeps the update unbiased over steps
        for gi, ei in zip(g, (opt_state["err"][n] for n in names)):
            for gp, ep in _pieces(gi, ei):
                total = gp + ep
                comp = total.to(torch.bfloat16).float()
                ep.copy_(total - comp)
                gp.copy_(comp)

    gnorm = global_norm(g)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        for gi in g:
            gi.mul_(scale)

    # 1-based update index: the same t drives the schedule and the bias correction
    t = _f32(step, dev) + 1
    lr = lr_schedule(cfg, t)
    bc1 = 1.0 - _f32(cfg.b1, dev) ** t
    bc2 = 1.0 - _f32(cfg.b2, dev) ** t
    for name, gi in zip(names, g):
        p, m, v = named[name], opt_state["m"][name], opt_state["v"][name]
        decay = p.ndim >= 2               # decoupled weight decay on matrices only
        for pp, gp, mp, vp in _pieces(p, gi, m, v):
            mp.mul_(cfg.b1).add_((1 - cfg.b1) * gp)
            vp.mul_(cfg.b2).add_((1 - cfg.b2) * gp * gp)
            step_val = (mp / bc1).div_(torch.sqrt(vp / bc2).add_(cfg.eps))
            pf = pp.float()
            if decay:
                step_val.add_(cfg.weight_decay * pf)
            pp.copy_(pf.sub_(lr * step_val))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
