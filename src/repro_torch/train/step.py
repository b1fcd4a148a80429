"""Train step: remat, microbatch gradient accumulation and AdamW
(``repro.train.step`` in PyTorch).

``make_train_step(cfg, ...)`` returns ``(init_state, train_step)``.  The
state is ``{"step": int, "params": LM, "opt": {"m", "v"[, "err"]}}``;
``train_step(state, batch)`` updates it in place and returns it with the
step's metrics.  The microbatches run in order, each under remat (one
checkpoint per block), and their gradients are added into float32
accumulators as ``repro``'s ``lax.scan`` adds them; a microbatch's
gradients are freed before the next one runs.
"""
from __future__ import annotations

import torch

from ..models.api import get_model
from ..models.lm import cross_entropy_loss
from .optimizer import AdamWConfig, apply_updates, init_opt_state


def make_loss_fn(cfg, remat: bool = True):
    def loss_fn(params, batch):
        logits, _ = params(batch["tokens"], mode="train", remat=remat)
        return cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    return loss_fn


def make_train_step(cfg, opt_cfg: AdamWConfig = AdamWConfig(), *, microbatches: int = 1,
                    remat: bool = True, device=None):
    """``init_state(generator)`` and ``train_step(state, batch)`` for ``cfg``
    on ``device`` (``cuda`` unless the caller asks; raises without a card).
    ``batch`` holds ``tokens`` and ``labels`` (B, S) with B a multiple of
    ``microbatches``.  Metrics: ``loss`` (the mean over microbatches),
    ``grad_norm`` and ``lr``, 0-dim float32 tensors left on the device."""
    model = get_model(cfg, device)
    loss_fn = make_loss_fn(cfg, remat=remat)

    def init_state(gen: torch.Generator) -> dict:
        params = model["init_params"](gen)
        return {"step": 0, "params": params, "opt": init_opt_state(params, opt_cfg)}

    def train_step(state: dict, batch: dict):
        params = state["params"]
        names, plist = zip(*params.named_parameters())
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"train_step: a batch of {b} does not split into "
                             f"{microbatches} microbatches")
        size = b // microbatches
        acc, losses = None, []
        for i in range(microbatches):
            mb = {key: batch[key][i * size:(i + 1) * size] for key in ("tokens", "labels")}
            loss = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, plist)
            if acc is None:
                acc = [g.float() / microbatches for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.float() / microbatches)
            losses.append(loss.detach())
            del grads, loss
        _, _, metrics = apply_updates(params, dict(zip(names, acc)), state["opt"],
                                      state["step"], opt_cfg)
        state["step"] += 1
        metrics["loss"] = torch.stack(losses).mean()
        return state, metrics

    return init_state, train_step
