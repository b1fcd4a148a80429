"""Deterministic synthetic data pipeline (``repro.data.pipeline`` in
PyTorch): batches are a pure function of (seed, step).

Checkpoint restore therefore resumes the stream exactly with no pipeline
state beyond the step counter.  The token stream mixes Zipf-ish unigram
draws with short repeated motifs, so the LM loss decreases.  The draws
come from a CPU ``torch.Generator`` seeded from (seed, step) and are then
moved to the device, so a batch is the same on the CPU and on the card.
Like every entry point of the port, a batch lands on the card unless the
caller asks for another device (``_device.resolve_device``).
They are not ``jax.random``'s numbers (ROADMAP §3): the structure is
``repro``'s, the values differ.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_generator(cfg: DataConfig, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's SeedSequence."""
    seed = np.random.SeedSequence([cfg.seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))


def make_batch(cfg: DataConfig, step: int, *, device=None) -> dict:
    """Returns {"tokens", "labels"}, int64 (B, S) on ``device``, for ``step``.

    ``device=None`` is the card; it raises where there is none."""
    device = resolve_device(device)
    gen = _batch_generator(cfg, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # Zipf-ish marginal: exponential scores -> ids, P(id) ~ exp(-8 id / v)
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s), generator=gen)
    zipf = torch.clamp(-torch.log(u) * (v / 8.0), 0, v - 1).to(torch.int64)
    # repeated motif: every position p copies position p - 7 with prob .5
    motif = torch.roll(zipf, 7, dims=1)
    pick = torch.rand((b, s), generator=gen) < 0.5
    tokens = torch.where(pick, motif, zipf)
    # next-token labels; the final position has no successor and is marked
    # -1 (masked by cross_entropy_loss)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}


class DataIterator:
    """Stateful wrapper with an explicit, checkpointable step counter; its
    batches land on ``device`` (``None``: the card, as ``make_batch``)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.step, device=self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict, *, device=None):
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on restore: {state['seed']} != {cfg.seed}")
        return cls(cfg, start_step=state["step"], device=device)
