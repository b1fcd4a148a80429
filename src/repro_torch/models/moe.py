"""Mixture-of-Experts layer with capacity-based dispatch (``repro.models.moe``
in PyTorch).

Tokens routed to each expert form batches of unequal sizes; they are made
regular as in ``repro``: (1) per-expert counts, (2) an exclusive scan for
slot offsets, (3) a compaction into fixed-capacity ``(E, capg, D)`` buffers,
then one batched product runs every expert at once.

On one device the group count is 1 (``repro`` groups by its data-parallel
mesh axes, which the port does not have).  No float atomics: kept
assignments go to their own slots by indexing (dropped ones to a spare row
that is thrown away), and each token's ``topk`` contributions are added
from a ``(T, K, D)`` gather in k order, as ``repro``'s scatter-add adds
them.  So a prefill on the card repeats bit for bit.

Parallel modes (``moe_parallel_mode``, ``repro``'s rule): TP, every
expert's d_ff sharded over "model", always applicable; EP, the experts
sharded over "model", when ``num_experts % tp == 0`` (read from the active
mesh, ``parallel.mesh_ctx``).  The mode picks the expert weights' specs
(``parallel.sharding``); the single-process forward does not change with it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh_ctx import axis_size
from .layers import dense_init


class MoE(nn.Module):
    """``router`` (d_model, E) float32; ``wg``, ``wu`` (E, d_model, d_ff) and
    ``wd`` (E, d_ff, d_model): the experts stacked on a leading E axis."""

    def __init__(self, router, wg, wu, wd):
        super().__init__()
        self.router = nn.Parameter(router)
        self.wg, self.wu, self.wd = (nn.Parameter(t) for t in (wg, wu, wd))


def make_moe_params(gen: torch.Generator, cfg, dtype) -> MoE:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype) for _ in range(e)])

    router = dense_init(gen, d, e, torch.float32)
    return MoE(router, stack(d, f), stack(d, f), stack(f, d))


def moe_parallel_mode(cfg) -> str:
    tp = max(axis_size("model"), 1)
    return "ep" if cfg.num_experts % tp == 0 and tp > 1 else "tp"


def capacity(tokens: int, cfg, capacity_factor: float | None = None) -> int:
    """Slots per expert: ``repro``'s expression, float floor division included.
    A decode step of 2 sequences gets 1 slot at E = 8, top-2, cf 1.25, so two
    sequences routed to one expert lose the later assignment (ROADMAP §3)."""
    cf = capacity_factor or cfg.moe_capacity_factor
    return int(max(1, (tokens * cfg.experts_per_token * cf) // cfg.num_experts))


def route(p: MoE, cfg, x2):
    """x2: (T, D) -> (gates renormalised (T, K) float32, experts (T, K) int64,
    the router's softmax (T, E)), top-k in descending order."""
    logits = x2.float() @ p.router
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.experts_per_token, dim=-1)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return top_g, top_e, gates


def dispatch(top_e, e: int, capg: int):
    """Each (token, k) assignment's slot in the flattened ``(E * capg)`` buffer
    and whether it is kept: the running count of assignments to its expert
    in token-major order (count, exclusive scan), kept below ``capg``."""
    flat_e = top_e.reshape(-1)                                  # (T K,)
    onehot = F.one_hot(flat_e, e)                               # (T K, E)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # scan per expert
    keep = slot < capg
    dest = flat_e * capg + torch.where(keep, slot, torch.zeros_like(slot))
    return dest, keep


def moe_block(p: MoE, cfg, x, *, capacity_factor: float | None = None):
    """x: (B, S, D) -> (B, S, D).  Top-k routing, capacity dropping."""
    b, s, d = x.shape
    e, topk = cfg.num_experts, cfg.experts_per_token
    t = b * s
    capg = capacity(t, cfg, capacity_factor)
    xt = x.reshape(t, d)
    top_g, top_e, _ = route(p, cfg, xt)
    dest, keep = dispatch(top_e, e, capg)

    # compaction: kept rows to their unique slots, dropped ones to row E*capg
    spare = torch.full_like(dest, e * capg)
    rows = torch.where(keep, dest, spare)
    vals = xt.repeat_interleave(topk, dim=0)                    # (T K, D), token-major
    vals = torch.where(keep[:, None], vals, torch.zeros_like(vals))
    buf = x.new_zeros((e * capg + 1, d))
    buf[rows] = vals
    buf = buf[:-1].reshape(e, capg, d)

    # one batched product for all experts, intermediates in the model dtype
    gate = torch.bmm(buf, p.wg)
    up = torch.bmm(buf, p.wu)
    h = F.silu(gate) * up
    out_buf = torch.bmm(h, p.wd).to(x.dtype).reshape(e * capg, d)

    # gather back and combine with the gates, k in order, in the model dtype
    back = out_buf[dest]
    back = torch.where(keep[:, None], back, torch.zeros_like(back))
    back = (back * top_g.reshape(-1)[:, None].to(x.dtype)).reshape(t, topk, d)
    out = back[:, 0]
    for k in range(1, topk):
        out = out + back[:, k]
    return out.reshape(b, s, d)


def router_aux_loss(p: MoE, cfg, x) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    _, top_e, gates = route(p, cfg, x.reshape(-1, x.shape[-1]))
    me = gates.mean(0)
    ce = F.one_hot(top_e, cfg.num_experts).float().sum(1).mean(0)
    return cfg.num_experts * torch.sum(me * ce)
