"""Parameter / optimizer / cache sharding rules, logical -> mesh axes
(``repro.parallel.sharding`` in PyTorch).

Megatron-style TP pairs on the "model" axis, DP over ("pod", "data"),
ZeRO-1 optimizer-state sharding over "data".  The rules are ``repro``'s,
keyed by ``repro``'s parameter paths; every spec is sanitised by
``resolve_spec`` (missing axes and non-divisible dims fall back to
replication), so one rule set covers all the architectures.

The port names its parameters by ``named_parameters()`` of its ``LM`` /
``EncDec`` and keeps one tensor per layer, where ``repro`` stacks the
layers of a pattern position (and the encoder-decoder's layers) on a
leading axis.  ``convert.repro_path`` maps a port name to ``repro``'s path
and stack; a rule is applied to the stacked shape, as ``repro`` applies
it, and the entry of the stack's axis goes to the spec's ``stack`` (see
``PartitionSpec``): ``None`` for every parameter spec, and ``"data"`` where
ZeRO-1 puts the optimizer moments' data axis on the stack.  The specs are
host-side data: nothing here moves a tensor.
"""
from __future__ import annotations

import re

from ..convert import repro_path
from .mesh_ctx import NamedSharding, P, PartitionSpec, current_mesh, entry_axes, resolve_spec

# (path regex, spec) -- first match wins.  Paths look like
# "pattern/0/attn/wq" or "dec_layers/cross_attn/wk"; stacked params carry a
# leading period axis which the length check in param_spec_for accounts for.
_RULES = [
    (r"embed$", P("model", None)),
    (r"lm_head$", P(None, "model")),
    (r"dec_pos$", P(None, None)),
    (r"(attn|self_attn|cross_attn)/w[qkv]$", P(None, "model")),
    (r"(attn|self_attn|cross_attn)/wo$", P("model", None)),
    (r"(attn|self_attn|cross_attn)/b[qkv]$", P("model")),
    (r"mlp/w[gu]$", P(None, "model")),
    (r"mlp/wd$", P("model", None)),
    (r"moe/router$", P(None, None)),
    (r"moe/w[gu]$", P("ep", None, "model")),   # "ep" resolved specially below
    (r"moe/wd$", P("ep", "model", None)),
    (r"mamba/w_in$", P(None, "model")),
    (r"mamba/w_out$", P("model", None)),
    (r"mlstm/w_up$", P(None, "model")),
    (r"mlstm/w[qkv]$", P(None, "model")),
    (r"mlstm/w_down$", P("model", None)),
    (r"mlstm/w_if$", P(None, None)),
    (r"slstm/w_x$", P(None, None)),
    (r"slstm/r_h$", P(None, None, None)),
    (r"slstm/w_out$", P(None, None)),
]


def _moe_resolve(spec, num_experts: int, tp: int) -> PartitionSpec:
    """Resolve the "ep" pseudo-axis: experts sharded over model when
    divisible (EP), else the feature dim keeps the "model" axis (TP)."""
    entries = list(spec)
    if entries and entries[0] == "ep":
        if tp > 1 and num_experts % tp == 0:
            # EP: expert axis takes "model"; drop it from the feature dim
            entries = ["model"] + [None if e == "model" else e for e in entries[1:]]
        else:
            entries[0] = None
    return P(*entries)


def _stacked(spec: PartitionSpec, periods: int | None) -> PartitionSpec:
    """A spec of a stacked shape as the spec of one entry of the stack."""
    if periods is None:
        return spec
    return P(*spec[1:], stack=spec[0] if len(spec) else None)


def _full_shape(shape, periods: int | None) -> tuple:
    return tuple(shape) if periods is None else (periods,) + tuple(shape)


def param_spec_for(path: str, shape, num_experts: int = 0, periods: int | None = None):
    """The spec of the leaf at ``repro``'s ``path`` with ``shape``; with
    ``periods``, of one entry of its stack of ``periods`` (the shape that of
    the entry)."""
    mesh = current_mesh()
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    full = _full_shape(shape, periods)
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = _moe_resolve(spec, num_experts, tp)
            # stacked (scan) params have a leading period axis
            if len(full) == len(spec) + 1:
                spec = P(*([None] + list(spec)))
            return _stacked(resolve_spec(full, spec), periods)
    return _stacked(resolve_spec(full, P()), periods)   # replicate (norms, biases, scalars)


def _leaves(params) -> list:
    """``[(name, repro path, periods, shape)]`` of a model's parameters."""
    cfg = params.cfg
    return [(name, *repro_path(cfg, name), tuple(p.shape))
            for name, p in params.named_parameters()]


def param_specs(params, num_experts: int = 0) -> dict:
    """``{name: PartitionSpec}`` over ``params.named_parameters()``."""
    return {name: param_spec_for(path, shape, num_experts, periods)
            for name, path, periods, shape in _leaves(params)}


def zero1_spec(spec, shape, periods: int | None = None) -> PartitionSpec:
    """Add "data" sharding to the first free, divisible dim (ZeRO-1); with
    ``periods``, the stack's axis (``spec.stack``) comes first."""
    mesh = current_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        return spec
    dsz = mesh.shape["data"]
    shape = _full_shape(shape, periods)
    lead = [] if periods is None else [getattr(spec, "stack", None)]
    entries = lead + list(spec) + [None] * (len(shape) - len(lead) - len(spec))
    if "data" in {nm for e in entries for nm in entry_axes(e)}:
        return spec
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsz == 0 and dim >= dsz:
            entries[i] = "data"
            return _stacked(P(*entries), periods)
        if e is not None and not isinstance(e, tuple):
            sz = mesh.shape.get(e, 1)
            if dim % (sz * dsz) == 0:
                entries[i] = (e, "data")
                return _stacked(P(*entries), periods)
    return spec


def opt_state_specs(params, num_experts: int = 0) -> dict:
    """ZeRO-1: ``{name: spec}`` of an optimizer moment (keyed as
    ``train.optimizer.init_opt_state`` keys each moment), sharded over
    "data" on top of the parameter's TP spec."""
    return {name: zero1_spec(param_spec_for(path, shape, num_experts, periods), shape, periods)
            for name, path, periods, shape in _leaves(params)}


def map_specs(fn, tree):
    """``fn`` on every spec of a tree of dicts, lists and tuples of specs."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: map_specs(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, val) for val in tree)
    return tree


def to_named(tree_of_specs):
    mesh = current_mesh()
    if mesh is None:
        return None
    return map_specs(lambda s: NamedSharding(mesh, s), tree_of_specs)


# ---------------------------------------------------------------------------
# Cache / batch specs
# ---------------------------------------------------------------------------


def batch_spec(global_batch: int) -> PartitionSpec:
    """Tokens (B, S): batch over all DP axes."""
    return P(("pod", "data"), None)


def cache_spec(kind: str, shape, *, batch: int) -> PartitionSpec:
    """Spec for one block's decode cache leaf.

    Attention caches (…, B, S, Hkv, D): batch over data when divisible, cache
    sequence over "model" (flash-decode); at batch=1 (long_500k) the sequence
    takes ("data", "model") — context parallelism.
    """
    mesh = current_mesh()
    if mesh is None:
        return P()
    dsz = mesh.shape.get("data", 1)
    batch_ok = batch % max(dsz, 1) == 0 and dsz > 1
    if kind in ("dense", "moe", "shared_attn", "self", "cross"):
        pre = [None] * (len(shape) - 4)
        if batch_ok:
            return resolve_spec(shape, P(*pre, ("pod", "data"), "model", None, None))
        return resolve_spec(shape, P(*pre, None, ("pod", "data", "model"), None, None))
    # SSM-ish states: (…, B, H, P, N) / mlstm tuples etc: batch over data,
    # heads over model where divisible.
    pre = [None] * (len(shape) - 4) if len(shape) >= 4 else []
    rest = len(shape) - len(pre)
    if rest >= 2:
        ent = [("pod", "data"), "model"] + [None] * (rest - 2)
        return resolve_spec(shape, P(*(pre + ent)))
    return resolve_spec(shape, P())
