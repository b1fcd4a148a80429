"""input_specs(): fake-tensor stand-ins + partition specs for every step
(``repro.launch.specs`` in PyTorch).

No device memory is allocated here: the stand-ins are fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``), made by the port's own
``init_params``, ``init_caches`` and ``init_state`` with a CPU generator,
which is what lets the dry run trace full-size cells on one CPU.  ``repro``
builds ``jax.ShapeDtypeStruct``s by ``jax.eval_shape``.  A call inside an
active ``FakeTensorMode`` makes its stand-ins in that mode (so a dry run
can feed them to a step traced there); otherwise each call opens its own.

Structure against ``repro``'s: the port's decode caches are a list with one
entry per layer (``(k, v)``, a recurrent state, or an encoder-decoder
layer's ``{"self": (k, v), "cross": (k, v)}``), where ``repro`` stacks the
layers of a pattern position (``{"pattern": [...], "tail": [...]}``, and
``{"self", "cross"}`` stacked over layers); the train state's parameters
and optimizer moments are keyed by parameter name (``parallel.sharding``
maps them to ``repro``'s paths).  Token ids are int64 and ``cache_len`` is
a host int, the port's step contracts (``repro``: int32 arrays).
"""
from __future__ import annotations

import contextlib

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models.api import get_model
from ..models.lm import ATTN_KINDS
from ..parallel.mesh_ctx import P, current_mesh, resolve_spec
from ..parallel.sharding import opt_state_specs, param_specs

WHISPER_DEC_PREFILL = 64      # decoder prompt length for enc-dec prefill
WHISPER_DEC_CACHE = 4096      # decoder self-cache capacity for enc-dec decode
TOKEN_DTYPE = torch.int64     # the port's token ids (repro: int32)


def fake_mode():
    """The active ``FakeTensorMode``'s block, or a new one's."""
    return contextlib.nullcontext() if detect_fake_mode() is not None else FakeTensorMode()


def _batch_entry(batch: int):
    return ("pod", "data")


def token_spec(batch: int, seq: int):
    with fake_mode():
        tok = torch.zeros((batch, seq), dtype=TOKEN_DTYPE)
    return tok, P(_batch_entry(batch), None)


def embed_spec(cfg, batch: int, seq: int):
    with fake_mode():
        emb = torch.zeros((batch, seq, cfg.d_model), dtype=getattr(torch, cfg.dtype))
    return emb, P(_batch_entry(batch), None, None)


# ---------------------------------------------------------------------------
# Cache specs (structure mirrors models.*.init_caches)
# ---------------------------------------------------------------------------


def _attn_cache_leaf_spec(shape, batch_dim: int, batch: int):
    """(…, B, S, Hkv, D): batch over DP; cache seq over 'model'
    (flash-decode); at batch==1 the sequence absorbs the DP axes too
    (context parallelism for long_500k)."""
    ent = [None] * len(shape)
    mesh = current_mesh()
    dp = 1
    if mesh is not None:
        for a in ("pod", "data"):
            dp *= mesh.shape.get(a, 1)
    if batch % dp == 0 and dp > 1:
        ent[batch_dim] = ("pod", "data")
        ent[batch_dim + 1] = "model"
    else:
        ent[batch_dim + 1] = ("pod", "data", "model")
    return resolve_spec(shape, P(*ent))


def _state_cache_leaf_spec(shape, batch_dim: int, batch: int):
    """SSM-ish states (…, B, H, …): batch over DP, heads over model."""
    ent = [None] * len(shape)
    ent[batch_dim] = ("pod", "data")
    if len(shape) > batch_dim + 1:
        ent[batch_dim + 1] = "model"
    return resolve_spec(shape, P(*ent))


def _leaf_specs(tree, leaf_spec):
    if isinstance(tree, torch.Tensor):
        return leaf_spec(tree.shape)
    if isinstance(tree, dict):
        return {key: _leaf_specs(val, leaf_spec) for key, val in tree.items()}
    return type(tree)(_leaf_specs(val, leaf_spec) for val in tree)


def cache_specs(cfg, caches, batch: int) -> list:
    """Spec tree matching the port's per-layer cache list (a layer's batch
    axis is its leaves' first)."""
    def attn(shape):
        return _attn_cache_leaf_spec(shape, 0, batch)

    def state(shape):
        return _state_cache_leaf_spec(shape, 0, batch)

    if cfg.is_encoder_decoder:
        return [_leaf_specs(cache, attn) for cache in caches]
    return [_leaf_specs(cache, attn if kind in ATTN_KINDS else state)
            for kind, cache in zip(cfg.layer_kinds, caches)]


# ---------------------------------------------------------------------------
# Step input specs
# ---------------------------------------------------------------------------


def train_input_specs(cfg, shape):
    """(batch_struct, batch_spec_tree) for train_step."""
    with fake_mode():
        tok, tok_spec = token_spec(shape.global_batch, shape.seq_len)
        batch = {"tokens": tok, "labels": torch.zeros_like(tok)}
        specs = {"tokens": tok_spec, "labels": tok_spec}
        if cfg.frontend == "audio_stub":
            emb, emb_spec = embed_spec(cfg, shape.global_batch, shape.seq_len)
            batch["embeds"] = emb
            specs["embeds"] = emb_spec
    return batch, specs


def state_struct_and_specs(cfg, init_state):
    """The train state of ``init_state`` (``train.step.make_train_step(cfg,
    ..., device="cpu")``'s) on fake tensors, and its spec tree.

    Optimizer moments get ZeRO-1 "data" sharding on top of the param TP spec.
    """
    with fake_mode():
        struct = init_state(torch.Generator())
    p_specs = param_specs(struct["params"], cfg.num_experts)
    o_specs = {k: opt_state_specs(struct["params"], cfg.num_experts) for k in struct["opt"]}
    specs = {"step": P(), "params": p_specs, "opt": o_specs}
    return struct, specs


def prefill_input_specs(cfg, shape):
    if cfg.is_encoder_decoder:
        with fake_mode():
            emb, emb_spec = embed_spec(cfg, shape.global_batch, shape.seq_len)
            tok, tok_spec = token_spec(shape.global_batch, WHISPER_DEC_PREFILL)
        return {"tokens": tok, "embeds": emb}, {"tokens": tok_spec, "embeds": emb_spec}
    tok, tok_spec = token_spec(shape.global_batch, shape.seq_len)
    return {"tokens": tok}, {"tokens": tok_spec}


def input_specs(cfg, shape):
    """Unified entry: fake-tensor stand-ins + PartitionSpecs for the step
    function matching ``shape.kind`` (no device allocation).

    train  -> (batch_struct, batch_specs)        for train_step(state, batch)
    prefill-> (inputs, specs)                    for prefill_step(params, **)
    decode -> (inputs, specs) incl. caches       for decode_step(params, **)
    """
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def decode_input_specs(cfg, shape, model=None):
    """The decode step's inputs: one token a sequence, caches of
    ``shape.seq_len`` slots (whisper: ``WHISPER_DEC_CACHE`` decoder slots
    and ``shape.seq_len`` encoder frames) and ``cache_len``, a host int: the
    last slot of the self-attention cache (``repro`` passes an abstract int32
    scalar)."""
    model = model or get_model(cfg, "cpu")
    b = shape.global_batch
    with fake_mode():
        tok, tok_spec = token_spec(b, 1)
        if cfg.is_encoder_decoder:
            slots = WHISPER_DEC_CACHE
            caches = model["init_caches"](b, slots, shape.seq_len)
        else:
            slots = shape.seq_len
            caches = model["init_caches"](b, slots)
    c_specs = cache_specs(cfg, caches, b)
    inputs = {"tokens": tok, "caches": caches, "cache_len": slots - 1}
    specs = {"tokens": tok_spec, "caches": c_specs, "cache_len": P()}
    return inputs, specs


__all__ = ["WHISPER_DEC_PREFILL", "WHISPER_DEC_CACHE", "TOKEN_DTYPE", "token_spec",
           "embed_spec", "cache_specs", "train_input_specs", "state_struct_and_specs",
           "prefill_input_specs", "decode_input_specs", "input_specs"]
