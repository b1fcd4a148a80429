"""Build ``repro_torch`` objects from plain NumPy arrays.

``hmatrix_from_arrays``: a ``repro_torch`` HMatrix.

The arrays are an export of an H-matrix built elsewhere (for instance by
the JAX reference), so that both sides apply the SAME tree, plan and
factors.  Keys of ``arrays`` (``{l}`` is a tree level):

    points (n_pad, d) f32, perm (n,) int, n, n_pad, c_leaf, n_levels, eta,
    k, kernel_name (str), bb_min/{l}, bb_max/{l} (2^l, d) f32 for every
    level, dense_blocks (n_dense, 2) int32, aca_levels/{l} (B_l, 2) int32,
    and, for a precomputed H-matrix, U/{l} (B_l, m, k), V/{l} (B_l, m, k) f32.

``lm_params_from_arrays``: the port's ``LM`` from ``repro``'s LM parameter
pytree (``repro.models.lm.init_params``) as NumPy arrays;
``train_state_from_arrays``: the port's train state from ``repro``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.block_tree import HMatrixPlan
from .core.clustering import ClusterTree
from .core.factor_store import FactorStore
from .core.geometry import get_kernel
from .core.hmatrix import HMatrix, block_groups
from .models.layers import MLP, Attention, Norm
from .models.lm import LM, Block


def _levels_of(arrays: dict, prefix: str) -> list[int]:
    return sorted(int(key.split("/", 1)[1]) for key in arrays if key.startswith(prefix + "/"))


def hmatrix_from_arrays(arrays: dict[str, np.ndarray], *, device) -> HMatrix:
    """The port's :class:`HMatrix` for an exported H-matrix, on ``device``."""
    dev = torch.device(device)

    def f32(key):
        return torch.from_numpy(np.array(arrays[key], np.float32)).to(dev)

    n_levels = int(arrays["n_levels"])
    tree = ClusterTree(
        points=f32("points"),
        perm=torch.from_numpy(np.array(arrays["perm"], np.int64)).to(dev),
        n=int(arrays["n"]), n_pad=int(arrays["n_pad"]), c_leaf=int(arrays["c_leaf"]),
        n_levels=n_levels,
        bb_min=tuple(f32(f"bb_min/{lv}") for lv in range(n_levels + 1)),
        bb_max=tuple(f32(f"bb_max/{lv}") for lv in range(n_levels + 1)))
    plan = HMatrixPlan(
        aca_levels={lv: np.asarray(arrays[f"aca_levels/{lv}"], np.int32)
                    for lv in _levels_of(arrays, "aca_levels")},
        dense_blocks=np.asarray(arrays["dense_blocks"], np.int32).reshape(-1, 2),
        c_leaf=tree.c_leaf, n_pad=tree.n_pad, n_levels=n_levels,
        eta=float(arrays["eta"]))
    factors = None
    if _levels_of(arrays, "U"):
        factors = FactorStore.from_factors(
            {lv: (f32(f"U/{lv}"), f32(f"V/{lv}")) for lv in _levels_of(arrays, "U")},
            plan=plan)
    kernel_name = str(arrays["kernel_name"])
    return HMatrix(tree=tree, plan=plan, kernel=get_kernel(kernel_name),
                   kernel_name=kernel_name, k=int(arrays["k"]), factors=factors,
                   groups=block_groups(plan, dev))


def _norm(tree: dict, t) -> Norm:
    return Norm(t(tree["w"]), t(tree["b"]) if "b" in tree else None)


def _block(tree: dict, t) -> Block:
    attn = tree["attn"]
    mlp = tree.get("mlp")
    return Block(_norm(tree["ln1"], t),
                 Attention(*(t(attn[name]) for name in ("wq", "wk", "wv", "wo")),
                           **{name: t(attn[name]) for name in ("bq", "bk", "bv")
                              if name in attn}),
                 _norm(tree["ln2"], t),
                 None if mlp is None else MLP(t(mlp["wu"]), t(mlp["wd"]),
                                              wg=t(mlp["wg"]) if "wg" in mlp else None))


def lm_params_from_arrays(arrays: dict, cfg, *, device) -> LM:
    """The port's :class:`LM` holding ``repro``'s LM parameters.

    ``arrays`` is ``repro.models.lm.init_params(key, cfg)`` with every leaf
    a NumPy array: ``embed``, ``final_norm/w``, ``lm_head`` (untied), and per
    pattern position ``pattern[pos]`` with the periods stacked on the leading
    axis (``ln1/w``, ``attn/{wq, wk, wv, wo, bq, bk, bv}``, ``ln2/w``,
    ``mlp/{wg, wu, wd}``), plus ``tail`` blocks.  Layer ``i`` is period
    ``i // len(pattern)`` of position ``i % len(pattern)``, then the tail.
    Tensors keep the arrays' dtype (NumPy has no bfloat16: hand bfloat16
    parameters over as float32).
    """
    dev = torch.device(device)
    pattern = cfg.block_pattern
    n_periods = cfg.n_layers // len(pattern)
    for kind in cfg.layer_kinds:
        if kind != "dense":
            raise NotImplementedError(f"block kind {kind!r}: not yet ported to repro_torch")

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def sliced(tree, period):
        if isinstance(tree, dict):
            return {key: sliced(val, period) for key, val in tree.items()}
        return tree[period]

    layers = [_block(sliced(arrays["pattern"][pos], period), t)
              for period in range(n_periods) for pos in range(len(pattern))]
    layers += [_block(tree, t) for tree in arrays["tail"]]
    head = None if cfg.tie_embeddings else t(arrays["lm_head"])
    return LM(cfg, t(arrays["embed"]), _norm(arrays["final_norm"], t), head, layers)


def train_state_from_arrays(arrays: dict, cfg, *, device) -> dict:
    """The port's train state from ``repro``'s ``{"step", "params", "opt":
    {"m", "v"[, "err"]}}`` with every leaf a NumPy array: the parameters
    through :func:`lm_params_from_arrays`, each optimizer moment keyed by
    the port's parameter names (float32, as ``repro`` keeps them)."""
    def by_name(tree):
        return {name: p.detach() for name, p in
                lm_params_from_arrays(tree, cfg, device=device).named_parameters()}
    return {"step": int(np.asarray(arrays["step"])),
            "params": lm_params_from_arrays(arrays["params"], cfg, device=device),
            "opt": {key: by_name(tree) for key, tree in arrays["opt"].items()}}
