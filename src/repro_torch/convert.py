"""Build ``repro_torch`` objects from plain NumPy arrays.

``hmatrix_from_arrays``: a ``repro_torch`` HMatrix.

The arrays are an export of an H-matrix built elsewhere (for instance by
the JAX reference), so that both sides apply the SAME tree, plan and
factors.  Keys of ``arrays`` (``{l}`` is a tree level):

    points (n_pad, d) f32, perm (n,) int, n, n_pad, c_leaf, n_levels, eta,
    k, kernel_name (str), bb_min/{l}, bb_max/{l} (2^l, d) f32 for every
    level, dense_blocks (n_dense, 2) int32, aca_levels/{l} (B_l, 2) int32,
    and, for a precomputed H-matrix, U/{l} (B_l, m, k), V/{l} (B_l, m, k) f32.

``lm_params_from_arrays``: the port's ``LM`` (every block kind) or, for an
encoder-decoder config, ``EncDec`` from ``repro``'s parameter pytree
(``repro.models.lm.init_params`` / ``repro.models.encdec.init_params``) as
NumPy arrays; ``train_state_from_arrays``: the port's train state from
``repro``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.block_tree import HMatrixPlan
from .core.clustering import ClusterTree
from .core.factor_store import FactorStore
from .core.geometry import get_kernel
from .core.hmatrix import HMatrix, block_groups
from .models.encdec import DecLayer, EncDec, EncLayer
from .models.layers import MLP, Attention, Norm
from .models.lm import LM, Block, RecurrentBlock
from .models.mamba2 import Mamba
from .models.moe import MoE
from .models.xlstm import MLSTM, SLSTM


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
                   groups=block_groups(plan, dev, int(arrays["k"])))


def _norm(tree: dict, t) -> Norm:
    return Norm(t(tree["w"]), t(tree["b"]) if "b" in tree else None)


def _attention(tree: dict, t) -> Attention:
    return Attention(*(t(tree[name]) for name in ("wq", "wk", "wv", "wo")),
                     **{name: t(tree[name]) for name in ("bq", "bk", "bv") if name in tree})


def _mlp(tree: dict, t) -> MLP:
    return MLP(t(tree["wu"]), t(tree["wd"]), wg=t(tree["wg"]) if "wg" in tree else None)


# the mixers of the recurrent kinds: their class and ``repro``'s leaf names in order
_MIXERS = {"mamba": (Mamba, ("w_in", "w_out", "a_log", "d_skip", "dt_bias")),
           "mlstm": (MLSTM, ("w_up", "wq", "wk", "wv", "w_if", "w_down", "f_bias")),
           "slstm": (SLSTM, ("w_x", "r_h", "bias", "w_out"))}


def _block(tree: dict, t, kind: str = "dense"):
    if kind in _MIXERS:
        cls, names = _MIXERS[kind]
        return RecurrentBlock(kind, _norm(tree["ln"], t),
                              cls(*(t(tree[kind][name]) for name in names)))
    mlp, moe = tree.get("mlp"), tree.get("moe")
    return Block(_norm(tree["ln1"], t), _attention(tree["attn"], t), _norm(tree["ln2"], t),
                 None if mlp is None else _mlp(mlp, t),
                 None if moe is None else MoE(*(t(moe[n]) for n in ("router", "wg", "wu", "wd"))))


def layer_source(cfg, i: int) -> tuple:
    """Where ``repro`` keeps decoder-only layer ``i``: ``("pattern", pos,
    period)``, entry ``period`` of the stack at pattern position ``pos``, for
    the layers before the tail, else ``("tail", j)``."""
    pattern = cfg.block_pattern
    stacked = (cfg.n_layers // len(pattern)) * len(pattern)
    if i < stacked:
        return "pattern", i % len(pattern), i // len(pattern)
    return "tail", i - stacked


def repro_path(cfg, name: str) -> tuple:
    """``(path, periods)``: ``repro``'s pytree path (``"pattern/0/attn/wq"``)
    of the port's parameter ``name`` (``"layers.0.attn.wq"``) and the length
    of the stack on its leading axis that the port's tensor is one entry of
    (``None`` for a leaf ``repro`` keeps whole).  The leaf names below a block
    are the port's attribute names, the mapping ``lm_params_from_arrays``
    reads ``repro``'s trees by."""
    parts = name.split(".")
    if cfg.is_encoder_decoder and parts[0] in ("enc_layers", "dec_layers"):
        periods = cfg.n_enc_layers if parts[0] == "enc_layers" else cfg.n_layers
        return "/".join([parts[0]] + parts[2:]), periods
    if not cfg.is_encoder_decoder and parts[0] == "layers":
        source = layer_source(cfg, int(parts[1]))
        if source[0] == "pattern":
            periods = cfg.n_layers // len(cfg.block_pattern)
            return "/".join(["pattern", str(source[1])] + parts[2:]), periods
        return "/".join(["tail", str(source[1])] + parts[2:]), None
    return "/".join(parts), None


def _sliced(tree, index):
    """Entry ``index`` of every leaf of a tree stacked on its leading axis."""
    if isinstance(tree, dict):
        return {key: _sliced(val, index) for key, val in tree.items()}
    return tree[index]


def lm_params_from_arrays(arrays: dict, cfg, *, device):
    """The port's model holding ``repro``'s parameters.

    For a decoder-only config, ``arrays`` is ``repro.models.lm.init_params(key,
    cfg)`` with every leaf a NumPy array: ``embed``, ``final_norm/w``,
    ``lm_head`` (untied), per pattern position ``pattern[pos]`` with the
    periods stacked on the leading axis (``{}`` at a ``shared_attn``
    position), ``shared`` (the ``shared_attn`` block) and ``tail`` blocks.
    Layer ``i`` is period ``i // len(pattern)`` of position ``i %
    len(pattern)``, then the tail.  For an encoder-decoder config it is
    ``repro.models.encdec.init_params``'s tree (``enc_layers`` and
    ``dec_layers`` stacked on the leading axis).  Tensors keep the arrays'
    dtype (NumPy has no bfloat16: hand bfloat16 parameters over as float32).
    """
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    if cfg.is_encoder_decoder:
        return _encdec_from_arrays(arrays, cfg, t)

    def layer_tree(i):
        source = layer_source(cfg, i)
        if source[0] == "pattern":
            return _sliced(arrays["pattern"][source[1]], source[2])
        return arrays["tail"][source[1]]

    layers = [torch.nn.Module() if kind == "shared_attn" else _block(layer_tree(i), t, kind)
              for i, kind in enumerate(cfg.layer_kinds)]
    shared = _block(arrays["shared"], t) if "shared" in arrays else None
    head = None if cfg.tie_embeddings else t(arrays["lm_head"])
    return LM(cfg, t(arrays["embed"]), _norm(arrays["final_norm"], t), head, layers, shared)


def _encdec_from_arrays(arrays: dict, cfg, t) -> EncDec:
    enc = [_sliced(arrays["enc_layers"], i) for i in range(cfg.n_enc_layers)]
    dec = [_sliced(arrays["dec_layers"], i) for i in range(cfg.n_layers)]
    return EncDec(
        cfg,
        [EncLayer(_norm(lp["ln1"], t), _attention(lp["attn"], t), _norm(lp["ln2"], t),
                  _mlp(lp["mlp"], t)) for lp in enc],
        [DecLayer(_norm(lp["ln1"], t), _attention(lp["self_attn"], t), _norm(lp["ln_x"], t),
                  _attention(lp["cross_attn"], t), _norm(lp["ln2"], t), _mlp(lp["mlp"], t))
         for lp in dec],
        t(arrays["embed"]), t(arrays["dec_pos"]), _norm(arrays["enc_norm"], t),
        _norm(arrays["dec_norm"], t))


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
