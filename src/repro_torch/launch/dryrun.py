"""Dry run: count every (arch x shape x mesh) cell's step on fake tensors
(``repro.launch.dryrun`` in PyTorch).

For each cell this builds the step of the cell's kind -- ``make_train_step``
(with ``MICROBATCHES`` and remat), ``make_prefill_step`` or
``make_decode_step`` -- on fake tensors (``launch.specs``: nothing is
allocated), runs it under ``analysis.opcount`` and reports, per mesh: the
traced FLOPs and HBM traffic per chip (the whole step's count divided
evenly by the chips), ``analysis.flops``' model FLOPs and their ratio, the
bytes per device of parameters, optimizer state, caches and batch under the
resolved specs (a leaf's bytes divided by the sizes of its sharded axes),
the roofline terms (``analysis.roofline``) and the trace seconds.  A JSON
record per cell and mesh goes to ``results/dryrun_torch/``.  ``repro``
compiles each cell for 256 or 512 chips and reads the HLO; the port has no
such compiler, so its twin counts the eager program (``analysis.opcount``).

Scaling, the twin of ``repro``'s HLO analyzer multiplying a ``while`` body
by its trip count: a full-depth trace of a 48-layer model would take
minutes, so each cell is traced at zero and at one period of its
``block_pattern`` (one and two for the encoder-decoder, whose period is one
encoder and one decoder layer, and where the pattern shares a block across
periods), each with its tail, with one and with two microbatches of the
cell's microbatch size (train), and, for a pattern with sLSTM's per-token
loop (prefill, train), at sequences of one and two ``ssm_chunk`` (a train
step: two, three and four).  Every count is a polynomial of known degree in
each of these (see ``scaling_axes``), so the traces determine it exactly at
the cell's depth, microbatch count and length (Lagrange extrapolation in
exact integers); ``tests/test_torch_dryrun.py`` holds the extrapolation
against full traces.

What it does not see: activations and temporaries are not modelled (their
bytes are ``null``, never 0); ``collective_bytes`` is ``null``, since a
single-process trace has no collectives (the roofline then has no
collective term); and on fake CPU tensors every ``kernels/*/ops.py``
dispatcher takes its plain version, so H-attention's near field is counted
as the plain version's arithmetic, the work kernel #11 does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import time
import traceback
from fractions import Fraction
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..analysis.flops import attention_extra_flops, model_flops
from ..analysis.opcount import ModuleStats, count_ops
from ..analysis.roofline import roofline_terms
from ..configs.base import SHAPES, ShapeConfig, shape_applicable
from ..configs.registry import get_arch, get_shape, iter_cells, list_archs
from ..models.api import count_params_analytic, get_model
from ..parallel.mesh_ctx import entry_axes, resolve_spec, use_mesh
from ..parallel.sharding import opt_state_specs, param_specs
from ..serve.step import make_decode_step, make_prefill_step
from ..train.optimizer import AdamWConfig
from ..train.step import make_train_step
from .mesh import make_production_mesh
from .specs import (cache_specs, decode_input_specs, prefill_input_specs,
                    state_struct_and_specs, train_input_specs)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# Microbatch counts chosen so per-device activation residency fits 16 GB HBM
# (remat keeps one microbatch x one layer live), as ``repro``'s.
MICROBATCHES = {
    "whisper-tiny": 1, "smollm-135m": 2, "granite-moe-1b-a400m": 2,
    "gemma-7b": 8, "phi3-medium-14b": 8, "qwen2.5-14b": 8,
    "qwen2.5-14b-hmatrix": 8, "mixtral-8x7b": 32, "chameleon-34b": 16,
    "xlstm-1.3b": 4, "zamba2-7b": 8,
}
NOT_MODELLED = "activations and temporaries are not modelled"


# ---------------------------------------------------------------------------
# Traces and their extrapolation
# ---------------------------------------------------------------------------


def depth_split(cfg) -> tuple:
    """``(periods, tail)``: whole periods of ``block_pattern`` and the layers
    after them (the encoder-decoder: one encoder and one decoder layer a
    period, no tail)."""
    if cfg.is_encoder_decoder:
        if cfg.n_enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: the dry run scales encoder and decoder together "
                             f"and needs as many of each ({cfg.n_enc_layers}, {cfg.n_layers})")
        return cfg.n_layers, 0
    periods = cfg.n_layers // len(cfg.block_pattern)
    return periods, cfg.n_layers - periods * len(cfg.block_pattern)


def at_depth(cfg, periods: int):
    """``cfg`` cut to ``periods`` periods, with its tail."""
    if cfg.is_encoder_decoder:
        return cfg.replace(n_layers=periods, n_enc_layers=periods)
    return cfg.replace(n_layers=periods * len(cfg.block_pattern) + depth_split(cfg)[1])


def trace_step(cfg, kind: str, batch: int, seq: int, microbatches: int = 1) -> ModuleStats:
    """The counts of one step of ``kind`` for ``cfg`` on fake tensors (a
    train step's ``batch`` splits into ``microbatches``)."""
    shape = ShapeConfig("trace", seq, batch, kind)
    with FakeTensorMode():
        if kind == "train":
            init_state, train_step = make_train_step(cfg, AdamWConfig(),
                                                     microbatches=microbatches, remat=True,
                                                     device="cpu")
            state = init_state(torch.Generator())
            inputs, _ = train_input_specs(cfg, shape)
            return count_ops(train_step, state, inputs)
        params = get_model(cfg, "cpu")["init_params"](torch.Generator())
        if kind == "prefill":
            inputs, _ = prefill_input_specs(cfg, shape)
            return count_ops(make_prefill_step(cfg), params, inputs["tokens"],
                             inputs.get("embeds"))
        inputs, _ = decode_input_specs(cfg, shape)
        return count_ops(make_decode_step(cfg), params, inputs["tokens"], inputs["caches"],
                         inputs["cache_len"])


def scaling_axes(cfg, shape: ShapeConfig, microbatches: int) -> list:
    """``[(name, points, target)]``: the traced points of each axis the
    counts are a polynomial in, and the cell's value.  Periods and
    microbatches enter affinely.  So does the length of sLSTM's per-token
    loop in a forward pass; a backward pass adds a part quadratic in it (the
    gradient of each step's slice of the sequence is a whole-sequence buffer),
    so a train step takes three points, from two chunks on (a sequence of one
    chunk takes other views)."""
    # no period at all, and one; one and two where a step needs a period:
    # a block shared across periods exists only with one, and without a
    # decoder layer the encoder's output (and its gradient) goes unused
    one_up = cfg.is_encoder_decoder or "shared_attn" in cfg.block_pattern
    periods = (1, 2) if one_up else (0, 1)
    axes = [("periods", periods, depth_split(cfg)[0])]
    if shape.kind == "train":
        axes.append(("microbatches", (1, 2), microbatches))
    c = cfg.ssm_chunk
    if shape.kind != "decode" and "slstm" in cfg.layer_kinds and shape.seq_len % c == 0:
        axes.append(("seq", (2 * c, 3 * c, 4 * c) if shape.kind == "train" else (c, 2 * c),
                     shape.seq_len))
    return axes


def _weights(points: tuple, x: int) -> list:
    """``[(point, Lagrange weight at x)]``, exact; just ``x`` when traced."""
    if x in points:
        return [(x, Fraction(1))]
    return [(p, math.prod(Fraction(x - q, p - q) for q in points if q != p)) for p in points]


def cell_counts(cfg, shape: ShapeConfig, microbatches: int = 1) -> ModuleStats:
    """The cell's counts, extrapolated from traces at the points of
    :func:`scaling_axes` (exact integers)."""
    axes = scaling_axes(cfg, shape, microbatches)
    mb_size = shape.global_batch // microbatches
    flops = traffic = Fraction(0)
    traced_at = []
    for corner in itertools.product(*(_weights(points, x) for _, points, x in axes)):
        point = {name: v for (name, *_), (v, _) in zip(axes, corner)}
        weight = math.prod(w for _, w in corner)
        m = point.get("microbatches", 1)
        st = trace_step(at_depth(cfg, point["periods"]), shape.kind,
                        mb_size * m if shape.kind == "train" else shape.global_batch,
                        point.get("seq", shape.seq_len), m)
        flops += weight * st.dot_flops
        traffic += weight * st.traffic_bytes
        traced_at.append(point)
    if flops.denominator != 1 or traffic.denominator != 1:
        raise AssertionError(f"{cfg.name}: extrapolated counts are not integers")
    body = {"periods": "period of block_pattern", "microbatches": "microbatch",
            "seq": "token (sLSTM's per-token loop)"}
    return ModuleStats(dot_flops=int(flops), traffic_bytes=int(traffic),
                       loops=[{"body": body[name], "trip": x, "traced": list(points)}
                              for name, points, x in axes] + [{"traced_at": traced_at}])


# ---------------------------------------------------------------------------
# Bytes per device
# ---------------------------------------------------------------------------


def _divisor(spec, mesh) -> int:
    entries = tuple(spec) + (getattr(spec, "stack", None),)
    return math.prod(mesh.shape[a] for e in entries for a in entry_axes(e))


def _paired(tree, specs):
    """``[(tensor, spec)]`` of a tree and its spec tree."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [pair for key in tree for pair in _paired(tree[key], specs[key])]
    if isinstance(tree, (list, tuple)):
        return [pair for t, s in zip(tree, specs) for pair in _paired(t, s)]
    return []


def device_bytes(pairs, mesh) -> int:
    """Bytes a device holds of ``[(tensor, spec)]``, each spec resolved
    against ``mesh`` (the active mesh)."""
    return sum(t.numel() * t.element_size() // _divisor(resolve_spec(t.shape, spec), mesh)
               for t, spec in pairs)


def cell_structs(cfg, shape: ShapeConfig, microbatches: int) -> dict:
    """The cell's full-depth stand-ins, ``{part: (tree, specs)}``: ``specs()``
    gives the part's spec tree under the active mesh."""
    ne = cfg.num_experts
    if shape.kind == "train":
        init_state, _ = make_train_step(cfg, AdamWConfig(), microbatches=microbatches,
                                        remat=True, device="cpu")
        state, _ = state_struct_and_specs(cfg, init_state)
        params = state["params"]
        batch, batch_specs = train_input_specs(cfg, shape)
        return {"params": (dict(params.named_parameters()), lambda: param_specs(params, ne)),
                "opt_state": (state["opt"],
                              lambda: {k: opt_state_specs(params, ne) for k in state["opt"]}),
                "batch": (batch, lambda: batch_specs)}
    with FakeTensorMode():
        params = get_model(cfg, "cpu")["init_params"](torch.Generator())
    parts = {"params": (dict(params.named_parameters()), lambda: param_specs(params, ne))}
    if shape.kind == "prefill":
        inputs, in_specs = prefill_input_specs(cfg, shape)
        parts["batch"] = (inputs, lambda: in_specs)
    else:
        inputs, in_specs = decode_input_specs(cfg, shape)
        caches = inputs["caches"]
        parts["caches"] = (caches, lambda: cache_specs(cfg, caches, shape.global_batch))
        parts["batch"] = ({"tokens": inputs["tokens"]}, lambda: {"tokens": in_specs["tokens"]})
    return parts


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def analyze_cell(arch_name: str, shape_name: str, meshes=(False,), overrides=None,
                 tag: str = "") -> list:
    """Records of one cell, one per mesh (``False``: the (16, 16) single-pod
    mesh, ``True``: the (2, 16, 16) multi-pod one); the trace is shared."""
    cfg = get_arch(arch_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = get_shape(shape_name)
    base = {"arch": arch_name, "shape": shape_name, "tag": tag}
    runs, reason = shape_applicable(cfg, shape)
    if not runs:
        return [dict(base, mesh="multi" if m else "single", skipped=True, reason=reason)
                for m in meshes]
    mb = MICROBATCHES.get(arch_name, 4) if shape.kind == "train" else 1
    try:
        t0 = time.perf_counter()
        stats = cell_counts(cfg, shape, mb)
        trace_s = time.perf_counter() - t0
        parts = cell_structs(cfg, shape, mb)
    except Exception as e:
        traceback.print_exc()
        return [dict(base, mesh="multi" if m else "single",
                     error="".join(traceback.format_exception_only(e)).strip()) for m in meshes]
    mf = model_flops(cfg, shape) + attention_extra_flops(cfg, shape)
    records = []
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        chips = mesh.size
        with use_mesh(mesh):
            by_part = {part: device_bytes(_paired(tree, specs()), mesh)
                       for part, (tree, specs) in parts.items()}
        by_part.setdefault("caches", 0)
        by_part.setdefault("opt_state", 0)
        by_part.update(activations=None, note=NOT_MODELLED)
        terms = roofline_terms(flops_per_chip=stats.dot_flops / chips,
                               hbm_bytes_per_chip=stats.traffic_bytes / chips,
                               collective_bytes_per_chip=None,
                               model_flops_per_chip=mf / chips)
        records.append(dict(
            base, mesh="multi" if multi else "single", skipped=False, chips=chips,
            microbatches=mb, trace_s=trace_s,
            traced={"dot_flops": stats.dot_flops, "traffic_bytes": stats.traffic_bytes,
                    "collective_bytes": None, "loops": stats.loops},
            traced_flops_per_chip=stats.dot_flops / chips,
            model_flops_global=mf, model_flops_per_chip=mf / chips,
            model_to_traced_flops=mf / stats.dot_flops if stats.dot_flops else None,
            params=count_params_analytic(cfg), bytes_per_device=by_part,
            roofline=terms.as_dict()))
    return records


def save_record(record: dict) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"-{record['tag']}" if record.get("tag") else ""
    path = RESULTS_DIR / f"{record['arch']}--{record['shape']}--{record['mesh']}{tag}.json"
    path.write_text(json.dumps(record, indent=1, default=float))
    return path


def status_line(rec: dict) -> str:
    if rec.get("skipped"):
        return "SKIP: " + rec.get("reason", "")
    if "error" in rec:
        return "ERROR: " + rec["error"][:120]
    b = rec["bytes_per_device"]
    return (f"ok trace={rec['trace_s']:.1f}s flops/chip={rec['traced_flops_per_chip']:.4e} "
            f"model/chip={rec['model_flops_per_chip']:.4e} "
            f"ratio={rec['model_to_traced_flops']:.3f} bytes/dev params={b['params']} "
            f"opt={b['opt_state']} caches={b['caches']} batch={b['batch']} "
            f"dom={rec['roofline']['dominant']}")


def run(cells, meshes, tag: str = "", save: bool = True, log=print) -> list:
    """Analyze ``cells`` ([(arch, shape)]) on ``meshes``; returns the records."""
    out = []
    for arch_name, shape_name in cells:
        t0 = time.perf_counter()
        for rec in analyze_cell(arch_name, shape_name, meshes, tag=tag):
            if save:
                save_record(rec)
            out.append(rec)
            log(f"[{time.perf_counter() - t0:7.1f}s] {arch_name:24s} {shape_name:12s} "
                f"{rec['mesh']:6s} {status_line(rec)}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]
    if args.all:
        cells = [(arch.name, shape.name) for arch, shape, _, _ in iter_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    return run(cells, meshes, tag=args.tag)


if __name__ == "__main__":
    main()
