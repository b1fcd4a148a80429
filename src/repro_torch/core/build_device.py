"""On-device H-matrix construction (paper Algorithms 1, 4, 6 and 7).

Port of ``repro.core.build_device``.  ``build_hmatrix`` sorts on the device
but walks the block cluster tree on the host (``block_tree``, NumPy);
:func:`build_hmatrix_device` keeps every stage on the device:

* Alg. 6, Morton codes and the Z-order sort: the encode kernel
  (``kernels/morton``) and a stable ``torch.sort`` on the int64 code;
* Alg. 7, bounding boxes: a reshape-reduce per level (the balanced tree);
* Algs. 1 and 4, the block cluster tree: the frontier of one level lives in
  two index tensors; admissibility is one vectorised box test and the
  frontier advances by count -> exclusive scan -> compact;
* the factors: one batched ACA launch per admissible level group
  (``kernels/batched_aca.batched_aca_level``), reading the cluster points
  from the tree-ordered array.

Frontier sizes.  ``repro`` gives every level the static capacity 4^level,
because a jitted program needs static shapes.  Here the host reads ONE
pair of counts per level (admissible, splitting) and sizes the next
frontier exactly: n_levels + 1 small reads (10 for the paper's problem),
and memory in proportion to the blocks that exist, where 4^level would
grow to 4^16 slots at N = 2^24, c_leaf = 256.

The plan, permutation, points and boxes equal the host builder's exactly:
the same exact operations (sort, gathers, min / max, the box test summed in
NumPy's order with a float32 ``eta``) in the same order.  With
``use_kernels=False`` the Morton code comes from ``core.morton`` and the
factors from ``core.aca`` (expansion-form entries), so the whole H-matrix is
bit-identical to ``build_hmatrix``'s on any device; the kernel route's
factors use the kernels' direct-difference entries and are held by
reconstruction error.

Chaos containment: with a chaos spec (``chaos=`` or the ``REPRO_CHAOS``
env twin) every stage launch (the plan program, each level group's ACA)
runs under the serving stack's ``FaultInjector``: raised injected faults
are retried with backoff, and a NaN-poisoned stage is run once more, the
same function again, and counted.  ``BuildReport`` carries ``retries``,
``fallback_launches`` and ``faults_injected``; a tenant onboarded from raw
coordinates (``serve.tenancy.apply_tenant``) builds under the same envelope
it serves under.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import _build
from .._device import as_f32, require_full_fp32, resolve_device
from .admissibility import admissible
from .block_tree import HMatrixPlan
from .clustering import ClusterTree, _level_bounding_boxes, next_pow2
from .factor_store import FactorStore, recompress_store
from .geometry import get_kernel, kernel_name_of
from .hmatrix import HMatrix, block_groups, level_factors
from .morton import morton_encode as morton_encode_plain


def _compact(mask: torch.Tensor, pos: torch.Tensor, count: int, *values: torch.Tensor):
    """The entries of ``values`` where ``mask`` holds, in order, placed at
    their exclusive-scan positions ``pos``; the others go to a spare slot."""
    idx = torch.where(mask, pos, torch.full_like(pos, count))
    out = []
    for v in values:
        dst = torch.empty((count + 1,), dtype=v.dtype, device=v.device)
        dst.scatter_(0, idx, v)
        out.append(dst[:count])
    return out


def _plan_program(coords: torch.Tensor, *, n_pad: int, n_levels: int, eta: float,
                  use_kernels: bool):
    """Sort, boxes and block-cluster-tree traversal on the device.

    Returns ``(sorted_pts, perm, bb_min, bb_max, meta, counts)``: ``meta`` is
    one int32 device tensor with the (row, col) ids of the admissible blocks
    per level and then of the dense leaves, ``counts`` the host list of their
    numbers (``n_levels + 2`` entries), as :func:`_assemble_plan` takes them.
    """
    n, d = coords.shape
    lo, hi = coords.amin(dim=0), coords.amax(dim=0)
    unit = (coords - lo) / torch.clamp(hi - lo, min=1e-30)
    if use_kernels:
        from ..kernels.morton.ops import morton_encode
        code = morton_encode(unit)
    else:
        code = morton_encode_plain(unit)
    perm = torch.sort(code, stable=True).indices
    spts = coords[perm]
    if n_pad > n:
        spts = torch.cat([spts, spts[-1:].expand(n_pad - n, d)], dim=0)
    spts = spts.contiguous()
    bb_min, bb_max = _level_bounding_boxes(spts, n_levels)

    dev = coords.device
    fr = torch.zeros((1,), dtype=torch.int64, device=dev)
    fc = torch.zeros((1,), dtype=torch.int64, device=dev)
    counts = [0] * (n_levels + 2)
    blocks: list[torch.Tensor] = []
    dense: list[torch.Tensor] = []
    for level in range(n_levels + 1):
        bmn, bmx = bb_min[level], bb_max[level]
        adm = admissible(bmn[fr], bmx[fr], bmn[fc], bmx[fc], eta)
        # count -> exclusive scan -> compact, for both outcomes at once
        flag = adm.to(torch.int64)
        pos_adm = torch.cumsum(flag, 0) - flag
        pos_split = torch.arange(flag.shape[0], device=dev) - pos_adm
        n_adm = int(pos_adm[-1] + flag[-1])
        n_split = flag.shape[0] - n_adm
        counts[level] = n_adm
        blocks += _compact(adm, pos_adm, n_adm, fr, fc)
        if level == n_levels:
            counts[-1] = n_split
            dense = _compact(~adm, pos_split, n_split, fr, fc)
            break
        if n_split == 0:
            break
        r, c = _compact(~adm, pos_split, n_split, fr, fc)
        # each splitting block emits its 4 children (2r + a, 2c + b) in
        # quadrant order, as the host traversal does
        quad = torch.arange(4, dtype=torch.int64, device=dev)
        fr = (2 * r[:, None] + quad[None, :] // 2).reshape(-1)
        fc = (2 * c[:, None] + quad[None, :] % 2).reshape(-1)
    meta = torch.cat([b.to(torch.int32) for b in blocks + dense])
    return spts, perm, bb_min, bb_max, meta, counts


def _assemble_plan(meta: np.ndarray, counts: list, c_leaf: int, n_pad: int,
                   n_levels: int, eta: float) -> HMatrixPlan:
    """Slice the fetched metadata vector into the host-layout plan."""
    aca_levels: dict[int, np.ndarray] = {}
    off = 0
    for level in range(n_levels + 1):
        cnt = counts[level]
        if cnt > 0:
            aca_levels[level] = np.stack([meta[off:off + cnt], meta[off + cnt:off + 2 * cnt]],
                                         axis=1).astype(np.int32)
        off += 2 * cnt
    cnt = counts[-1]
    dense = np.stack([meta[off:off + cnt], meta[off + cnt:off + 2 * cnt]],
                     axis=1).astype(np.int32).reshape(-1, 2)
    return HMatrixPlan(aca_levels=aca_levels, dense_blocks=dense, c_leaf=c_leaf,
                       n_pad=n_pad, n_levels=n_levels, eta=eta)


def _contained_stage(name: str, fn: Callable, chaos_spec, retry, rng, counters: dict,
                     device: torch.device):
    """Run ``fn`` as ONE construction launch under the chaos envelope.

    As the serving containment: raised injected faults are retried with
    exponential backoff up to ``retry.max_attempts``; a NaN-poisoned launch
    shows on a scalar health token on ``device`` and is answered by running
    ``fn`` once more, counted in ``fallback_launches``.  The real outputs
    travel in ``box`` because the poison fills whatever the launch returns.
    """
    if chaos_spec is None:
        return fn()
    from ..serve.faults import FaultInjector, InjectedFault     # serving layer: lazy
    injector = FaultInjector(chaos_spec, name)
    box: dict = {}

    def launch(_panel):
        box["out"] = fn()
        return torch.zeros((), device=device)       # health token

    wrapped = injector.wrap(launch)
    attempts = 0
    try:
        while True:
            attempts += 1
            try:
                token = wrapped(None)
            except InjectedFault:
                if retry is not None and attempts < retry.max_attempts:
                    counters["retries"] += 1
                    time.sleep(retry.delay_s(attempts, rng))
                    continue
                raise
            if not bool(torch.isfinite(token)):
                counters["fallback_launches"] += 1
                box["out"] = fn()                   # the one relaunch
            return box["out"]
    finally:
        faults = counters["faults_injected"]
        for kind, hits in injector.counters.items():
            if hits:
                faults[kind] = faults.get(kind, 0) + hits


def _fresh_counters() -> dict:
    return {"retries": 0, "fallback_launches": 0, "faults_injected": {}}


def _resolve_containment(chaos):
    """Chaos spec, retry policy and jitter stream of the build's launches."""
    from ..serve.faults import RetryPolicy, resolve_chaos      # serving layer: lazy
    spec = resolve_chaos(chaos)
    if spec is None:
        return None, None, None
    return spec, RetryPolicy(), random.Random(spec.seed)


def compute_factors_device(tree: ClusterTree, plan: HMatrixPlan, kernel: str | Callable,
                           k: int, groups: dict, use_kernels: bool = True, chaos=None,
                           _counters: dict | None = None) -> dict:
    """One batched ACA launch per admissible level group (paper §5.4.1).

    The kernel reads each group's cluster points from the tree-ordered
    ``tree.points`` by cluster id.  ``use_kernels=False`` is
    ``hmatrix.compute_factors``: bit-identical to the host builder's factors.
    With ``chaos`` each group's launch runs under the chaos envelope.
    """
    kname = kernel_name_of(kernel)
    kfn = get_kernel(kname)
    chaos_spec, retry, rng = _resolve_containment(chaos)
    counters = _counters if _counters is not None else _fresh_counters()
    if use_kernels:
        from ..kernels.batched_aca.ops import batched_aca_level

    def group_factors(level):
        g = groups[level]
        if use_kernels:
            return batched_aca_level(tree.points, g.rows, g.cols, level, kname, k)
        return level_factors(tree, level, g, kfn, k)

    return {level: _contained_stage(f"build:factors:{level}",
                                    lambda level=level: group_factors(level),
                                    chaos_spec, retry, rng, counters, tree.points.device)
            for level in plan.aca_levels}


def eval_dense_leaves(hm: HMatrix) -> torch.Tensor:
    """Every inadmissible leaf block, ``(n_dense, c_leaf, c_leaf)`` in
    ``plan.dense_blocks`` order, in one batched evaluation.

    The apply never stores these (the dense leaves are generated on the fly,
    §5.4.2); this is the dense half of assembly for tests and measurements.
    """
    c = hm.plan.c_leaf
    g = hm.groups["dense"]
    pts = hm.tree.points.reshape(hm.plan.n_pad // c, c, -1)
    return hm.kernel(pts[g.rows], pts[g.cols])


@dataclass
class BuildReport:
    """Stage timings and launch counts of one device build."""

    n: int
    n_pad: int
    n_levels: int
    plan_s: float                   # sort, boxes, traversal, plan fetch, block groups
    factors_s: float                # batched ACA level-group launches
    total_s: float
    launches: int                   # hand-written kernel launches (``_build.LAUNCHES``)
    num_aca_blocks: int
    num_dense_blocks: int
    recompress_s: float = 0.0       # build-time recompression pass (``recompress_tol``)
    retries: int = 0                # chaos containment: injected faults retried,
    fallback_launches: int = 0      # NaN-poisoned stages run again,
    faults_injected: dict = field(default_factory=dict)    # and injections by kind


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_hmatrix_device(coords, kernel: str | Callable = "gaussian", k: int = 16,
                         c_leaf: int = 256, eta: float = 1.5, precompute: bool = False,
                         use_kernels: bool = True, chaos=None,
                         recompress_tol: float | None = None, device=None) -> HMatrix:
    """Device-side H-matrix construction, a drop-in for ``build_hmatrix``.

    ``device=None`` means CUDA and raises ``RuntimeError`` when there is no
    card.  See :func:`build_hmatrix_device_report` for the stage times.
    """
    hm, _ = build_hmatrix_device_report(
        coords, kernel=kernel, k=k, c_leaf=c_leaf, eta=eta, precompute=precompute,
        use_kernels=use_kernels, chaos=chaos, recompress_tol=recompress_tol, device=device)
    return hm


def build_hmatrix_device_report(
        coords, kernel: str | Callable = "gaussian", k: int = 16, c_leaf: int = 256,
        eta: float = 1.5, precompute: bool = False, use_kernels: bool = True, chaos=None,
        recompress_tol: float | None = None, device=None) -> tuple[HMatrix, BuildReport]:
    """Build on the device and return ``(hmatrix, report)``.

    ``use_kernels`` routes the Morton code and the factors through the CUDA
    kernels (their plain versions for CPU tensors); ``False`` takes
    ``core.morton`` and ``core.aca``, the host builder's own functions.
    ``recompress_tol`` truncates the fresh store (``recompress_store``, the
    kernel with ``use_kernels``, else the QR + SVD oracle); its wall time is
    ``report.recompress_s``.  ``chaos`` (``None`` defers to ``REPRO_CHAOS``)
    runs every stage launch under the chaos envelope; the report counts its
    retries, relaunches and injected faults.
    """
    dev = resolve_device(device)
    require_full_fp32("build_hmatrix_device", dev)
    kname = kernel_name_of(kernel)
    pts = as_f32(coords, dev)
    n = pts.shape[0]
    if c_leaf & (c_leaf - 1):
        raise ValueError("c_leaf must be a power of two")
    n_pad = max(next_pow2(n), c_leaf)
    n_levels = (n_pad // c_leaf).bit_length() - 1
    launches_before = sum(_build.LAUNCHES.values())
    chaos_spec, retry, rng = _resolve_containment(chaos)
    counters = _fresh_counters()

    _sync(dev)
    t0 = time.perf_counter()
    spts, perm, bb_min, bb_max, meta, counts = _contained_stage(
        "build:plan",
        lambda: _plan_program(pts, n_pad=n_pad, n_levels=n_levels, eta=eta,
                              use_kernels=use_kernels),
        chaos_spec, retry, rng, counters, dev)
    plan = _assemble_plan(meta.cpu().numpy(), counts, c_leaf, n_pad, n_levels, eta)
    tree = ClusterTree(points=spts, perm=perm, n=n, n_pad=n_pad, c_leaf=c_leaf,
                       n_levels=n_levels, bb_min=bb_min, bb_max=bb_max)
    groups = block_groups(plan, dev, k)
    _sync(dev)
    t1 = time.perf_counter()

    factors = None
    if precompute:
        factors = FactorStore.from_factors(
            compute_factors_device(tree, plan, kname, k, groups, use_kernels, chaos=chaos_spec,
                                   _counters=counters), plan=plan)
    _sync(dev)
    t2 = time.perf_counter()
    recompress_s = 0.0
    if factors is not None and recompress_tol is not None:
        recompress_store(factors, recompress_tol, use_kernels=use_kernels)
        _sync(dev)
        recompress_s = time.perf_counter() - t2

    hm = HMatrix(tree=tree, plan=plan, kernel=get_kernel(kname), kernel_name=kname, k=k,
                 factors=factors, groups=groups)
    report = BuildReport(n=n, n_pad=n_pad, n_levels=n_levels, plan_s=t1 - t0,
                         factors_s=t2 - t1, total_s=t2 - t0 + recompress_s,
                         launches=sum(_build.LAUNCHES.values()) - launches_before,
                         num_aca_blocks=plan.num_aca_blocks,
                         num_dense_blocks=plan.num_dense_blocks, recompress_s=recompress_s,
                         retries=counters["retries"],
                         fallback_launches=counters["fallback_launches"],
                         faults_injected=counters["faults_injected"])
    return hm, report
