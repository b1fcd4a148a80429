"""Sharded multi-device execution of the H-matrix apply and solve.

Port of ``repro.parallel.hshard``: the batched executors of
``repro_torch.core.hmatrix`` and ``repro_torch.solve`` spread over the
devices of a :class:`~repro_torch.parallel.mesh_ctx.PanelMesh`.  One process
drives every device: each shard's work is issued on its device's current
stream, so the shards of distinct cards run at the same time, and shards
that name the same device run one after the other (how one card, or the
CPU, runs a sharded executor with several shards).  Two shardings:

Row sharding (``shard="rows"``, the apply's default).  Each level group's
block list and the dense leaves' block list are split into ``n_dev``
contiguous shares by block index (equal or one less: no dummy blocks, which
``repro`` needs only because ``shard_map`` wants static shapes); each shard
computes the partial ``Z`` of its blocks, in P mode from its slice of the
stored factors, in NP mode recomputing them by the batched ACA, and the
partials are summed on ``hm.device`` in shard order, so that two applies
give the same bits.  Each shard evaluates a share of the blocks, at any R.

Column sharding (``shard="columns"``, ``repro``'s default, and the
solver's).  The panel ``X: (N, R)`` is padded with zero columns to a
multiple of the shard count and split along R; every shard runs the whole
tree-ordered apply on its ``(n_pad, R / n_dev)`` slice on its device, and
the slices are gathered back onto ``hm.device``.  No exchange between
shards in the apply, but every shard evaluates every block's kernel entries
(the dense leaves' kernel does not get cheaper with fewer columns), so on
an H100 a column-sharded apply cost about ``n_dev`` unsharded applies on
one card and lost to the unsharded apply on four (``PERF.md``, cell M),
where row shards gained.  The PCG solve steps every shard's columns in
lockstep: each trip issues every shard's step before the host reads "is any
column of any shard active" once, so every shard runs the same trip count;
padded columns start converged.

The points are copied to each distinct device of the mesh once, when the
executor is made, and a device named several times shares them; so do the
factors, block tables and block-Jacobi factors of a column shard, while a
row shard holds its own slice of the factors and its own block tables.
The executors capture the factor store when they are made, as ``repro``'s
do: a spilled store raises there, and spilling or recompressing the store
later does not retarget them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from .._device import require_full_fp32
from ..core.block_tree import HMatrixPlan
from ..core.clustering import permute_from_tree, permute_to_tree
from ..core.hmatrix import HMatrix, apply_in_tree_order, block_groups, operand, panel_entry
from .mesh_ctx import PanelMesh, check_mesh, map_shards


def make_panel_mesh(n_devices: int | None = None, devices=None) -> PanelMesh:
    """A one-axis ("data") mesh.

    ``devices`` lists the shards' devices explicitly and may repeat one
    (``("cuda:0",) * 4``, ``("cpu",) * 4``).  Without it the mesh is the first
    ``n_devices`` visible CUDA devices (default all); asking for more than
    are visible raises, as does a machine with no CUDA device.
    """
    if devices is not None:
        devices = tuple(devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices listed")
        return PanelMesh(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("make_panel_mesh: no CUDA device is available; pass devices= "
                           "(e.g. ('cpu',) * 4) for a mesh of other devices")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(f"make_panel_mesh: {n} devices asked for, {visible} visible; "
                         f"name repeated devices with devices= to shard logically")
    return PanelMesh(tuple(torch.device("cuda", i) for i in range(n)))


def pad_panel_width(r: int, n_dev: int) -> int:
    """Smallest panel width >= max(r, 1) divisible by ``n_dev``."""
    r = max(int(r), 1)
    return ((r + n_dev - 1) // n_dev) * n_dev


def mesh_device_count(mesh) -> int:
    """The shard count of ``mesh`` (its number of devices); 1 for no mesh."""
    return 1 if mesh is None else len(check_mesh(mesh).devices)


def mesh_panel(max_batch: int, mesh) -> tuple:
    """``(width, n_dev)`` of a column-sharded panel front: ``max_batch``
    rounded up to a multiple of the mesh's shard count ``n_dev``, so that
    every shard is full (unchanged, and ``n_dev`` 1, without a mesh)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    n_dev = mesh_device_count(mesh)
    return pad_panel_width(max_batch, n_dev), n_dev


def _pad_columns(x: torch.Tensor, r_pad: int) -> torch.Tensor:
    r = x.shape[1]
    if r_pad == r:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], r_pad - r))], dim=1)


def _gather_columns(parts, device) -> torch.Tensor:
    """Per-shard column slices side by side on ``device``: a copy from another
    card is ordered after that card's current stream and before this one's."""
    return torch.cat([p.to(device) for p in parts], dim=1)


def _captured_factors(hm: HMatrix):
    """The factors the executor keeps: ``{level: (U, V)}`` as they are now,
    or None in NP mode.  A spilled store raises."""
    factors = hm.factors
    if factors is None:
        return None
    if factors.is_spilled:
        raise RuntimeError("a sharded executor captures the factor store when it is made; "
                           "this FactorStore is spilled to host: reload() it first")
    return dict(factors.items())


@dataclass(frozen=True)
class _Share:
    """What one shard applies, on its device: a plan (``hm``'s, or a row
    share's blocks), its factors (None in NP mode), block tables and points,
    and a solver shard's block-Jacobi factors."""

    plan: HMatrixPlan
    points: torch.Tensor
    factors: dict | None
    groups: dict
    chol: torch.Tensor | None = None

    def apply(self, hm: HMatrix, use_kernels: bool, x_pad: torch.Tensor) -> torch.Tensor:
        return apply_in_tree_order(hm.tree, self.plan, hm.kernel, hm.k, use_kernels,
                                   self.points, self.factors, self.groups, x_pad)


def _points_on(hm: HMatrix, mesh: PanelMesh) -> dict:
    """``hm``'s points on each distinct device of the mesh, copied once."""
    return {dev: hm.tree.points.to(dev) for dev in mesh.distinct_devices}


def _share(hm: HMatrix, dev, points: dict, plan: HMatrixPlan, factors, chol=None) -> _Share:
    """A :class:`_Share` on ``dev``; tensors already there are not copied."""
    groups = hm.groups if plan is hm.plan and dev == hm.device else block_groups(plan, dev)
    return _Share(plan, points[dev],
                  None if factors is None else {lv: (u.to(dev), v.to(dev))
                                                for lv, (u, v) in factors.items()},
                  groups, None if chol is None else chol.to(dev))


def _column_shares(hm: HMatrix, mesh: PanelMesh, chol=None) -> dict:
    """One whole-matrix :class:`_Share` per distinct device of the mesh."""
    points, factors = _points_on(hm, mesh), _captured_factors(hm)
    return {dev: _share(hm, dev, points, hm.plan, factors, chol)
            for dev in mesh.distinct_devices}


def make_sharded_apply(hm: HMatrix, mesh: PanelMesh, shard: str = "rows",
                       use_kernels: bool = True) -> Callable:
    """Multi-device ``apply(x) -> Z = H x`` over ``mesh``, the contract of
    :func:`repro_torch.core.hmatrix.make_apply`: ``x`` is ``(N,)`` or
    ``(N, R)`` in the original point order, the result lies on ``hm.device``.

    ``shard="rows"`` (the default) splits the block lists and sums the
    shards' partial results; ``"columns"`` splits the panel along R (R padded
    to a multiple of the shard count), as ``repro`` does by default.  Row
    shards divide the work at every R; column shards each evaluate every
    block (see the module's docstring).  ``use_kernels`` as in
    ``make_apply``: on CUDA shards the kernels, on CPU shards their plain
    versions.
    """
    n_dev = mesh_device_count(mesh)
    if shard == "columns":
        run = _colsharded_apply(hm, mesh, n_dev, use_kernels)
    elif shard == "rows":
        run = _rowsharded_apply(hm, mesh, n_dev, use_kernels)
    else:
        raise ValueError(f"shard must be 'columns' or 'rows', got {shard!r}")
    return panel_entry(hm, run)


def _colsharded_apply(hm: HMatrix, mesh: PanelMesh, n_dev: int, use_kernels: bool):
    tree = hm.tree
    shares = _column_shares(hm, mesh)

    def body(_i, dev, x_shard):
        return shares[dev].apply(hm, use_kernels, x_shard.to(dev))

    def run(x2: torch.Tensor) -> torch.Tensor:
        r = x2.shape[1]
        x_pad = permute_to_tree(tree, _pad_columns(x2, pad_panel_width(r, n_dev)))
        parts = map_shards(mesh, body, torch.tensor_split(x_pad, n_dev, dim=1))
        return permute_from_tree(tree, _gather_columns(parts, hm.device))[:, :r]

    return run


def share_bounds(n_blocks: int, n_dev: int) -> np.ndarray:
    """Block index bounds of ``n_dev`` contiguous shares, sizes equal or one
    less (the first ``n_blocks % n_dev`` shares take one more)."""
    sizes = np.full(n_dev, n_blocks // n_dev, np.int64)
    sizes[:n_blocks % n_dev] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def _row_shares(hm: HMatrix, mesh: PanelMesh, n_dev: int) -> list:
    """One :class:`_Share` per shard: the plan restricted to its blocks
    (empty level groups dropped) and, in P mode, its slice of the factors."""
    plan = hm.plan
    points, factors = _points_on(hm, mesh), _captured_factors(hm)
    bounds = {lv: share_bounds(b.shape[0], n_dev) for lv, b in plan.aca_levels.items()}
    dense_bounds = share_bounds(plan.dense_blocks.shape[0], n_dev)
    shares = []
    for i, dev in enumerate(mesh.devices):
        levels, fac = {}, (None if factors is None else {})
        for lv, blocks in plan.aca_levels.items():
            lo, hi = bounds[lv][i], bounds[lv][i + 1]
            if hi == lo:
                continue
            levels[lv] = blocks[lo:hi]
            if factors is not None:
                u, v = factors[lv]
                fac[lv] = (u[lo:hi], v[lo:hi])
        plan_i = replace(plan, aca_levels=levels,
                         dense_blocks=plan.dense_blocks[dense_bounds[i]:dense_bounds[i + 1]])
        shares.append(_share(hm, dev, points, plan_i, fac))
    return shares


def _rowsharded_apply(hm: HMatrix, mesh: PanelMesh, n_dev: int, use_kernels: bool):
    tree = hm.tree
    shares = _row_shares(hm, mesh, n_dev)

    def body(_i, _dev, share, x_pad):
        return share.apply(hm, use_kernels, x_pad)

    def run(x2: torch.Tensor) -> torch.Tensor:
        x_pad = permute_to_tree(tree, x2).contiguous()
        on_dev = {dev: x_pad.to(dev) for dev in mesh.distinct_devices}
        parts = map_shards(mesh, body, shares, [on_dev[dev] for dev in mesh.devices])
        z_pad = parts[0].to(hm.device)
        for part in parts[1:]:                  # the partials in shard order
            z_pad = z_pad + part.to(hm.device)
        return permute_from_tree(tree, z_pad)

    return run


def make_sharded_solver(hm: HMatrix, sigma2: float, mesh: PanelMesh, tol: float = 1e-5,
                        max_iter: int = 300, precondition: bool = True,
                        use_kernels: bool = True) -> Callable:
    """Multi-device ``solve(F) -> (C, SolveInfo)`` over ``mesh``, the contract
    of :func:`repro_torch.solve.make_solver` (block Jacobi or none).

    The panel's columns are sharded: each shard runs the active-mask PCG
    (``solve.cg.PCGIteration``) on its own columns with its own masks, on
    its device.  The shards step in lockstep: every trip issues each
    shard's step, then the host reads once whether any column of any shard
    is still active; so every shard runs the same trip count, the largest
    per-column count.  Each column's arithmetic is the single-device
    solver's on a panel of the shard's width (on a card PyTorch's column
    sums round by the panel's width, so the bits are those of the unsharded
    solves of the shards' column slices).  Ragged R is padded with zero
    columns, which start converged, and sliced off; ``SolveInfo.iterations``
    equals ``iters_per_column.max()``.
    """
    from ..solve.cg import PCGIteration, SolveInfo, build_preconditioner

    n_dev = mesh_device_count(mesh)
    tree = hm.tree
    tol2 = float(tol) * float(tol)
    chol = build_preconditioner(hm, sigma2, use_kernels) if precondition else None
    shares = _column_shares(hm, mesh, chol)
    pcgs = [PCGIteration(tree, hm.plan, hm.kernel, hm.k, use_kernels, sigma2, tol2,
                         shares[dev].points, shares[dev].factors, shares[dev].groups,
                         shares[dev].chol, dev)
            for dev in mesh.devices]

    def solve(f):
        require_full_fp32("solve", hm.device)
        f = operand(f, hm, "rhs")
        fp = f[:, None] if f.ndim == 1 else f
        r = fp.shape[1]
        b_pad = permute_to_tree(tree, _pad_columns(fp, pad_panel_width(r, n_dev)))
        states = map_shards(mesh, lambda _i, dev, pcg, b: pcg.init(b.to(dev).contiguous()),
                            pcgs, torch.tensor_split(b_pad, n_dev, dim=1))
        it = 0
        while it < max_iter and bool(_gather_columns(
                [s.active[None, :] for s in states], hm.device).any()):
            states = map_shards(mesh, lambda _i, _dev, pcg, s: pcg.step(s, it), pcgs, states)
            it += 1
        x = permute_from_tree(tree, _gather_columns([s.x for s in states], hm.device))[:, :r]
        iters_col = _gather_columns([s.iters_col[None, :] for s in states], hm.device)[0, :r]
        rr = _gather_columns([s.rr[None, :] for s in states], hm.device)[0, :r]
        info = SolveInfo(it, iters_col, torch.sqrt(rr), tol)
        return (x[:, 0] if f.ndim == 1 else x), info

    solve.preconditioner = None
    return solve
