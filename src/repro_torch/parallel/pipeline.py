"""GPipe-style pipeline parallelism over a mesh axis (``repro.parallel.pipeline``
in PyTorch).

The stages live on the devices along one axis of the active mesh
(``use_mesh``); microbatches stream through them on ``repro``'s schedule:
``n_micro + n_stages - 1`` ticks, stage 0 takes microbatch ``t`` at tick
``t``, every activation moves one stage forward a tick, and the last stage
holds microbatch ``t - (n_stages - 1)`` at tick ``t``.  One process drives
every stage: each tick issues every busy stage's work on its device's
current stream, so the stages of distinct cards overlap as GPipe's do.
``repro`` runs every stage every tick inside a ``shard_map`` and discards
the bubbles' results; here a stage with no microbatch in a tick does no
work.  A hand-off is a ``.to(next_device, non_blocking=True)`` copy issued
on the sending device's stream (free between logical shards of one
device), where ``repro`` uses ``ppermute``.  The output comes back on the
input's device, where ``repro`` replicates it with a ``psum``.  Each
microbatch goes through the same stage functions in the same order as the
sequential stack, so on one device the results are the stack's bits.
"""
from __future__ import annotations

import torch
from torch import nn

from .mesh_ctx import current_mesh, mesh_axes, on_device


def _to(tree, device):
    """``tree`` (tensors, modules, dicts, lists, tuples) on ``device``; a
    module is moved in place, as ``nn.Module.to`` does."""
    if isinstance(tree, (torch.Tensor, nn.Module)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {key: _to(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(val, device) for val in tree)
    return tree


def _entry(tree, i: int):
    """Entry ``i`` of every tensor of a tree stacked on its leading axis."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {key: _entry(val, i) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_entry(val, i) for val in tree)
    return tree


def pipeline_apply(stage_params, x_microbatches, *, axis: str, n_stages: int, stage_fn):
    """Run microbatches through pipeline stages living on mesh axis ``axis``.

    stage_params: ``repro``'s contract, a tree (tensors, dicts, tuples)
        with every tensor stacked on a leading ``(n_stages,)`` dim; or a
        ``list`` / ``nn.ModuleList`` of ``n_stages`` per-stage trees (the
        way to pass ``nn.Module`` blocks).  Stage ``i``'s parameters are
        put on the ``i``-th device along ``axis``.
    x_microbatches: (n_micro, mb, ...) inputs, or a sequence of n_micro
        tensors.
    stage_fn: ``stage_fn(stage_params_i, x) -> x`` of the same shape.
    Returns (n_micro, mb, ...): the last stage's outputs, on the input's
    device.  Raises without an active mesh or when ``axis`` does not have
    ``n_stages`` devices.
    """
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("pipeline_apply requires an active mesh")
    (name,) = mesh_axes(mesh, axis)
    if mesh.shape[name] != n_stages:
        raise ValueError(f"pipeline_apply: axis {name!r} has {mesh.shape[name]} devices, "
                         f"not n_stages={n_stages}")
    devices = mesh.along((name,)).devices
    if isinstance(stage_params, (list, nn.ModuleList)):
        if len(stage_params) != n_stages:
            raise ValueError(f"pipeline_apply: {len(stage_params)} stages of parameters, "
                             f"n_stages={n_stages}")
        params = [_to(p, dev) for p, dev in zip(stage_params, devices)]
    else:
        params = [_to(_entry(stage_params, i), dev) for i, dev in enumerate(devices)]
    xs = list(x_microbatches)
    n_micro = len(xs)
    home = xs[0].device
    held = [None] * n_stages          # the activation each stage takes this tick
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            held[0] = xs[t].to(devices[0], non_blocking=True)
        # last stage first: a stage hands on before its successor's slot is refilled
        for s in reversed(range(n_stages)):
            if held[s] is None:
                continue
            with on_device(devices[s]):
                y = stage_fn(params[s], held[s])
                held[s] = None
                if s == n_stages - 1:
                    outs[t - (n_stages - 1)] = y.to(home, non_blocking=True)
                else:
                    held[s + 1] = y.to(devices[s + 1], non_blocking=True)
    return torch.stack(outs)
