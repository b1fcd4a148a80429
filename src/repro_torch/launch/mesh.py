"""Production and debug meshes (``repro.launch.mesh`` in PyTorch).

Functions, not module-level constants: importing this module touches no
device.  The production shapes are abstract meshes (no card machine holds
256 or 512 GPUs): the sharding rules, ``launch.specs`` and the dry run read
their axis names and sizes only.
"""
from __future__ import annotations

from .._device import resolve_device
from ..parallel.mesh_ctx import PanelMesh


def make_production_mesh(*, multi_pod: bool = False) -> PanelMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return PanelMesh(None, axes, shape)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device=None) -> PanelMesh:
    """A ``(n_data, n_model)`` mesh over ``("data", "model")`` of logical
    shards of one device (``cuda`` unless the caller asks; raises without a
    card), which a single process drives."""
    dev = resolve_device(device)
    return PanelMesh((dev,) * (n_data * n_model), ("data", "model"), (n_data, n_model))
