"""The panel mesh: an ordered tuple of devices driven by one process.

Counterpart of what the sharded H-matrix executors of ``repro`` take from
``repro.parallel.mesh_ctx``.  ``repro`` shards with ``shard_map`` over a
JAX ``Mesh``: one Python thread drives every device.  Its counterpart here is a
single-process mesh: :class:`PanelMesh` lists the devices, and
:func:`map_shards` runs one body per shard, in shard order, each on its
device's current stream.  CUDA streams are asynchronous, so the shards of
distinct cards run at the same time; shards that name the same device run
one after the other.  A mesh may name one device several times, which is
how one card (or the CPU) runs a sharded executor's logic with several
shards.  The mesh has one axis, so the reference's axis selection
(``mesh_axes``, ``mesh_axes_size``), which serves multi-axis JAX meshes,
has no counterpart: a mesh's shard count is its number of devices.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

AXIS = "data"


def _normalize(device) -> torch.device:
    """A device with its index: "cuda" means the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class PanelMesh:
    """One mesh axis, ``"data"``, over ``devices`` in shard order (a device
    may repeat)."""

    devices: tuple

    def __post_init__(self):
        devices = tuple(_normalize(d) for d in self.devices)
        if not devices:
            raise ValueError("a PanelMesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def axis_names(self) -> tuple:
        return (AXIS,)

    @property
    def distinct_devices(self) -> tuple:
        """The devices of the mesh, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def check_mesh(mesh) -> PanelMesh:
    if not isinstance(mesh, PanelMesh):
        raise TypeError(f"mesh must be a PanelMesh (see repro_torch.parallel.make_panel_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def on_device(device: torch.device):
    """Make ``device`` current (its current stream then takes the work)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def map_shards(mesh: PanelMesh, body: Callable, *shard_args: Sequence) -> list:
    """``[body(i, device_i, *(arg[i] for arg in shard_args)) for each shard i]``,
    in shard order, each call with its device current."""
    outs = []
    for i, device in enumerate(mesh.devices):
        with on_device(device):
            outs.append(body(i, device, *(arg[i] for arg in shard_args)))
    return outs
