"""The mesh: named axes over devices driven by one process, the active-mesh
context, and the partition-spec helpers (``repro.parallel.mesh_ctx`` in
PyTorch).

``repro`` shards with ``shard_map`` over a JAX ``Mesh``: one Python thread
drives every device.  Its counterpart here is a single-process mesh:
:class:`PanelMesh` lists devices in row-major order over named axes (one
axis, ``"data"``, unless asked), and :func:`map_shards` runs one body per
shard, in shard order, each on its device's current stream.  CUDA streams
are asynchronous, so the shards of distinct cards run at the same time;
shards that name the same device run one after the other.  A mesh may name
one device several times, which is how one card (or the CPU) runs a
sharded executor's logic with several shards.  A mesh may also be abstract
(``devices=None``, ``jax.sharding.AbstractMesh``'s counterpart): axis
names and sizes only, which is all the sharding rules read, for meshes
larger than any machine at hand (the production (16, 16) and (2, 16, 16)).
``repro``'s ``shard_map_compat`` is a shim between JAX versions and has no
counterpart: its role, one body per shard, is :func:`map_shards`.

Models are written mesh-agnostic: with no mesh active (``use_mesh``) the
helpers below are no-ops.  With one, logical axes are resolved against it
by ``repro``'s two rules:

  * axis names missing from the mesh are dropped (e.g. "pod" on the
    single-pod mesh);
  * axes that do not divide the dimension are dropped (replicate instead).

Axis conventions: "pod" (inter-pod DP), "data" (DP / context parallel),
"model" (TP / EP).  A spec entry may be a tuple, e.g. ("data", "model")
shards one dimension over both.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

AXIS = "data"
# Logical batch axis = all DP axes that exist in the mesh.
BATCH_AXES = ("pod", "data")

_state = threading.local()


def _normalize(device) -> torch.device:
    """A device with its index: "cuda" means the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class PanelMesh:
    """Named axes (``axis_names``, sizes ``axis_sizes``) over ``devices``
    listed in row-major order over the axes; a device may repeat.  The
    default is one axis, ``"data"``, over the listed devices.  With
    ``devices=None`` the mesh is abstract and ``axis_sizes`` is required."""

    devices: tuple | None
    axis_names: tuple = (AXIS,)
    axis_sizes: tuple | None = None

    def __post_init__(self):
        names = tuple(self.axis_names)
        if not names or len(set(names)) != len(names):
            raise ValueError(f"a PanelMesh needs distinct axis names, got {names}")
        sizes = None if self.axis_sizes is None else tuple(int(s) for s in self.axis_sizes)
        devices = self.devices
        if devices is None:
            if sizes is None:
                raise ValueError("an abstract PanelMesh (devices=None) needs axis_sizes")
        else:
            devices = tuple(_normalize(d) for d in devices)
            if not devices:
                raise ValueError("a PanelMesh needs at least one device")
            if sizes is None:
                if len(names) != 1:
                    raise ValueError("a mesh of several axes needs axis_sizes")
                sizes = (len(devices),)
            if math.prod(sizes) != len(devices):
                raise ValueError(f"axis sizes {sizes} do not cover {len(devices)} devices")
        if len(sizes) != len(names) or min(sizes) < 1:
            raise ValueError(f"axis sizes {sizes} do not fit axis names {names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        """{axis name: size} in axis order, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def distinct_devices(self) -> tuple:
        """The devices of the mesh, each once, in order of first appearance."""
        return tuple(dict.fromkeys(_concrete(self).devices))

    def along(self, axes: tuple) -> "PanelMesh":
        """A one-axis mesh of the devices along ``axes`` (names of this mesh,
        in the order given: the first varies slowest), at index 0 of every
        other axis.  A single process computes each shard once: the copies
        that a JAX mesh would hold along the other axes add nothing here."""
        mesh = _concrete(self)
        strides = {}
        stride = 1
        for name, size in zip(reversed(mesh.axis_names), reversed(mesh.axis_sizes)):
            strides[name] = stride
            stride *= size
        picks = [mesh.devices[sum(i * strides[name] for i, name in zip(index, axes))]
                 for index in itertools.product(*(range(mesh.shape[name]) for name in axes))]
        return PanelMesh(tuple(picks))


def _concrete(mesh: PanelMesh) -> PanelMesh:
    if mesh.abstract:
        raise ValueError(f"the mesh {mesh.shape} is abstract (devices=None): it has no "
                         "devices to run shards on")
    return mesh


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
    for i, device in enumerate(_concrete(mesh).devices):
        with on_device(device):
            outs.append(body(i, device, *(arg[i] for arg in shard_args)))
    return outs


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------


def current_mesh() -> PanelMesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: PanelMesh | None):
    """Make ``mesh`` the active mesh of this thread for the block."""
    if mesh is not None:
        check_mesh(mesh)
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_size(name: str) -> int:
    """Size of a mesh axis; 1 if absent or no mesh."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def dp_size() -> int:
    return axis_size("pod") * axis_size("data")


def tp_size() -> int:
    return axis_size("model")


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """A partition spec: one entry per dimension, each ``None``, an axis name
    or a tuple of names (``jax.sharding.PartitionSpec``'s counterpart; a
    plain tuple of its entries).

    ``stack`` serves a tensor that ``repro`` keeps as one slice of a stack:
    the port keeps one tensor per layer where ``repro`` stacks the layers of
    a pattern position on a leading axis, and ``stack`` is the entry of that
    axis (the layers of the stack split over those mesh axes in order).
    ``None`` for any tensor the mesh does not split that way."""

    def __new__(cls, *entries, stack=None):
        spec = super().__new__(cls, entries)
        spec.stack = stack
        return spec

    def __eq__(self, other):
        return (tuple(self) == tuple(other)
                and self.stack == getattr(other, "stack", None))

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((tuple(self), self.stack))

    def __repr__(self):
        body = ", ".join(repr(e) for e in self)
        stack = "" if self.stack is None else f"{', ' if body else ''}stack={self.stack!r}"
        return f"PartitionSpec({body}{stack})"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec resolved against it (``jax.sharding.NamedSharding``)."""

    mesh: PanelMesh
    spec: PartitionSpec


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _resolve_entry(entry, dim: int, mesh: PanelMesh):
    """Resolve one PartitionSpec entry against the mesh + divisibility."""
    kept = []
    prod = 1
    for nm in entry_axes(entry):
        if nm in mesh.axis_names and dim % (prod * mesh.shape[nm]) == 0:
            kept.append(nm)
            prod *= mesh.shape[nm]
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def resolve_spec(shape, spec) -> PartitionSpec:
    """Sanitise a PartitionSpec for the current mesh (see module docstring)."""
    mesh = current_mesh()
    if mesh is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(_resolve_entry(e, d, mesh) for e, d in zip(entries, shape)),
             stack=getattr(spec, "stack", None))


def constrain(x, *spec_entries):
    """``with_sharding_constraint`` with logical axes; a no-op without a mesh.

    A deliberate difference from ``repro``: the port's mesh is driven by one
    process and its tensors are not split across it, so there is nothing
    to re-lay.  With a mesh active the spec is resolved against it (a spec
    longer than ``x``'s rank raises, as JAX's constraint does) and ``x``
    itself is returned: no copy, no reshard."""
    if current_mesh() is not None:
        if len(spec_entries) > x.ndim:
            raise ValueError(f"constrain: spec {spec_entries} has more entries than "
                             f"the rank {x.ndim} of the tensor")
        resolve_spec(x.shape, P(*spec_entries))
    return x


def named_sharding(shape, spec) -> NamedSharding | None:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(shape, spec))


def mesh_axes(mesh: PanelMesh, axis=None) -> tuple:
    """Normalise an axis selection to a tuple of mesh axis names.

    ``axis=None`` selects ALL axes of the mesh (shard over every device);
    a string selects one axis; a tuple passes through.  Unknown names raise.
    """
    if axis is None:
        return tuple(mesh.axis_names)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for nm in names:
        if nm not in mesh.axis_names:
            raise ValueError(f"axis {nm!r} not in mesh axes {mesh.axis_names}")
    return names


def mesh_axes_size(mesh: PanelMesh, axes: tuple) -> int:
    """Number of devices along ``axes`` (their product); unknown names raise
    ``ValueError``."""
    size = 1
    for nm in mesh_axes(mesh, axes):
        size *= mesh.shape[nm]
    return size
