"""The port's named-axis mesh, spec resolution and production meshes against
``repro.parallel.mesh_ctx`` / ``repro.launch.mesh``.

``repro``'s rules run under a ``jax.sharding.AbstractMesh`` set as its
active mesh (``torch_parity_util.jax_mesh``): no forced host devices.
"""
import itertools

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.parallel import mesh_ctx as jctx
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.parallel import mesh_ctx as ctx
from repro_torch.parallel.mesh_ctx import P, PanelMesh
from torch_parity_util import jax_mesh, one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4": ((4,), ("data",))}
SHAPES = [(), (7,), (64,), (32, 48), (48, 32, 6), (1, 512, 8, 128), (2, 1024, 2, 64),
          (512, 16, 2)]
ENTRIES = [None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
           ("pod", "data", "model"), ("model", "data"), "stage"]


def _specs(ndim):
    """Specs of length 0..ndim over a few entry combinations."""
    out = []
    for n in range(ndim + 1):
        for combo in itertools.islice(itertools.product(ENTRIES, repeat=n), 0, None, 3):
            out.append(combo)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_spec_equals_repro(mesh_name):
    sizes, names = MESHES[mesh_name]
    mesh = PanelMesh(None, names, sizes)
    checked = 0
    with jax_mesh(sizes, names), ctx.use_mesh(mesh):
        for shape in SHAPES:
            for spec in _specs(min(len(shape), 3)):
                want = tuple(jctx.resolve_spec(shape, JP(*spec)))
                got = ctx.resolve_spec(shape, P(*spec))
                assert tuple(got) == want, (shape, spec)
                assert got.stack is None
                checked += 1
        for name in ("pod", "data", "model", "stage"):
            assert ctx.axis_size(name) == jctx.axis_size(name)
        assert ctx.dp_size() == jctx.dp_size() and ctx.tp_size() == jctx.tp_size()
        for axis in (None, "data", names, names[::-1]):
            assert ctx.mesh_axes(mesh, axis) == jctx.mesh_axes(jctx.current_mesh(), axis)
            axes = ctx.mesh_axes(mesh, axis)
            assert ctx.mesh_axes_size(mesh, axes) == jctx.mesh_axes_size(jctx.current_mesh(), axes)
        with pytest.raises(ValueError):
            ctx.mesh_axes(mesh, "stage")
        with pytest.raises(ValueError):
            ctx.mesh_axes_size(mesh, ("stage",))
        assert ctx.named_sharding((64, 48), P("model")) == ctx.NamedSharding(
            mesh, ctx.resolve_spec((64, 48), P("model")))
    assert checked > 500


def test_no_mesh_outside_use_mesh_and_constrain_returns_its_input():
    assert ctx.current_mesh() is None and jctx.current_mesh() is None
    assert ctx.axis_size("model") == 1 and ctx.dp_size() == 1 and ctx.tp_size() == 1
    assert ctx.resolve_spec((4, 4), P("model")) == P("model")
    assert ctx.named_sharding((4, 4), P("model")) is None
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert ctx.constrain(x, "data", None, "model") is x
    mesh = PanelMesh(("cpu",) * 4, ("data", "model"), (2, 2))
    with ctx.use_mesh(mesh) as active:
        assert active is mesh and ctx.current_mesh() is mesh
        y = ctx.constrain(x, ("pod", "data"), None, "model")
        assert y is x and torch.equal(y, torch.arange(24.0).reshape(2, 3, 4))
        with pytest.raises(ValueError):
            ctx.constrain(x, "data", None, "model", None)
        with ctx.use_mesh(None):
            assert ctx.current_mesh() is None
        assert ctx.current_mesh() is mesh
    assert ctx.current_mesh() is None


def test_panel_mesh_axes_abstract_and_along():
    one = PanelMesh(("cpu",) * 4)
    assert one.axis_names == ("data",) and one.shape == {"data": 4} and one.size == 4
    two = PanelMesh(tuple(f"cpu:{i}" for i in range(6)), ("data", "model"), (2, 3))
    assert list(two.shape.items()) == [("data", 2), ("model", 3)]
    idx = [d.index for d in two.along(("data", "model")).devices]
    assert idx == [0, 1, 2, 3, 4, 5]
    assert [d.index for d in two.along(("model", "data")).devices] == [0, 3, 1, 4, 2, 5]
    assert [d.index for d in two.along(("model",)).devices] == [0, 1, 2]
    assert [d.index for d in two.along(("data",)).devices] == [0, 3]
    assert one.along(("data",)) == one
    with pytest.raises(ValueError):
        PanelMesh(("cpu",) * 4, ("data", "model"), (3, 2))
    with pytest.raises(ValueError):
        PanelMesh(None, ("data", "model"))
    with pytest.raises(ValueError):
        PanelMesh(("cpu",) * 4, ("data", "data"), (2, 2))
    abstract = PanelMesh(None, ("data", "model"), (16, 16))
    assert abstract.abstract and abstract.size == 256
    with pytest.raises(ValueError, match="abstract"):
        ctx.map_shards(abstract, lambda i, dev: i)
    with pytest.raises(ValueError, match="abstract"):
        abstract.distinct_devices


def test_production_meshes_and_debug_mesh():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.abstract and multi.abstract
    assert single.shape == {"data": 16, "model": 16}
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    debug = make_debug_mesh(2, 2, device="cpu")
    assert debug.shape == {"data": 2, "model": 2}
    assert debug.devices == (torch.device("cpu"),) * 4
    with ctx.use_mesh(debug):
        assert ctx.dp_size() == 2 and ctx.tp_size() == 2


def test_partition_spec_is_a_tuple_with_a_stack_entry():
    spec = P(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model") and len(spec) == 3
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    stacked = P(None, "model", stack="data")
    assert stacked != P(None, "model") and stacked == P(None, "model", stack="data")
    assert hash(stacked) == hash(P(None, "model", stack="data"))
    assert "stack='data'" in repr(stacked)
