"""The port's sharding rules against ``repro.parallel.sharding``.

Every registry architecture at its published widths: the port's parameters
come from its ``init_params`` under ``FakeTensorMode`` (nothing allocated),
``repro``'s tree from ``jax.eval_shape``.  The mapping: the port keeps one
tensor per layer, ``repro`` a stack per pattern position (and per
encoder-decoder layer list); ``repro_torch.convert.repro_path`` names each
port parameter's ``repro`` path and stack length.  For a stacked leaf
``repro``'s shape is ``(periods,) + the port's``, and its spec is the port
spec's ``stack`` entry followed by the port spec's entries; every other
leaf has the port's shape and spec.  ``repro`` runs under an
``AbstractMesh`` set through ``repro.parallel.mesh_ctx._state``.
"""
import functools

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_arch as j_get_arch
from repro.models import moe as jmoe
from repro.models.api import get_model as j_get_model
from repro.parallel import sharding as jsharding
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.convert import repro_path
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh_ctx import P, PanelMesh, use_mesh
from torch_parity_util import jax_mesh, one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    with FakeTensorMode():
        return get_model(get_arch(arch), "cpu")["init_params"](torch.Generator())


@functools.lru_cache(maxsize=None)
def _repro_struct(arch):
    return jax.eval_shape(j_get_model(j_get_arch(arch))["init_params"], jax.random.PRNGKey(0))


def _repro_leaves(tree):
    return {jsharding._path_str(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked_spec(spec, periods):
    """The port spec as the spec of ``repro``'s leaf (stacked with
    ``periods``)."""
    return tuple(spec) if periods is None else (spec.stack, *spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_state_specs_equal_repro(arch, mesh_name):
    cfg = get_arch(arch)
    params = _port_params(arch)
    struct = _repro_struct(arch)
    sizes, names = MESHES[mesh_name]
    with jax_mesh(sizes, names), use_mesh(PanelMesh(None, names, sizes)):
        j_param = _repro_leaves(jsharding.param_specs(struct, cfg.num_experts))
        j_opt = _repro_leaves(jsharding.opt_state_specs(struct, cfg.num_experts))
        p_specs = sharding.param_specs(params, cfg.num_experts)
        o_specs = sharding.opt_state_specs(params, cfg.num_experts)
    j_leaves = _repro_leaves(struct)
    seen = set()
    for name, p in params.named_parameters():
        path, periods = repro_path(cfg, name)
        seen.add(path)
        leaf = j_leaves[path]
        assert tuple(leaf.shape) == ((periods,) if periods else ()) + tuple(p.shape), name
        assert str(leaf.dtype) == str(p.dtype).removeprefix("torch."), name
        assert p_specs[name].stack is None, name
        if periods is None:
            assert o_specs[name].stack is None, name
        assert _stacked_spec(p_specs[name], periods) == tuple(j_param[path]), (name, p_specs[name])
        assert _stacked_spec(o_specs[name], periods) == tuple(j_opt[path]), (name, o_specs[name])
    assert seen == set(j_leaves), set(j_leaves) ^ seen


def test_zero1_puts_data_on_the_stack_where_repro_does():
    """qwen2.5-14b's 48 periods split over 16 data shards: ``repro`` shards
    every stacked moment's period axis; the port says so by ``stack``."""
    params = _port_params("qwen2.5-14b")
    with use_mesh(PanelMesh(None, ("data", "model"), (16, 16))):
        specs = sharding.opt_state_specs(params)
    assert specs["layers.5.attn.wq"] == P(None, "model", stack="data")
    assert specs["embed"] == P(("model", "data"), None)
    assert specs["final_norm.w"] == P("data")


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-moe-1b-a400m"])
def test_moe_parallel_mode_cache_and_batch_specs(arch, tp):
    cfg = get_arch(arch)
    sizes, names = (16 if tp == 16 else 2, tp), ("data", "model")
    with jax_mesh(sizes, names), use_mesh(PanelMesh(None, names, sizes)):
        assert moe.moe_parallel_mode(cfg) == jmoe.moe_parallel_mode(cfg)
        assert tuple(sharding.batch_spec(256)) == tuple(jsharding.batch_spec(256))
        for kind in ("dense", "moe", "shared_attn", "self", "cross", "mamba", "mlstm", "slstm"):
            for shape in [(128, 4096, 8, 128), (1, 524288, 8, 128), (32, 32, 4096, 8, 128),
                          (2, 16, 64, 128), (3, 16), (48, 128, 16, 64), (8,)]:
                for batch in (1, 2, 128):
                    want = tuple(jsharding.cache_spec(kind, shape, batch=batch))
                    assert tuple(sharding.cache_spec(kind, shape, batch=batch)) == want
    mode = {("mixtral-8x7b", 2): "ep", ("mixtral-8x7b", 16): "tp",
            ("granite-moe-1b-a400m", 2): "ep", ("granite-moe-1b-a400m", 16): "ep"}
    with use_mesh(PanelMesh(None, names, sizes)):
        assert moe.moe_parallel_mode(cfg) == mode[(arch, tp)]
    assert moe.moe_parallel_mode(cfg) == "tp"          # no mesh: tp = 1


def test_to_named_maps_every_spec():
    mesh = PanelMesh(None, ("data", "model"), (2, 2))
    tree = {"a": P("data"), "b": [P(None, "model"), (P(),)]}
    assert sharding.to_named(tree) is None
    with use_mesh(mesh):
        named = sharding.to_named(tree)
    assert named["a"].mesh is mesh and named["a"].spec == P("data")
    assert named["b"][1][0].spec == P()
