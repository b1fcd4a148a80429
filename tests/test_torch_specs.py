"""The port's step input specs against ``repro.launch.specs`` in every cell
that ``shape_applicable`` admits (33 of the 40), under the (16, 16)
production mesh (an ``AbstractMesh`` on ``repro``'s side).

How the structures are mapped:
  * parameters and optimizer moments: by ``convert.repro_path`` (see
    ``tests/test_torch_sharding.py``): a stacked ``repro`` leaf has shape
    ``(periods,) + the port's`` and spec ``(stack, *the port's)``;
  * decode caches: the port's per-layer list against ``repro``'s stacks:
    layer ``i``'s cache is entry ``period`` of ``repro``'s
    ``caches["pattern"][pos]`` (``convert.layer_source``), or
    ``caches["tail"][j]``; an encoder-decoder layer's ``{"self", "cross"}``
    is entry ``i`` of ``repro``'s ``{"self", "cross"}`` stacks.  A stacked
    leaf's shape is ``(periods,) + the port's`` and its spec ``(None, *the
    port's)``; recurrent states have ``repro``'s shapes per layer;
  * deliberate dtype differences (ROADMAP.md §3, fault 10): token ids are
    int64 (``repro``: int32); ``cache_len`` and the train step are host
    ints (``repro``: () int32 arrays), with the same ``P()`` spec.
"""
import functools

import jax
import pytest

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import get_shape as j_get_shape
from repro.launch import specs as jspecs
from repro.parallel import sharding as jsharding
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.registry import get_arch, get_shape, iter_cells
from repro_torch.convert import layer_source, repro_path
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.mesh_ctx import use_mesh
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_step
from torch_parity_util import jax_mesh, one_torch_thread  # noqa: F401

CELLS = [(arch.name, shape.name) for arch, shape, runs, _ in iter_cells() if runs]
INT_DTYPES = {"int64": "int32"}      # the port's token ids -> repro's


def _dtype(t) -> str:
    name = str(t.dtype).removeprefix("torch.")
    return INT_DTYPES.get(name, name)


def _same_leaf(t, sds, stacked: bool):
    lead = (sds.shape[0],) if stacked else ()
    assert lead + tuple(t.shape) == tuple(sds.shape)
    assert _dtype(t) == str(sds.dtype)


def _leaves(tree):
    return {jsharding._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _both(fn_port, fn_repro):
    mesh = make_production_mesh()
    with jax_mesh(tuple(mesh.axis_sizes), mesh.axis_names), use_mesh(mesh):
        return fn_port(), fn_repro()


def _check_flat(port: dict, port_specs: dict, repro: dict, repro_specs: dict):
    assert set(port) == set(repro)
    for key, t in port.items():
        _same_leaf(t, repro[key], False)
        assert tuple(port_specs[key]) == tuple(repro_specs[key]), key


def _check_named(cfg, named: dict, named_specs: dict, j_tree, j_specs):
    """Tensors keyed by port parameter name against ``repro``'s pytree."""
    leaves, spec_leaves = _leaves(j_tree), _leaves(j_specs)
    seen = set()
    for name, t in named.items():
        path, periods = repro_path(cfg, name)
        seen.add(path)
        _same_leaf(t, leaves[path], periods is not None)
        spec = named_specs[name]
        got = tuple(spec) if periods is None else (spec.stack, *spec)
        assert got == tuple(spec_leaves[path]), (name, spec)
    assert seen == set(leaves)


@functools.lru_cache(maxsize=None)
def _train_state(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    init_state, _ = make_train_step(cfg, AdamWConfig(), device="cpu")
    j_init, _ = j_make_train_step(jcfg, JAdamWConfig())
    return _both(lambda: specs.state_struct_and_specs(cfg, init_state),
                 lambda: jspecs.state_struct_and_specs(jcfg, j_init))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_repro(arch, shape_name):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    shape, jshape = get_shape(shape_name), j_get_shape(shape_name)
    (inputs, in_specs), (j_inputs, j_specs) = _both(lambda: specs.input_specs(cfg, shape),
                                                    lambda: jspecs.input_specs(jcfg, jshape))
    if shape.kind != "decode":
        _check_flat(inputs, in_specs, j_inputs, j_specs)
    if shape.kind == "train":
        (state, st_specs), (j_state, j_st_specs) = _train_state(arch)
        assert state["step"] == 0 and tuple(st_specs["step"]) == tuple(j_st_specs["step"]) == ()
        assert j_state["step"].shape == () and str(j_state["step"].dtype) == "int32"
        named = dict(state["params"].named_parameters())
        _check_named(cfg, named, st_specs["params"], j_state["params"], j_st_specs["params"])
        assert set(state["opt"]) == set(j_state["opt"]) == set(st_specs["opt"])
        for key in state["opt"]:
            _check_named(cfg, state["opt"][key], st_specs["opt"][key], j_state["opt"][key],
                         j_st_specs["opt"][key])
    if shape.kind == "decode":
        _check_decode(cfg, inputs, in_specs, j_inputs, j_specs)


def _check_decode(cfg, inputs, in_specs, j_inputs, j_specs):
    _same_leaf(inputs["tokens"], j_inputs["tokens"], False)
    assert tuple(in_specs["tokens"]) == tuple(j_specs["tokens"])
    assert isinstance(inputs["cache_len"], int) and j_inputs["cache_len"].shape == ()
    assert tuple(in_specs["cache_len"]) == tuple(j_specs["cache_len"]) == ()
    caches, c_specs = inputs["caches"], in_specs["caches"]
    assert len(caches) == len(c_specs) == cfg.n_layers
    for i, (cache, spec) in enumerate(zip(caches, c_specs)):
        if cfg.is_encoder_decoder:
            pairs = [(cache[part], spec[part], j_inputs["caches"][part], j_specs["caches"][part],
                      i) for part in ("self", "cross")]
        else:
            source = layer_source(cfg, i)
            if source[0] == "pattern":
                pairs = [(cache, spec, j_inputs["caches"]["pattern"][source[1]],
                          j_specs["caches"]["pattern"][source[1]], source[2])]
            else:
                pairs = [(cache, spec, j_inputs["caches"]["tail"][source[1]],
                          j_specs["caches"]["tail"][source[1]], None)]
        for c, s, jc, js, entry in pairs:
            c_leaves, s_leaves = jax.tree.leaves(c), jax.tree.leaves(s, is_leaf=_is_spec)
            jc_leaves, js_leaves = jax.tree.leaves(jc), jax.tree.leaves(js, is_leaf=_is_spec)
            assert len(c_leaves) == len(s_leaves) == len(jc_leaves) == len(js_leaves)
            for t, sp, sds, jsp in zip(c_leaves, s_leaves, jc_leaves, js_leaves):
                _same_leaf(t, sds, entry is not None)
                got = tuple(sp) if entry is None else (None, *sp)
                assert got == tuple(jsp), (i, sp, jsp)


def _is_spec(x):
    return isinstance(x, (jax.sharding.PartitionSpec, specs.P))


def test_thirty_three_cells_admitted():
    assert len(CELLS) == 33
