"""repro_torch.parallel — meshes, sharding rules, the pipeline, and the
H-matrix apply and solve over several devices.

Public API:
    PanelMesh, PartitionSpec, NamedSharding, map_shards, BATCH_AXES,
    current_mesh, use_mesh, axis_size, dp_size, tp_size, resolve_spec,
    constrain, named_sharding, mesh_axes, mesh_axes_size        (mesh_ctx)
    make_panel_mesh, make_sharded_apply, make_sharded_solver,
    mesh_device_count, mesh_panel, pad_panel_width        (hshard)
    param_specs, opt_state_specs, ...                     (sharding)
    pipeline_apply                                        (pipeline)
"""
from .hshard import (make_panel_mesh, make_sharded_apply, make_sharded_solver,
                     mesh_device_count, mesh_panel, pad_panel_width)
from .mesh_ctx import (BATCH_AXES, NamedSharding, PanelMesh, PartitionSpec, axis_size,
                       constrain, current_mesh, dp_size, map_shards, mesh_axes, mesh_axes_size,
                       named_sharding, resolve_spec, tp_size, use_mesh)

__all__ = ["PanelMesh", "PartitionSpec", "NamedSharding", "map_shards", "BATCH_AXES",
           "current_mesh", "use_mesh", "axis_size", "dp_size", "tp_size", "resolve_spec",
           "constrain", "named_sharding", "mesh_axes", "mesh_axes_size", "make_panel_mesh",
           "make_sharded_apply", "make_sharded_solver", "mesh_device_count", "mesh_panel",
           "pad_panel_width"]
