"""repro_torch.parallel — the H-matrix apply and solve over several devices.

Public API:
    PanelMesh, map_shards                                 (mesh_ctx)
    make_panel_mesh, make_sharded_apply, make_sharded_solver,
    mesh_device_count, mesh_panel, pad_panel_width        (hshard)
"""
from .hshard import (make_panel_mesh, make_sharded_apply, make_sharded_solver,
                     mesh_device_count, mesh_panel, pad_panel_width)
from .mesh_ctx import PanelMesh, map_shards

__all__ = ["PanelMesh", "map_shards", "make_panel_mesh", "make_sharded_apply",
           "make_sharded_solver", "mesh_device_count", "mesh_panel", "pad_panel_width"]
