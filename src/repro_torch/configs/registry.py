"""Architecture registry: ``--arch <id>`` resolution for the port's launchers
(``repro.configs.registry`` in the port: the same names, configs and cells)."""
from __future__ import annotations

from . import (chameleon_34b, gemma_7b, granite_moe_1b, mixtral_8x7b, phi3_medium_14b,
               qwen2_5_14b, smollm_135m, whisper_tiny, xlstm_1_3b, zamba2_7b)
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "whisper-tiny": whisper_tiny,
    "gemma-7b": gemma_7b,
    "smollm-135m": smollm_135m,
    "phi3-medium-14b": phi3_medium_14b,
    "qwen2.5-14b": qwen2_5_14b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "mixtral-8x7b": mixtral_8x7b,
    "chameleon-34b": chameleon_34b,
    "xlstm-1.3b": xlstm_1_3b,
    "zamba2-7b": zamba2_7b,
}

# The 10 assigned architectures (the 40 cells iterate these).
ASSIGNED = tuple(_MODULES)

# Extra selectable configs (beyond-paper variants).
_EXTRA = {
    "qwen2.5-14b-hmatrix": qwen2_5_14b.ARCH_HMATRIX,
}


def list_archs() -> list[str]:
    return list(ASSIGNED) + list(_EXTRA)


def get_arch(name: str) -> ArchConfig:
    if name in _MODULES:
        return _MODULES[name].ARCH
    if name in _EXTRA:
        return _EXTRA[name]
    raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_smoke(name: str) -> ArchConfig:
    if name in _MODULES:
        return _MODULES[name].smoke()
    if name == "qwen2.5-14b-hmatrix":
        return qwen2_5_14b.smoke_hmatrix()
    raise KeyError(f"unknown arch {name!r}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def iter_cells():
    """All (arch, shape, runs, reason) assignment cells — 40 total."""
    for arch_name in ASSIGNED:
        arch = get_arch(arch_name)
        for shape in SHAPES.values():
            runs, reason = shape_applicable(arch, shape)
            yield arch, shape, runs, reason


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ASSIGNED", "shape_applicable",
           "list_archs", "get_arch", "get_smoke", "get_shape", "iter_cells"]
