"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

The names are ``repro``'s.  Only the configs of the families the port can
run are copied (``dense`` with attention backend ``full`` or ``hmatrix``:
qwen2.5-14b and qwen2.5-14b-hmatrix); the other names raise
``NotImplementedError``.
"""
from __future__ import annotations

from . import qwen2_5_14b
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "qwen2.5-14b": qwen2_5_14b,
}

# repro's other assigned architectures, whose families the port does not run yet
_NOT_PORTED = ("whisper-tiny", "gemma-7b", "smollm-135m", "phi3-medium-14b",
               "granite-moe-1b-a400m", "mixtral-8x7b", "chameleon-34b", "xlstm-1.3b",
               "zamba2-7b")

# Extra selectable configs (beyond-paper variants).
_EXTRA = {
    "qwen2.5-14b-hmatrix": qwen2_5_14b.ARCH_HMATRIX,
}


def list_archs() -> list[str]:
    return list(_NOT_PORTED) + list(_MODULES) + list(_EXTRA)


def _unknown(name: str):
    if name in _NOT_PORTED:
        return NotImplementedError(f"arch {name!r}: not yet ported to repro_torch")
    return KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_arch(name: str) -> ArchConfig:
    if name in _MODULES:
        return _MODULES[name].ARCH
    if name in _EXTRA:
        return _EXTRA[name]
    raise _unknown(name)


def get_smoke(name: str) -> ArchConfig:
    if name in _MODULES:
        return _MODULES[name].smoke()
    if name == "qwen2.5-14b-hmatrix":
        return qwen2_5_14b.smoke_hmatrix()
    raise _unknown(name)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable", "list_archs",
           "get_arch", "get_smoke", "get_shape"]
