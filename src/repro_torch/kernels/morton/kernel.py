"""Launch wrapper of the CUDA kernel ``csrc/morton.cu``.

Replaces ``repro/kernels/morton/kernel.py:morton_encode_t``: the Z-order
code of every point, here one int64 ``(hi << 32) | lo`` per point.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
MAX_POINT_DIM = 3


def morton_encode_cuda(coords: torch.Tensor) -> torch.Tensor:
    """coords: (N, d) float32 CUDA tensor in [0, 1]^d -> (N,) int64 codes."""
    what = "morton_encode"
    require_cuda_f32(what, coords)
    if coords.ndim != 2 or not 1 <= coords.shape[1] <= MAX_POINT_DIM:
        raise ValueError(f"{what}: the kernel takes (N, d) points with d in "
                         f"1..{MAX_POINT_DIM}, got {tuple(coords.shape)}")
    n, d = coords.shape
    if n >= 2 ** 31:
        raise ValueError(f"{what}: the kernel takes fewer than 2^31 points, got {n}")
    codes = torch.empty((n,), dtype=torch.int64, device=coords.device)
    if n == 0:
        return codes
    fn = _build.c_function("morton", "repro_morton_encode", _ARGTYPES)
    with torch.cuda.device(coords.device):
        err = fn(coords.data_ptr(), codes.data_ptr(), n, d, stream_handle(coords.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return codes
