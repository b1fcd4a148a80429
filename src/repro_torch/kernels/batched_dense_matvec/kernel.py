"""Launch wrappers of the CUDA kernel ``csrc/dense_matmat.cu``.

Replace ``repro/kernels/batched_dense_matvec/kernel.py``:
``batched_kernel_matmat_t`` (``Y[b] = phi(rows[b], cols[b]) @ X[b]``) and
``batched_kernel_matvec_t`` (its vector form), the block generated on chip
and never stored.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...core.geometry import matern_norm
from .. import require_cuda_f32, stream_handle
from ..phi import kernel_id

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_VEC = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
MAX_POINT_DIM = 3


def batched_kernel_matvec_cuda(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                               kernel_name: str = "gaussian") -> torch.Tensor:
    """rows, cols: (B, C, d), x: (B, C) float32 CUDA tensors -> (B, C)."""
    what = "batched_kernel_matvec"
    require_cuda_f32(what, rows, cols, x)
    if rows.ndim != 3 or cols.shape != rows.shape or x.shape != rows.shape[:2]:
        raise ValueError(f"{what}: shapes rows {tuple(rows.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)} do not match "
                         "(B, C, d), (B, C, d), (B, C)")
    b, c, d = rows.shape
    if not 1 <= d <= MAX_POINT_DIM:
        raise ValueError(f"{what}: the kernel takes point dimension 1..{MAX_POINT_DIM}, got {d}")
    y = torch.empty_like(x)
    if b == 0 or c == 0:
        return y
    fn = _build.c_function("dense_matmat", "repro_dense_matvec", _ARGTYPES_VEC)
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                 b, c, d, kernel_id(kernel_name), matern_norm(d), stream_handle(x.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y


def batched_kernel_matmat_cuda(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                               kernel_name: str = "gaussian") -> torch.Tensor:
    """rows, cols: (B, C, d), x: (B, C, R) float32 CUDA tensors -> (B, C, R)."""
    what = "batched_kernel_matmat"
    require_cuda_f32(what, rows, cols, x)
    if rows.ndim != 3 or cols.shape != rows.shape or x.ndim != 3 \
            or x.shape[:2] != rows.shape[:2]:
        raise ValueError(f"{what}: shapes rows {tuple(rows.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)} do not match "
                         "(B, C, d), (B, C, d), (B, C, R)")
    b, c, d = rows.shape
    r = x.shape[2]
    if not 1 <= d <= MAX_POINT_DIM:
        raise ValueError(f"{what}: the kernel takes point dimension 1..{MAX_POINT_DIM}, got {d}")
    y = torch.empty_like(x)
    fn = _build.c_function("dense_matmat", "repro_dense_matmat", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                 b, c, d, r, kernel_id(kernel_name), matern_norm(d),
                 stream_handle(x.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y
