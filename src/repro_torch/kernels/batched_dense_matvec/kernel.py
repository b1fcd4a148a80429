"""Launch wrappers of the CUDA kernel ``csrc/dense_matmat.cu``.

Replace ``repro/kernels/batched_dense_matvec/kernel.py``:
``batched_kernel_matmat_t`` (``Y[b] = phi(rows[b], cols[b]) @ X[b]``) and
``batched_kernel_matvec_t`` (its vector form), the block generated on chip
and never stored.  Two entries each: the gathered one takes every block's
points and panel slice, the level one (``*_level_cuda``) reads them by leaf
id from the tree-ordered points and padded panel, as an apply holds them.
Both run the same CUDA code (the gathered one with ids ``0..B-1``) and give
the same bits.
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
_ARGTYPES_IDS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
MAX_POINT_DIM = 3


def _level_launch(what: str, points: torch.Tensor, row_ids: torch.Tensor,
                  col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                  kernel_name: str) -> torch.Tensor:
    """Shared body of the level entries: x_pad (n_pad, R) -> Y (B, c_leaf, R)."""
    require_cuda_f32(what, points, x_pad)
    if points.ndim != 2 or x_pad.ndim != 2 or x_pad.shape[0] != points.shape[0] \
            or row_ids.ndim != 1 or row_ids.shape != col_ids.shape:
        raise ValueError(f"{what}: shapes points {tuple(points.shape)}, row_ids "
                         f"{tuple(row_ids.shape)}, col_ids {tuple(col_ids.shape)}, x_pad "
                         f"{tuple(x_pad.shape)} do not match (n_pad, d), (B,), (B,), (n_pad, R)")
    for ids in (row_ids, col_ids):
        if ids.device != points.device or ids.dtype != torch.int64 or not ids.is_contiguous():
            raise ValueError(f"{what}: leaf ids must be contiguous int64 on {points.device}")
    n_pad, d = points.shape
    if not 1 <= d <= MAX_POINT_DIM:
        raise ValueError(f"{what}: the kernel takes point dimension 1..{MAX_POINT_DIM}, got {d}")
    if c_leaf < 1 or n_pad % c_leaf:
        raise ValueError(f"{what}: {n_pad} points do not split into leaves of {c_leaf}")
    b, r = row_ids.shape[0], x_pad.shape[1]
    y = torch.empty((b, c_leaf, r), dtype=torch.float32, device=points.device)
    if b == 0 or r == 0:
        return y
    n_leaf = n_pad // c_leaf
    fn = _build.c_function("dense_matmat", "repro_dense_matmat_ids", _ARGTYPES_IDS)
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), row_ids.data_ptr(), points.data_ptr(), col_ids.data_ptr(),
                 x_pad.data_ptr(), y.data_ptr(), b, c_leaf, d, r, n_leaf, n_leaf,
                 kernel_id(kernel_name), matern_norm(d), stream_handle(points.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y


def batched_kernel_matmat_level_cuda(points: torch.Tensor, row_ids: torch.Tensor,
                                     col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                     kernel_name: str = "gaussian") -> torch.Tensor:
    """Dense leaf products read in place.

    points: (n_pad, d) tree-ordered points; row_ids, col_ids: (B,) int64
    leaf ids (leaf i is rows [i c_leaf, (i + 1) c_leaf)); x_pad: (n_pad, R)
    tree-ordered padded panel; all on one CUDA device -> Y: (B, c_leaf, R)
    with ``Y[b] = phi(leaf row_ids[b], leaf col_ids[b]) @ x_pad[leaf
    col_ids[b]]``.  The ids are not read back to the host: a block with an
    id outside the leaves gets NaN rows.
    """
    return _level_launch("batched_kernel_matmat", points, row_ids, col_ids, x_pad, c_leaf,
                         kernel_name)


def batched_kernel_matvec_level_cuda(points: torch.Tensor, row_ids: torch.Tensor,
                                     col_ids: torch.Tensor, x_pad: torch.Tensor, c_leaf: int,
                                     kernel_name: str = "gaussian") -> torch.Tensor:
    """The vector form of :func:`batched_kernel_matmat_level_cuda`: x_pad
    (n_pad,) -> (B, c_leaf)."""
    what = "batched_kernel_matvec"
    if x_pad.ndim != 1:
        raise ValueError(f"{what}: x_pad must be (n_pad,), got {tuple(x_pad.shape)}")
    return _level_launch(what, points, row_ids, col_ids, x_pad[:, None], c_leaf,
                         kernel_name)[:, :, 0]


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
