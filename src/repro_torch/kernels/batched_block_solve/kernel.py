"""Launch wrappers of ``csrc/block_cholesky.cu`` and ``csrc/block_cholesky_solve.cu``.

Replace ``repro/kernels/batched_block_solve/kernel.py``:
``batched_block_cholesky_t`` (factorise the shifted diagonal blocks once at
solver setup) and ``batched_block_cholesky_solve_t`` (the block-Jacobi
apply of every PCG iteration).
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle

MAX_BATCH = 65535


def batched_block_cholesky_cuda(a: torch.Tensor) -> torch.Tensor:
    """a: (B, c, c) SPD float32 CUDA tensor -> lower factors (B, c, c)."""
    what = "batched_block_cholesky"
    require_cuda_f32(what, a)
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"{what}: expected (B, c, c) blocks, got {tuple(a.shape)}")
    b, c, _ = a.shape
    if b > MAX_BATCH:
        raise ValueError(f"{what}: the kernel takes at most {MAX_BATCH} blocks, got {b}")
    lmat = torch.empty_like(a)
    if b == 0 or c == 0:
        return lmat
    dinv = torch.empty((b, c), dtype=torch.float32, device=a.device)
    fn = _build.c_function("block_cholesky", "repro_block_cholesky",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), lmat.data_ptr(), dinv.data_ptr(), b, c,
                 stream_handle(a.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return lmat


def batched_block_cholesky_solve_cuda(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """l: (B, c, c) lower factors, x: (B, c, R), float32 CUDA -> (B, c, R)."""
    what = "batched_block_cholesky_solve"
    require_cuda_f32(what, l, x)
    if l.ndim != 3 or l.shape[1] != l.shape[2] or x.ndim != 3 or x.shape[:2] != l.shape[:2]:
        raise ValueError(f"{what}: shapes l {tuple(l.shape)}, x {tuple(x.shape)} do not "
                         "match (B, c, c), (B, c, R)")
    b, c, _ = l.shape
    r = x.shape[2]
    max_c = _build.c_function("block_cholesky_solve", "repro_chol_solve_max_c",
                              [ctypes.c_int])(r)
    if c > max_c:
        raise ValueError(f"{what}: the kernel keeps a (c, R-chunk) panel in shared "
                         f"memory and takes c <= {max_c}, got {c}")
    y = torch.empty_like(x)
    if b == 0 or c == 0 or r == 0:
        return y
    fn = _build.c_function("block_cholesky_solve", "repro_block_cholesky_solve",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(l.device):
        err = fn(l.data_ptr(), x.data_ptr(), y.data_ptr(), b, c, r, stream_handle(l.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y
