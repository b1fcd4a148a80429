"""Launch wrapper of the CUDA kernel ``csrc/recompress.cu``.

Replaces ``repro/kernels/batched_recompress/kernel.py``:
``batched_recompress_t`` (Gram matrices with jitter, Cholesky, triangular
inverses, one-sided Jacobi of the k x k core, truncation), with the
descending-sigma sort of ``repro``'s dispatcher folded into the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle

MAX_K = 64
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def batched_recompress_cuda(u: torch.Tensor, v: torch.Tensor, tol: float):
    """u: (B, m, k), v: (B, n, k) float32 CUDA tensors -> ``(u2, v2, s, ranks,
    sweeps)``: the truncated factors (columns in descending-sigma order,
    dropped columns zero), the (B, k) truncated singular values in the same
    order, and (B,) int32 surviving ranks and Jacobi sweeps run."""
    what = "batched_recompress"
    require_cuda_f32(what, u, v)
    if u.ndim != 3 or v.ndim != 3 or u.shape[0] != v.shape[0] or u.shape[2] != v.shape[2]:
        raise ValueError(f"{what}: shapes u {tuple(u.shape)}, v {tuple(v.shape)} do not "
                         "match (B, m, k), (B, n, k)")
    b, m, k = u.shape
    n = v.shape[1]
    if not 1 <= k <= MAX_K or m == 0 or n == 0:
        raise ValueError(f"{what}: the kernel takes 1 <= k <= {MAX_K} and non-empty panels, "
                         f"got k={k}, m={m}, n={n}")
    dev = u.device
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    s = torch.empty((b, k), dtype=torch.float32, device=dev)
    ranks = torch.empty((b,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return u2, v2, s, ranks, sweeps
    splits = _build.c_function("recompress", "repro_recompress_splits",
                               [ctypes.c_int, ctypes.c_int])(m, n)
    log_floats = _build.c_function("recompress", "repro_recompress_log_floats",
                                   [ctypes.c_int])(k)
    part = torch.empty((2 * b * splits * k * k,), dtype=torch.float32, device=dev)
    tmat = torch.empty((2 * b * k * k,), dtype=torch.float32, device=dev)
    tlog = torch.empty((b * log_floats,), dtype=torch.float32, device=dev)
    fn = _build.c_function("recompress", "repro_batched_recompress", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(), s.data_ptr(),
                 ranks.data_ptr(), sweeps.data_ptr(), part.data_ptr(), tmat.data_ptr(),
                 tlog.data_ptr(), b, m, n, k, float(tol), stream_handle(dev))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return u2, v2, s, ranks, sweeps
