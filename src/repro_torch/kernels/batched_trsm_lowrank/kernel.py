"""Launch wrapper of the CUDA kernel ``csrc/trsm_panels.cu``.

Replaces ``repro/kernels/batched_trsm_lowrank/kernel.py``:
``batched_trsm_panels_t``, the TRSM task of the H-Cholesky schedule.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle


def batched_trsm_panels_cuda(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """l: (B, c, c) lower, or (1, c, c) shared by the batch (read with batch
    stride 0, never copied B times); x: (B, c, P); float32 CUDA -> (B, c, P)."""
    what = "batched_trsm_panels"
    require_cuda_f32(what, l, x)
    if l.ndim != 3 or x.ndim != 3 or l.shape[1] != l.shape[2] or x.shape[1] != l.shape[1] \
            or l.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"{what}: shapes l {tuple(l.shape)}, x {tuple(x.shape)} do not "
                         "match (B or 1, c, c), (B, c, P)")
    b, c, p = x.shape
    max_c = _build.c_function("trsm_panels", "repro_trsm_max_c", [])()
    if c > max_c:
        raise ValueError(f"{what}: the kernel keeps a (c, 8) panel chunk in shared memory "
                         f"and takes c <= {max_c}, got {c}")
    y = torch.empty_like(x)
    if b == 0 or c == 0 or p == 0:
        return y
    stride = c * c if l.shape[0] == b and b > 1 else 0
    fn = _build.c_function("trsm_panels", "repro_trsm_panels",
                           [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(l.data_ptr(), stride, x.data_ptr(), y.data_ptr(), b, c, p,
                 stream_handle(x.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y
