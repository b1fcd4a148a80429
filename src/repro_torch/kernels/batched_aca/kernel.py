"""Launch wrapper of the CUDA kernel ``csrc/lowrank_matmat.cu``.

Replaces ``repro/kernels/batched_aca/kernel.py:batched_lowrank_matmat_t``:
``Y[b] = U[b] (V[b]^T X[b])`` for one level group of ACA factors.  The ACA
itself (``batched_aca_t``) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_K = 64
MAX_KR = 1024        # k * R per launch; wider panels go in column chunks
MAX_BATCH = 65535


def batched_lowrank_matmat_cuda(u: torch.Tensor, v: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """u: (B, m, k), v: (B, n, k), x: (B, n, R) float32 CUDA tensors -> (B, m, R)."""
    what = "batched_lowrank_matmat"
    require_cuda_f32(what, u, v, x)
    if u.ndim != 3 or v.ndim != 3 or x.ndim != 3 or v.shape[0] != u.shape[0] \
            or v.shape[2] != u.shape[2] or x.shape[:2] != v.shape[:2]:
        raise ValueError(f"{what}: shapes u {tuple(u.shape)}, v {tuple(v.shape)}, "
                         f"x {tuple(x.shape)} do not match (B, m, k), (B, n, k), (B, n, R)")
    b, m, k = u.shape
    n, r = v.shape[1], x.shape[2]
    if not 1 <= k <= MAX_K or b > MAX_BATCH:
        raise ValueError(f"{what}: the kernel takes 1 <= k <= {MAX_K} and at most "
                         f"{MAX_BATCH} blocks, got k={k}, B={b}")
    y = torch.empty((b, m, r), dtype=torch.float32, device=u.device)
    if b == 0 or m == 0 or r == 0:
        return y
    width = max(1, MAX_KR // k)
    splits_of = _build.c_function("lowrank_matmat", "repro_lowrank_splits", [ctypes.c_int])
    fn = _build.c_function("lowrank_matmat", "repro_lowrank_matmat", _ARGTYPES)
    with torch.cuda.device(u.device):
        for c0 in range(0, r, width):
            xc = x if width >= r else x[:, :, c0:c0 + width].contiguous()
            rc = xc.shape[2]
            yc = y if width >= r else torch.empty((b, m, rc), dtype=torch.float32,
                                                  device=u.device)
            part = torch.empty((b * splits_of(n) * k * rc,), dtype=torch.float32,
                               device=u.device)
            tmat = torch.empty((b * k * rc,), dtype=torch.float32, device=u.device)
            err = fn(u.data_ptr(), v.data_ptr(), xc.data_ptr(), yc.data_ptr(),
                     part.data_ptr(), tmat.data_ptr(), b, m, n, k, rc,
                     stream_handle(u.device))
            _build.check(err, what)
            _build.LAUNCHES[what] += 1
            if yc is not y:
                y[:, :, c0:c0 + rc] = yc
    return y
