"""Launch wrapper of the CUDA kernel ``csrc/schur_dense.cu``.

Replaces ``repro/kernels/batched_schur_update/kernel.py``:
``batched_schur_dense_t``.  The low-rank targets' ``batched_schur_retruncate_t``
is no kernel of its own in the reference either: it runs the recompression
kernel (``kernels/batched_recompress``) at the widened width.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, sm_count, stream_handle

# CTA tile edges the kernel is built for, largest first
SCHUR_TILES = (128, 64)


def schur_tile(b: int, m: int, n: int, sms: int) -> int:
    """CTA tile edge for (b, m, n) on a card of ``sms`` SMs: 128 when b x
    (128 x 128 tiles) gives every SM a CTA, else 64."""
    big, small = SCHUR_TILES
    return big if b * -(-m // big) * -(-n // big) >= sms else small


def batched_schur_dense_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c: (B, m, n), a: (B, m, p), b: (B, n, p) float32 CUDA -> C - A B^T."""
    what = "batched_schur_dense"
    require_cuda_f32(what, c, a, b)
    if c.ndim != 3 or a.ndim != 3 or b.ndim != 3 or a.shape[:2] != c.shape[:2] \
            or b.shape[0] != c.shape[0] or b.shape[1] != c.shape[2] or b.shape[2] != a.shape[2]:
        raise ValueError(f"{what}: shapes c {tuple(c.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not match (B, m, n), (B, m, p), (B, n, p)")
    nb, m, n = c.shape
    p = a.shape[2]
    if nb * -(-m // 64) * -(-n // 64) > 2 ** 31 - 1:
        raise ValueError(f"{what}: the kernel takes at most 2^31 - 1 output tiles of 64 x 64, "
                         f"got {nb} x {m} x {n}")
    y = torch.empty_like(c)
    if nb == 0 or m == 0 or n == 0:
        return y
    tile = schur_tile(nb, m, n, sm_count(c.device))
    fn = _build.c_function("schur_dense", "repro_schur_dense",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(c.device):
        err = fn(c.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), nb, m, n, p, tile,
                 stream_handle(c.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y
