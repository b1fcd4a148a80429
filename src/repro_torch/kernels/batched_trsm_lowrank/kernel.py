"""Launch wrapper of the CUDA kernel ``csrc/trsm_panels.cu``.

Replaces ``repro/kernels/batched_trsm_lowrank/kernel.py``:
``batched_trsm_panels_t``, the TRSM task of the H-Cholesky schedule.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from .. import require_cuda_f32, sm_count, stream_handle

# panel columns per CTA the kernel is built for, widest first
CHUNK_COLS = (32, 16, 8, 4)


@functools.lru_cache(maxsize=None)
def max_c(rc: int) -> int:
    """Largest c the kernel takes at rc panel columns per CTA (its (c, rc)
    chunk must fit in shared memory)."""
    return _build.c_function("trsm_panels", "repro_trsm_max_c", [ctypes.c_int])(rc)


def chunk_cols(b: int, c: int, p: int, sms: int) -> int:
    """Panel columns per CTA for (b, c, p) on a card of ``sms`` SMs: the
    narrowest width that covers P, or the widest whose chunk fits; then
    halved while the grid has fewer CTAs than half the SMs (a CTA's time
    grows with its columns' diagonal chains).  0 when no width fits c."""
    fits = [rc for rc in CHUNK_COLS if c <= max_c(rc)]
    if not fits:
        return 0
    rc = min([w for w in fits if w >= p] or [fits[0]])
    while rc > CHUNK_COLS[-1] and b * -(-p // rc) < sms // 2:
        rc //= 2
    return rc


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
    rc = chunk_cols(b, c, p, sm_count(x.device))
    if rc == 0:
        raise ValueError(f"{what}: the kernel keeps at least a (c, {CHUNK_COLS[-1]}) panel "
                         f"chunk in shared memory and takes c <= {max_c(CHUNK_COLS[-1])}, "
                         f"got {c}")
    y = torch.empty_like(x)
    if b == 0 or c == 0 or p == 0:
        return y
    stride = c * c if l.shape[0] == b and b > 1 else 0
    fn = _build.c_function("trsm_panels", "repro_trsm_panels",
                           [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(l.data_ptr(), stride, x.data_ptr(), y.data_ptr(), b, c, p, rc,
                 stream_handle(x.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y
