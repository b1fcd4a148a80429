"""Launch wrapper of the CUDA kernel ``csrc/hattention_nearfield.cu``.

Replaces ``repro/kernels/hattention_block/kernel.py``: ``hattention_nearfield``,
the dense near field of H-matrix attention (``core/hattention.h_attention``).
Its backward (``csrc/hattention_nearfield_bwd.cu``, #11b) replaces no TPU
kernel: ``repro`` differentiates its einsum near field with ``jax.grad``.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import require_cuda_f32, stream_handle

HEAD_DIMS = (16, 32, 64, 128)


def hattention_nearfield_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v: (BH, n_leaf, c, D) float32 CUDA, q pre-scaled, D in
    ``HEAD_DIMS`` -> num (BH, n_leaf, c, D), den and m (BH, n_leaf, c)."""
    what = "hattention_nearfield"
    require_cuda_f32(what, q, k, v)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must all be (BH, n_leaf, c, D)")
    bh, nl, c, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims {HEAD_DIMS}, got {d}")
    if bh * nl * -(-c // 128) > 2 ** 31 - 1:
        raise ValueError(f"{what}: {bh} x {nl} leaves of {c} rows exceed the kernel's grid")
    num = torch.empty_like(q)
    den = q.new_empty((bh, nl, c))
    m = q.new_empty((bh, nl, c))
    if bh == 0 or nl == 0 or c == 0:
        return num, den, m
    fn = _build.c_function("hattention_nearfield", "repro_hattention_nearfield",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), num.data_ptr(), den.data_ptr(),
                 m.data_ptr(), bh, nl, c, d, stream_handle(q.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return num, den, m


def hattention_nearfield_bwd_cuda(q, k, v, num, den, m, gnum, gden, gm):
    """Kernel #11b, the backward of #11 (``csrc/hattention_nearfield_bwd.cu``).

    q, k, v, num, gnum: (BH, n_leaf, c, D); den, m, gden, gm: (BH, n_leaf,
    c); float32 CUDA, contiguous; ``num``, ``den`` and ``m`` as #11 computed
    them from these q, k, v (the kernel finds each row's arg-max by
    ``s == m``, recomputing the scores in #11's order).  Returns dq, dk, dv
    (BH, n_leaf, c, D).  One count a call (three CUDA launches: dq, the
    rows whose max ties, dk and dv).  The products run on
    the tensor cores at fp32 accuracy (3xTF32, split in the kernel); the
    scores that may attain a row's max are recomputed in #11's order.  No
    TF32 flag is read or set.
    """
    what = "hattention_nearfield_bwd"
    require_cuda_f32(what, q, k, v, num, den, m, gnum, gden, gm)
    if q.ndim != 4 or any(t.shape != q.shape for t in (k, v, num, gnum)) or \
            any(t.shape != q.shape[:3] for t in (den, m, gden, gm)):
        raise ValueError(f"{what}: q, k, v, num, gnum must be (BH, n_leaf, c, D) and den, m, "
                         f"gden, gm (BH, n_leaf, c); got q {tuple(q.shape)}")
    bh, nl, c, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims {HEAD_DIMS}, got {d}")
    if bh * nl * -(-c // 64) > 2 ** 31 - 1:
        raise ValueError(f"{what}: {bh} x {nl} leaves of {c} rows exceed the kernel's grid")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if bh == 0 or nl == 0 or c == 0:
        return dq, dk, dv
    scratch = q.new_empty((3, bh, nl, c))
    ties = torch.empty((bh, nl, c), dtype=torch.int32, device=q.device)
    stash = q.new_empty((2, bh, nl, c, 2 * c))      # ds and p, from the dq pass to dk, dv
    fn = _build.c_function("hattention_nearfield_bwd", "repro_hattention_nearfield_bwd",
                           [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in (q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv,
                                         scratch, ties, stash)),
                 bh, nl, c, d, stream_handle(q.device))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return dq, dk, dv


def hattention_nearfield_bwd_info(d: int) -> dict:
    """Resources of #11b's dq and dk/dv kernels at head dim ``d`` on the
    current card: registers and local (spill) bytes a thread, dynamic
    shared bytes a CTA and resident CTAs an SM (CUDA's occupancy calculator)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"hattention_nearfield_bwd_info: head dims {HEAD_DIMS}, got {d}")
    out = (ctypes.c_int * 8)()
    fn = _build.c_function("hattention_nearfield_bwd", "repro_hattention_nearfield_bwd_info",
                           [ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(d, ctypes.addressof(out)), "hattention_nearfield_bwd_info")
    keys = ("registers", "spill_bytes", "shared_bytes", "ctas_per_sm")
    return {kernel: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, kernel in enumerate(("dq", "dkv"))}
