"""Kernel packages: ``kernel.py`` (CUDA launch wrapper) + ``ops.py``
(dispatch) + ``ref.py`` (plain PyTorch version) per hot spot.

Dispatch rule, the same in every ``ops.py``: tensors on the CPU go to the
plain version; CUDA tensors go to the kernel, and any failure raises.
There is no size-based route to the plain version and no fallback.
"""
from __future__ import annotations

import functools

import torch


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` whose bits for each matrix do not depend on how many
    the batch holds, so that an apply in batches repeats a one-batch apply.
    On the CPU a batch of one lone column takes another route (a
    matrix-vector product, summed in another order); it runs here as a
    batch of two views of itself."""
    if a.shape[0] == 1 and b.shape[-1] == 1:
        return torch.bmm(a.expand(2, -1, -1), b.expand(2, -1, -1))[:1]
    return torch.bmm(a, b)


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True if every operand lies on the CPU (plain version), False if they
    share another device (the CUDA wrapper then launches or raises);
    raises for operands on several devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices {sorted(map(str, devices))}")
    return devices.pop().type == "cpu"


def require_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """Operand checks of a CUDA launch wrapper: one CUDA device, float32,
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def stream_handle(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device`` for a launch."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
