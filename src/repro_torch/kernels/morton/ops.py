"""Dispatch of the Morton encode (paper Algorithm 6), the first stage of the
device build."""
from __future__ import annotations

import torch

from .. import on_cpu
from .kernel import morton_encode_cuda
from .ref import morton_encode_ref


def morton_encode(coords: torch.Tensor) -> torch.Tensor:
    """Morton codes of (N, d) points in the unit box as one int64 each.

    CPU tensors run the plain version, CUDA tensors the kernel.
    """
    if on_cpu("morton_encode", coords):
        return morton_encode_ref(coords)
    return morton_encode_cuda(coords)
