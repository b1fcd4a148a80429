"""Device selection shared by the entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    With ``device=None`` and no CUDA card this raises instead of carrying on
    quietly on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def as_f32(x, device: torch.device) -> torch.Tensor:
    """numpy array / tensor / sequence -> contiguous float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device).contiguous()
