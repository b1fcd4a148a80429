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


def tf32_matmul_enabled() -> bool:
    """True while PyTorch may run float32 matrix products in TF32: the
    legacy ``torch.backends.cuda.matmul.allow_tf32``, a float32 matmul
    precision other than "highest" (``torch.set_float32_matmul_precision``),
    or the newer ``fp32_precision`` spelling set to "tf32"."""
    matmul = torch.backends.cuda.matmul
    if getattr(matmul, "fp32_precision", None) == "tf32":
        return True
    try:
        return bool(matmul.allow_tf32) or torch.get_float32_matmul_precision() != "highest"
    except RuntimeError:
        # PyTorch refuses to read the legacy flags once both spellings were set
        return True


def require_full_fp32(what: str, device) -> None:
    """Raise ``RuntimeError`` for a CUDA ``device`` while TF32 is enabled for
    float32 matmuls.  The H-matrix path keeps full float32 products, as the
    reference does; the flag is process-wide, so it is checked, never flipped
    here.  CPU devices are not checked."""
    if torch.device(device).type == "cuda" and tf32_matmul_enabled():
        raise RuntimeError(
            f"{what}: TF32 is enabled for float32 matmuls "
            "(torch.backends.cuda.matmul.allow_tf32, torch.set_float32_matmul_precision or "
            "torch.backends.cuda.matmul.fp32_precision); repro_torch needs full float32 "
            "products: set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') before calling it")
