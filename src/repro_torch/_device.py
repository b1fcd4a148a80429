"""Device selection shared by the entry points, the host fetch and the
sync-debug window of the strict-transfer guard."""
from __future__ import annotations

import contextlib
import threading

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


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a host tensor.

    From a card: an asynchronous copy into pinned memory on the current
    stream, then a wait on an event recorded after it.  Neither is an
    operation that ``torch.cuda.set_sync_debug_mode("error")`` rejects, so a
    client thread may fetch while a launch runs inside a strict window
    (:func:`sync_debug_window`).  A host tensor comes back as it is.
    """
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    copied.synchronize()
    return host


def release_pinned_host_memory() -> None:
    """Give back to the system the pinned host blocks that PyTorch's caching
    host allocator keeps unused (a panel's staging rows and fetched results
    are pinned; freed, they stay cached and page-locked).  Blocks in use are
    untouched.  ``torch.accelerator.empty_host_cache`` where the release has
    it, ``torch._C._host_emptyCache`` in older ones; nothing without either."""
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    if empty is not None and torch.cuda.is_available():
        empty()


# the strict windows open across threads: PyTorch's sync-debug mode is one
# process-wide setting, so the first window to open sets it and the last to
# close restores what was there before
_WINDOW_LOCK = threading.Lock()
_WINDOWS = {"open": 0, "saved": 0, "exempt": 0}


@contextlib.contextmanager
def sync_debug_window(device):
    """Run the body with ``torch.cuda.set_sync_debug_mode("error")``: a
    synchronizing CUDA operation (``.item()``, a blocking copy, a stream
    synchronize, an op that sizes its result by the data) raises instead of
    stalling.  The mode is process-wide: while any window is open it holds
    for every thread.  The mode found when the first window opened is
    restored when the last one closes.  A no-op unless ``device`` is CUDA
    (``set_sync_debug_mode`` asserts without a card)."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _WINDOW_LOCK:
        if _WINDOWS["open"] == 0:
            _WINDOWS["saved"] = torch.cuda.get_sync_debug_mode()
        _WINDOWS["open"] += 1
        if _WINDOWS["exempt"] == 0:
            torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        with _WINDOW_LOCK:
            _WINDOWS["open"] -= 1
            if _WINDOWS["open"] == 0:
                torch.cuda.set_sync_debug_mode(_WINDOWS["saved"])


@contextlib.contextmanager
def documented_sync():
    """A documented host read inside a strict window (the PCG's per-iteration
    ``active.any()``, queue 1 B1): the sync-debug mode is lifted for its
    duration, for every thread, and set again after it while a window is
    still open.  A no-op outside windows and on the CPU."""
    with _WINDOW_LOCK:
        lifted = _WINDOWS["open"] > 0
        if lifted:
            _WINDOWS["exempt"] += 1
            if _WINDOWS["exempt"] == 1:
                torch.cuda.set_sync_debug_mode(_WINDOWS["saved"])
    try:
        yield
    finally:
        if lifted:
            with _WINDOW_LOCK:
                _WINDOWS["exempt"] -= 1
                if _WINDOWS["open"] > 0 and _WINDOWS["exempt"] == 0:
                    torch.cuda.set_sync_debug_mode("error")
