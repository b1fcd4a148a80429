"""The port's float32 guard: entry points refuse CUDA work while TF32 is on.

``torch.backends.cuda.matmul.allow_tf32`` and the float32 matmul precision
are process-wide, so the port checks them (``_device.require_full_fp32``)
instead of flipping them.  A ``torch.device("cuda")`` object needs no card,
so the check itself and the build entry points (which check before any
tensor reaches the device) are tested here; the entry points that take CUDA
tensors are tested on the card (``tests/test_torch_cuda.py``).  Every flag
is restored after each test, each through the spelling that set it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_hmatrix, build_hmatrix_device, make_apply
from repro_torch._device import require_full_fp32, tf32_matmul_enabled
from repro_torch.solve import make_solver
from torch_parity_util import one_torch_thread  # noqa: F401

MATMUL = torch.backends.cuda.matmul


@pytest.fixture()
def precision():
    """Sets the float32 matmul precision; restores "highest" afterwards."""
    old = torch.get_float32_matmul_precision()
    yield torch.set_float32_matmul_precision
    torch.set_float32_matmul_precision(old)


def _tf32_on(how, monkeypatch, precision):
    if how == "allow_tf32":
        monkeypatch.setattr(MATMUL, "allow_tf32", True)
    elif how == "precision_high":
        precision("high")
    elif how == "precision_medium":
        precision("medium")
    elif how == "fp32_precision":
        monkeypatch.setattr(MATMUL, "fp32_precision", "tf32")
    else:
        raise AssertionError(how)


ALL_SPELLINGS = ["allow_tf32", "precision_high", "precision_medium", "fp32_precision"]


def test_defaults_are_full_fp32():
    assert not tf32_matmul_enabled()
    require_full_fp32("test", torch.device("cuda"))
    require_full_fp32("test", "cuda:0")


@pytest.mark.parametrize("how", ALL_SPELLINGS)
def test_guard_raises_for_cuda_with_tf32_on(how, monkeypatch, precision):
    _tf32_on(how, monkeypatch, precision)
    assert tf32_matmul_enabled()
    with pytest.raises(RuntimeError, match="TF32"):
        require_full_fp32("test", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="TF32"):
        require_full_fp32("test", "cuda:1")
    require_full_fp32("test", torch.device("cpu"))            # CPU operands are not checked


@pytest.mark.parametrize("how", ALL_SPELLINGS)
def test_guard_silent_again_once_tf32_is_off(how, monkeypatch, precision):
    _tf32_on(how, monkeypatch, precision)
    if how == "allow_tf32":
        MATMUL.allow_tf32 = False
    elif how == "fp32_precision":
        MATMUL.fp32_precision = "ieee"
    else:
        precision("highest")
    assert not tf32_matmul_enabled()
    require_full_fp32("test", torch.device("cuda"))


@pytest.mark.parametrize("how", ["allow_tf32", "precision_high", "fp32_precision"])
@pytest.mark.parametrize("builder", [build_hmatrix, build_hmatrix_device])
def test_build_entry_points_raise_for_cuda_with_tf32_on(how, builder, monkeypatch, precision):
    _tf32_on(how, monkeypatch, precision)
    pts = np.random.RandomState(0).rand(300, 2).astype(np.float32)
    with pytest.raises(RuntimeError, match=f"{builder.__name__}: TF32"):
        builder(pts, "gaussian", k=4, c_leaf=64, device="cuda")


@pytest.mark.parametrize("how", ["allow_tf32", "precision_high", "fp32_precision"])
def test_cpu_path_runs_unchanged_with_tf32_on(how, monkeypatch, precision):
    pts = np.random.RandomState(1).rand(300, 2).astype(np.float32)
    x = np.random.RandomState(2).randn(300, 3).astype(np.float32)
    hm = build_hmatrix(pts, "gaussian", k=4, c_leaf=64, precompute=True, device="cpu")
    want = make_apply(hm)(x)
    want_sol = make_solver(hm, 1e-2, tol=1e-4)(x)[0]
    _tf32_on(how, monkeypatch, precision)
    hm2 = build_hmatrix_device(pts, "gaussian", k=4, c_leaf=64, precompute=True, device="cpu")
    assert torch.equal(make_apply(hm)(x), want)
    assert torch.equal(make_solver(hm, 1e-2, tol=1e-4)(x)[0], want_sol)
    assert torch.isfinite(make_apply(hm2)(x)).all()
