"""The reference equals a dense product at a tiny N, and the control is
one precision below it."""
from __future__ import annotations

import math

import numpy as np
import pytest
import scipy.special
import torch


def dense(points: np.ndarray, kernel: str) -> np.ndarray:
    """The whole kernel matrix in float64 with scipy's K_1."""
    d = points.shape[1]
    r2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    if kernel == "gaussian":
        return np.exp(-r2)
    r = np.sqrt(r2)
    beta = d / 2.0 + 1.0
    with np.errstate(invalid="ignore", divide="ignore"):
        val = np.where(r > 1e-8, r * scipy.special.k1(np.maximum(r, 1e-30)), 1.0)
    return val / (2.0 ** (beta - 1.0) * math.gamma(beta))


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d", [2, 3])
def test_reference_rows_equal_a_dense_product(kernel, d):
    from harness import inputs
    from reference.exact import exact_rows
    pts = inputs.halton(300, d, "cpu")
    vec = torch.from_numpy(np.random.default_rng(d).standard_normal((5, 300)).astype(np.float32))
    rows = np.array([0, 17, 150, 299])
    got = exact_rows(pts, torch.from_numpy(rows), vec, kernel, block=3).numpy()
    want = dense(pts.numpy().astype(np.float64), kernel)[rows] @ vec.numpy().T.astype(np.float64)
    # A&S 9.8.7 holds K_1 to a few 1e-8 relative; the Gaussian is exact
    np.testing.assert_allclose(got, want, rtol=2e-6 if kernel == "matern" else 1e-12,
                               atol=1e-9 * np.abs(want).max())


def test_bessel_k1_matches_scipy():
    from reference.exact import bessel_k1
    x = torch.linspace(1e-3, 6.0, 2000, dtype=torch.float64)
    np.testing.assert_allclose(bessel_k1(x).numpy(), scipy.special.k1(x.numpy()), rtol=3e-7)


def test_round_tf32_keeps_ten_mantissa_bits():
    from reference.exact import round_tf32
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0000002, 1e-30],
                     dtype=torch.float32)
    y = round_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2.0 ** -10
    assert y[1] == 1.0 + 2.0 ** -10            # the tie rounds away from zero
    bits = y.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0
    rel = ((y - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -11


FP32 = {"dtype": "float32", "tf32": False}


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
def test_control_parts_from_the_reference_by_tf32_rounding(kernel):
    from harness import inputs
    from reference.exact import control_rows, exact_rows
    pts = inputs.halton(2048, 2, "cpu")
    vec = torch.from_numpy(inputs.request_pool(3, 8, 2048, "cpu"))
    rows = torch.arange(0, 2048, 16)
    ref = exact_rows(pts, rows, vec, kernel).numpy()
    ctl = control_rows(pts, rows, vec, kernel, FP32).numpy().astype(np.float64)
    rel = np.linalg.norm(ctl - ref, axis=0) / np.linalg.norm(ref, axis=0)
    assert np.all(rel > 1e-5) and np.all(rel < 1e-2)
    with pytest.raises(ValueError):                     # no control below TF32 here
        control_rows(pts, rows, vec, kernel, dict(FP32, tf32=True))
