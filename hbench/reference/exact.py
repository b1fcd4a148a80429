"""Plain reference of the served apply: exact kernel rows times the requests.

``A[i, j] = phi(y_i, y_j)`` over the configuration's points, with ``phi``
the unscaled Gaussian ``exp(-|y - y'|^2)`` or the Matérn kernel with
``beta - d/2 = 1``, ``r K_1(r) / (2^(beta - 1) Gamma(beta))`` (1 at r = 0),
as the paper's §6.2 defines them.  ``K_1`` is a frozen copy of the
Abramowitz & Stegun 9.8.7 / 9.8.8 polynomials, the function the
configuration names, evaluated here in float64.

Rows ``A[rows, :] @ V`` are computed in blocks of rows, squared distances
as direct differences, all in float64.  Plain PyTorch; nothing of the
program is imported or read.

The control (:func:`control_rows`) is this reference one precision below
the configuration's float32 with TF32 off: entries in float32, their
product with the requests in TF32 (both operands rounded to TF32's 10-bit
mantissa, products summed in float32), which is what a float32 matrix
product on the tensor cores computes.
"""
from __future__ import annotations

import math

import torch


def bessel_k1(x: torch.Tensor) -> torch.Tensor:
    """K_1(x), x > 0, by A&S 9.8.7 (x <= 2) and 9.8.8 (x > 2)."""
    small = x <= 2.0
    xs = torch.where(small, x, torch.full_like(x, 2.0))
    xl = torch.where(small, torch.full_like(x, 2.0), x)
    t = (xs / 3.75) ** 2
    i1 = xs * (0.5 + t * (0.87890594 + t * (0.51498869 + t * (0.15084934
         + t * (0.02658733 + t * (0.00301532 + t * 0.00032411))))))
    u = (xs / 2.0) ** 2
    p = 1.0 + u * (0.15443144 + u * (-0.67278579 + u * (-0.18156897
        + u * (-0.01919402 + u * (-0.00110404 + u * (-0.00004686))))))
    k_small = torch.log(xs / 2.0) * i1 + p / xs
    w = 2.0 / xl
    q = 1.25331414 + w * (0.23498619 + w * (-0.03655620 + w * (0.01504268
        + w * (-0.00780353 + w * (0.00325614 + w * (-0.00068245))))))
    k_large = torch.exp(-xl) / torch.sqrt(xl) * q
    return torch.where(small, k_small, k_large)


def phi(d2: torch.Tensor, kernel: str, d: int) -> torch.Tensor:
    """The kernel function of squared distances ``d2``."""
    if kernel == "gaussian":
        return torch.exp(-d2)
    if kernel == "matern":
        beta = d / 2.0 + 1.0
        r = torch.sqrt(d2)
        val = torch.where(r > 1e-8, r * bessel_k1(torch.clamp(r, min=1e-30)),
                          torch.ones_like(r))
        return val / ((2.0 ** (beta - 1.0)) * math.gamma(beta))
    raise ValueError(f"unknown kernel {kernel!r}")


def entries(points: torch.Tensor, rows: torch.Tensor, kernel: str) -> torch.Tensor:
    """``A[rows, :]`` in the dtype of ``points``: (len(rows), N)."""
    y = points[rows]
    d2 = torch.zeros((y.shape[0], points.shape[0]), dtype=points.dtype, device=points.device)
    for k in range(points.shape[1]):
        diff = y[:, k, None] - points[None, :, k]
        d2 += diff * diff
    return phi(d2, kernel, points.shape[1])


def exact_rows(points: torch.Tensor, rows, vectors: torch.Tensor, kernel: str,
               block: int = 32) -> torch.Tensor:
    """``A[rows, :] @ vectors.T`` in float64: points (N, d), vectors (P, N)
    -> (len(rows), P)."""
    pts = points.to(torch.float64)
    vec = vectors.to(device=pts.device, dtype=torch.float64)
    rows = torch.as_tensor(rows, device=pts.device)
    out = [entries(pts, rows[i:i + block], kernel) @ vec.T
           for i in range(0, rows.shape[0], block)]
    return torch.cat(out)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as the conversion to the tensor
    cores' input format rounds."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def control_rows(points: torch.Tensor, rows, vectors: torch.Tensor, kernel: str,
                 precision: dict, block: int = 32) -> torch.Tensor:
    """The control: the rows one precision below the configuration's
    ``precision``, which has to be float32 with TF32 off: in TF32 (float32
    entries and requests rounded to TF32, the products summed in float32),
    (len(rows), P)."""
    if precision != {"dtype": "float32", "tf32": False}:
        raise ValueError(f"no control below {precision}")
    pts = points.to(torch.float32)
    vec = round_tf32(vectors.to(device=pts.device, dtype=torch.float32))
    rows = torch.as_tensor(rows, device=pts.device)
    out = [round_tf32(entries(pts, rows[i:i + block], kernel)) @ vec.T
           for i in range(0, rows.shape[0], block)]
    return torch.cat(out)
