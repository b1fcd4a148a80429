"""Point sets and kernel functions for the paper's model problem (§6.2).

Port of ``repro.core.geometry``.  ``A[i, j] = phi(y_i, y_j)`` with ``Y`` a
Halton sequence on [0, 1]^d and ``phi`` the unscaled Gaussian or the Matérn
kernel with ``beta - d/2 = 1``.  Squared distances here use the EXPANSION
form ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0, as the reference's plain path
does; the kernels (``repro_torch.kernels.phi``) use direct differences.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)


def _radical_inverse(indices: torch.Tensor, base: int, n_digits: int) -> torch.Tensor:
    """Radical inverse of ``indices`` in ``base``, accumulated in float32
    digit by digit in the reference's order."""
    idx = indices.to(torch.int64)
    result = torch.zeros(indices.shape, dtype=torch.float32, device=indices.device)
    inv_base = 1.0 / base
    f = inv_base
    for _ in range(n_digits):
        digit = (idx % base).to(torch.float32)
        # the reference multiplies by a weakly typed Python float: f32 math
        result = result + digit * torch.tensor(f, dtype=torch.float32)
        idx = idx // base
        f = f * inv_base
    return result


def halton(n: int, d: int, device=None) -> torch.Tensor:
    """First ``n`` points of the ``d``-dimensional Halton sequence, (n, d) f32.

    Built on the CPU (the digit loop is cheap) and moved to ``device``.
    """
    if d > len(_PRIMES):
        raise ValueError(f"halton supports d <= {len(_PRIMES)}")
    idx = torch.arange(1, n + 1, dtype=torch.int64)
    n_digits = max(8, int(math.ceil(math.log(n + 1) / math.log(2))) + 1)
    cols = [_radical_inverse(idx, _PRIMES[j], n_digits) for j in range(d)]
    pts = torch.stack(cols, dim=-1)
    return pts if device is None else pts.to(device)


def _sqdist(y: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between (..., m, d) and (..., n, d)."""
    na = (y * y).sum(-1)[..., :, None]
    nb = (yp * yp).sum(-1)[..., None, :]
    cross = torch.matmul(y, yp.transpose(-1, -2))
    return torch.clamp(na + nb - 2.0 * cross, min=0.0)


def gaussian_kernel(y: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """phi_G(y, y') = exp(-|y - y'|^2)   (paper §6.2, unscaled)."""
    return torch.exp(-_sqdist(y, yp))


def bessel_k1(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel function K_1 via Abramowitz & Stegun 9.8.7 / 9.8.8,
    the same float32 polynomials as the reference."""
    small = x <= 2.0
    xs = torch.where(small, x, torch.full_like(x, 2.0))
    xl = torch.where(small, torch.full_like(x, 2.0), x)
    t = (xs / 3.75) ** 2
    i1 = xs * (0.5 + t * (0.87890594 + t * (0.51498869 + t * (0.15084934
         + t * (0.02658733 + t * (0.00301532 + t * 0.00032411))))))
    u = (xs / 2.0) ** 2
    p = 1.0 + u * (0.15443144 + u * (-0.67278579 + u * (-0.18156897
        + u * (-0.01919402 + u * (-0.00110404 + u * (-0.00004686))))))
    k1_small = torch.log(xs / 2.0) * i1 + p / xs
    w = 2.0 / xl
    q = 1.25331414 + w * (0.23498619 + w * (-0.03655620 + w * (0.01504268
        + w * (-0.00780353 + w * (0.00325614 + w * (-0.00068245))))))
    k1_large = torch.exp(-xl) / torch.sqrt(xl) * q
    return torch.where(small, k1_small, k1_large)


def matern_norm(d: int) -> float:
    """Normaliser ``2^(beta-1) Gamma(beta)`` with ``beta = d/2 + 1``."""
    beta = d / 2.0 + 1.0
    return (2.0 ** (beta - 1.0)) * math.gamma(beta)


def matern_kernel(y: torch.Tensor, yp: torch.Tensor, d: int | None = None) -> torch.Tensor:
    """Matérn kernel with ``beta - d/2 = 1`` (paper §6.2)."""
    if d is None:
        d = y.shape[-1]
    r = torch.sqrt(_sqdist(y, yp))
    val = torch.where(r > 1e-8, r * bessel_k1(torch.clamp(r, min=1e-30)),
                      torch.ones_like(r))
    return val / matern_norm(d)


KERNELS: dict[str, Callable] = {
    "gaussian": gaussian_kernel,
    "matern": matern_kernel,
}


def get_kernel(name: str) -> Callable:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    return KERNELS[name]


def kernel_name_of(kernel: Callable | str) -> str:
    """Registered name of a kernel function (the kernels take names)."""
    if isinstance(kernel, str):
        return kernel
    for name, fn in KERNELS.items():
        if fn is kernel:
            return name
    raise ValueError(f"kernel {kernel!r} is not registered; have {sorted(KERNELS)}")


def dense_kernel_matrix(points: torch.Tensor, kernel: Callable | str = "gaussian",
                        points_b: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: the full dense collocation matrix (test use only)."""
    if isinstance(kernel, str):
        kernel = get_kernel(kernel)
    pb = points if points_b is None else points_b
    return kernel(points, pb)


_TARGET_FREQS = ((4.0, 3.0), (2.0, 5.0), (6.0, 1.0), (3.0, 3.0),
                 (5.0, 2.0), (1.0, 6.0), (4.0, 4.0), (2.0, 2.0))


def sinusoid_targets(pts, r: int, domain: float = 1.0) -> torch.Tensor:
    """R regression targets f_j(y) = sin(a_j y_0 / D) cos(b_j y_1 / D).

    Computed in NumPy on the host, as the reference does, and returned as an
    (N, R) float32 tensor on the device of ``pts`` (CPU for an array).
    """
    device = pts.device if isinstance(pts, torch.Tensor) else torch.device("cpu")
    y = pts.detach().cpu().numpy() if isinstance(pts, torch.Tensor) else np.asarray(pts)
    freqs = (_TARGET_FREQS * ((r + len(_TARGET_FREQS) - 1)
                              // len(_TARGET_FREQS)))[:r]
    cols = [np.sin(a * y[:, 0] / domain) * np.cos(b * y[:, 1] / domain)
            for a, b in freqs]
    return torch.from_numpy(np.stack(cols, axis=1).astype(np.float32)).to(device)
