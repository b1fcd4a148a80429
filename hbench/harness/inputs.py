"""The inputs both sides are handed: the configuration's points, the
request pool made from the seed, and the rows the judge samples.

The points are the configuration's (a Halton sequence on the unit cube,
the same for every seed); the pool and the sampled rows come from the seed.
Everything is made on the device in a few large calls.
"""
from __future__ import annotations

import numpy as np
import torch

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)


def seed64(seed: int) -> int:
    """A seed as a non-negative 63-bit integer (numpy and torch take it)."""
    return int(seed) % (1 << 63)


def halton(n: int, d: int, device) -> torch.Tensor:
    """The first ``n`` points of the ``d``-dimensional Halton sequence
    (index 1 onward), radical inverses summed in float64, as (n, d) float32."""
    if not 1 <= d <= len(PRIMES):
        raise ValueError(f"halton: d = {d} outside [1, {len(PRIMES)}]")
    idx = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    cols = []
    for base in PRIMES[:d]:
        rest = idx.clone()
        acc = torch.zeros(n, dtype=torch.float64, device=device)
        f = 1.0 / base
        while True:
            acc += (rest % base).to(torch.float64) * f
            rest //= base
            f /= base
            if f < 1e-17:
                break
        cols.append(acc)
    return torch.stack(cols, dim=1).to(torch.float32)


def points(config: dict, device) -> torch.Tensor:
    if config["points"] != "halton":
        raise ValueError(f"unknown point set {config['points']!r}")
    return halton(int(config["n"]), int(config["dim"]), device)


def request_pool(seed: int, count: int, n: int, device) -> np.ndarray:
    """``count`` request vectors of length ``n``, standard normal float32,
    drawn on the device from the seed in one call, as host rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    pool = torch.randn((count, n), generator=gen, device=device, dtype=torch.float32)
    return pool.cpu().numpy()


def sampled_rows(seed: int, n: int, count: int) -> np.ndarray:
    """``count`` distinct row indices in [0, n), ascending, from the seed."""
    rng = np.random.default_rng([seed64(seed), 1])
    return np.sort(rng.choice(n, size=min(count, n), replace=False)).astype(np.int64)
