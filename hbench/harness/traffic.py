"""The one traffic generator: a mix file (``hbench/traffic/<name>.json``)
gives the parameters, the seed gives the draws.

A mix names the server's panel settings (``server``: ``max_batch``,
``deadline_s``), the request pool (``pool`` vectors made from the seed),
the warm-up (``warm``: ``widths``, ``panels``) and one or more
``sources`` of requests, each active during a share of the window
(``during``: ``[from, to]`` as fractions of it, ``[0, 1]`` if left out):

* ``{"kind": "open", "rate_rps": r, "burst": b}``: independent users.
  Exactly ``round(r * span / b)`` arrivals of ``b`` requests each (``b``
  1 if left out) in the source's span, placed as a Poisson process
  conditioned on its count (sorted uniform times), so that every seed
  offers the same number of requests at the same mean rate, in another
  order.
* ``{"kind": "closed", "clients": c}``: ``c`` callers who start at the
  span's beginning, each sending its next request when its last one
  returns, until the span ends.

So steps, ramps, bursts and a flood under a trickle are new mix files
(after ``benchmarks/bench_serve.py``'s closed and open loops).  Each
request is a vector of the pool, drawn by index from the seed: an open
source's with its schedule, a closed source's from a stream of its own in
the order its callers send.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .inputs import seed64

KINDS = ("open", "closed")


@dataclass(frozen=True)
class Plan:
    """What the window's driver sends.  ``start_s``, ``source`` and
    ``count``: the generator's events in time order (an open arrival of
    ``count`` requests, or a closed source's ``count`` callers starting);
    ``pool_index``: each open request's pool vector, in event order;
    ``closed_stop_s`` and ``closed_draws``: per source, when its callers
    stop and its stream of pool indices (None for an open source)."""
    start_s: np.ndarray
    source: np.ndarray
    count: np.ndarray
    pool_index: np.ndarray
    closed_stop_s: tuple
    closed_draws: tuple


class Draws:
    """A closed source's pool indices, one per request in the order sent."""

    def __init__(self, seed: int, source: int, pool: int):
        self._rng = np.random.default_rng([seed64(seed), 3, source])
        self._pool = pool

    def next(self) -> int:
        return int(self._rng.integers(0, self._pool))


def span(src: dict, seconds: float) -> tuple[float, float]:
    a, b = src.get("during", (0.0, 1.0))
    return float(a) * seconds, float(b) * seconds


def check_mix(mix: dict) -> None:
    server, warm = mix["server"], mix["warm"]
    if int(mix["pool"]) < 1 or int(server["max_batch"]) < 1:
        raise ValueError("traffic: pool and max_batch must be >= 1")
    if server.get("deadline_s") is not None and not float(server["deadline_s"]) > 0:
        raise ValueError("traffic: deadline_s must be > 0 or null")
    if not warm["widths"] or int(warm.get("panels", 1)) < 1:
        raise ValueError("traffic: warm needs widths and panels >= 1")
    if not mix["sources"]:
        raise ValueError("traffic: a mix needs at least one source")
    for src in mix["sources"]:
        if src.get("kind") not in KINDS:
            raise ValueError(f"traffic: source kind {src.get('kind')!r} not in {KINDS}")
        a, b = span(src, 1.0)
        if not 0.0 <= a < b <= 1.0:
            raise ValueError(f"traffic: during {src.get('during')} is not within [0, 1]")
        if src["kind"] == "open" and not (float(src["rate_rps"]) > 0
                                          and int(src.get("burst", 1)) >= 1):
            raise ValueError("traffic: an open source needs rate_rps > 0 and burst >= 1")
        if src["kind"] == "closed" and int(src["clients"]) < 1:
            raise ValueError("traffic: a closed source needs clients >= 1")


def plan(mix: dict, seed: int, seconds: float) -> Plan:
    """The events of ``mix`` in a window of ``seconds`` from ``seed``."""
    check_mix(mix)
    pool = int(mix["pool"])
    events, stops, draws = [], [], []       # events: (time, source, count, pool indices)
    for i, src in enumerate(mix["sources"]):
        a, b = span(src, seconds)
        if src["kind"] == "open":
            burst = int(src.get("burst", 1))
            rng = np.random.default_rng([seed64(seed), 2, i])
            n = max(1, int(round(float(src["rate_rps"]) * (b - a) / burst)))
            t = np.sort(rng.uniform(a, b, size=n))
            idx = rng.integers(0, pool, size=(n, burst))
            events += [(t[j], i, burst, idx[j]) for j in range(n)]
            stops.append(None)
            draws.append(None)
        else:
            events.append((a, i, int(src["clients"]), np.zeros(0, np.int64)))
            stops.append(b)
            draws.append(Draws(seed, i, pool))
    events.sort(key=lambda e: (e[0], e[1]))
    return Plan(start_s=np.array([e[0] for e in events]),
                source=np.array([e[1] for e in events], np.int64),
                count=np.array([e[2] for e in events], np.int64),
                pool_index=np.concatenate([e[3] for e in events]).astype(np.int64),
                closed_stop_s=tuple(stops), closed_draws=tuple(draws))
