"""Fault injection and failure containment for the serving stack.

Port of ``repro.serve.faults``.  The serving runtimes
(``serve.runtime.PanelRuntime``, ``serve.tenancy.MultiTenantRuntime``)
batch many users' requests into few wide launches, which concentrates
blast radius: one failed launch fails every co-batched future.  This module
is the resilience layer, in two halves.

**Chaos harness.**  :class:`FaultInjector` wraps a launch callable and
injects faults from a deterministic, seedable schedule described by a
:class:`ChaosSpec`:

* ``error=RATE``             raised launch errors (permanent);
* ``transient=RATE[:K]``     raised errors that keep failing for ``K``
  consecutive attempts of that lane, then recover (retryable);
* ``nan=RATE``               NaN-poisoned outputs (the launch succeeds, the
  panel is garbage; caught by output validation);
* ``latency=RATE[:SECONDS]`` injected stragglers (the launch sleeps);
* ``seed=INT``               the schedule seed.  Every lane draws from its
  own stream, ``random.Random((seed << 32) ^ crc32(name))``, so a lane's
  schedule is the reference's for the same seed and name, and independent
  of other lanes' traffic.

``REPRO_CHAOS=<spec>`` is the environment twin: a runtime built without an
explicit ``chaos=`` injects per that spec.

**Containment policies.**  :class:`ResiliencePolicy` bundles what a runtime
does when a launch fails: :class:`RetryPolicy` (bounded per-panel retry with
exponential backoff and jitter; a retried panel re-enters its queue at the
front and goes back through the pacer), :class:`BreakerPolicy` (a per-lane
circuit breaker with a half-open probe), ``launch_deadline_s`` (slow-launch
accounting) and ``validate_outputs`` (:class:`NaNGuard`: NaN/Inf validation
at fetch time with ONE counted relaunch of the panel through the lane's own
launch, counted as ``fallback_launches``, the reference's name).  Nothing
reruns on another route: the relaunch is the same kernel path, a launch that
raises fails its futures or is retried, and a panel that is NaN/Inf twice
raises :class:`NaNPanelError`.

The mutable per-lane state lives in :class:`LaneResilience` /
:class:`CircuitBreaker`; every mutating method expects the caller to hold
the owning runtime's lock.  :class:`StragglerMonitor` and
:func:`run_with_restarts` come along from the reference.
"""
from __future__ import annotations

import os
import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


# -- error taxonomy ----------------------------------------------------------

class InjectedFault(RuntimeError):
    """Raised by the chaos harness in place of a real launch failure."""


class TransientInjectedFault(InjectedFault):
    """An injected launch failure that recovers after bounded re-attempts."""


class CircuitOpenError(RuntimeError):
    """The lane's circuit breaker is open: submits fail fast until the
    cooldown elapses and a half-open probe panel succeeds."""


class OverloadedError(RuntimeError):
    """Load shedding: the queue is beyond its admission budget; the request
    was rejected instead of blocking unboundedly."""


class NaNPanelError(RuntimeError):
    """A launched panel produced NaN/Inf output, and so did its one relaunch."""


# -- chaos spec + env twin ---------------------------------------------------

@dataclass(frozen=True)
class ChaosSpec:
    """Parsed fault-injection schedule (see the module docstring's grammar)."""

    error_rate: float = 0.0
    transient_rate: float = 0.0
    transient_fails: int = 1        # consecutive failing attempts per hit
    nan_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.01
    seed: int = 0

    def __post_init__(self):
        for name in ("error_rate", "transient_rate", "nan_rate", "latency_rate"):
            r = getattr(self, name)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"chaos {name} must be in [0, 1], got {r}")
        total = self.error_rate + self.transient_rate + self.nan_rate + self.latency_rate
        if total > 1.0:
            raise ValueError(f"chaos rates sum to {total} > 1 — the kinds partition one "
                             f"uniform draw per launch")
        if self.transient_fails < 1:
            raise ValueError(f"transient fail count must be >= 1, got {self.transient_fails}")
        if self.latency_s < 0:
            raise ValueError(f"injected latency must be >= 0, got {self.latency_s}")

    @staticmethod
    def parse(spec: str) -> "ChaosSpec":
        """Parse ``"error=0.05,transient=0.1:2,nan=0.01,latency=0.05:0.2,
        seed=42"``: comma-separated ``key=value`` fields, any subset."""
        kw: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(f"bad chaos field {item!r}: expected key=value")
            key, val = key.strip(), val.strip()
            try:
                if key == "error":
                    kw["error_rate"] = float(val)
                elif key == "transient":
                    rate, _, fails = val.partition(":")
                    kw["transient_rate"] = float(rate)
                    if fails:
                        kw["transient_fails"] = int(fails)
                elif key == "nan":
                    kw["nan_rate"] = float(val)
                elif key == "latency":
                    rate, _, secs = val.partition(":")
                    kw["latency_rate"] = float(rate)
                    if secs:
                        kw["latency_s"] = float(secs)
                elif key == "seed":
                    kw["seed"] = int(val)
                else:
                    raise ValueError(f"unknown chaos field {key!r} (known: error, transient, "
                                     f"nan, latency, seed)")
            except ValueError as exc:
                raise ValueError(f"bad chaos field {item!r}: {exc}") from None
        return ChaosSpec(**kw)


def chaos_from_env() -> ChaosSpec | None:
    """The ``REPRO_CHAOS`` env twin: the parsed spec, or ``None`` when unset
    or empty.  Read per call, so that tests can set the variable at run time."""
    raw = os.environ.get("REPRO_CHAOS", "")
    return ChaosSpec.parse(raw) if raw.strip() else None


def resolve_chaos(chaos) -> ChaosSpec | None:
    """Normalize a runtime's ``chaos=`` argument: ``None`` defers to the env
    twin, a string is parsed (the empty string disables injection even when
    the env var is set), a :class:`ChaosSpec` passes through."""
    if chaos is None:
        return chaos_from_env()
    if isinstance(chaos, str):
        return ChaosSpec.parse(chaos) if chaos.strip() else None
    if isinstance(chaos, ChaosSpec):
        return chaos
    raise TypeError(f"chaos must be None, a spec string, or a ChaosSpec, got {type(chaos)!r}")


def _poison_panel(out: torch.Tensor) -> torch.Tensor:
    """A NaN panel like ``out``, filled on ``out``'s device (no host fill)."""
    return torch.full_like(out, float("nan"))


def _lane_stream(seed: int, name: str) -> random.Random:
    """Independent deterministic stream per (seed, lane name)."""
    return random.Random((seed << 32) ^ zlib.crc32(name.encode()))


class FaultInjector:
    """Deterministic fault injector for ONE lane's launch callable.

    Used from the lane's scheduler thread only, so it needs no lock.  One
    uniform draw per launch attempt decides the fault kind: the kinds
    partition ``[0, 1)`` into disjoint rate bands, so one seeded stream gives
    a reproducible schedule that depends only on this lane's attempt order.
    ``counters`` tallies injected faults per kind.
    """

    def __init__(self, spec: ChaosSpec, name: str = "panel"):
        self.spec = spec
        self.name = name
        self._rng = _lane_stream(spec.seed, name)
        self._pending_fails = 0         # transient hit: attempts left to fail
        self.counters = {"error": 0, "transient": 0, "nan": 0, "latency": 0}

    def total(self) -> int:
        return sum(self.counters.values())

    def _transient(self) -> TransientInjectedFault:
        return TransientInjectedFault(
            f"injected transient launch failure on lane {self.name!r} (recovers after "
            f"{self._pending_fails} more attempt(s))")

    def wrap(self, launch: Callable) -> Callable:
        def chaotic_launch(panel):
            spec = self.spec
            if self._pending_fails > 0:
                self._pending_fails -= 1
                self.counters["transient"] += 1
                raise self._transient()
            r = self._rng.random()
            edge = spec.error_rate
            if r < edge:
                self.counters["error"] += 1
                raise InjectedFault(f"injected permanent launch failure on lane {self.name!r}")
            if r < edge + spec.transient_rate:
                self.counters["transient"] += 1
                self._pending_fails = spec.transient_fails - 1
                raise self._transient()
            edge += spec.transient_rate
            poison = r < edge + spec.nan_rate
            if poison:
                self.counters["nan"] += 1
            elif r < edge + spec.nan_rate + spec.latency_rate:
                self.counters["latency"] += 1
                time.sleep(spec.latency_s)
            out = launch(panel)
            return _poison_panel(out) if poison else out

        return chaotic_launch


# -- containment policies ----------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded per-panel retry with exponential backoff and jitter.

    ``max_attempts`` counts ALL launch attempts (the first included); after
    attempt ``k`` fails the next waits ``backoff_s * backoff_mult**(k-1)``,
    scaled by up to ``1 + jitter``.
    """

    max_attempts: int = 4
    backoff_s: float = 0.002
    backoff_mult: float = 2.0
    jitter: float = 0.5             # uniform fraction of the step added

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_s < 0 or self.jitter < 0 or self.backoff_mult < 1:
            raise ValueError("backoff_s/jitter must be >= 0 and backoff_mult >= 1")

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        base = self.backoff_s * self.backoff_mult ** max(0, attempt - 1)
        return base * (1.0 + self.jitter * rng.random())


@dataclass(frozen=True)
class BreakerPolicy:
    """Per-lane circuit breaker: quarantine after ``threshold`` CONSECUTIVE
    panel failures (retry-exhausted panels, not attempts); after
    ``cooldown_s`` the next submit is admitted as a half-open probe."""

    threshold: int = 5
    cooldown_s: float = 0.25

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {self.threshold}")
        if self.cooldown_s < 0:
            raise ValueError(f"breaker cooldown must be >= 0, got {self.cooldown_s}")


@dataclass(frozen=True)
class ResiliencePolicy:
    """What a runtime does about failure.

    ``retry=None`` disables retries, ``breaker=None`` the breaker;
    ``launch_deadline_s`` turns on slow-launch accounting;
    ``validate_outputs`` turns on the NaN/Inf fetch-time guard (one counted
    relaunch of a non-finite panel through the same launch).
    ``seed`` feeds the backoff jitter stream.
    """

    retry: RetryPolicy | None = field(default_factory=RetryPolicy)
    breaker: BreakerPolicy | None = field(default_factory=BreakerPolicy)
    launch_deadline_s: float | None = None
    validate_outputs: bool = True
    seed: int = 0


class CircuitBreaker:
    """closed -> open -> half_open state machine of one lane (caller holds
    the owning runtime's lock for every method)."""

    def __init__(self, policy: BreakerPolicy):
        self.policy = policy
        self.state = "closed"
        self.failures = 0               # consecutive panel failures
        self.opened_at = 0.0

    def allow_submit(self, now: float) -> bool:
        """Admission check; flips open -> half_open once cooled down (the
        admitted request becomes the probe panel)."""
        if self.state == "open" and now - self.opened_at >= self.policy.cooldown_s:
            self.state = "half_open"
        return self.state != "open"

    def on_panel_success(self):
        self.state = "closed"
        self.failures = 0

    def on_panel_failure(self, now: float) -> bool:
        """Count one retry-exhausted panel; True if the breaker (re)opened."""
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.policy.threshold:
            self.state = "open"
            self.opened_at = now
            return True
        return False


class LaneResilience:
    """Mutable retry / breaker state of one lane (caller holds the owning
    runtime's lock: the scheduler and the submitters both read it)."""

    def __init__(self, policy: ResiliencePolicy, name: str = "panel"):
        self.policy = policy
        self.breaker = CircuitBreaker(policy.breaker) if policy.breaker is not None else None
        self._rng = _lane_stream(policy.seed, "backoff:" + name)
        self.attempts = 0               # launch attempts of the head panel
        self.not_before = 0.0           # backoff gate (monotonic time)

    def gate(self, now: float) -> float | None:
        """Monotonic wake time while backing off, else ``None`` (go)."""
        return self.not_before if now < self.not_before else None

    def breaker_state(self) -> str:
        return self.breaker.state if self.breaker is not None else "disabled"

    def allow_submit(self, now: float) -> bool:
        return self.breaker is None or self.breaker.allow_submit(now)

    def on_success(self):
        self.attempts = 0
        self.not_before = 0.0
        if self.breaker is not None:
            self.breaker.on_panel_success()

    def decide_failure(self, now: float) -> str:
        """One launch attempt failed.  Returns ``'retry'`` (backoff gate set:
        requeue the panel), ``'fail'`` (retries exhausted: fail the panel's
        futures) or ``'open'`` (fail the panel AND quarantine the lane)."""
        self.attempts += 1
        probing = self.breaker is not None and self.breaker.state == "half_open"
        if (self.policy.retry is not None and not probing
                and self.attempts < self.policy.retry.max_attempts):
            self.not_before = now + self.policy.retry.delay_s(self.attempts, self._rng)
            return "retry"
        self.attempts = 0
        self.not_before = 0.0
        opened = self.breaker.on_panel_failure(now) if self.breaker is not None else False
        return "open" if opened else "fail"


# -- output validation and the one counted relaunch -------------------------

class NaNGuard:
    """Fetch-time NaN/Inf containment of one launched panel.

    ``check`` validates the real (non-pad) rows of the fetched ``(w, n)``
    result.  On NaN/Inf it counts the event through ``on_relaunch`` and calls
    ``relaunch()`` ONCE, on the fetching thread: the owning lane launches the
    panel's saved request rows again through its own launch, the same kernel
    route, and returns the fetched rows.  An injected poison is transient, so
    the relaunch returns the launch's clean bits; a NaN/Inf that the launch
    itself produces comes back and raises :class:`NaNPanelError`.  The panel
    record runs ``check`` under its own lock: one validation and at most one
    relaunch per panel.
    """

    __slots__ = ("n_real", "relaunch", "on_relaunch")

    def __init__(self, n_real: int, relaunch: Callable[[], np.ndarray],
                 on_relaunch: Callable | None = None):
        self.n_real = n_real
        self.relaunch = relaunch
        self.on_relaunch = on_relaunch

    def check(self, out: np.ndarray) -> np.ndarray:
        if np.isfinite(out[:self.n_real]).all():
            return out
        if self.on_relaunch is not None:
            self.on_relaunch()
        redo = self.relaunch()
        if not np.isfinite(redo[:self.n_real]).all():
            raise NaNPanelError(
                "the relaunched panel produced NaN/Inf output again — the launch itself "
                "produces it (the panel inputs were validated finite at submit)")
        return redo


# -- supervision utilities ----------------------------------------------------

class StragglerMonitor:
    """EWMA launch-time outlier detection per lane.

    ``record`` folds one observation into the lane's EWMA and compares it to
    the fleet median; ``threshold`` x slower flags a straggler.
    ``MultiTenantRuntime`` feeds it each launch's run time.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: dict = {}
        self.fleet_ewma: float | None = None

    def record(self, lane: str, seconds: float) -> bool:
        """Record one observation; True if ``lane`` is now a straggler."""
        prev = self.ewma.get(lane)
        self.ewma[lane] = seconds if prev is None else \
            (1 - self.alpha) * prev + self.alpha * seconds
        fleet = sorted(self.ewma.values())
        self.fleet_ewma = fleet[len(fleet) // 2]
        return self.ewma[lane] > self.threshold * self.fleet_ewma

    def stragglers(self) -> list:
        if not self.ewma or self.fleet_ewma is None:
            return []
        return [lane for lane, v in self.ewma.items() if v > self.threshold * self.fleet_ewma]

    def forget(self, lane: str):
        """Drop a lane's history (e.g. its tenant was removed)."""
        self.ewma.pop(lane, None)


def run_with_restarts(make_loop, max_restarts: int = 3, on_restart=None):
    """Supervisor: calls ``make_loop()`` again after a recoverable failure
    (``RuntimeError``, ``OSError``), at most ``max_restarts`` times;
    ``make_loop`` restores its own state on entry."""
    attempt = 0
    while True:
        try:
            return make_loop()
        except (RuntimeError, OSError) as e:        # recoverable class
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
