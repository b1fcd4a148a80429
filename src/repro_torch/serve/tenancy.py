"""Multi-tenant serving: many H-matrices behind ONE panel scheduler.

Port of ``repro.serve.tenancy``.  A service holding many kernel matrices
(per dataset, per length scale, per region) multiplexes them onto one card
without one tenant's traffic starving the rest; the unit of scheduling is
a whole batched panel launch.

:class:`MultiTenantRuntime` hosts tenants (apply- and solve-backed, each
with its own ``n`` and width buckets) behind one scheduler thread and one
global in-flight budget:

* **Registry and per-tenant queues.**  :meth:`MultiTenantRuntime.add_tenant`
  registers a :class:`TenantSpec` (or anything with a ``tenant_spec()``
  method: both ``serve.step`` servers) and returns a :class:`TenantHandle`
  whose ``submit`` returns the runtime's ``PanelFuture``.  Each tenant keeps
  its own FIFO queue, deadline, backpressure cap, stats and
  :class:`~repro_torch.serve.runtime.PanelLane` (staging buffers and CUDA
  stream).
* **Weighted deficit round robin.**  Each scheduling round credits every
  READY tenant with its ``weight``; the launch slot goes to the largest
  banked deficit (ties to the least recently served), which pays one slot.
  Idle tenants bank no credit.
* **One shared pacer.**  One :class:`~repro_torch.serve.runtime.LaunchPacer`
  bounds the panels in flight across all tenants; every lane holds that
  many staging buffers, which carries the staging-buffer guarantee across
  tenants.
* **The memory tier.**  With ``device_bytes_budget`` the factor stores of
  least-recently-served tenants are spilled to pinned host memory
  (``FactorStore.spill``) until the budget holds, and a spilled tenant's
  next panel reloads its store first (``reload``; ``reload_s`` in its stats).
* **Hot add / remove**, mid-traffic; removal drains the tenant's queue.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable

import torch

from .. import obs
from ..core.factor_store import FactorStore
from ..parallel.hshard import mesh_panel
from .faults import (CircuitOpenError, FaultInjector, LaneResilience, OverloadedError,
                     ResiliencePolicy, StragglerMonitor, resolve_chaos)
from .runtime import LaunchPacer, PanelFuture, PanelLane, _Stats, validate_request


@dataclass(frozen=True)
class TenantSpec:
    """Everything the runtime needs to host one launch target.

    n, max_batch:   request length and full panel width (a multiple of
                    ``n_dev``: :func:`solve_tenant` and a solve server's
                    ``tenant_spec()`` round it).
    launch:         ``(n, w) -> (n, w)`` on ``device``, as ``PanelRuntime``'s.
    n_dev:          shard count of a column-sharded launch (a meshed solve);
                    every width bucket is a multiple of it.
    weight:         fair-share weight (> 0).
    deadline_s, max_queue, shed_above: per-tenant deadline flush,
                    backpressure cap and load-shedding budget.
    resilience:     per-tenant containment; ``None`` inherits the runtime's.
    build_s:        onboarding time when built from raw coordinates (the
                    device build, plus an H-LU setup); ``onboard_s`` in stats.
    store:          the ``FactorStore`` the launch reads (P mode): byte
                    accounting and the memory tier.
    precond_nbytes: device bytes of a preconditioner held by the launch
                    (H-LU), charged against the budget and never spilled.
    device:         where the tenant's panels run; ``None`` means CUDA.
    """

    n: int
    max_batch: int
    launch: Callable
    n_dev: int = 1
    weight: float = 1.0
    deadline_s: float | None = None
    max_queue: int | None = None
    resilience: ResiliencePolicy | None = None
    shed_above: int | None = None
    build_s: float | None = None
    store: object | None = None
    precond_nbytes: int = 0
    device: object | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.max_queue is not None and self.max_queue < self.max_batch:
            raise ValueError(f"max_queue ({self.max_queue}) must be >= max_batch "
                             f"({self.max_batch})")
        if self.shed_above is not None and self.shed_above < self.max_batch:
            raise ValueError(f"shed_above ({self.shed_above}) must be >= max_batch "
                             f"({self.max_batch}) — a full panel could never be admitted")


def _onboard(hm, build: dict | None, spec_kw: dict):
    """An assembled H-matrix as it is; raw ``(n, d)`` coordinates (anything
    without a ``.plan``) built on the device with ``build_hmatrix_device``
    and the options in ``build`` (kernel, k, c_leaf, eta, precompute, chaos,
    device, ...), the build's time recorded as ``spec_kw["build_s"]``."""
    if hasattr(hm, "plan"):
        return hm
    from ..core.build_device import build_hmatrix_device_report
    hm, report = build_hmatrix_device_report(hm, **(build or {}))
    spec_kw.setdefault("build_s", report.total_s)
    return hm


def _wire_store(spec_kw: dict, hm, mesh):
    """Attach ``hm.factors`` as the tenant's store in P mode on one device.

    NP-mode tenants have nothing to spill, and a meshed executor holds the
    factors it captured when it was made (copies on other devices, slices
    by block): spilling the store would free nothing of them while it
    blocked launches.  An explicit ``store=`` wins."""
    factors = getattr(hm, "factors", None)
    if mesh is None and isinstance(factors, FactorStore) and factors.nbytes()["total"] > 0:
        spec_kw.setdefault("store", factors)


def apply_tenant(hm, max_batch: int = 64, use_kernels: bool = True, mesh=None,
                 build: dict | None = None, **spec_kw) -> TenantSpec:
    """Spec of an apply-backed tenant (``Z = H X`` query traffic).

    ``hm`` is an H-matrix, or raw ``(n, d)`` coordinates onboarded by the
    device build (options in ``build``, its time in ``build_s``).  With a
    ``mesh`` each panel's blocks are sharded over it (row shards, any
    width), as :class:`~repro_torch.serve.step.HMatrixServer` does.
    """
    from ..core.hmatrix import make_apply
    hm = _onboard(hm, build, spec_kw)
    launch = make_apply(hm, use_kernels=use_kernels, mesh=mesh)
    _wire_store(spec_kw, hm, mesh)
    spec_kw.setdefault("device", hm.device)
    return TenantSpec(n=hm.shape[0], max_batch=max_batch, launch=launch, **spec_kw)


def solve_tenant(hm, sigma2: float, max_batch: int = 8, tol: float = 1e-5, max_iter: int = 300,
                 precondition: bool = True, use_kernels: bool = True, mesh=None,
                 info_log: deque | None = None, precond=None, hlu_opts: dict | None = None,
                 **spec_kw) -> TenantSpec:
    """Spec of a solve-backed tenant (regression-fit traffic): one
    ``make_solver`` PCG per panel.

    ``hm`` may be raw coordinates (as :func:`apply_tenant`, options through
    ``build=`` in ``spec_kw``).  ``info_log`` (a bounded deque) keeps each
    panel's lazy ``SolveInfo``.  ``precond`` is as in ``make_solver``
    (``"bj"``, ``"none"``, ``"hlu"`` or a prebuilt ``HLUPreconditioner``);
    an H-LU factorization adds its setup time to ``build_s`` and its bytes
    to ``precond_nbytes``.  A panel the NaN/Inf guard relaunches logs a
    second record.  With a ``mesh`` each panel's columns are sharded over it
    (block Jacobi or no preconditioner) and ``max_batch`` rounds up to a
    multiple of its shard count.
    """
    from ..solve import make_solver
    hm = _onboard(hm, spec_kw.pop("build", None), spec_kw)
    max_batch, n_dev = mesh_panel(max_batch, mesh)
    solve = make_solver(hm, sigma2, tol=tol, max_iter=max_iter, precondition=precondition,
                        use_kernels=use_kernels, mesh=mesh, precond=precond, hlu_opts=hlu_opts)
    pre = solve.preconditioner

    def launch(panel):
        c, info = solve(panel)
        if info_log is not None:
            info_log.append(info)
        return c

    _wire_store(spec_kw, hm, mesh)
    spec_kw.setdefault("device", hm.device)
    if pre is not None:
        spec_kw.setdefault("precond_nbytes", int(pre.nbytes()))
        spec_kw["build_s"] = (spec_kw.get("build_s") or 0.0) + pre.setup_seconds
    return TenantSpec(n=hm.shape[0], max_batch=max_batch, launch=launch, n_dev=n_dev,
                      **spec_kw)


class _Tenant:
    """Scheduler-internal per-tenant state (guarded by the runtime lock)."""

    __slots__ = ("name", "spec", "lane", "pending", "submitted", "launched", "flush_goal",
                 "in_launch", "weight", "deficit", "last_served", "removing", "resident",
                 "stats", "res")

    def __init__(self, name: str, spec: TenantSpec, slots: int, lock, injector=None,
                 resilience=None):
        self.name = name
        self.spec = spec
        guard = resilience is not None and resilience.validate_outputs
        self.lane = PanelLane(spec.n, spec.max_batch, spec.launch, n_dev=spec.n_dev,
                              slots=slots, injector=injector, guard_outputs=guard,
                              store=spec.store, device=spec.device)
        self.res = LaneResilience(resilience, name) if resilience is not None else None
        self.pending: list = []         # [(np vector, PanelFuture, t_arrival)]
        self.submitted = 0
        self.launched = 0
        self.flush_goal = 0
        self.in_launch = False
        self.weight = float(spec.weight)
        self.deficit = 0.0              # banked launch-slot credit (DRR)
        self.last_served = 0            # global launch seq, for tie-breaks
        self.removing = False
        # memory tier: does this tenant's store hold device tensors?
        self.resident = spec.store is not None and not spec.store.is_spilled
        self.stats = _Stats(lock, {"launched_widths": deque(maxlen=1024),
                                   "pack_s": deque(maxlen=1024),
                                   "panels_launched": 0, "submitted": 0,
                                   "max_queue_depth": 0, "backpressure_waits": 0,
                                   "deadline_flushes": 0, "retries": 0, "panel_failures": 0,
                                   "faults_injected": {}, "fallback_launches": 0,
                                   "shed_requests": 0, "slow_launches": 0,
                                   "breaker_state": ("disabled" if self.res is None
                                                     else "closed"),
                                   "onboard_s": spec.build_s, "nbytes": self.lane.nbytes(),
                                   "precond_nbytes": spec.precond_nbytes,
                                   "resident": self.resident, "spills": 0, "reloads": 0,
                                   "reload_s": None, "events": deque(maxlen=256)})

    def drained(self) -> bool:
        return not self.pending and not self.in_launch


class TenantHandle:
    """Client-side view of one registered tenant: ``submit`` / ``flush`` /
    ``drain`` / ``queue_depth`` / ``widths`` / ``stats`` scoped to it.  It
    stays readable after ``remove_tenant``; only ``submit`` is rejected then."""

    def __init__(self, runtime: "MultiTenantRuntime", tenant: _Tenant):
        self._runtime = runtime
        self._tenant = tenant

    @property
    def name(self) -> str:
        return self._tenant.name

    @property
    def widths(self) -> tuple:
        return self._tenant.lane.widths

    @property
    def weight(self) -> float:
        with self._runtime._cv:
            return self._tenant.weight

    @property
    def stats(self) -> _Stats:
        return self._tenant.stats

    def submit(self, vec) -> PanelFuture:
        return self._runtime._submit(self._tenant, vec)

    def flush(self):
        # on the tenant object, not the registry name: after remove_tenant
        # this is a harmless no-op (the queue was drained)
        rt = self._runtime
        with rt._cv:
            self._tenant.flush_goal = max(self._tenant.flush_goal, self._tenant.submitted)
            rt._cv.notify_all()

    def drain(self):
        self.flush()
        rt = self._runtime
        with rt._cv:
            rt._cv.wait_for(lambda: self._tenant.drained() or rt._closing)

    def queue_depth(self) -> int:
        with self._runtime._cv:
            return len(self._tenant.pending)

    def set_weight(self, weight: float):
        """Change this tenant's fair-share weight."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._runtime._cv:
            self._tenant.weight = float(weight)


class MultiTenantRuntime:
    """One scheduler thread and one in-flight budget hosting many tenants.

    Parameters
    ----------
    max_inflight : int, optional
        GLOBAL launch depth: panels outstanding across ALL tenants (one shared
        :class:`~repro_torch.serve.runtime.LaunchPacer`); every tenant's
        staging pool has this many buffers.
    chaos : None | str | ChaosSpec, optional
        Fault injection; ``None`` defers to ``REPRO_CHAOS``.  Each tenant
        draws from its own stream (seed + its name).
    resilience : ResiliencePolicy, optional
        Default containment for tenants without their own (on by default
        while chaos is active).
    shed_above : int, optional
        GLOBAL load shedding: ``submit`` raises ``OverloadedError`` while the
        requests queued across tenants reach this budget.
    device_bytes_budget : int, optional
        Cap on the factor-store bytes (plus pinned preconditioner bytes)
        resident on the card across tenants.  Adding or reloading a store
        beyond it spills least-recently-served stores to pinned host memory;
        a spilled tenant's next panel reloads its store on the scheduler
        thread, under the same chaos / retry envelope as a launch.  A store
        larger than the budget alone is served anyway (overcommit beats an
        outage).  ``None``: no tier.

    ``stats`` holds ``panels_launched``, ``launch_order`` (tenant names in
    launch order), ``tenants_added`` / ``tenants_removed``, ``retries``,
    ``panel_failures``, ``shed_requests``, ``straggler_tenants``,
    ``onboard_s``, ``evictions``, ``reloads``, ``device_store_bytes`` and
    ``budget_bytes``; per-tenant counters live on each handle.
    """

    def __init__(self, max_inflight: int = 2, chaos=None,
                 resilience: ResiliencePolicy | None = None, shed_above: int | None = None,
                 device_bytes_budget: int | None = None):
        chaos_spec = resolve_chaos(chaos)
        if resilience is None and chaos_spec is not None:
            resilience = ResiliencePolicy()
        self._cv = threading.Condition()
        self._pacer = LaunchPacer(max_inflight)
        self.max_inflight = int(max_inflight)
        self.chaos_spec = chaos_spec    # frozen (lock-free reads ok)
        self.resilience = resilience    # frozen default policy
        self.shed_above = shed_above
        self.device_bytes_budget = device_bytes_budget
        self._monitor = StragglerMonitor()
        self._tenants: dict[str, _Tenant] = {}
        self._compiled: set = set()     # warmed (tenant name, width) pairs
        self._launch_seq = 0
        self._resident_bytes = 0        # device bytes held by tenant stores
        self.stats = _Stats(self._cv,
                            {"panels_launched": 0, "launch_order": deque(maxlen=2048),
                             "tenants_added": 0, "tenants_removed": 0, "retries": 0,
                             "panel_failures": 0, "shed_requests": 0,
                             "straggler_tenants": [], "onboard_s": {}, "evictions": 0,
                             "reloads": 0, "device_store_bytes": 0,
                             "budget_bytes": device_bytes_budget})
        self._closing = False
        self._closed = False
        self._thread: threading.Thread | None = None

    # -- registry -----------------------------------------------------------

    def add_tenant(self, name: str, spec, **overrides) -> TenantHandle:
        """Register a tenant under ``name`` and return its handle.

        ``spec`` is a :class:`TenantSpec` or has a ``tenant_spec()`` method;
        keyword ``overrides`` replace spec fields (``weight=2.0``, ...).  Hot:
        works while other tenants are served.
        """
        if hasattr(spec, "tenant_spec"):
            spec = spec.tenant_spec()
        if not isinstance(spec, TenantSpec):
            raise TypeError(f"spec must be a TenantSpec or have a tenant_spec() method, got "
                            f"{type(spec)!r}")
        if overrides:
            spec = replace(spec, **overrides)
        injector = FaultInjector(self.chaos_spec, name) if self.chaos_spec is not None else None
        resilience = spec.resilience if spec.resilience is not None else self.resilience
        with self._cv:
            self._check_open()
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            tenant = _Tenant(name, spec, self.max_inflight, self._cv, injector=injector,
                             resilience=resilience)
            tenant.lane._on_relaunch = self._make_on_relaunch(tenant)
            self._tenants[name] = tenant
            self.stats["tenants_added"] += 1
            if spec.build_s is not None:
                self.stats["onboard_s"][name] = float(spec.build_s)
            if tenant.resident or spec.precond_nbytes:
                # account the new store and any pinned preconditioner bytes,
                # then spill LRU stores until the budget holds again
                if tenant.resident:
                    self._resident_bytes += tenant.stats["nbytes"]
                self._resident_bytes += spec.precond_nbytes
                self.stats["device_store_bytes"] = self._resident_bytes
                self._enforce_budget_locked(exempt=tenant)
            self._cv.notify_all()
            return TenantHandle(self, tenant)

    def _make_on_relaunch(self, tenant: _Tenant):
        """Fetch-thread callback counting a NaN/Inf relaunch."""
        def on_relaunch():
            with self._cv:
                tenant.stats["fallback_launches"] += 1
                tenant.stats["events"].append(
                    (time.monotonic(), "fallback",
                     "NaN/Inf panel relaunched once through the same launch"))
        return on_relaunch

    def remove_tenant(self, name: str):
        """Drain ``name``'s queue, then deregister it.  Its submitted requests
        all launch and resolve; other tenants keep being served; later
        submits on its handle raise."""
        with self._cv:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"no tenant named {name!r}")
            tenant.removing = True
            tenant.flush_goal = tenant.submitted    # drain = flush everything
            self._ensure_thread_locked()
            self._cv.notify_all()
            self._cv.wait_for(lambda: tenant.drained() or self._closing)
            self._tenants.pop(name, None)
            self._compiled = {kw for kw in self._compiled if kw[0] != name}
            self._monitor.forget(name)
            self.stats["tenants_removed"] += 1
            if tenant.resident:
                tenant.resident = False
                tenant.stats["resident"] = False
                self._resident_bytes -= tenant.stats["nbytes"]
            self._resident_bytes -= tenant.spec.precond_nbytes
            self.stats["device_store_bytes"] = self._resident_bytes
            self._cv.notify_all()                   # wake backpressured submits

    def tenants(self) -> tuple:
        with self._cv:
            return tuple(self._tenants)

    # -- client side --------------------------------------------------------

    def _submit(self, tenant: _Tenant, vec) -> PanelFuture:
        q = validate_request(vec, tenant.lane.n, who=f"request for tenant {tenant.name!r}")
        fut = PanelFuture()
        with self._cv:
            self._check_submittable(tenant)
            self._check_admission(tenant)
            cap = tenant.spec.max_queue
            while cap is not None and len(tenant.pending) >= cap:
                tenant.stats["backpressure_waits"] += 1
                self._cv.wait()
                self._check_submittable(tenant)
                self._check_admission(tenant)
            tenant.pending.append((q, fut, time.monotonic()))
            tenant.submitted += 1
            tenant.stats["submitted"] += 1
            depth = len(tenant.pending)
            if depth > tenant.stats["max_queue_depth"]:
                tenant.stats["max_queue_depth"] = depth
            self._ensure_thread_locked()
            self._cv.notify_all()
        return fut

    def _check_open(self):
        if self._closing:
            raise RuntimeError("MultiTenantRuntime is closed — submit()/add_tenant() rejected; "
                               "already-submitted futures remain fetchable")

    def _check_submittable(self, tenant: _Tenant):
        self._check_open()
        if tenant.removing:
            raise RuntimeError(f"tenant {tenant.name!r} has been removed from the runtime — "
                               f"submit() rejected")

    def _check_admission(self, tenant: _Tenant):
        """Breaker and load-shedding admission control (caller holds _cv)."""
        if tenant.res is not None:
            if not tenant.res.allow_submit(time.monotonic()):
                raise CircuitOpenError(
                    f"tenant {tenant.name!r} circuit breaker is open after consecutive panel "
                    f"failures — submits fail fast until the cooldown elapses and a "
                    f"half-open probe panel succeeds")
            tenant.stats["breaker_state"] = tenant.res.breaker_state()
        cap = tenant.spec.shed_above
        if cap is not None and len(tenant.pending) >= cap:
            tenant.stats["shed_requests"] += 1
            self._tenant_event(tenant, "shed", f"tenant queue depth {len(tenant.pending)} >= "
                                               f"shed_above {cap}")
            raise OverloadedError(
                f"request shed: tenant {tenant.name!r} holds {len(tenant.pending)} queued "
                f"requests >= its admission budget shed_above={cap} — retry later")
        if self.shed_above is not None:
            total = sum(len(t.pending) for t in self._tenants.values())
            if total >= self.shed_above:
                tenant.stats["shed_requests"] += 1
                self.stats["shed_requests"] += 1
                self._tenant_event(tenant, "shed", f"global queue depth {total} >= "
                                                   f"shed_above {self.shed_above}")
                raise OverloadedError(
                    f"request shed: {total} queued requests across all tenants >= the global "
                    f"admission budget shed_above={self.shed_above} — retry later")

    def _tenant_event(self, tenant: _Tenant, kind: str, detail: str):
        """Append to a tenant's bounded event trace (caller holds _cv)."""
        tenant.stats["events"].append((time.monotonic(), kind, detail))

    def flush(self, name: str | None = None):
        """Launch everything already submitted (one tenant, or all)."""
        with self._cv:
            for tenant in self._select(name):
                tenant.flush_goal = max(tenant.flush_goal, tenant.submitted)
            self._cv.notify_all()

    def drain(self, name: str | None = None):
        """Flush, then block until every selected request has LAUNCHED."""
        self.flush(name)
        with self._cv:
            tenants = self._select(name)
            self._cv.wait_for(lambda: all(t.drained() for t in tenants) or self._closing)

    def _select(self, name: str | None) -> list:
        if name is None:
            return list(self._tenants.values())
        if name not in self._tenants:
            raise KeyError(f"no tenant named {name!r}")
        return [self._tenants[name]]

    def precompile(self):
        """Launch every tenant's width buckets once (incremental: warmed
        ``(tenant, width)`` pairs are skipped).  Tenants whose store is spilled
        are skipped too; their first panel after the reload warms them."""
        with self._cv:
            todo = [(t.name, t.lane, w) for t in self._tenants.values()
                    if not (t.spec.store is not None and t.spec.store.is_spilled)
                    for w in t.lane.widths if (t.name, w) not in self._compiled]
        for name, lane, w in todo:      # blocking launches OUTSIDE the lock
            lane.precompile_width(w)
            with self._cv:
                current = self._tenants.get(name)
                if current is not None and current.lane is lane:
                    # a remove + re-add of the name mid-precompile must not
                    # make the NEW tenant's buckets look warm
                    self._compiled.add((name, w))

    def tenant_stats(self) -> dict:
        """Locked snapshot of every tenant's counters, keyed by name."""
        with self._cv:
            tenants = list(self._tenants.items())
        return {name: tenant.stats() for name, tenant in tenants}

    def close(self):
        """Drain every tenant, then stop the scheduler thread (idempotent)."""
        with self._cv:
            if self._closed:
                return
        self.drain()
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._closing = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler side -----------------------------------------------------

    def _ensure_thread_locked(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._scheduler, name="tenant-runtime",
                                            daemon=True)
            self._thread.start()

    def _ready(self, tenant: _Tenant, now: float) -> bool:
        """Does this tenant have a launchable panel right now?"""
        if not tenant.pending:
            tenant.deficit = 0.0        # classic DRR: idle banks no credit
            return False
        if tenant.res is not None and tenant.res.gate(now) is not None:
            return False                # retry backoff
        if len(tenant.pending) >= tenant.lane.max_batch:
            return True                 # full panel
        if tenant.launched < tenant.flush_goal:
            return True                 # flushed / draining partial panel
        dl = tenant.spec.deadline_s
        return dl is not None and tenant.pending[0][2] + dl <= now

    def _next_wake(self, now: float) -> float | None:
        """Earliest scheduler wake time: pending deadlines and retry-backoff
        gate expiries (None if neither applies)."""
        wakes = []
        for t in self._tenants.values():
            if not t.pending:
                continue
            if t.spec.deadline_s is not None:
                wakes.append(t.pending[0][2] + t.spec.deadline_s)
            if t.res is not None:
                gate = t.res.gate(now)
                if gate is not None:
                    wakes.append(gate)
        return min(wakes) if wakes else None

    def _pick(self, ready: list) -> _Tenant:
        """Weighted deficit round robin over the ready tenants: each round
        credits every ready tenant its weight; the slot goes to the largest
        banked deficit (ties to the least recently served), which pays 1."""
        while True:
            eligible = [t for t in ready if t.deficit >= 1.0]
            if eligible:
                tenant = max(eligible, key=lambda t: (t.deficit, -t.last_served))
                tenant.deficit -= 1.0
                return tenant
            for t in ready:             # one credit round (weights > 0)
                t.deficit += t.weight

    def _enforce_budget_locked(self, exempt: _Tenant | None = None, incoming: int = 0):
        """Spill LRU stores until the device-bytes budget holds.

        Caller holds ``_cv``.  ``incoming`` reserves room for a store about to
        be reloaded; ``exempt`` protects the tenant being served.  Victims are
        resident, store-backed and not ``in_launch``.  A victim's panels may
        still be running on its lane's stream and reading the store: the
        stream is synchronized before its tensors are released.  When no
        victim is left, the runtime overcommits and keeps serving.
        """
        budget = self.device_bytes_budget
        if budget is None:
            return
        while self._resident_bytes + incoming > budget:
            victims = [t for t in self._tenants.values()
                       if t.resident and t.spec.store is not None and not t.in_launch
                       and t is not exempt]
            if not victims:
                break                   # overcommit beats an outage
            victim = min(victims, key=lambda t: t.last_served)      # LRU
            victim.lane.synchronize()
            freed = int(victim.spec.store.spill())
            victim.resident = False
            victim.stats["resident"] = False
            victim.stats["spills"] += 1
            self._resident_bytes -= freed
            self.stats["evictions"] += 1
            self.stats["device_store_bytes"] = self._resident_bytes
            self._tenant_event(victim, "spill", f"store spilled to host ({freed} bytes freed, "
                                                f"LRU under {budget}-byte budget)")

    def _reload_store(self, tenant: _Tenant):
        """Reload ``tenant``'s spilled store before its launch.

        Scheduler thread, OUTSIDE the lock, after the pick reserved the bytes
        and set ``in_launch``.  With a chaos injector the reload runs under
        it, so injected faults hit the reload like a launch attempt and take
        the same retry / breaker path; every injected raise fires BEFORE the
        reload, which leaves the store spilled for the retry.  Returns None,
        or the exception after releasing the reservation.
        """
        store = tenant.spec.store
        t0 = time.perf_counter()
        try:
            inj = tenant.lane.injector
            if inj is not None:
                def _reload(_panel):
                    store.reload()
                    # a token for the injector's NaN arm: the reload is an
                    # exact copy, so a poisoned token is dropped
                    return torch.zeros((), device=tenant.lane.device)
                inj.wrap(_reload)(None)
            else:
                store.reload()
        except Exception as exc:
            with self._cv:
                if store.is_spilled:    # the reload never happened: unreserve
                    self._resident_bytes -= tenant.stats["nbytes"]
                    self.stats["device_store_bytes"] = self._resident_bytes
            return exc
        reload_s = time.perf_counter() - t0
        with self._cv:
            tenant.resident = True
            tenant.stats["resident"] = True
            tenant.stats["reloads"] += 1
            tenant.stats["reload_s"] = reload_s
            self.stats["reloads"] += 1
            self._tenant_event(tenant, "reload", f"store reloaded to device in "
                                                 f"{reload_s:.4f}s")
        return None

    def _scheduler(self):
        while True:
            # global pacing: retire the oldest in-flight panel across ALL
            # tenants before taking new work
            self._pacer.wait_for_slot()
            with self._cv:
                tenant = None
                while tenant is None:
                    if self._closing:
                        return
                    now = time.monotonic()
                    ready = [t for t in self._tenants.values() if self._ready(t, now)]
                    if ready:
                        tenant = self._pick(ready)
                        break
                    wake = self._next_wake(now)
                    if wake is not None:
                        wait = wake - time.monotonic()
                        if wait > 0:
                            self._cv.wait(wait)
                    else:
                        self._cv.wait()
                is_deadline_flush = (len(tenant.pending) < tenant.lane.max_batch
                                     and tenant.launched >= tenant.flush_goal)
                chunk = tenant.pending[:tenant.lane.max_batch]
                del tenant.pending[:len(chunk)]
                tenant.launched += len(chunk)
                tenant.in_launch = True
                self._launch_seq += 1
                tenant.last_served = self._launch_seq
                store = tenant.spec.store
                needs_reload = store is not None and store.is_spilled
                if needs_reload:
                    # make room and reserve the bytes BEFORE dropping the lock;
                    # in_launch keeps this tenant from being a spill victim
                    self._enforce_budget_locked(exempt=tenant, incoming=tenant.stats["nbytes"])
                    self._resident_bytes += tenant.stats["nbytes"]
                    self.stats["device_store_bytes"] = self._resident_bytes
                self._cv.notify_all()               # wake backpressured submits
            w, exc, dispatch_s, pack_s = None, None, 0.0, 0.0
            try:
                if needs_reload:
                    exc = self._reload_store(tenant)
                if exc is None:
                    w, exc, dispatch_s, pack_s = tenant.lane.launch_panel(
                        chunk, self._pacer, self._make_on_retire(tenant.name),
                        panel=obs.new_id())
            except Exception as err:                # the lane itself failed (device error)
                exc = err
            with self._cv:
                tenant.in_launch = False
                now = time.monotonic()
                if w is not None:                   # stats mutate under _cv
                    tenant.stats["launched_widths"].append(w)
                    tenant.stats["pack_s"].append(pack_s)
                    tenant.stats["panels_launched"] += 1
                    if is_deadline_flush:
                        tenant.stats["deadline_flushes"] += 1
                    self.stats["panels_launched"] += 1
                    self.stats["launch_order"].append(tenant.name)
                    self._compiled.add((tenant.name, w))
                    if tenant.res is not None:
                        tenant.res.on_success()
                        tenant.stats["breaker_state"] = tenant.res.breaker_state()
                        dl = tenant.res.policy.launch_deadline_s
                        if dl is not None and dispatch_s > dl:
                            tenant.stats["slow_launches"] += 1
                            self._tenant_event(tenant, "slow_launch",
                                               f"dispatch took {dispatch_s:.4f}s > deadline "
                                               f"{dl}s")
                else:
                    self._handle_failure(tenant, chunk, exc, now)
                if tenant.lane.injector is not None:
                    tenant.stats["faults_injected"] = dict(tenant.lane.injector.counters)
                self._cv.notify_all()               # wake drain() / remove_tenant()

    def _handle_failure(self, tenant: _Tenant, chunk, exc, now: float):
        """One tenant panel launch failed (caller holds _cv): retry with
        backoff, fail the panel, or fail it AND quarantine the tenant."""
        verdict = "fail" if tenant.res is None else tenant.res.decide_failure(now)
        if verdict == "retry":
            # front of the TENANT queue: the relaunch goes back through _pick
            # and the shared pacer; neighbors are served during the backoff
            tenant.pending[:0] = chunk
            tenant.launched -= len(chunk)
            tenant.stats["retries"] += 1
            self.stats["retries"] += 1
            self._tenant_event(tenant, "retry", f"launch attempt failed ({exc!r}); panel of "
                                                f"{len(chunk)} re-queued with backoff")
            return
        for _, fut, _ in chunk:
            fut._fail(exc)
        tenant.stats["panel_failures"] += 1
        self.stats["panel_failures"] += 1
        self._tenant_event(tenant, "panel_failed", f"panel of {len(chunk)} failed: {exc!r}")
        if tenant.res is not None:
            tenant.stats["breaker_state"] = tenant.res.breaker_state()
        if verdict == "open":
            dropped, tenant.pending[:] = list(tenant.pending), []
            tenant.launched += len(dropped)
            self._tenant_event(tenant, "breaker_open", f"circuit opened; {len(dropped)} queued "
                                                       f"requests failed fast")
            err = CircuitOpenError(
                f"tenant {tenant.name!r} circuit breaker opened after consecutive panel "
                f"failures — queued request failed fast; resubmit after the cooldown "
                f"(half-open probe)")
            err.__cause__ = exc
            for _, fut, _ in dropped:
                fut._fail(err)

    def _make_on_retire(self, name: str):
        """Pacer-retirement callback: the launch's run time
        (``Completion.seconds``) into the per-tenant straggler EWMA."""
        def on_retire(elapsed_s: float, ok: bool):
            with self._cv:
                self._monitor.record(name, elapsed_s)
                self.stats["straggler_tenants"] = self._monitor.stragglers()
        return on_retire
