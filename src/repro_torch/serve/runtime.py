"""Async panel-serving runtime: queue -> scheduler -> staging -> fetch.

Port of ``repro.serve.runtime``.  The synchronous panel loop
(``serve.step._serve_in_panels``) packs, launches and fetches each panel
to completion before it packs the next, so the device idles while the host
packs and the host idles while the device computes.  :class:`PanelRuntime`
is the asynchronous path that ``HMatrixServer`` and ``HMatrixSolveServer``
share:

* **Request queue.**  :meth:`PanelRuntime.submit` takes one ``(N,)``
  vector, validates it on the submitting thread and returns a
  :class:`PanelFuture` at once; ``max_queue`` bounds the requests not yet
  launched (backpressure), ``shed_above`` rejects beyond a budget.
* **Panel scheduler.**  A daemon thread packs pending requests into panels
  and launches each as soon as it is full (or flushed, or its oldest
  request is ``deadline_s`` old).  Partial panels pad to the smallest
  width bucket of :func:`panel_width_buckets` (about R/4, R/2, R);
  :meth:`PanelRuntime.precompile` launches every bucket once up front, which
  also builds the CUDA kernels.
* **Staging on the card.**  Each request is packed as a contiguous ROW of a
  ``(max_batch, n)`` host staging buffer (pinned when the lane's device is
  CUDA): one memcpy per request, where a column of an ``(n, max_batch)``
  buffer is ``n`` strided writes.  The scheduler uploads ``buf[:w]`` with
  ``non_blocking=True`` on the lane's own CUDA stream (captured with the
  device when the runtime is built; PyTorch's current stream is per
  thread), transposes it on the device into the ``(n, w)`` panel the launch
  takes, launches, transposes the result back into rows on the device, and
  records a ``torch.cuda.Event`` on that stream.  The sync path packs,
  uploads and fetches the same way, so both give the same bits.
* **Pacing.**  :class:`LaunchPacer` keeps at most ``max_inflight`` panels
  outstanding; before taking new work the scheduler retires the oldest by
  synchronizing ITS event (never the whole device).  A lane has one staging
  buffer per pacer slot, and retirement is strict FIFO, so a buffer is
  packed again only after the upload that read it has finished.
* **Lazy fetch.**  The result stays on the device in a per-panel record;
  the first :meth:`PanelFuture.result` of the panel waits on the panel's
  event and copies the rows to the host once for all its futures.

:class:`LaunchPacer` and :class:`PanelLane` are the two reusable pieces:
``serve.tenancy.MultiTenantRuntime`` hosts many lanes behind one pacer.

There is no twin of ``repro``'s ``REPRO_STRICT_TRANSFERS`` switch: it is
``jax.transfer_guard``, which PyTorch does not have.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.hshard import pad_panel_width
from .faults import (CircuitOpenError, FaultInjector, LaneResilience, NaNGuard, OverloadedError,
                     ResiliencePolicy, resolve_chaos)

# width fractions of the full panel launched for partial flushes
_BUCKET_FRACTIONS = (4, 2, 1)


def panel_width_buckets(max_batch: int, n_dev: int = 1) -> tuple:
    """Increasing panel widths {~R/4, ~R/2, R}, each a multiple of ``n_dev``.

    Partial panels pad to the smallest sufficient bucket instead of the full
    width.  Duplicates collapse, and the largest bucket is ``max_batch``.
    """
    if max_batch < 1:
        raise ValueError(f"panel width must be >= 1, got {max_batch}")
    if max_batch % n_dev != 0:
        raise ValueError(f"panel width {max_batch} not a multiple of the device count {n_dev}")
    widths = {pad_panel_width(-(-max_batch // frac), n_dev) for frac in _BUCKET_FRACTIONS}
    widths.add(max_batch)
    return tuple(sorted(w for w in widths if w <= max_batch))


def width_for(count: int, widths: Sequence[int]) -> int:
    """Smallest bucket width >= ``count`` (``count`` <= the largest bucket)."""
    for w in widths:
        if w >= count:
            return w
    raise ValueError(f"{count} requests exceed the panel width {widths[-1]}")


def _host(vec):
    """A request as host data (a tensor on any device comes to the host)."""
    return vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor) else vec


def as_vector(vec) -> np.ndarray:
    """A request as a contiguous float32 host vector (no other checks)."""
    return np.ascontiguousarray(_host(vec), dtype=np.float32)


def validate_request(vec, n: int, who: str = "request") -> np.ndarray:
    """Host-side payload validation at ``submit()`` time.

    An invalid payload (wrong shape or dtype, non-finite values) is rejected
    HERE, on the submitting thread, not at launch, where it would fail the
    whole packed panel and every co-batched neighbor's future.
    """
    vec = _host(vec)
    if np.iscomplexobj(vec):
        raise ValueError(f"{who}: complex payload rejected — the serving panels are float32")
    try:
        q = np.ascontiguousarray(vec, dtype=np.float32)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{who}: payload not convertible to a float32 vector ({exc})") from None
    if q.shape != (n,):
        raise ValueError(f"{who} shape {q.shape} != ({n},)")
    if not np.isfinite(q).all():
        raise ValueError(f"{who}: non-finite payload (NaN/Inf) rejected at submit — it would "
                         f"poison every co-batched request in its panel")
    return q


def staging_buffer(rows: int, n: int, device: torch.device) -> torch.Tensor:
    """A ``(rows, n)`` float32 host buffer, pinned when ``device`` is CUDA."""
    return torch.zeros((rows, n), dtype=torch.float32, pin_memory=device.type == "cuda")


def pack_rows(buf: np.ndarray, vectors, w: int) -> None:
    """Request j into row j of ``buf``; rows ``len(vectors):w`` zeroed (a
    reused buffer holds the last panel's rows there)."""
    for j, q in enumerate(vectors):
        buf[j] = q
    buf[len(vectors):w] = 0.0


def upload_rows(rows, device) -> torch.Tensor:
    """A host ``(w, n)`` block of request rows as the ``(n, w)`` device panel
    a launch takes: one copy to the device, transposed there (a view)."""
    rows = torch.as_tensor(rows)
    return rows.to(device, non_blocking=rows.is_pinned(), copy=True).t()


def fetch_rows(out: torch.Tensor) -> np.ndarray:
    """A launch's ``(n, w)`` result as host ``(w, n)`` rows: transposed on the
    device, so that each request's vector comes back as a contiguous row."""
    return rows_to_host(out.t().contiguous())


def rows_to_host(rows: torch.Tensor) -> np.ndarray:
    """Device rows on the host, copied into pinned memory from a card (a
    pageable destination copies at a fraction of the link's rate)."""
    if rows.device.type != "cuda":
        return rows.numpy()
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows)
    return host.numpy()


def _on_stream(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _snapshot(value):
    """Deep-ish copy of a stats tree: dicts copied, deques become lists."""
    if isinstance(value, dict):
        return {k: _snapshot(v) for k, v in value.items()}
    if isinstance(value, (deque, list, tuple)):
        return [_snapshot(v) for v in value]
    return value


class _Stats(dict):
    """Stats counters: a dict the runtime mutates under its lock, CALLABLE for
    a consistent snapshot copied under that lock (deques become lists)."""

    def __init__(self, lock, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = lock

    def __call__(self) -> dict:
        with self._lock:
            return _snapshot(self)


class _PanelRecord:
    """One launched panel, shared by the futures of its columns.

    Holds the device result as ``(w, n)`` rows and the launch's
    :class:`Completion`; the first ``host()`` waits on it, copies the rows to the host
    once and caches them for every other column.  With a
    :class:`~repro_torch.serve.faults.NaNGuard` attached the fetched rows are
    validated first (and on NaN/Inf relaunched once through the lane's
    launch); a guard failure is cached too, so every column re-raises the
    same error.
    """

    __slots__ = ("_rows", "_done", "_host", "_lock", "_guard", "_exc")

    def __init__(self, rows: torch.Tensor, done: "Completion", guard=None):
        self._rows = rows
        self._done = done
        self._host = None
        self._lock = threading.Lock()
        self._guard = guard
        self._exc = None

    def host(self) -> np.ndarray:
        with self._lock:
            if self._exc is not None:
                raise self._exc
            if self._host is None:
                self._done.synchronize()
                out = rows_to_host(self._rows)
                if self._guard is not None:
                    try:
                        out = self._guard.check(out)
                    except Exception as exc:
                        self._exc = exc
                        raise
                self._host = out
                self._rows = self._done = self._guard = None
            return self._host


class PanelFuture:
    """Result handle of one submitted request.

    ``done()`` turns True when the request's panel has been LAUNCHED (it may
    still be computing).  ``result()`` blocks until then, fetches the panel to
    the host (once, shared by the panel's futures) and returns this request's
    ``(N,)`` row.
    """

    __slots__ = ("_event", "_record", "_col", "_exc", "t_submit")

    def __init__(self):
        self._event = threading.Event()
        self._record = None
        self._col = 0
        self._exc = None
        self.t_submit = time.monotonic()

    def _resolve(self, record: _PanelRecord, col: int):
        self._record, self._col = record, col
        self._event.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("panel not launched within timeout")
        if self._exc is not None:
            raise self._exc
        return self._record.host()[self._col]


class Completion:
    """When one launch's work is done, and how long it ran.

    On CUDA two timing events bracket the launch on the lane's stream:
    ``synchronize`` waits for the second, ``seconds`` is the device time
    between them.  On the CPU a launch has finished when it returns, and
    ``seconds`` is the call's host time.
    """

    __slots__ = ("_start", "_end", "_host_s")

    def __init__(self, stream):
        self._start = self._end = None
        if stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
        self._host_s = time.perf_counter()

    def record(self, stream) -> None:
        """Mark the end of the launch's work on ``stream``."""
        if self._end is not None:
            self._end.record(stream)
        self._host_s = time.perf_counter() - self._host_s

    def synchronize(self):
        if self._end is not None:
            self._end.synchronize()

    def seconds(self) -> float:
        """The launch's run time (call after ``synchronize``)."""
        if self._end is None:
            return self._host_s
        return self._start.elapsed_time(self._end) / 1e3


class LaunchPacer:
    """Bounded in-flight launch FIFO: the pacing half of the runtime.

    At most ``max_inflight`` launches are outstanding; before taking new work
    the scheduler calls :meth:`wait_for_slot`, which retires the OLDEST
    outstanding launch by synchronizing its :class:`Completion` (its CUDA
    event) until a slot is free.  Single consumer: only the owning scheduler
    thread calls it.

    This is also the staging-buffer guarantee.  Retirement is strict FIFO, so
    after :meth:`wait_for_slot` the outstanding set is the most recent
    ``<= max_inflight - 1`` launches.  A :class:`PanelLane` with
    ``max_inflight`` staging buffers comes back to a buffer only after
    ``max_inflight - 1`` NEWER launches of that lane; were the buffer's old
    upload still outstanding, those would be too: ``>= max_inflight``
    outstanding, a contradiction.  It holds when many lanes (tenants) share
    one pacer.
    """

    def __init__(self, max_inflight: int = 2):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = int(max_inflight)
        self._inflight: list = []   # (done, t_commit, on_retire), FIFO order

    def __len__(self) -> int:
        return len(self._inflight)

    def wait_for_slot(self):
        """Block on the oldest outstanding launch until a slot is free.

        Arrivals keep queueing meanwhile, so the next panel packs wider under
        load.  Retirement calls the launch's ``on_retire(seconds, ok)`` with
        its run time (``Completion.seconds``).  An error surfaced by the
        synchronize (a device fault) is contained here and reaches the
        panel's awaiters at their fetch; one raised by ``seconds`` or
        ``on_retire`` (accounting) is contained too.
        """
        while len(self._inflight) >= self.max_inflight:
            done, t_commit, on_retire = self._inflight.pop(0)
            ok = True
            try:
                done.synchronize()
            except Exception:
                # the panel's awaiters meet the same error at their fetch; it
                # must not end the scheduler thread (its pending requests
                # would strand and close() would wait forever)
                ok = False
            if on_retire is None:
                continue
            try:
                on_retire(done.seconds() if ok else time.monotonic() - t_commit, ok)
            except Exception:
                pass                # accounting must not kill the scheduler

    def commit(self, done, on_retire=None):
        """Record one freshly enqueued launch (scheduler thread only)."""
        self._inflight.append((done, time.monotonic(), on_retire))


class PanelLane:
    """Packing lane of ONE launch target: staging pool, stream, width buckets.

    Owns everything per target about getting a request chunk onto the card:
    the width buckets, the device and the CUDA stream its panels run on, a
    pool of host staging buffers (one per pacer slot; see
    :class:`LaunchPacer`), the launch call and resolving the chunk's futures.
    ``PanelRuntime`` owns one lane; ``MultiTenantRuntime`` one per tenant, all
    paced by one shared :class:`LaunchPacer`.

    Resilience hooks: ``injector`` wraps the launch with a chaos
    :class:`~repro_torch.serve.faults.FaultInjector`; ``guard_outputs``
    attaches a :class:`~repro_torch.serve.faults.NaNGuard` to every panel
    (one host copy of the packed rows per launch, so it is opt-in), whose one
    relaunch is :meth:`relaunch`, and ``on_relaunch`` counts it.  ``store``
    is the ``FactorStore`` the launch reads, held for the owning runtime's
    byte accounting and memory tier.
    """

    def __init__(self, n: int, max_batch: int, launch: Callable, n_dev: int = 1,
                 slots: int = 2, injector=None, guard_outputs: bool = False,
                 on_relaunch: Callable | None = None, store=None, device=None):
        self.n = int(n)
        self.max_batch = int(max_batch)
        self.widths = panel_width_buckets(self.max_batch, n_dev)
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.injector = injector
        self.store = store
        self._inner = launch            # un-instrumented: the warm-up path
        self._launch = injector.wrap(launch) if injector is not None else launch
        self._guard_outputs = bool(guard_outputs)
        self._on_relaunch = on_relaunch
        self._staging = [staging_buffer(self.max_batch, self.n, self.device)
                         for _ in range(slots)]
        self._staging_np = [b.numpy() for b in self._staging]
        self._buf = 0

    def nbytes(self) -> int:
        """Device bytes of this lane's factor store (0 without one)."""
        return int(self.store.nbytes()["total"]) if self.store is not None else 0

    def synchronize(self):
        """Wait until everything this lane queued on its stream has run."""
        if self.stream is not None:
            self.stream.synchronize()

    def launch_panel(self, chunk, pacer: LaunchPacer, on_retire=None):
        """Pack ``chunk`` into the current staging buffer, pad it to its width
        bucket, launch, and resolve the chunk's futures.

        Scheduler thread only, and only AFTER ``pacer.wait_for_slot()``: that
        order is the staging-buffer reuse guarantee.  Returns ``(w, None,
        dispatch_s, pack_s)``, or ``(None, exc, dispatch_s, pack_s)`` when the
        launch raised; the owning runtime decides between failing and
        retrying, so the lane never fails futures itself.
        """
        w = width_for(len(chunk), self.widths)
        buf = self._staging[self._buf]
        t0 = time.perf_counter()
        pack_rows(self._staging_np[self._buf], [q for q, _, _ in chunk], w)
        pack_s = time.perf_counter() - t0
        t0 = time.monotonic()
        try:
            with _on_stream(self.stream):
                done = Completion(self.stream)
                out = self._launch(upload_rows(buf[:w], self.device))
                rows = out.t().contiguous()     # the fetch's layout, made on the device
                done.record(self.stream)
        except Exception as exc:
            # the upload may still be reading the buffer, whose index stays
            # put: wait for it before the buffer is packed again
            self.synchronize()
            return None, exc, time.monotonic() - t0, pack_s
        dispatch_s = time.monotonic() - t0
        guard = None
        if self._guard_outputs:
            # the buffer is repacked once the pacer retires this launch: keep
            # a host copy of the rows for the guard's relaunch
            saved = buf[:w].clone()
            guard = NaNGuard(len(chunk), lambda: self.relaunch(saved), self._on_relaunch)
        record = _PanelRecord(rows, done, guard)
        pacer.commit(done, on_retire)
        self._buf = (self._buf + 1) % len(self._staging)
        for j, (_, fut, _) in enumerate(chunk):
            fut._resolve(record, j)
        return w, None, dispatch_s, pack_s

    def relaunch(self, rows: torch.Tensor) -> np.ndarray:
        """Launch saved host ``(w, n)`` request rows once more through the
        un-instrumented launch, on the lane's stream, and fetch the result
        rows: the NaN/Inf guard's one relaunch, run on the fetching thread.
        The launch is the lane's own, so the relaunch takes the same kernels
        and, on clean inputs, gives the same bits."""
        with _on_stream(self.stream):
            return fetch_rows(self._inner(upload_rows(rows, self.device)))

    def precompile_width(self, w: int):
        """Launch the un-instrumented callable on a zero ``(n, w)`` panel and
        wait for it (warm-up, which also builds the kernels; it never draws
        from the chaos schedule)."""
        z = torch.zeros((self.n, w), dtype=torch.float32, device=self.device)
        with _on_stream(self.stream):
            self._inner(z)
        self.synchronize()


class PanelRuntime:
    """Asynchronous micro-batching runtime over one panel launch callable.

    Parameters
    ----------
    n : int
        Request vector length (the H-matrix size).
    max_batch : int
        Full panel width; a multiple of ``n_dev``.
    launch : Callable
        ``launch(panel)`` takes an ``(n, w)`` float32 panel on ``device``
        (``w`` one of ``self.widths``) and returns the ``(n, w)`` result on
        it, enqueued on the current stream.  A host sync inside it (as the
        PCG's per-iteration ``active.any()``) holds the scheduler thread for
        its duration.
    n_dev : int, optional
        Shard count of a meshed launch: every width bucket is a multiple of
        it, so that every shard is full.
    deadline_s : float, optional
        Flush a partial panel once its oldest request has waited this long;
        ``None``: partial panels launch only on flush / drain / close.
    max_queue : int, optional
        Backpressure cap on requests not yet launched (``submit`` blocks).
    max_inflight : int, optional
        At most this many panels outstanding on the card (:class:`LaunchPacer`).
    chaos : None | str | ChaosSpec, optional
        Fault-injection schedule; ``None`` defers to ``REPRO_CHAOS``, ``""``
        disables it.
    resilience : ResiliencePolicy, optional
        Failure containment; ``None`` means none, unless chaos is active,
        which installs the default policy.
    shed_above : int, optional
        Load shedding: ``submit`` raises ``OverloadedError`` while the queue
        holds this many requests (>= ``max_batch``).
    store : FactorStore, optional
        The factor store ``launch`` reads, for byte accounting.
    device : optional
        Where panels are staged and launched; ``None`` means CUDA (and raises
        without a card).

    ``stats`` holds ``launched_widths`` and ``pack_s`` (bounded deques, most
    recent panels: width, and host seconds spent packing), ``panels_launched``,
    ``max_queue_depth``, ``backpressure_waits``, ``retries``,
    ``panel_failures``, ``faults_injected``, ``breaker_state``,
    ``fallback_launches`` (the NaN guard's relaunches, under the reference's
    name), ``shed_requests``, ``slow_launches`` and ``events`` (a bounded
    trace of ``(t, kind, detail)``); call it for a snapshot.
    """

    def __init__(self, n: int, max_batch: int, launch: Callable, n_dev: int = 1,
                 deadline_s: float | None = None, max_queue: int | None = None,
                 max_inflight: int = 2, chaos=None, resilience: ResiliencePolicy | None = None,
                 shed_above: int | None = None, store=None, device=None):
        if max_queue is not None and max_queue < max_batch:
            raise ValueError(f"max_queue ({max_queue}) must be >= max_batch ({max_batch})")
        if shed_above is not None and shed_above < max_batch:
            raise ValueError(f"shed_above ({shed_above}) must be >= max_batch ({max_batch}) — "
                             f"a full panel could never be admitted")
        chaos_spec = resolve_chaos(chaos)
        if resilience is None and chaos_spec is not None:
            resilience = ResiliencePolicy()
        self._cv = threading.Condition()
        self._pacer = LaunchPacer(max_inflight)
        injector = FaultInjector(chaos_spec, "panel") if chaos_spec is not None else None
        guard = resilience is not None and resilience.validate_outputs
        self._lane = PanelLane(n, max_batch, launch, n_dev=n_dev, slots=max_inflight,
                               injector=injector, guard_outputs=guard,
                               on_relaunch=self._count_relaunch, store=store, device=device)
        self.n = self._lane.n
        self.max_batch = self._lane.max_batch
        self.widths = self._lane.widths
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self.max_inflight = max_inflight
        self.shed_above = shed_above
        self.resilience = resilience    # frozen policy (lock-free reads ok)
        self._res = LaneResilience(resilience, "panel") if resilience is not None else None
        self.stats = _Stats(self._cv,
                            {"launched_widths": deque(maxlen=1024),
                             "pack_s": deque(maxlen=1024),
                             "panels_launched": 0, "max_queue_depth": 0,
                             "backpressure_waits": 0, "retries": 0, "panel_failures": 0,
                             "faults_injected": {}, "fallback_launches": 0,
                             "shed_requests": 0, "slow_launches": 0,
                             "breaker_state": ("disabled" if self._res is None
                                               else self._res.breaker_state()),
                             "events": deque(maxlen=256)})
        self._pending: list = []        # [(np vector, PanelFuture, t_arrival)]
        self._flush_goal = 0            # launch until this many have launched
        self._launched = 0              # requests launched so far (FIFO count)
        self._submitted = 0
        self._in_launch = False
        self._closing = False
        self._closed = False
        self._thread: threading.Thread | None = None

    # -- client side --------------------------------------------------------

    def submit(self, vec) -> PanelFuture:
        """Enqueue one request vector; returns its future at once.

        Blocks only for backpressure (``max_queue``), never for the device.
        Raises ``RuntimeError`` once closed, ``ValueError`` on an invalid
        payload, ``CircuitOpenError`` while the breaker quarantines the lane
        and ``OverloadedError`` when load shedding rejects the request.
        """
        q = validate_request(vec, self.n)
        fut = PanelFuture()
        with self._cv:
            self._check_open()
            self._check_admission()
            while self.max_queue is not None and len(self._pending) >= self.max_queue:
                self.stats["backpressure_waits"] += 1
                self._cv.wait()
                self._check_open()
                self._check_admission()
            self._pending.append((q, fut, time.monotonic()))
            self._submitted += 1
            depth = len(self._pending)
            if depth > self.stats["max_queue_depth"]:
                self.stats["max_queue_depth"] = depth
            self._ensure_thread()
            self._cv.notify_all()
        return fut

    def _check_open(self):
        if self._closing:
            raise RuntimeError(
                "PanelRuntime is closed — submit() rejected; results of already-submitted "
                "requests remain fetchable via their futures, but new work needs a new runtime")

    def _check_admission(self):
        """Breaker and load-shedding admission control (caller holds _cv)."""
        if self._res is not None:
            if not self._res.allow_submit(time.monotonic()):
                raise CircuitOpenError(
                    "circuit breaker is open after consecutive panel failures — submits fail "
                    "fast until the cooldown elapses and a half-open probe panel succeeds")
            self._sync_breaker_stat()   # open -> half_open is observable
        if self.shed_above is not None and len(self._pending) >= self.shed_above:
            self.stats["shed_requests"] += 1
            self._event("shed", f"queue depth {len(self._pending)} >= shed_above "
                                f"{self.shed_above}")
            raise OverloadedError(
                f"request shed: {len(self._pending)} queued requests >= admission budget "
                f"shed_above={self.shed_above} — retry later or raise the budget")

    def _sync_breaker_stat(self):
        """Mirror the breaker state into stats (caller holds _cv)."""
        if self._res is not None:
            self.stats["breaker_state"] = self._res.breaker_state()

    def _count_relaunch(self):
        # called from the FETCHING client thread (NaNGuard): takes the lock
        with self._cv:
            self.stats["fallback_launches"] += 1
            self._event("fallback", "NaN/Inf panel relaunched once through the same launch")

    def _event(self, kind: str, detail: str):
        """Append to the bounded failure-event trace (caller holds _cv)."""
        self.stats["events"].append((time.monotonic(), kind, detail))

    def flush(self):
        """Launch everything already submitted, partial panels included."""
        with self._cv:
            self._flush_goal = max(self._flush_goal, self._submitted)
            self._cv.notify_all()

    def drain(self):
        """Flush, then block until every submitted request has LAUNCHED
        (launched, not fetched: results are still awaited per future)."""
        self.flush()
        with self._cv:
            self._cv.wait_for(lambda: (not self._pending and not self._in_launch)
                              or self._closing)

    def precompile(self):
        """Launch every width bucket once on a zero panel (builds the kernels
        and warms the allocator before real requests)."""
        for w in self.widths:
            self._lane.precompile_width(w)

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def close(self):
        """Drain pending requests, then stop the scheduler thread (idempotent)."""
        with self._cv:
            if self._closed:
                return
        self.drain()
        with self._cv:
            if self._closed:            # lost a close/close race: done
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

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._scheduler, name="panel-runtime",
                                            daemon=True)
            self._thread.start()

    def _next_deadline(self) -> float | None:
        if self.deadline_s is None or not self._pending:
            return None
        return self._pending[0][2] + self.deadline_s

    def _launchable(self, now: float) -> bool:
        """Is a panel ready to take right now?  (Caller holds _cv; the
        retry-backoff gate is checked by the scheduler.)"""
        if len(self._pending) >= self.max_batch:
            return True                             # full panel ready
        if self._pending and self._launched < self._flush_goal:
            return True                             # flushed partial panel
        deadline = self._next_deadline()
        return deadline is not None and deadline <= now

    def _handle_failure(self, chunk, exc, now: float):
        """One panel launch failed (caller holds _cv): retry with backoff,
        fail the panel, or fail it AND open the breaker."""
        verdict = "fail" if self._res is None else self._res.decide_failure(now)
        if verdict == "retry":
            # the panel RE-ENTERS the queue at the front and goes back through
            # wait_for_slot and the staging rotation like any other panel
            self._pending[:0] = chunk
            self._launched -= len(chunk)
            self.stats["retries"] += 1
            self._event("retry", f"launch attempt failed ({exc!r}); panel of {len(chunk)} "
                                 f"re-queued with backoff")
            return
        for _, fut, _ in chunk:
            fut._fail(exc)
        self.stats["panel_failures"] += 1
        self._sync_breaker_stat()
        self._event("panel_failed", f"panel of {len(chunk)} failed: {exc!r}")
        if verdict == "open":
            # quarantine: everything queued fails fast
            dropped, self._pending[:] = list(self._pending), []
            self._launched += len(dropped)
            self._event("breaker_open", f"circuit opened; {len(dropped)} queued requests "
                                        f"failed fast")
            err = CircuitOpenError(
                "circuit breaker opened after consecutive panel failures — queued request "
                "failed fast; resubmit after the cooldown (half-open probe)")
            err.__cause__ = exc
            for _, fut, _ in dropped:
                fut._fail(err)

    def _scheduler(self):
        while True:
            # pacing: retire the oldest in-flight panel BEFORE taking new work
            self._pacer.wait_for_slot()
            with self._cv:
                while True:
                    if self._closing:
                        return
                    now = time.monotonic()
                    gate = self._res.gate(now) if self._res is not None else None
                    if gate is None and self._launchable(now):
                        break
                    # sleep until the earliest of: retry-backoff expiry, the
                    # oldest request's deadline (None: until notified)
                    wakes = [t for t in (gate, self._next_deadline()) if t is not None]
                    if wakes:
                        wait = min(wakes) - time.monotonic()
                        if wait > 0:
                            self._cv.wait(wait)
                    else:
                        self._cv.wait()
                chunk = self._pending[:self.max_batch]
                del self._pending[:len(chunk)]
                self._launched += len(chunk)
                self._in_launch = True
                self._cv.notify_all()               # wake backpressured submits
            w, exc, dispatch_s, pack_s = None, None, 0.0, 0.0
            try:
                w, exc, dispatch_s, pack_s = self._lane.launch_panel(chunk, self._pacer)
            except Exception as err:                # the lane itself failed (device error)
                exc = err
            with self._cv:
                self._in_launch = False
                now = time.monotonic()
                if w is not None:                   # stats mutate under _cv
                    self.stats["launched_widths"].append(w)
                    self.stats["pack_s"].append(pack_s)
                    self.stats["panels_launched"] += 1
                    if self._res is not None:
                        self._res.on_success()
                        self._sync_breaker_stat()
                        dl = self.resilience.launch_deadline_s
                        if dl is not None and dispatch_s > dl:
                            self.stats["slow_launches"] += 1
                            self._event("slow_launch", f"dispatch took {dispatch_s:.4f}s > "
                                                       f"deadline {dl}s")
                else:
                    self._handle_failure(chunk, exc, now)
                if self._lane.injector is not None:
                    self.stats["faults_injected"] = dict(self._lane.injector.counters)
                self._cv.notify_all()               # wake drain()
