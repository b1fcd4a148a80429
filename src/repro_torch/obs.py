"""In-memory spans of the serving runtime and the apply, off by default.

::

    from repro_torch import obs
    obs.enable()
    ...                            # serve
    out = obs.collect()            # {"spans": [...], "dropped": n}; clears the buffer
    obs.disable()

A **host span** (:func:`span`) times a block on ``time.perf_counter_ns``,
the clock a ``torch.profiler`` trace can be mapped onto, so the spans and
the device's activity share one timeline.  A **device span**
(:func:`device_span`) brackets the work a block enqueues on the current
CUDA stream with a :class:`Completion` (two timing events); on the CPU it
takes the block's host time.  The events are read by :func:`collect`, the
one place that waits on them, off the launch path.

Host spans opened with one :class:`Tiles` share their boundaries, each
beginning where the last ended, so that a loop's spans cover it whole.
Each span's parent is the host span open on the same thread when it began,
and it inherits that span's ``panel`` id.  ``runtime.queued`` spans begin
on the submitting thread and end on the scheduler's (:func:`queued`,
:func:`end_queued`).

While the tracer is off, a span site costs one flag check and gets a shared
null context: nothing is allocated, no clock is read and no CUDA event is
made.  The buffer holds at most ``capacity`` records; past that a record is
dropped and counted.  :func:`collect` also reports the host spans still open
(``"open": True``, ending at the collect), so that what a thread is waiting
in shows while it waits.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch

_clock = time.perf_counter_ns

_on = False
_lock = threading.Lock()
_records: list = []
_capacity = 0
_dropped = 0
_since = 0                      # the clock at enable(): older open spans are not reported
_ids = itertools.count(1)
_stacks: dict = {}              # thread ident -> its open host spans, innermost last

FIELDS = ("name", "kind", "id", "parent", "thread", "t0_ns", "t1_ns", "panel", "request",
          "requests", "width", "blocks", "batches")


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


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def enable(capacity: int = 1 << 16) -> None:
    """Start recording into an empty buffer of ``capacity`` records."""
    global _on, _capacity, _records, _dropped, _since
    with _lock:
        _records, _dropped, _capacity, _since = [], 0, int(capacity), _clock()
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`collect`."""
    global _on
    _on = False


def collect() -> dict:
    """The records so far and the host spans still open, oldest start first,
    and the count dropped; clears the records.  Waits for each device span's
    second event."""
    global _records, _dropped
    now = _clock()
    with _lock:
        records, dropped = _records, _dropped
        _records, _dropped = [], 0
    spans = [dict(zip(FIELDS, span.record(thread, now)), open=True)
             for thread, stack in list(_stacks.items()) for span in list(stack)
             if span.t0 >= _since]
    for rec in records:
        out = dict(zip(FIELDS, rec))
        done = rec[-1]
        if done is not None:
            done.synchronize()
            out["device_ms"] = done.seconds() * 1e3
        spans.append(out)
    spans.sort(key=lambda s: (s["t0_ns"], s["id"]))
    return {"spans": spans, "dropped": dropped}


def _append(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_records) < _capacity:
            _records.append(rec)
        else:
            _dropped += 1


def _stack() -> list:
    thread = threading.get_ident()
    stack = _stacks.get(thread)
    if stack is None:
        stack = _stacks[thread] = []
    return stack


def _parent() -> tuple:
    """``(id, panel)`` of the host span open on this thread, or Nones."""
    stack = _stack()
    return (stack[-1].id, stack[-1].panel) if stack else (None, None)


def new_id():
    """A fresh span / panel id, or None while the tracer is off."""
    return next(_ids) if _on else None


class Tiles:
    """Successive host spans of one loop that leave none of it uncovered:
    a span opened with ``tiles=`` begins at the instant the last one of the
    same ``Tiles`` ended (read once, so the two share it), or at its own
    start when there is no such span since :func:`enable`.  What runs
    between two of them (taking a lock, bookkeeping) counts in the later."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = 0


class _HostSpan:
    __slots__ = ("name", "panel", "requests", "width", "tiles", "id", "parent", "t0")

    def __init__(self, name, panel, requests, width, tiles):
        self.name, self.panel, self.requests, self.width = name, panel, requests, width
        self.tiles = tiles

    def __enter__(self):
        self.id = next(_ids)
        self.parent, panel = _parent()
        if self.panel is None:
            self.panel = panel
        self.t0 = _clock()
        if self.tiles is not None and _since <= self.tiles.t <= self.t0:
            self.t0 = self.tiles.t
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.tiles is not None:
            self.tiles.t = t1
        _stack().pop()
        _append(self.record(threading.get_ident(), t1))
        return False

    def record(self, thread: int, t1: int) -> tuple:
        return (self.name, "host", self.id, self.parent, thread, self.t0, t1, self.panel, None,
                self.requests, self.width, None, None, None)


def span(name: str, panel=None, requests=None, width=None, tiles: Tiles | None = None):
    """A host span over a ``with`` block; ``panel`` defaults to the parent's;
    with ``tiles`` it begins where the last span of ``tiles`` ended."""
    if not _on:
        return NULL
    return _HostSpan(name, panel, requests, width, tiles)


class _DeviceSpan:
    __slots__ = ("name", "stream", "blocks", "batches", "done", "parent", "panel", "t0")

    def __init__(self, name, stream, blocks, batches):
        self.name, self.stream, self.blocks, self.batches = name, stream, blocks, batches

    def __enter__(self):
        self.parent, self.panel = _parent()
        self.t0 = _clock()
        self.done = Completion(self.stream)
        return self

    def __exit__(self, *exc):
        self.done.record(self.stream)
        _append((self.name, "device", next(_ids), self.parent, threading.get_ident(), self.t0,
                 _clock(), self.panel, None, None, None, self.blocks, self.batches, self.done))
        return False


def device_span(name: str, at, blocks=None, batches=None):
    """A device span over the work a ``with`` block enqueues on the current
    stream of ``at`` (a ``torch.device``, or a tensor on it: its ``.device``
    is read only while the tracer is on); the block's host time on the CPU.
    ``blocks`` and ``batches`` are kept with it (a batch's blocks, a stage's
    batches)."""
    if not _on:
        return NULL
    device = at if isinstance(at, torch.device) else at.device
    return _DeviceSpan(name, torch.cuda.current_stream(device) if device.type == "cuda"
                       else None, blocks, batches)


def device_record(name: str, done: Completion) -> None:
    """Keep an existing, recorded :class:`Completion` as a device span under
    the host span open on this thread."""
    if not _on:
        return
    parent, panel = _parent()
    t = _clock()
    _append((name, "device", next(_ids), parent, threading.get_ident(), t, t, panel, None, None,
             None, None, None, done))


def queued(request: int):
    """At submit: request ``request``'s open ``runtime.queued`` span, or None
    while the tracer is off."""
    if not _on:
        return None
    return request, threading.get_ident(), _clock()


def end_queued(tokens, panel: int) -> None:
    """Close the ``runtime.queued`` spans of ``tokens`` (from :func:`queued`;
    None is skipped) as their requests are taken into panel ``panel``."""
    if not _on:
        return
    t1 = _clock()
    for tok in tokens:
        if tok is not None:
            request, thread, t0 = tok
            _append(("runtime.queued", "host", next(_ids), None, thread, t0, t1, panel, request,
                     None, None, None, None, None))
