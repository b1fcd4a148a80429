"""The measured window: a traffic plan's requests through
``HMatrixServer.submit`` and ``PanelFuture.result``.

One generator thread sends the plan's events when due (open arrivals,
closed callers starting); this thread fetches every answer in the order
the requests were sent (the runtime launches panels first in, first out)
and sends a closed caller's next request when its answer is back.  Each
answer is kept only at the judge's sampled rows.  Times are on the host's
monotonic clock; an open request is timed from the moment it was due, so
a stall counts against every request it delays, and a closed one from its
sending.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

GRACE_S = 60.0          # how long past the window's close an answer is waited for


@dataclass
class Window:
    t0: float                # window start (monotonic s)
    due: np.ndarray          # (n,) when each request was due / sent
    done: np.ndarray         # (n,) when its answer came back; nan if never
    pool_index: np.ndarray   # (n,)
    samples: np.ndarray      # (n, S) served rows at the sampled rows
    late_s: np.ndarray       # (n,) how late the generator sent each request
    give_up: float           # the last moment an answer was waited for
    accepted: int            # requests that submit took (the rest it refused)

    def answered(self) -> np.ndarray:
        return np.isfinite(self.done)

    def rps(self) -> float:
        """Every request of the window that was answered, over the time from
        the window's start to the last answer: all the work sent in the
        window and all the time it took, with no cut at the close (a
        closed loop's answers come 64 at a time, seconds apart)."""
        done = self.done[self.answered()]
        if done.size == 0:
            return 0.0
        return float(done.size / (done.max() - self.t0))

    def latency_s(self) -> np.ndarray:
        """Per request, due to answer; an unanswered one counts as waited
        for until the harness gave up."""
        return np.where(self.answered(), self.done, self.give_up) - self.due


def _fetch(srv, fut, rows, end, give_up, spans):
    """The answer's sampled rows, or None when it fails or never comes.
    From the window's close on, a partial panel left behind is flushed
    (a mix with no deadline would hold it for ever)."""
    with spans.span("hbench.result"):
        while True:
            now = time.monotonic()
            if now >= end:
                srv.flush()
            try:
                out = fut.result(timeout=max(0.0, (end if now < end else give_up) - now))
            except TimeoutError:            # not launched yet
                if time.monotonic() < give_up:
                    continue
                return None
            except Exception:               # a failed request
                return None
            return out[rows]


def run(srv, plan, pool: np.ndarray, rows: np.ndarray, seconds: float, spans) -> Window:
    """Drive ``plan`` (``traffic.plan``) through ``srv`` for a window of
    ``seconds``, then wait for every request sent."""
    t0 = time.monotonic() + 0.01
    end, give_up = t0 + seconds, t0 + seconds + GRACE_S
    due, index, late, futs = [], [], [], []
    sent: queue.Queue = queue.Queue()
    lock = threading.Lock()                 # sending order == fetching order

    def send(source, due_at=None, pool_row=None):
        """An open request (due at ``due_at``, ``pool_row`` drawn with the
        plan) or a closed caller's next (its source's next draw, taken
        under the lock so that the draws' order is the sending order)."""
        with lock, spans.span("hbench.submit"):
            if pool_row is None:
                pool_row = plan.closed_draws[source].next()
            try:
                fut = srv.submit(pool[pool_row])
            except Exception as exc:        # refused: counts as unanswered
                fut = exc
            now = time.monotonic()
            due.append(now if due_at is None else due_at)
            late.append(0.0 if due_at is None else now - due_at)
            index.append(pool_row)
            futs.append(fut)
            sent.put((len(futs) - 1, source))

    def generate():
        k = 0                               # next open request's pool index
        for t, source, count in zip(plan.start_s, plan.source, plan.count):
            with spans.span("hbench.sleep"):
                wait = t0 + t - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            closed = plan.closed_draws[source] is not None
            for _ in range(count):
                if closed:
                    send(source)
                else:
                    send(source, t0 + t, int(plan.pool_index[k]))
                    k += 1

    gen = threading.Thread(target=generate, name="hbench-generator")
    gen.start()
    done, samples = {}, {}
    while True:
        try:
            i, source = sent.get(timeout=0.05)
        except queue.Empty:
            if not gen.is_alive() and sent.empty():
                break
            continue
        fut = futs[i]
        got = None if isinstance(fut, Exception) else _fetch(srv, fut, rows, end, give_up,
                                                              spans)
        if got is not None:
            done[i], samples[i] = time.monotonic(), got
        if (plan.closed_draws[source] is not None
                and time.monotonic() < t0 + plan.closed_stop_s[source]):
            send(source)
    gen.join()
    n = len(futs)
    out = np.zeros((n, rows.shape[0]), np.float32)
    for i, row in samples.items():
        out[i] = row
    return Window(t0=t0, due=np.asarray(due, float),
                  done=np.array([done.get(i, np.nan) for i in range(n)], float),
                  pool_index=np.asarray(index, np.int64), samples=out,
                  late_s=np.asarray(late, float), give_up=give_up,
                  accepted=sum(not isinstance(f, Exception) for f in futs))
