"""The seeded generators repeat: an open source's schedule, a closed
source's draws, a mix of both, the request pool and the judge's rows."""
from __future__ import annotations

import numpy as np
import pytest

BIG = 2 ** 31 + 12345          # seeds may pass 32 signed bits
BASE = {"server": {"max_batch": 64, "deadline_s": 0.2}, "pool": 256,
        "warm": {"widths": [64], "panels": 1}}
OPEN = dict(BASE, sources=[{"kind": "open", "rate_rps": 110.0}])
CLOSED = dict(BASE, sources=[{"kind": "closed", "clients": 256}])


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_open_schedule_repeats_and_keeps_its_count(seed):
    from harness import traffic
    a = traffic.plan(OPEN, seed, 30.0)
    b = traffic.plan(OPEN, seed, 30.0)
    np.testing.assert_array_equal(a.start_s, b.start_s)
    np.testing.assert_array_equal(a.pool_index, b.pool_index)
    assert a.start_s.shape == a.pool_index.shape == (3300,)
    assert np.all(a.count == 1) and np.all(a.source == 0)
    assert np.all(np.diff(a.start_s) >= 0) and 0 <= a.start_s[0] and a.start_s[-1] < 30.0
    assert a.pool_index.min() >= 0 and a.pool_index.max() < 256
    assert a.closed_draws == (None,)


def test_open_schedule_differs_by_seed_not_by_count():
    from harness import traffic
    a = traffic.plan(OPEN, 1, 30.0)
    b = traffic.plan(OPEN, 2, 30.0)
    assert a.start_s.shape == b.start_s.shape
    assert not np.array_equal(a.start_s, b.start_s)
    gaps = np.diff(a.start_s)
    assert abs(gaps.mean() * 110.0 - 1.0) < 0.05          # the mean rate
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1      # exponential gaps


def test_closed_draws_repeat():
    from harness import traffic
    a, b = traffic.plan(CLOSED, BIG, 30.0), traffic.plan(CLOSED, BIG, 30.0)
    assert a.start_s.tolist() == [0.0] and a.count.tolist() == [256]
    assert a.closed_stop_s == (30.0,) and a.pool_index.size == 0
    seq = [a.closed_draws[0].next() for _ in range(1000)]
    assert seq == [b.closed_draws[0].next() for _ in range(1000)]
    assert min(seq) >= 0 and max(seq) < 256
    c = traffic.plan(CLOSED, BIG + 1, 30.0)
    assert seq != [c.closed_draws[0].next() for _ in range(1000)]


def test_sources_mix_in_time_order():
    """A burst source in the window's second half over a closed trickle:
    one plan, events in time order, each source's count and span kept."""
    from harness import traffic
    mix = dict(BASE, sources=[{"kind": "closed", "clients": 4, "during": [0.0, 0.5]},
                              {"kind": "open", "rate_rps": 64, "burst": 8,
                               "during": [0.5, 1.0]}])
    p = traffic.plan(mix, BIG, 10.0)
    assert np.all(np.diff(p.start_s) >= 0)
    assert p.source[0] == 0 and p.count[0] == 4 and p.closed_stop_s == (5.0, None)
    opened = p.source == 1
    assert opened.sum() == 40 and np.all(p.count[opened] == 8)      # 64 / s x 5 s / 8
    assert np.all(p.start_s[opened] >= 5.0) and p.pool_index.size == 320
    assert p.closed_draws[1] is None and p.closed_draws[0] is not None


@pytest.mark.parametrize("bad", [
    {"sources": [{"kind": "both"}]},
    {"sources": []},
    {"sources": [{"kind": "open", "rate_rps": 0}]},
    {"sources": [{"kind": "open", "rate_rps": 5, "burst": 0}]},
    {"sources": [{"kind": "closed", "clients": 0}]},
    {"sources": [{"kind": "closed", "clients": 4, "during": [0.5, 0.5]}]},
    {"server": {"max_batch": 64, "deadline_s": 0}, "sources": OPEN["sources"]},
])
def test_bad_mix_is_refused(bad):
    from harness import traffic
    with pytest.raises((ValueError, KeyError)):
        traffic.check_mix(dict(BASE, **bad))


def test_pool_and_rows_repeat():
    from harness import inputs
    a = inputs.request_pool(BIG, 4, 1000, "cpu")
    b = inputs.request_pool(BIG, 4, 1000, "cpu")
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (4, 1000)
    assert not np.array_equal(a, inputs.request_pool(BIG + 1, 4, 1000, "cpu"))
    r = inputs.sampled_rows(BIG, 5000, 512)
    np.testing.assert_array_equal(r, inputs.sampled_rows(BIG, 5000, 512))
    assert np.unique(r).size == 512 and np.all(np.diff(r) > 0) and r[-1] < 5000


def test_halton_points():
    from harness import inputs
    p = inputs.halton(8, 3, "cpu").numpy()
    np.testing.assert_allclose(p[:3, 0], [0.5, 0.25, 0.75])
    np.testing.assert_allclose(p[:3, 1], [1 / 3, 2 / 3, 1 / 9], rtol=1e-6)
    np.testing.assert_allclose(p[:2, 2], [0.2, 0.4], rtol=1e-6)
    q = inputs.halton(1 << 16, 2, "cpu")
    assert float(q.min()) > 0.0 and float(q.max()) < 1.0


def test_window_rate_counts_every_answer_and_latency_the_wait():
    from harness.drive import Window
    due = np.array([0.0, 0.5, 1.0, 1.5])
    done = np.array([2.0, 2.0, 4.0, np.nan])      # two 2-wide panels; one never answered
    win = Window(t0=0.0, due=due, done=done, pool_index=np.zeros(4, np.int64),
                 samples=np.zeros((4, 1), np.float32), late_s=np.zeros(4), give_up=61.6,
                 accepted=4)
    # every answer, also the one after the window's close, over the time to the last
    assert win.rps() == pytest.approx(3 / 4.0)
    np.testing.assert_allclose(win.latency_s(), [2.0, 1.5, 3.0, 60.1])


class PanelsOfFour:
    """A server stand-in: panels of four, no deadline, so a partial panel
    waits for ``flush``; each answer is twice the request."""

    def __init__(self):
        import threading
        self.lock, self.pending, self.flushes = threading.Lock(), [], 0

    def submit(self, vec):
        from concurrent.futures import Future
        fut = Future()
        with self.lock:
            self.pending.append((vec, fut))
            if len(self.pending) >= 4:
                self._launch()
        return fut

    def flush(self):
        with self.lock:
            self.flushes += 1
            self._launch()

    def _launch(self):
        chunk, self.pending = self.pending, []
        for vec, fut in chunk:
            fut.set_result(2.0 * vec)


def test_drive_answers_every_request_and_flushes_at_the_close():
    """Six closed callers (never a multiple of four at the close) beside an
    open source: every request is answered in the order sent, each answer
    the served one, and nothing is left waiting."""
    from harness import drive, traffic, trace
    mix = dict(BASE, sources=[{"kind": "closed", "clients": 6},
                              {"kind": "open", "rate_rps": 40, "burst": 2}])
    pool = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    rows = np.array([1, 3])
    srv = PanelsOfFour()
    p = traffic.plan(dict(mix, pool=8), BIG, 0.5)
    win = drive.run(srv, p, pool, rows, 0.5, trace.Spans())
    assert win.answered().all() and win.accepted == win.due.shape[0] > 6 + 20
    np.testing.assert_array_equal(win.samples, 2.0 * pool[win.pool_index][:, rows])
    assert srv.flushes >= 1 and srv.pending == []
    assert np.all(win.done >= win.due)
    assert np.sum(win.late_s > 0) > 0                   # the open requests, timed when due
