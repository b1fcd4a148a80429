"""The trace reduction: the host mark maps the clocks, device activity is
clipped to the window, idle gaps are named by the host spans open then."""
from __future__ import annotations

import pytest


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce_trace_by_hand():
    from harness import trace
    # host clock (ns) = trace clock (us) * 1e3 - 5e9: the mark sits at 1000 us
    events = [ev(trace.MARK, "user_annotation", 1000.0, 1.0),
              ev("void (anonymous namespace)::dense_matmat_kernel<2, 0, 8>(float const*, int)",
                 "kernel", 1100.0, 300.0),
              ev("lowrank_vtx_kernel<4>(float const*)", "kernel", 1350.0, 100.0),
              ev("Memset (Device)", "gpu_memset", 1500.0, 50.0),
              ev("Memcpy DtoH", "gpu_memcpy", 1900.0, 300.0),    # runs past the window
              ev("elsewhere", "cpu_op", 1200.0, 500.0),
              ev("before", "kernel", 800.0, 50.0)]               # before the window
    mark_ns = 1000 * 1000 - 5_000_000
    start_ns, end_ns = mark_ns + 50_000, mark_ns + 1_050_000     # 1050 .. 2050 us
    spans = [("hbench.sleep", 1, start_ns, mark_ns + 1_000_000),
             ("hbench.result", 2, mark_ns + 600_000, end_ns)]
    out = trace.reduce_trace({"traceEvents": events}, mark_ns, start_ns, end_ns, spans)
    assert out["window_s"] == pytest.approx(1000e-6)
    # busy: 1100..1450 (overlapping kernels), 1500..1550, 1900..2050
    assert out["busy_s"] == pytest.approx((350 + 50 + 150) * 1e-6)
    assert [k for k, _ in out["kernels"]] == ["dense_matmat_kernel<2, 0, 8>",
                                              "lowrank_vtx_kernel<4>"]
    assert out["device_ops"][0] == ["dense_matmat_kernel<2, 0, 8>", pytest.approx(300e-6)]
    # gaps 1550..1900 (both spans open), 1050..1100 and 1450..1500 (sleep only)
    assert [(n, round(s * 1e6)) for n, s in out["idle_gaps"]] == [
        ("hbench.result+hbench.sleep", 350), ("hbench.sleep", 50), ("hbench.sleep", 50)]


def test_reduce_trace_needs_the_mark():
    from harness import trace
    with pytest.raises(ValueError):
        trace.reduce_trace({"traceEvents": []}, 0, 0, 1, [])


def test_spans_record_threads():
    import threading
    from harness import trace
    spans = trace.Spans()

    def other():
        with spans.span("b"):
            pass

    with spans.span("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    (b, tb, b0, b1), (a, ta, a0, a1) = spans.items
    assert (a, b) == ("a", "b") and ta != tb
    assert a0 <= b0 <= b1 <= a1
