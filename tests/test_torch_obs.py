"""The port's tracer (``repro_torch.obs``): off, a span site records and
makes nothing; on, the serving runtime's and the apply's spans nest and
carry their panel and request ids.  The readings of ``scripts/trace_cell.py``
on hand-made records, and its wrapped window on a small cell on the CPU.
The card test holds the device spans of a panel to its ``device.panel``.
"""
import importlib.util
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import build_hmatrix, halton, make_apply
from repro_torch.serve.runtime import PanelRuntime
from torch_parity_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N = 2048
STAGES = ("runtime.upload", "apply.permute_in", "apply.lowrank", "apply.dense", "apply.scatter",
          "apply.permute_out", "runtime.transpose")
APPLY = STAGES[1:6]


def _script():
    spec = importlib.util.spec_from_file_location("trace_cell", ROOT / "scripts/trace_cell.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    obs.collect()
    yield
    obs.disable()
    obs.collect()


@pytest.fixture(scope="module")
def hm():
    return build_hmatrix(halton(N, 2, device="cpu"), "gaussian", k=8, c_leaf=128,
                         precompute=True, device="cpu")


def _requests(count, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(N).astype(np.float32) for _ in range(count)]


def _serve(hm, count, max_batch=8, deadline_s=None, device="cpu"):
    """``count`` requests through a runtime over ``hm``'s apply; returns the
    futures (answered) and the runtime's panel count."""
    with PanelRuntime(N, max_batch, make_apply(hm), deadline_s=deadline_s,
                      device=device) as rt:
        futs = [rt.submit(q) for q in _requests(count)]
        if deadline_s is None:
            rt.flush()
        for f in futs:
            f.result(timeout=120)
        rt.drain()
        return futs, rt.stats()["panels_launched"]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.mark.parametrize("on", [False, True])
def test_completions_and_clock_reads_only_while_on(hm, monkeypatch, on):
    made, reads = [], []
    init = obs.Completion.__init__
    monkeypatch.setattr(obs.Completion, "__init__",
                        lambda self, stream: (made.append(1), init(self, stream))[1])
    clock = obs._clock
    monkeypatch.setattr(obs, "_clock", lambda: (reads.append(1), clock())[1])
    if on:
        obs.enable()
    else:
        assert obs.span("x") is obs.NULL and obs.device_span("x", torch.device("cpu")) is obs.NULL
        assert obs.new_id() is None and obs.queued(0) is None
    _, panels = _serve(hm, 12)
    served_reads = len(reads)
    out = obs.collect()
    # the lane's own completion, one a panel; traced, one more a stage
    assert len(made) == panels * (1 + len(STAGES) if on else 1)
    assert bool(served_reads) == on and bool(out["spans"]) == on and out["dropped"] == 0


def test_panels_nest_and_requests_name_their_panel(hm):
    obs.enable()
    futs, panels = _serve(hm, 20)
    spans = obs.collect()["spans"]
    launched = _named(spans, "runtime.panel")
    assert len(launched) == panels == 3
    assert sorted((s["requests"], s["width"]) for s in launched) == [(4, 4), (8, 8), (8, 8)]
    for p in launched:
        children = [s for s in spans if s["parent"] == p["id"]]
        assert [s["name"] for s in children] == ["runtime.pack", "runtime.dispatch"]
        assert all(s["panel"] == p["panel"] for s in children)
    queued = sorted(_named(spans, "runtime.queued"), key=lambda s: s["request"])
    assert [s["request"] for s in queued] == list(range(20))
    assert [s["panel"] for s in queued] == [f._record._panel for f in futs]
    fetched = _named(spans, "runtime.fetch")
    assert sorted(s["panel"] for s in fetched) == sorted(p["panel"] for p in launched)


def test_a_deadline_panel_waits_its_deadline(hm):
    obs.enable()
    _serve(hm, 3, deadline_s=0.2)
    queued = sorted(_named(obs.collect()["spans"], "runtime.queued"), key=lambda s: s["request"])
    assert len(queued) == 3 and len({s["panel"] for s in queued}) == 1
    assert queued[0]["t1_ns"] - queued[0]["t0_ns"] >= 0.2e9


def test_scheduler_spans_tile_its_loop(hm):
    obs.enable()
    _serve(hm, 30, deadline_s=0.05)
    spans = obs.collect()["spans"]
    thread = _named(spans, "runtime.panel")[0]["thread"]
    loop = sorted((s for s in spans if s["thread"] == thread and s["parent"] is None),
                  key=lambda s: s["t0_ns"])
    assert {s["name"] for s in loop} == {"runtime.slot_wait", "runtime.idle", "runtime.panel"}
    gaps = [b["t0_ns"] - a["t1_ns"] for a, b in zip(loop, loop[1:])]
    assert min(gaps) >= 0
    assert max(gaps) < 20e6, "a stretch of the scheduler's loop is in no span"
    assert sum(gaps) < 0.05 * (loop[-1]["t1_ns"] - loop[0]["t0_ns"])


@pytest.mark.parametrize("route", ["served", "direct"])
def test_apply_stages_once_each_in_order_under_the_launch(hm, route):
    obs.enable()
    if route == "served":
        _serve(hm, 8)
        spans = obs.collect()["spans"]
        parent = _named(spans, "runtime.dispatch")[0]["id"]
        names = STAGES
    else:
        x = torch.from_numpy(np.stack(_requests(3), 1))
        with obs.span("launch") as launch:
            make_apply(hm)(x)
        spans = obs.collect()["spans"]
        parent = launch.id
        names = APPLY
    stages = sorted((s for s in spans if s["kind"] == "device" and s["name"] != "device.panel"),
                    key=lambda s: s["t0_ns"])
    assert tuple(s["name"] for s in stages) == names
    assert all(s["parent"] == parent and s["device_ms"] >= 0 for s in stages)


@pytest.mark.parametrize("on", [False, True])
def test_the_upload_is_freed_once_the_launch_has_its_own_layout(on):
    """The upload is the launch's argument only, so that the apply can free it
    (at N = 2^20 a 64-wide panel is 256 MiB of the card's peak)."""
    freed = []

    def launch(panel):
        upload = weakref.ref(panel)
        panel = panel.contiguous() * 2.0
        freed.append(upload() is None)
        return panel

    if on:
        obs.enable()
    with PanelRuntime(16, 4, launch, device="cpu") as rt:
        futs = [rt.submit(np.ones(16, np.float32)) for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
    assert freed == [True]


def test_a_full_buffer_counts_its_drops():
    obs.enable(capacity=3)
    for _ in range(5):
        with obs.span("x"):
            pass
    out = obs.collect()
    assert len(out["spans"]) == 3 and out["dropped"] == 2
    assert obs.collect() == {"spans": [], "dropped": 0}


def test_collect_reports_the_spans_still_open():
    with obs.span("before"):             # off: never a span
        obs.enable()
        with obs.span("outer") as outer:
            with obs.span("inner"):
                pass
            out = obs.collect()
        later = obs.collect()
    opened = [s for s in out["spans"] if s.get("open")]
    assert [s["name"] for s in opened] == ["outer"] and opened[0]["id"] == outer.id
    assert opened[0]["t1_ns"] >= opened[0]["t0_ns"]
    assert [(s["name"], s.get("open")) for s in later["spans"]] == [("outer", None)]


def test_two_submitting_threads_keep_their_spans_apart(hm):
    per_thread = 12
    obs.enable()
    with PanelRuntime(N, 8, make_apply(hm), device="cpu") as rt:
        idents, futs = {}, []

        def client(k):
            idents[k] = threading.get_ident()
            with obs.span(f"client.{k}"):
                with obs.span("submits"):
                    for q in _requests(per_thread, seed=k):
                        futs.append(rt.submit(q))
                        time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        rt.flush()
        for f in futs:
            f.result(timeout=120)
    spans = obs.collect()["spans"]
    for k in range(2):
        mine = [s for s in spans if s["thread"] == idents[k]]
        client_span = _named(mine, f"client.{k}")[0]
        assert _named(mine, "submits")[0]["parent"] == client_span["id"]
        assert len(_named(mine, "runtime.queued")) == per_thread
        assert not [s for s in mine if s["name"].startswith("runtime.")
                    and s["name"] != "runtime.queued"]
    assert len({s["request"] for s in _named(spans, "runtime.queued")}) == 2 * per_thread


# ---------------------------------------------------------------------------
# scripts/trace_cell.py: the readings and the wrapped window
# ---------------------------------------------------------------------------


def _host(name, t0_ms, t1_ms, **kw):
    return dict(name=name, kind="host", thread=1, t0_ns=int(t0_ms * 1e6), t1_ns=int(t1_ms * 1e6),
                panel=kw.pop("panel", None), **kw)


def _device(name, panel, ms):
    return dict(name=name, kind="device", thread=1, t0_ns=0, t1_ns=0, panel=panel,
                device_ms=ms)


def _program(dropped=0):
    spans = [_host("runtime.queued", 0, 10 * j + 10, panel=1 + j // 10, request=j)
             for j in range(20)]
    spans += [_host("runtime.slot_wait", 100, 400), _host("runtime.slot_wait", 600, 700),
              _host("runtime.slot_wait", 900, 1100), _host("runtime.idle", 400, 600)]
    for panel, scale in ((1, 1.0), (2, 3.0)):
        spans += [_device(name, panel, scale * (j + 1)) for j, name in enumerate(STAGES)]
        spans.append(_device("device.panel", panel, scale * 28.0 * (1.01 if panel == 2 else 1)))
    return {"spans": spans, "dropped": dropped, "t0_ns": 0, "t1_ns": int(1000e6)}


@pytest.mark.parametrize("reading,expected", [
    ("queue_wait_ms", float(np.percentile([10.0 * j + 10 for j in range(20)], 95))),
    ("slot_wait_share", 50.0),                  # 300 + 100 + 100 of 1000 ms, clipped
    ("scatter_ms", 10.0),                       # (5 + 15) / 2 panels
    ("stage_gap", 100.0 * (1 - 1 / 1.01)),      # panel 2: 84 of 84.84 ms
])
def test_readings_on_hand_made_records(reading, expected):
    read = getattr(_script(), reading)
    assert read({"program": _program()}) == pytest.approx(expected)
    assert read({}) is None
    assert read({"program": _program(dropped=1)}) is None


def test_the_program_s_spans_name_an_idle_gap(monkeypatch):
    script = _script()
    monkeypatch.syspath_prepend(str(ROOT / "hbench"))
    from harness import trace
    mark_ns = 1_000_000 - 5_000_000          # the mark at 1000 us of the trace
    events = [{"ph": "X", "name": trace.MARK, "cat": "user_annotation", "ts": 1000.0, "dur": 1.0},
              {"ph": "X", "name": "k", "cat": "kernel", "ts": 1100.0, "dur": 400.0},
              {"ph": "X", "name": "k", "cat": "kernel", "ts": 1700.0, "dur": 350.0}]
    # the gap 1500..1700 us: its middle, 1600, is on the host clock mark_ns + 600 us
    program = {"spans": [_host("runtime.slot_wait", 0, 0) | dict(t0_ns=mark_ns + 550_000,
                                                                  t1_ns=mark_ns + 650_000),
                         _host("runtime.idle", 0, 0) | dict(t0_ns=mark_ns + 650_000,
                                                             t1_ns=mark_ns + 700_000)],
               "dropped": 0}
    out = trace.reduce_trace({"traceEvents": events}, mark_ns, mark_ns + 100_000,
                             mark_ns + 1_050_000, script.host_spans(program))
    assert out["idle_gaps"][0] == ["runtime.slot_wait", pytest.approx(200e-6)]


@pytest.mark.parametrize("traced", [False, True])
def test_the_wrapped_window_records_a_small_cell(monkeypatch, traced):
    script = _script()
    monkeypatch.syspath_prepend(str(ROOT / "hbench"))
    monkeypatch.syspath_prepend(str(ROOT / "hbench" / "tests"))
    from harness import bench, drive
    from harness import trace as tracing
    from hb_util import small_cell
    kept = script.install(bench, drive, tracing, obs, patch=monkeypatch.setattr)
    res = bench.run_cell(small_cell("gauss2d.steady", n=N), 2 ** 31 + 7, 1.0, traced,
                         device="cpu")
    assert res["correct"], res["checks"]
    program = res["run"]["program"]
    assert program is kept["program"] and program["dropped"] == 0
    assert obs.span("after") is obs.NULL
    assert len(_named(program["spans"], "runtime.queued")) == res["run"]["stats"]["requests"]
    assert len(_named(program["spans"], "runtime.panel")) == res["run"]["stats"]["panels"]
    readings = script.readings(res["run"])
    assert readings["queue_wait_ms"] > 0 and 0 <= readings["slot_wait_share"] <= 100
    assert readings["scatter_ms"] > 0
    if traced:      # on the CPU the whole window is one gap; a scheduler span is open mid-way
        name = res["run"]["trace"]["idle_gaps"][0][0]
        assert any(n.startswith("runtime.") for n in name.split("+")), name


@pytest.mark.cuda
def test_device_spans_sum_to_the_panel_on_card():
    """The seven stage spans cover a panel's device time.  The panels are
    queued behind a sleep on the lane's stream, so that the card never
    waits for the host between two stages (a gap that would be in no
    stage, and is the host's, not a stage's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc on first use)")
    dev = torch.device("cuda")
    n, width, panels = 1 << 16, 32, 4
    hm_card = build_hmatrix(halton(n, 2, device=dev), "gaussian", k=16, c_leaf=512,
                            precompute=True, device=dev)
    rng = np.random.RandomState(0)
    with PanelRuntime(n, width, make_apply(hm_card), max_inflight=panels, device=dev) as rt:
        rt.precompile()
        obs.enable()
        with torch.cuda.stream(rt._lane.stream):
            torch.cuda._sleep(1 << 30)
        futs = [rt.submit(rng.rand(n).astype(np.float32)) for _ in range(panels * width)]
        for f in futs:
            f.result(timeout=300)
        rt.drain()
        out = obs.collect()
    spans = out["spans"]
    launched = _named(spans, "device.panel")
    assert len(launched) == panels and out["dropped"] == 0
    for p in launched:
        stages = [s for s in spans if s["panel"] == p["panel"] and s["name"] in STAGES]
        assert sorted(s["name"] for s in stages) == sorted(STAGES)
        total = sum(s["device_ms"] for s in stages)
        assert total == pytest.approx(p["device_ms"], rel=0.02)
