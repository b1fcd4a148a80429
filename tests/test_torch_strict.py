"""``REPRO_STRICT_TRANSFERS=1`` on the port: the twin of ``repro``'s guard
(``tests/test_strict_transfers.py``), on the CPU.

PyTorch's sync-debug mode needs a card (``set_sync_debug_mode`` asserts
without one), so here the CPU path must never touch it, a served burst must
stay bit-identical under the variable, the launch must run inside the
window, and the window's process-wide bookkeeping (nested windows across
threads, the documented PCG read, restoring on errors) is checked against a
stand-in for the mode.  ``chip_smoke.py`` phase d holds the mode itself on
the card.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import _device
from repro_torch.core import build_hmatrix, halton
from repro_torch.serve import runtime as rt_mod
from repro_torch.serve.runtime import PanelRuntime, strict_transfers
from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer
from repro_torch.serve.tenancy import MultiTenantRuntime, TenantSpec
from repro_torch.solve.cg import any_active
from torch_parity_util import one_torch_thread  # noqa: F401


@pytest.fixture
def no_cuda_mode(monkeypatch):
    """Fail the test if anything reads or sets the CUDA sync-debug mode."""
    def forbidden(*_):
        raise AssertionError("the CUDA sync-debug mode was touched on the CPU path")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", forbidden)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", forbidden)


@pytest.fixture
def fake_mode(monkeypatch):
    """A stand-in for the process-wide mode: records every setting."""
    state = {"mode": 1, "sets": []}
    names = {"default": 0, "warn": 1, "error": 2}

    def set_mode(mode):
        state["mode"] = names.get(mode, mode)
        state["sets"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    return state


@pytest.fixture(scope="module")
def hm():
    return build_hmatrix(halton(600, 2), "gaussian", k=8, c_leaf=64, precompute=True,
                         device="cpu")


def _requests(n, count, seed=0):
    return list(np.random.RandomState(seed).randn(count, n).astype(np.float32))


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_guard_is_a_no_op_on_the_cpu(monkeypatch, no_cuda_mode, value):
    if value is None:
        monkeypatch.delenv("REPRO_STRICT_TRANSFERS", raising=False)
    else:
        monkeypatch.setenv("REPRO_STRICT_TRANSFERS", value)
    with strict_transfers(torch.device("cpu")):
        assert float(torch.ones(3).sum()) == 3.0


def test_served_burst_is_bit_identical_under_the_variable(monkeypatch, hm, no_cuda_mode):
    qs = _requests(hm.shape[0], 20)
    monkeypatch.delenv("REPRO_STRICT_TRANSFERS", raising=False)
    with HMatrixServer(hm, max_batch=8) as srv:
        plain = [f.result(timeout=60) for f in srv.serve_async(qs)]
        plain_sync = srv.serve(qs)
    monkeypatch.setenv("REPRO_STRICT_TRANSFERS", "1")
    with HMatrixServer(hm, max_batch=8) as srv:
        strict = [f.result(timeout=60) for f in srv.serve_async(qs)]
        strict_sync = srv.serve(qs)
    for a, b, c, d in zip(plain, strict, plain_sync, strict_sync):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
        np.testing.assert_array_equal(a, c)


def test_solve_burst_is_bit_identical_under_the_variable(monkeypatch, hm, no_cuda_mode):
    fs = _requests(hm.shape[0], 6, seed=1)
    monkeypatch.delenv("REPRO_STRICT_TRANSFERS", raising=False)
    with HMatrixSolveServer(hm, 0.5, max_batch=4, tol=1e-5) as srv:
        plain = [f.result(timeout=60) for f in srv.serve_async(fs)]
    monkeypatch.setenv("REPRO_STRICT_TRANSFERS", "1")
    with HMatrixSolveServer(hm, 0.5, max_batch=4, tol=1e-5) as srv:
        strict = [f.result(timeout=60) for f in srv.serve_async(fs)]
    for a, b in zip(plain, strict):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("value,inside", [(None, False), ("1", True)])
def test_launch_runs_inside_the_window(monkeypatch, value, inside):
    seen = []
    state = threading.local()

    class Window:
        def __init__(self, device):
            seen.append(torch.device(device))

        def __enter__(self):
            state.inside = True

        def __exit__(self, *exc):
            state.inside = False

    if value is None:
        monkeypatch.delenv("REPRO_STRICT_TRANSFERS", raising=False)
    else:
        monkeypatch.setenv("REPRO_STRICT_TRANSFERS", value)
    monkeypatch.setattr(rt_mod, "sync_debug_window", Window)
    flags = []

    def launch(panel):
        flags.append(getattr(state, "inside", False))
        return panel * 2.0

    with PanelRuntime(16, 4, launch, device="cpu") as rt:
        fut = rt.submit(np.ones(16, np.float32))
        rt.flush()
        np.testing.assert_array_equal(fut.result(timeout=60), np.full(16, 2.0))
    assert flags == [inside]
    assert seen == ([torch.device("cpu")] if inside else [])


def test_a_failing_launch_fails_its_futures_and_the_lane_serves_on(monkeypatch, no_cuda_mode):
    monkeypatch.setenv("REPRO_STRICT_TRANSFERS", "1")
    calls = []

    def launch(panel):
        calls.append(panel.shape[1])
        if len(calls) == 1:
            raise RuntimeError("injected synchronizing operation")
        return panel + 1.0

    with PanelRuntime(16, 4, launch, device="cpu") as rt:
        bad = [rt.submit(np.ones(16, np.float32)) for _ in range(4)]
        rt.flush()
        for f in bad:
            with pytest.raises(RuntimeError, match="injected synchronizing"):
                f.result(timeout=60)
        good = rt.submit(np.zeros(16, np.float32))
        rt.flush()
        np.testing.assert_array_equal(good.result(timeout=60), np.ones(16))
        assert rt.stats()["panel_failures"] == 1


def test_tenant_burst_is_bit_identical_and_a_bad_tenant_fails_alone(monkeypatch, hm,
                                                                   no_cuda_mode):
    qs = _requests(hm.shape[0], 12, seed=2)

    def serve(strict):
        if strict:
            monkeypatch.setenv("REPRO_STRICT_TRANSFERS", "1")
        else:
            monkeypatch.delenv("REPRO_STRICT_TRANSFERS", raising=False)
        srv = HMatrixServer(hm, max_batch=8)

        def bad(panel):
            raise RuntimeError("tenant launch failed")

        with MultiTenantRuntime() as mtr:
            good = mtr.add_tenant("apply", srv)
            worse = mtr.add_tenant("bad", TenantSpec(16, 4, bad, device="cpu"))
            futs = [good.submit(q) for q in qs]
            bf = worse.submit(np.ones(16, np.float32))
            mtr.flush()
            outs = [f.result(timeout=60) for f in futs]
            with pytest.raises(RuntimeError, match="tenant launch failed"):
                bf.result(timeout=60)
        srv.close()
        return outs

    for a, b in zip(serve(False), serve(True)):
        np.testing.assert_array_equal(a, b)


def test_window_is_process_wide_and_the_last_to_close_restores(fake_mode):
    opened, release = threading.Event(), threading.Event()

    def other():
        with _device.sync_debug_window("cuda"):
            opened.set()
            release.wait(10)

    t = threading.Thread(target=other)
    with _device.sync_debug_window("cuda"):
        assert fake_mode["mode"] == 2
        t.start()
        assert opened.wait(10)
    # this thread's window closed first: the other still holds the mode
    assert fake_mode["mode"] == 2
    release.set()
    t.join(10)
    assert fake_mode["mode"] == 1 and fake_mode["sets"][-1] == 1


def test_window_restores_the_mode_when_its_body_raises(fake_mode):
    with pytest.raises(ValueError):
        with _device.sync_debug_window("cuda"):
            raise ValueError("launch failed")
    assert fake_mode["mode"] == 1 and _device._WINDOWS["open"] == 0


def test_documented_sync_lifts_the_mode_only_inside_a_window(fake_mode):
    with _device.documented_sync():
        pass
    assert fake_mode["sets"] == []
    with _device.sync_debug_window("cuda"):
        with _device.documented_sync():
            assert fake_mode["mode"] == 1
            assert any_active(torch.tensor([False, True]))
        assert fake_mode["mode"] == 2
    assert fake_mode["mode"] == 1 and fake_mode["sets"] == [2, 1, 2, 1]


def test_cpu_window_and_host_fetch_touch_nothing(no_cuda_mode):
    with _device.sync_debug_window("cpu"):
        t = torch.arange(6.0).reshape(2, 3)
        assert _device.to_host(t) is t
        np.testing.assert_array_equal(rt_mod.rows_to_host(t), t.numpy())
        assert not any_active(torch.zeros(3, dtype=torch.bool))
