"""The launch pacer contains what goes wrong while it retires a launch.

``repro``'s ``LaunchPacer.wait_for_slot`` (``repro/serve/runtime.py``)
catches any exception from the device wait and from the ``on_retire``
callback: an exception there would end the scheduler thread, strand its
pending requests and leave ``close()`` waiting forever.  The port's pacer
does the same, for the device wait, the launch's run time and the callback;
both schedulers keep serving and close within the time the test sets.
"""
import threading

import numpy as np
import pytest

from repro_torch.serve.runtime import LaunchPacer, PanelRuntime
from repro_torch.serve.tenancy import MultiTenantRuntime, TenantSpec

N = 8
CLOSE_TIMEOUT_S = 30.0


def _double(panel):
    return panel * 2.0


def _boom(*_):
    raise ValueError("accounting failed")


class _Done:
    """A launch's completion whose wait or run time may raise."""

    def __init__(self, sync_exc=None, seconds_exc=None):
        self.sync_exc, self.seconds_exc = sync_exc, seconds_exc
        self.synced = False

    def synchronize(self):
        self.synced = True
        if self.sync_exc is not None:
            raise self.sync_exc

    def seconds(self):
        if self.seconds_exc is not None:
            raise self.seconds_exc
        return 0.25


def _close_within(runtime, timeout=CLOSE_TIMEOUT_S):
    closer = threading.Thread(target=runtime.close, daemon=True)
    closer.start()
    closer.join(timeout)
    assert not closer.is_alive(), "close() did not return"


def test_pacer_contains_device_and_accounting_errors():
    pacer = LaunchPacer(max_inflight=1)
    seen = []
    launches = [(_Done(sync_exc=ValueError("device fault")), lambda s, ok: seen.append(ok)),
                (_Done(seconds_exc=KeyError("no timing")), lambda s, ok: seen.append(ok)),
                (_Done(), _boom),
                (_Done(), lambda s, ok: seen.append((s, ok)))]
    for done, on_retire in launches:
        pacer.wait_for_slot()
        pacer.commit(done, on_retire)
    pacer.wait_for_slot()
    assert all(done.synced for done, _ in launches) and len(pacer) == 0
    # a failed wait reports ok=False; a raising run time loses only its record
    assert seen == [False, (0.25, True)]


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_panel_runtime_survives_a_raising_on_retire(max_inflight):
    rt = PanelRuntime(N, 2, _double, max_inflight=max_inflight, device="cpu")
    commit = rt._pacer.commit
    rt._pacer.commit = lambda done, on_retire=None: commit(done, _boom)
    rng = np.random.RandomState(0)
    qs = [rng.randn(N).astype(np.float32) for _ in range(9)]
    futures = [rt.submit(q) for q in qs]
    rt.flush()
    for q, fut in zip(qs, futures):
        np.testing.assert_array_equal(fut.result(timeout=CLOSE_TIMEOUT_S), q * 2.0)
    later = rt.submit(qs[0])                        # the scheduler still serves
    rt.flush()
    np.testing.assert_array_equal(later.result(timeout=CLOSE_TIMEOUT_S), qs[0] * 2.0)
    _close_within(rt)
    assert rt.stats()["panels_launched"] == 6


def test_multi_tenant_runtime_survives_a_raising_on_retire():
    mtr = MultiTenantRuntime(max_inflight=1)
    mtr._monitor.record = _boom                     # the tenants' on_retire raises
    a = mtr.add_tenant("a", TenantSpec(N, 2, _double, device="cpu"))
    b = mtr.add_tenant("b", TenantSpec(N, 4, lambda p: p + 1.0, device="cpu"))
    rng = np.random.RandomState(1)
    qs = [rng.randn(N).astype(np.float32) for _ in range(10)]
    fa = [a.submit(q) for q in qs]
    fb = [b.submit(q) for q in qs]
    mtr.flush()
    for q, f_a, f_b in zip(qs, fa, fb):
        np.testing.assert_array_equal(f_a.result(timeout=CLOSE_TIMEOUT_S), q * 2.0)
        np.testing.assert_array_equal(f_b.result(timeout=CLOSE_TIMEOUT_S), q + 1.0)
    _close_within(mtr)
    assert mtr.stats()["panels_launched"] == 5 + 3
