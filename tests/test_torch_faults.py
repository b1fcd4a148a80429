"""Port parity and behaviour: fault injection and containment
(``repro_torch.serve.faults``, the chaos envelope of the device build).

Parity with ``repro.serve.faults`` on the same inputs: ``ChaosSpec.parse``
gives the same fields and rejects the same specs with the same message;
``FaultInjector`` gives the same fault-kind sequence for the same seed and
lane name; ``RetryPolicy.delay_s``, ``CircuitBreaker`` and
``LaneResilience`` go through the same values and verdicts.  Then the
reference's ``tests/test_faults.py`` and the build-chaos cases of
``tests/test_build_onboarding.py``, case for case, on the CPU (launches are
torch callables on ``device="cpu"``).  Every runtime pins ``chaos=`` (a spec
or ``""``), so the assertions hold under a global ``REPRO_CHAOS``.
"""
import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

import repro.serve.faults as jf
import repro_torch.serve.faults as tf
from repro_torch.core import build_hmatrix_device_report, halton
from repro_torch.serve.faults import (BreakerPolicy, ChaosSpec, CircuitBreaker,
                                      CircuitOpenError, FaultInjector, InjectedFault,
                                      LaneResilience, NaNGuard, NaNPanelError, OverloadedError,
                                      ResiliencePolicy, RetryPolicy, StragglerMonitor,
                                      TransientInjectedFault, chaos_from_env, resolve_chaos,
                                      run_with_restarts)
from repro_torch.serve.runtime import PanelRuntime
from repro_torch.serve.tenancy import MultiTenantRuntime, TenantSpec


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _double(panel):
    return panel * 2.0


def _triple(panel):
    return panel * 3.0


def _spec(n, max_batch, launch, **kw):
    return TenantSpec(n, max_batch, launch, device="cpu", **kw)


def _fail_fast_policy(threshold=3, cooldown_s=0.05):
    """No retries: every panel failure counts against the breaker at once."""
    return ResiliencePolicy(retry=None,
                            breaker=BreakerPolicy(threshold=threshold, cooldown_s=cooldown_s))


# ---------------------------------------------------------------------------
# parity with repro.serve.faults
# ---------------------------------------------------------------------------

GOOD_SPECS = ["error=0.1, transient=0.2:3, nan=0.05,latency=0.1:0.02, seed=7", "seed=3", "",
              "transient=0.5", "latency=0.25", "nan=1.0", " error = 0.3 ,, seed=11",
              "transient=0.25:4,nan=0.5,seed=-2"]
BAD_SPECS = ["error=1.5", "error=0.6,transient=0.6", "transient=0.1:0", "latency=0.1:-1",
             "error", "frobnicate=1", "error=abc", "transient=0.1:x", "seed=1.5", "nan=-0.1",
             "nan:1.0"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_chaos_spec_parse_matches_reference(spec):
    assert dataclasses.asdict(ChaosSpec.parse(spec)) == \
        dataclasses.asdict(jf.ChaosSpec.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_spec_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError) as ours:
        ChaosSpec.parse(spec)
    with pytest.raises(ValueError) as ref:
        jf.ChaosSpec.parse(spec)
    assert str(ours.value) == str(ref.value)


def _kinds(module, spec_text, name, launch, panel, n=200):
    """Fault kinds one injector of ``module`` gives over ``n`` attempts."""
    inj = module.FaultInjector(module.ChaosSpec.parse(spec_text), name)
    chaotic = inj.wrap(launch)
    out = []
    for _ in range(n):
        try:
            res = chaotic(panel)
        except module.TransientInjectedFault:
            out.append("T")
        except module.InjectedFault:
            out.append("E")
        else:
            out.append("N" if np.isnan(np.asarray(res)).any() else ".")
    return out, inj.counters


@pytest.mark.parametrize("name", ["panel", "tenant-a", "build:factors:7"])
@pytest.mark.parametrize("spec", ["error=0.1,transient=0.15:2,nan=0.1,latency=0.05:0,seed=11",
                                  "transient=0.3:1,nan=0.1,seed=7"])
def test_fault_injector_sequence_matches_reference(spec, name):
    ours, our_counts = _kinds(tf, spec, name, _double, torch.ones((4, 2)))
    ref, ref_counts = _kinds(jf, spec, name, lambda p: p * 2.0, np.ones((4, 2), np.float32))
    assert ours == ref
    assert our_counts == ref_counts
    assert len(set(ours)) >= 3                      # the schedule mixes kinds


def test_retry_delays_match_reference():
    for pol_kw in ({}, {"backoff_s": 0.01, "backoff_mult": 3.0, "jitter": 0.25}):
        ours, ref = RetryPolicy(**pol_kw), jf.RetryPolicy(**pol_kw)
        r1, r2 = random.Random(5), random.Random(5)
        for attempt in (1, 2, 3, 4, 5, 6, 2, 1):
            assert ours.delay_s(attempt, r1) == ref.delay_s(attempt, r2)


def _breaker_script(module):
    br = module.CircuitBreaker(module.BreakerPolicy(threshold=2, cooldown_s=0.1))
    out = [br.state, br.allow_submit(0.0), br.on_panel_failure(1.0), br.on_panel_failure(1.0),
           br.state, br.allow_submit(1.05), br.allow_submit(1.2), br.state,
           br.on_panel_failure(1.3), br.state, br.allow_submit(1.5)]
    br.on_panel_success()
    return out + [br.state, br.failures]


def _lane_script(module):
    res = module.LaneResilience(module.ResiliencePolicy(
        retry=module.RetryPolicy(max_attempts=3, backoff_s=0.01),
        breaker=module.BreakerPolicy(threshold=2, cooldown_s=1.0), seed=4), "lane")
    out = []
    for now in (1.0, 1.1, 1.2, 2.0, 2.1, 2.2, 2.3, 3.5, 3.6):
        out += [res.decide_failure(now), res.gate(now), res.breaker_state(),
                res.allow_submit(now + 0.5)]
    res.on_success()
    return out + [res.breaker_state(), res.gate(9.0)]


def test_breaker_and_lane_verdicts_match_reference():
    assert _breaker_script(tf) == _breaker_script(jf)
    ours = _lane_script(tf)
    assert ours == _lane_script(jf)
    assert {"retry", "fail", "open"} <= set(ours)


# ---------------------------------------------------------------------------
# chaos spec grammar + env twin
# ---------------------------------------------------------------------------


def test_chaos_spec_parse_full_grammar():
    spec = ChaosSpec.parse("error=0.1, transient=0.2:3, nan=0.05,latency=0.1:0.02, seed=7")
    assert spec == ChaosSpec(error_rate=0.1, transient_rate=0.2, transient_fails=3,
                             nan_rate=0.05, latency_rate=0.1, latency_s=0.02, seed=7)
    assert ChaosSpec.parse("seed=3") == ChaosSpec(seed=3)
    assert ChaosSpec.parse("") == ChaosSpec()


@pytest.mark.parametrize("bad", BAD_SPECS[:7])
def test_chaos_spec_rejects_bad_fields(bad):
    with pytest.raises(ValueError):
        ChaosSpec.parse(bad)


def test_chaos_env_twin_and_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert chaos_from_env() is None
    monkeypatch.setenv("REPRO_CHAOS", "transient=0.25,seed=9")
    assert chaos_from_env() == ChaosSpec(transient_rate=0.25, seed=9)
    assert resolve_chaos(None) == ChaosSpec(transient_rate=0.25, seed=9)
    assert resolve_chaos("") is None
    assert resolve_chaos("nan=0.5") == ChaosSpec(nan_rate=0.5)
    spec = ChaosSpec(error_rate=0.1)
    assert resolve_chaos(spec) is spec
    with pytest.raises(TypeError):
        resolve_chaos(42)


# ---------------------------------------------------------------------------
# deterministic injection schedules
# ---------------------------------------------------------------------------


def _schedule(spec, name, n=60):
    return _kinds(tf, spec, name, _double, torch.ones((4, 2)), n)


def test_injection_schedule_is_deterministic_per_seed_and_lane():
    spec = "error=0.1,transient=0.15:2,nan=0.1,seed=11"
    s1, c1 = _schedule(spec, "lane-a")
    s2, c2 = _schedule(spec, "lane-a")
    assert s1 == s2 and c1 == c2
    assert _schedule(spec, "lane-b")[0] != s1
    assert _schedule("error=0.1,transient=0.15:2,nan=0.1,seed=12", "lane-a")[0] != s1
    assert c1["error"] == s1.count("E")
    assert c1["transient"] == s1.count("T")
    assert c1["nan"] == s1.count("N")
    assert sum(c1.values()) == len(s1) - s1.count(".")


def test_poison_is_a_device_op_on_the_result():
    inj = FaultInjector(ChaosSpec(nan_rate=1.0), "lane")
    panel = torch.ones((3, 2), dtype=torch.float32)
    out = inj.wrap(_double)(panel)
    assert out.device == panel.device and out.dtype == panel.dtype
    assert torch.isnan(out).all() and inj.counters["nan"] == 1


def test_transient_fault_fails_k_consecutive_attempts_then_recovers():
    inj = FaultInjector(ChaosSpec(transient_rate=1.0, transient_fails=3), "lane")
    chaotic = inj.wrap(_double)
    for _ in range(3):
        with pytest.raises(TransientInjectedFault):
            chaotic(torch.ones((2, 1)))
    assert inj._pending_fails == 0


def test_injected_latency_delays_launch():
    inj = FaultInjector(ChaosSpec(latency_rate=1.0, latency_s=0.05), "lane")
    t0 = time.monotonic()
    out = inj.wrap(_double)(torch.ones((2, 1)))
    assert time.monotonic() - t0 >= 0.05
    assert inj.counters["latency"] == 1
    np.testing.assert_array_equal(out.numpy(), np.full((2, 1), 2.0))


# ---------------------------------------------------------------------------
# retry/backoff: recovery and exhaustion
# ---------------------------------------------------------------------------


def test_transient_fault_recovers_via_retry_with_correct_results():
    """seed=0 / lane "panel" at rate 0.5: the reference's schedule, so panel 1
    fails twice then recovers and panel 2 fails once."""
    rt = PanelRuntime(8, 2, _double, chaos="transient=0.5:1,seed=0",
                      resilience=ResiliencePolicy(
                          retry=RetryPolicy(max_attempts=3, backoff_s=0.001), breaker=None),
                      device="cpu")
    with rt:
        futs = [rt.submit(np.full(8, j, np.float32)) for j in range(4)]
        rt.flush()
        outs = [f.result(timeout=60) for f in futs]
    for j, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full(8, 2.0 * j, np.float32))
    assert rt.stats["retries"] >= 2
    assert rt.stats["panel_failures"] == 0
    assert rt.stats["faults_injected"]["transient"] >= 2
    assert "retry" in [k for _, k, _ in rt.stats["events"]]


def test_retry_exhaustion_propagates_the_launch_error():
    calls = []

    def broken(panel):
        calls.append(1)
        raise RuntimeError("device on fire")

    rt = PanelRuntime(8, 2, broken, chaos="",
                      resilience=ResiliencePolicy(
                          retry=RetryPolicy(max_attempts=3, backoff_s=0.001), breaker=None),
                      device="cpu")
    f = rt.submit(np.zeros(8, np.float32))
    rt.flush()
    with pytest.raises(RuntimeError, match="device on fire"):
        f.result(timeout=60)
    rt.close()
    assert len(calls) == 3
    assert rt.stats["retries"] == 2
    assert rt.stats["panel_failures"] == 1


def test_backoff_delay_grows_exponentially_with_jitter_bound():
    pol = RetryPolicy(max_attempts=5, backoff_s=0.01, backoff_mult=2.0, jitter=0.5)
    rng = random.Random(0)
    for attempt in (1, 2, 3):
        base = 0.01 * 2.0 ** (attempt - 1)
        for _ in range(20):
            assert base <= pol.delay_s(attempt, rng) <= base * 1.5


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(BreakerPolicy(threshold=2, cooldown_s=0.1))
    assert br.state == "closed" and br.allow_submit(0.0)
    assert br.on_panel_failure(1.0) is False
    assert br.on_panel_failure(1.0) is True
    assert br.state == "open" and not br.allow_submit(1.05)
    assert br.allow_submit(1.2)
    assert br.state == "half_open"
    assert br.on_panel_failure(1.3) is True
    assert br.state == "open"
    assert br.allow_submit(1.5)
    br.on_panel_success()
    assert br.state == "closed" and br.failures == 0


def test_breaker_opens_fails_fast_and_recloses_after_probe():
    state = {"broken": True}

    def flaky(panel):
        if state["broken"]:
            raise RuntimeError("lane down")
        return _double(panel)

    rt = PanelRuntime(8, 2, flaky, chaos="",
                      resilience=_fail_fast_policy(threshold=2, cooldown_s=0.05), device="cpu")
    with rt:
        f1 = rt.submit(np.zeros(8, np.float32))
        rt.flush()
        with pytest.raises(RuntimeError, match="lane down"):
            f1.result(timeout=30)
        assert rt.stats["breaker_state"] == "closed"
        f2 = rt.submit(np.zeros(8, np.float32))
        f3 = rt.submit(np.zeros(8, np.float32))
        f4 = rt.submit(np.zeros(8, np.float32))
        rt.flush()
        for f in (f2, f3):
            with pytest.raises(RuntimeError, match="lane down"):
                f.result(timeout=30)
        with pytest.raises(CircuitOpenError):
            f4.result(timeout=30)
        assert rt.stats["breaker_state"] == "open"
        with pytest.raises(CircuitOpenError):
            rt.submit(np.zeros(8, np.float32))
        assert "breaker_open" in [k for _, k, _ in rt.stats["events"]]
        state["broken"] = False
        time.sleep(0.06)
        probe = rt.submit(np.ones(8, np.float32))
        rt.flush()
        np.testing.assert_array_equal(probe.result(timeout=30), np.full(8, 2.0, np.float32))
        assert rt.stats["breaker_state"] == "closed"


def test_half_open_probe_failure_reopens_without_retry():
    calls = []

    def broken(panel):
        calls.append(1)
        raise RuntimeError("still down")

    rt = PanelRuntime(8, 2, broken, chaos="",
                      resilience=ResiliencePolicy(
                          retry=RetryPolicy(max_attempts=4, backoff_s=0.001),
                          breaker=BreakerPolicy(threshold=1, cooldown_s=0.05)),
                      device="cpu")
    with rt:
        f = rt.submit(np.zeros(8, np.float32))
        rt.flush()
        with pytest.raises(RuntimeError):
            f.result(timeout=30)
        assert len(calls) == 4
        time.sleep(0.06)
        probe = rt.submit(np.zeros(8, np.float32))
        rt.flush()
        with pytest.raises(RuntimeError):
            probe.result(timeout=30)
        assert len(calls) == 5
        assert rt.stats["breaker_state"] == "open"


# ---------------------------------------------------------------------------
# tenant isolation
# ---------------------------------------------------------------------------


def _p95(xs):
    return float(np.percentile(np.asarray(xs), 95))


def _healthy_latencies(with_bad_neighbor, n_requests=40):
    with MultiTenantRuntime(chaos="") as mtr:
        good = mtr.add_tenant("good", _spec(16, 4, _double))
        bad_futs = []
        if with_bad_neighbor:
            def broken(panel):
                raise RuntimeError("neighbor on fire")
            bad = mtr.add_tenant("bad", _spec(8, 2, broken,
                                              resilience=_fail_fast_policy(threshold=3)))
            bad_futs = [bad.submit(np.zeros(8, np.float32)) for _ in range(8)]
        futs = [good.submit(np.full(16, j, np.float32)) for j in range(n_requests)]
        mtr.flush()
        lat = []
        for j, f in enumerate(futs):
            out = f.result(timeout=120)
            lat.append(time.monotonic() - f.t_submit)
            np.testing.assert_array_equal(out, np.full(16, 2.0 * j, np.float32))
        mtr.drain()                     # the last panel's stats are in
        stats = {"good": good.stats(), "global": mtr.stats(),
                 "bad": bad.stats() if with_bad_neighbor else None}
        for f in bad_futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=30)
    return lat, stats


def test_failing_tenant_trips_breaker_healthy_neighbor_unaffected():
    base_lat, _ = _healthy_latencies(with_bad_neighbor=False)
    lat, stats = _healthy_latencies(with_bad_neighbor=True)
    assert stats["bad"]["breaker_state"] == "open"
    assert stats["bad"]["panel_failures"] >= 3
    assert stats["good"]["panels_launched"] == 10
    assert stats["good"]["panel_failures"] == 0
    assert stats["good"]["retries"] == 0
    order = stats["global"]["launch_order"]
    assert order.count("bad") <= 4
    assert order.count("good") == 10
    assert _p95(lat) <= max(10 * _p95(base_lat), 1.0)


def test_multitenant_bit_identical_under_recoverable_chaos():
    rng = np.random.RandomState(0)
    reqs = {"a": [rng.randn(16).astype(np.float32) for _ in range(64)],
            "b": [rng.randn(8).astype(np.float32) for _ in range(64)]}

    def run(chaos):
        with MultiTenantRuntime(chaos=chaos) as mtr:
            ta = mtr.add_tenant("a", _spec(16, 2, _double))
            tb = mtr.add_tenant("b", _spec(8, 2, _triple))
            fa = [ta.submit(q) for q in reqs["a"]]
            fb = [tb.submit(q) for q in reqs["b"]]
            mtr.flush()
            outs = ([f.result(timeout=120) for f in fa], [f.result(timeout=120) for f in fb])
            mtr.drain()
            return outs, mtr.stats(), ta.stats(), tb.stats()

    clean, *_ = run(chaos="")
    chaotic, gstats, astats, bstats = run(chaos="transient=0.05:1,seed=3")
    for side in (0, 1):
        for out_clean, out_chaos in zip(clean[side], chaotic[side]):
            np.testing.assert_array_equal(out_clean, out_chaos)
    assert gstats["panel_failures"] == 0
    assert gstats["retries"] >= 1
    assert sum(astats["faults_injected"].values()) + sum(bstats["faults_injected"].values()) >= 1
    assert astats["breaker_state"] == "closed" and bstats["breaker_state"] == "closed"


def test_server_async_matches_sync_under_zero_rate_env_chaos(monkeypatch):
    from repro_torch.core import build_hmatrix
    from repro_torch.serve.step import HMatrixServer
    monkeypatch.setenv("REPRO_CHAOS", "seed=7")
    rng = np.random.RandomState(1)
    hm = build_hmatrix(halton(300, 2, device="cpu"), "gaussian", k=16, c_leaf=128,
                       precompute=True, device="cpu")
    queries = [torch.from_numpy(rng.randn(300).astype(np.float32)) for _ in range(9)]
    with HMatrixServer(hm, max_batch=4) as srv:
        sync = srv.serve(queries)
        outs = [f.result(timeout=120) for f in srv.serve_async(queries)]
    stats = srv.runtime.stats()                 # after close: every panel counted
    for a, b in zip(sync, outs):
        np.testing.assert_array_equal(a, b)
    assert stats["faults_injected"] == {"error": 0, "transient": 0, "nan": 0, "latency": 0}
    assert stats["breaker_state"] == "closed"
    assert stats["retries"] == 0 and stats["fallback_launches"] == 0


def test_server_nan_chaos_relaunch_gives_the_chaos_free_bits():
    # poison and transient faults cost relaunches and retries, never bits:
    # the relaunch is the server's own apply
    from repro_torch.core import build_hmatrix
    from repro_torch.serve.step import HMatrixServer
    rng = np.random.RandomState(2)
    hm = build_hmatrix(halton(300, 2, device="cpu"), "gaussian", k=16, c_leaf=128,
                       precompute=True, device="cpu")
    queries = [rng.randn(300).astype(np.float32) for _ in range(14)]
    with HMatrixServer(hm, max_batch=4, chaos="") as clean_srv:
        clean = clean_srv.serve(queries)
    with HMatrixServer(hm, max_batch=4, chaos="transient=0.3:1,nan=0.5,seed=7",
                       resilience=ResiliencePolicy(validate_outputs=True)) as srv:
        outs = [f.result(timeout=120) for f in srv.serve_async(queries)]
    stats = srv.runtime.stats()
    for a, b in zip(clean, outs):
        np.testing.assert_array_equal(a, b)
    injected = stats["faults_injected"]
    assert injected["nan"] >= 1
    assert stats["fallback_launches"] == injected["nan"]
    assert stats["retries"] >= injected["transient"]
    assert stats["panel_failures"] == 0


# ---------------------------------------------------------------------------
# NaN/Inf output validation + the one counted relaunch
# ---------------------------------------------------------------------------


def _counting(launch):
    """``launch`` that records the width of every panel it is given."""
    calls = []

    def counted(panel):
        calls.append(panel.shape[1])
        return launch(panel)

    return counted, calls


def _nan_launch(panel):
    return panel * float("nan")


def test_nan_poisoned_panel_falls_back_to_reference_result():
    # the one relaunch goes through the lane's own launch, not another route
    launch, calls = _counting(_double)
    rt = PanelRuntime(8, 2, launch, chaos="nan=1.0,seed=0", device="cpu")
    with rt:
        futs = [rt.submit(np.full(8, j + 1.0, np.float32)) for j in range(4)]
        rt.flush()
        outs = [f.result(timeout=60) for f in futs]
    for j, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full(8, 2.0 * (j + 1.0), np.float32))
    assert rt.stats["faults_injected"]["nan"] == 2
    assert rt.stats["fallback_launches"] == 2
    assert rt.stats["panel_failures"] == 0
    assert [k for _, k, _ in rt.stats["events"]].count("fallback") == 2
    assert calls == [2, 2, 2, 2]                    # 2 launches + 2 relaunches, same callable


def test_nan_without_fallback_raises_nan_panel_error():
    # a NaN that the launch itself produces is not hidden: the relaunch gives
    # NaN again and the panel fails
    launch, calls = _counting(_nan_launch)
    rt = PanelRuntime(8, 2, launch, chaos="", device="cpu",
                      resilience=ResiliencePolicy(validate_outputs=True))
    f = rt.submit(np.ones(8, np.float32))
    rt.flush()
    with pytest.raises(NaNPanelError, match="relaunched panel produced NaN/Inf output again"):
        f.result(timeout=60)
    rt.close()
    assert rt.stats["fallback_launches"] == 1
    assert calls == [1, 1]


def test_nan_guard_failure_is_cached_across_column_futures():
    launch, calls = _counting(_nan_launch)
    rt = PanelRuntime(8, 2, launch, chaos="", device="cpu",
                      resilience=ResiliencePolicy(validate_outputs=True))
    with rt:
        futs = [rt.submit(np.ones(8, np.float32)) for _ in range(2)]
        rt.flush()
        errors = []
        for f in futs:
            with pytest.raises(NaNPanelError) as info:
                f.result(timeout=60)
            errors.append(info.value)
    assert errors[0] is errors[1]                   # one validation for the panel
    assert calls == [2, 2]                          # one launch, one relaunch
    assert rt.stats["fallback_launches"] == 1
    # the guard alone: the relaunch's rows replace a NaN panel's
    redo = []
    guard = NaNGuard(2, lambda: redo.append(1) or np.full((2, 4), 2.0, np.float32))
    out = guard.check(np.full((2, 4), np.nan, np.float32))
    np.testing.assert_array_equal(out, np.full((2, 4), 2.0, np.float32))
    assert redo == [1]
    broken_guard = NaNGuard(2, lambda: np.full((2, 4), np.nan, np.float32))
    with pytest.raises(NaNPanelError, match="again"):
        broken_guard.check(np.full((2, 4), np.nan, np.float32))
    # only the real rows are validated: a NaN pad row passes untouched
    padded = np.ones((2, 4), np.float32)
    padded[1] = np.nan
    assert NaNGuard(1, broken_guard.relaunch).check(padded) is padded


# ---------------------------------------------------------------------------
# payload validation at submit()
# ---------------------------------------------------------------------------


def test_invalid_payloads_rejected_at_submit_neighbors_unharmed():
    with PanelRuntime(8, 4, _double, chaos="", device="cpu") as rt:
        good = [rt.submit(np.full(8, 1.0, np.float32))]
        with pytest.raises(ValueError, match=r"shape \(9,\) != \(8,\)"):
            rt.submit(np.zeros(9, np.float32))
        with pytest.raises(ValueError, match="complex"):
            rt.submit(np.zeros(8, np.complex64))
        with pytest.raises(ValueError, match="complex"):
            rt.submit(torch.zeros(8, dtype=torch.complex64))
        with pytest.raises(ValueError, match="not convertible"):
            rt.submit(["not", "a", "vector", 0, 0, 0, 0, 0])
        with pytest.raises(ValueError, match="non-finite"):
            rt.submit(np.array([np.nan] + [0.0] * 7, np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            rt.submit(np.array([np.inf] + [0.0] * 7, np.float32))
        good.append(rt.submit(torch.full((8,), 2.0)))
        rt.flush()
        for j, f in enumerate(good):
            np.testing.assert_array_equal(f.result(timeout=30),
                                          np.full(8, 2.0 * (j + 1), np.float32))
        assert rt.stats["panels_launched"] == 1


def test_tenant_submit_validation_names_the_tenant():
    with MultiTenantRuntime(chaos="") as mtr:
        t = mtr.add_tenant("alpha", _spec(8, 2, _double))
        with pytest.raises(ValueError, match="tenant 'alpha'"):
            t.submit(np.zeros(5, np.float32))
        f = t.submit(np.ones(8, np.float32))
        mtr.flush()
        np.testing.assert_array_equal(f.result(timeout=30), np.full(8, 2.0, np.float32))


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------


def test_runtime_load_shedding_rejects_beyond_budget():
    blocker, started = threading.Event(), threading.Event()

    def gated(panel):
        started.set()
        blocker.wait(timeout=30)
        return _double(panel)

    rt = PanelRuntime(8, 2, gated, chaos="", shed_above=4, device="cpu")
    try:
        futs = [rt.submit(np.full(8, j, np.float32)) for j in range(2)]
        assert started.wait(timeout=30)
        futs += [rt.submit(np.full(8, j, np.float32)) for j in range(2, 6)]
        with pytest.raises(OverloadedError, match="shed"):
            rt.submit(np.zeros(8, np.float32))
        assert rt.stats["shed_requests"] == 1
        assert "shed" in [k for _, k, _ in rt.stats["events"]]
    finally:
        blocker.set()
    with rt:
        rt.flush()
        for j, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=60), np.full(8, 2.0 * j, np.float32))
    with pytest.raises(ValueError, match="shed_above"):
        PanelRuntime(8, 4, _double, chaos="", shed_above=2, device="cpu")


def test_global_shedding_across_tenants():
    blocker, started = threading.Event(), threading.Event()

    def gated(panel):
        started.set()
        blocker.wait(timeout=30)
        return _double(panel)

    mtr = MultiTenantRuntime(chaos="", shed_above=4)
    try:
        ta = mtr.add_tenant("a", _spec(8, 2, gated))
        tb = mtr.add_tenant("b", _spec(8, 2, _double))
        fa = [ta.submit(np.zeros(8, np.float32)) for _ in range(2)]
        assert started.wait(timeout=30)
        fa += [ta.submit(np.zeros(8, np.float32)) for _ in range(3)]
        fb = [tb.submit(np.ones(8, np.float32))]
        with pytest.raises(OverloadedError, match="across all"):
            tb.submit(np.ones(8, np.float32))
        assert mtr.stats["shed_requests"] == 1
        assert tb.stats["shed_requests"] == 1
    finally:
        blocker.set()
    with mtr:
        mtr.flush()
        for f in fa + fb:
            f.result(timeout=60)


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------


def test_slow_launch_accounting_via_deadline():
    def sluggish(panel):
        time.sleep(0.02)
        return _double(panel)

    rt = PanelRuntime(8, 2, sluggish, chaos="",
                      resilience=ResiliencePolicy(retry=None, breaker=None,
                                                  launch_deadline_s=0.005),
                      device="cpu")
    with rt:
        futs = [rt.submit(np.ones(8, np.float32)) for _ in range(4)]
        rt.flush()
        [f.result(timeout=60) for f in futs]
    assert rt.stats["slow_launches"] == 2
    assert "slow_launch" in [k for _, k, _ in rt.stats["events"]]


def test_multitenant_straggler_monitor_flags_slow_tenant():
    """The retirement hook feeds each launch's run time into the
    per-tenant EWMA (on the CPU, the call's host time): a tenant whose
    launches run far longer than the fleet's is flagged."""
    a = torch.from_numpy(np.random.RandomState(0).randn(128, 128).astype(np.float32) * 0.05)

    def heavy(panel):
        for _ in range(300):
            panel = a @ panel
        time.sleep(0.02)
        return panel

    with MultiTenantRuntime(chaos="") as mtr:
        slow = mtr.add_tenant("slow", _spec(128, 2, heavy))
        f1 = mtr.add_tenant("fast1", _spec(128, 2, _double))
        f2 = mtr.add_tenant("fast2", _spec(128, 2, _double))
        futs = []
        for t in (slow, f1, f2):
            futs += [t.submit(np.ones(128, np.float32)) for _ in range(8)]
        mtr.flush()
        [f.result(timeout=120) for f in futs]
        mtr.drain()
        stragglers = mtr.stats()["straggler_tenants"]
    assert stragglers == ["slow"]


def test_straggler_monitor():
    mon = StragglerMonitor(alpha=1.0, threshold=2.0)
    for host in ("h0", "h1", "h2", "h3"):
        mon.record(host, 1.0)
    assert mon.stragglers() == []
    assert mon.record("h3", 5.0) is True
    assert mon.stragglers() == ["h3"]
    mon.forget("h3")
    assert mon.stragglers() == []


def test_restart_supervisor_retries():
    attempts, restarts = [], []

    def loop():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("simulated node failure")
        return "done"

    out = run_with_restarts(loop, max_restarts=5, on_restart=lambda n, e: restarts.append(n))
    assert out == "done" and len(attempts) == 3 and restarts == [1, 2]


def test_restart_supervisor_gives_up():
    def loop():
        raise RuntimeError("hard failure")
    with pytest.raises(RuntimeError):
        run_with_restarts(loop, max_restarts=2)


def test_lane_resilience_verdict_sequence():
    res = LaneResilience(ResiliencePolicy(
        retry=RetryPolicy(max_attempts=2, backoff_s=0.01, jitter=0.0),
        breaker=BreakerPolicy(threshold=2, cooldown_s=10.0)), "lane")
    assert res.gate(0.0) is None
    assert res.decide_failure(1.0) == "retry"
    assert res.gate(1.005) == pytest.approx(1.01)
    assert res.gate(1.02) is None
    assert res.decide_failure(1.02) == "fail"
    assert res.decide_failure(2.0) == "retry"
    assert res.decide_failure(2.1) == "open"
    assert res.breaker_state() == "open"
    assert not res.allow_submit(2.2)
    res.on_success()
    assert res.breaker_state() == "closed" and res.allow_submit(2.2)


# ---------------------------------------------------------------------------
# the device build under chaos (the cases of tests/test_build_onboarding.py)
# ---------------------------------------------------------------------------

BUILD = {"c_leaf": 128, "k": 8, "device": "cpu"}


def _build_pts():
    return halton(768, 2, device="cpu") * 8.0


def _same_build(a, b):
    assert torch.equal(a.tree.perm, b.tree.perm)
    assert torch.equal(a.tree.points, b.tree.points)
    np.testing.assert_array_equal(a.plan.dense_blocks, b.plan.dense_blocks)
    assert a.plan.aca_levels.keys() == b.plan.aca_levels.keys()
    for lvl, blocks in b.plan.aca_levels.items():
        np.testing.assert_array_equal(a.plan.aca_levels[lvl], blocks)
    if b.factors is not None:
        for lvl in b.factors:
            for x, y in zip(a.factors[lvl], b.factors[lvl]):
                assert torch.equal(x, y)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_build_under_transient_chaos_gives_the_chaos_free_bits(use_kernels):
    pts = _build_pts()
    kw = dict(BUILD, precompute=True, use_kernels=use_kernels)
    ref, rep0 = build_hmatrix_device_report(pts, chaos="", **kw)
    hm, rep = build_hmatrix_device_report(pts, chaos="transient=0.5:1,seed=3", **kw)
    assert rep0.retries == 0 and rep0.faults_injected == {}
    assert rep.retries > 0
    assert rep.faults_injected == {"transient": rep.retries}
    assert rep.fallback_launches == 0
    _same_build(hm, ref)


def test_transient_build_fault_retried_with_exact_result():
    pts = _build_pts()
    ref, _ = build_hmatrix_device_report(pts, chaos="", **BUILD)
    hm, rep = build_hmatrix_device_report(pts, chaos="transient=0.6:1,seed=3", **BUILD)
    assert rep.retries == 1                         # build:plan: one fault, one retry
    assert rep.faults_injected.get("transient") == 1
    assert rep.fallback_launches == 0
    _same_build(hm, ref)


def test_nan_poisoned_build_launch_relaunched():
    pts = _build_pts()
    ref, _ = build_hmatrix_device_report(pts, chaos="", precompute=True, **BUILD)
    hm, rep = build_hmatrix_device_report(pts, chaos="nan=1.0", precompute=True, **BUILD)
    assert rep.fallback_launches == 1 + len(ref.plan.aca_levels)    # every stage once more
    assert rep.faults_injected == {"nan": rep.fallback_launches}
    _same_build(hm, ref)


def test_exhausted_build_retries_surface_the_fault():
    with pytest.raises(InjectedFault):
        build_hmatrix_device_report(_build_pts(), chaos="transient=1.0:4,seed=0", **BUILD)


def test_build_chaos_env_twin(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "transient=0.6:1,seed=3")
    _, rep = build_hmatrix_device_report(_build_pts(), **BUILD)
    assert rep.retries == 1
    _, rep = build_hmatrix_device_report(_build_pts(), chaos="", **BUILD)
    assert rep.retries == 0
