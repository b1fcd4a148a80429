"""Port parity and behaviour: multi-tenant serving (``repro_torch.serve.tenancy``).

Parity with ``repro``: two tenants (an apply and a solve, different ``n``)
served by ``repro.serve.tenancy.MultiTenantRuntime`` and by the port's, on
the reference's H-matrices carried over by ``convert.hmatrix_from_arrays``,
agree within the apply's 1e-4 and the solve's one iteration per column and
rtol 1e-3 / atol 1e-4 (``tests/test_torch_serve.py`` says why the
reference's solve runs its kernel route).  Then the reference's
``tests/test_tenancy.py`` case for case (not the mesh cases), its
onboarding cases (``tests/test_build_onboarding.py``), its memory-tier cases
(``tests/test_factor_store.py``) and its H-LU tenant case
(``tests/test_harith.py``), on the CPU.
"""
import threading
import time
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.serve.tenancy import MultiTenantRuntime as JMultiTenantRuntime
from repro.serve.tenancy import apply_tenant as j_apply_tenant
from repro.serve.tenancy import solve_tenant as j_solve_tenant
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import build_hmatrix, build_hmatrix_device, halton, make_apply
from repro_torch.serve.runtime import PanelRuntime
from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer
from repro_torch.serve.tenancy import (MultiTenantRuntime, TenantSpec, apply_tenant,
                                       solve_tenant)
from torch_parity_util import export_hmatrix, one_torch_thread, rel_err  # noqa: F401

SIGMA2 = 0.5


def _system(n, r, seed=0):
    rng = np.random.RandomState(seed)
    hm = build_hmatrix(halton(n, 2, device="cpu"), "gaussian", k=16, c_leaf=128,
                       precompute=True, device="cpu")
    return hm, rng.randn(n, r).astype(np.float32)


def _double(panel):
    return panel * 2.0


def _echo(scale):
    return lambda panel: panel * scale


def _spec(n, max_batch, launch, **kw):
    return TenantSpec(n, max_batch, launch, device="cpu", **kw)


def _echo_spec(n=16, max_batch=4, scale=2.0, **kw):
    return _spec(n, max_batch, _echo(scale), **kw)


# ---------------------------------------------------------------------------
# parity with repro
# ---------------------------------------------------------------------------


def test_two_tenants_match_reference_runtime():
    pts_a = np.asarray(j_halton(1024, 2))
    pts_s = np.asarray(j_halton(512, 2)) * 16.0
    jhm_a = j_build_hmatrix(jnp.asarray(pts_a), "gaussian", k=8, c_leaf=64, precompute=True)
    jhm_s = j_build_hmatrix(jnp.asarray(pts_s), "gaussian", k=8, c_leaf=64, precompute=True)
    rng = np.random.RandomState(11)
    fa = rng.randn(1024, 6).astype(np.float32)
    fs = rng.randn(512, 5).astype(np.float32)
    solve_kw = dict(max_batch=2, tol=1e-5, max_iter=200)

    def run(runtime, a_spec, s_spec):
        with runtime() as mtr:
            ta = mtr.add_tenant("apply", a_spec, weight=2.0)
            ts = mtr.add_tenant("solve", s_spec)
            futs_a = [ta.submit(fa[:, j]) for j in range(6)]
            futs_s = [ts.submit(fs[:, j]) for j in range(5)]
            mtr.flush()
            return (np.stack([np.asarray(f.result(timeout=240)) for f in futs_a]),
                    np.stack([np.asarray(f.result(timeout=240)) for f in futs_s]))

    j_log, log = deque(), deque()
    want_a, want_s = run(JMultiTenantRuntime, j_apply_tenant(jhm_a, max_batch=4),
                         j_solve_tenant(jhm_s, SIGMA2, use_pallas=True, info_log=j_log,
                                        **solve_kw))
    hm_a = hmatrix_from_arrays(export_hmatrix(jhm_a), device="cpu")
    hm_s = hmatrix_from_arrays(export_hmatrix(jhm_s), device="cpu")
    got_a, got_s = run(MultiTenantRuntime, apply_tenant(hm_a, max_batch=4),
                       solve_tenant(hm_s, SIGMA2, info_log=log, **solve_kw))
    assert rel_err(got_a, want_a) <= 1e-4
    np.testing.assert_allclose(got_s, want_s, rtol=1e-3, atol=1e-4)
    iters = np.concatenate([info.iters_per_column for info in log])
    j_iters = np.concatenate([info.iters_per_column for info in j_log])
    assert iters.shape == j_iters.shape == (5,)     # panels of 2, 2 and 1
    assert np.abs(iters - j_iters).max() <= 1


# ---------------------------------------------------------------------------
# bit-identity: a tenant == a dedicated runtime on the same requests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_requests", [8, 11])
def test_tenant_matches_dedicated_runtime_bit_identical(n_requests):
    hm, f = _system(600, 11)
    with HMatrixServer(hm, max_batch=4) as srv:
        queries = [f[:, j] for j in range(n_requests)]
        dedicated = [fut.result(timeout=120) for fut in srv.serve_async(queries)]
        with MultiTenantRuntime() as mtr:
            tenant = mtr.add_tenant("apply", srv)
            futures = [tenant.submit(q) for q in queries]
            tenant.flush()
            outs = [fut.result(timeout=120) for fut in futures]
    for j in range(n_requests):
        np.testing.assert_array_equal(outs[j], dedicated[j])
    assert list(tenant.stats["launched_widths"]) == list(srv.runtime.stats["launched_widths"])


def test_mixed_apply_and_solve_tenants_match_single_tenant():
    hm_a, f_a = _system(600, 6, seed=1)
    hm_s, f_s = _system(512, 5, seed=2)
    info_log = deque(maxlen=8)
    with MultiTenantRuntime() as mtr:
        ta = mtr.add_tenant("apply", apply_tenant(hm_a, max_batch=4))
        ts = mtr.add_tenant("solve", solve_tenant(hm_s, SIGMA2, max_batch=2, tol=1e-6,
                                                  max_iter=400, info_log=info_log))
        fa = [ta.submit(f_a[:, j]) for j in range(6)]
        fs = [ts.submit(f_s[:, j]) for j in range(5)]
        mtr.flush()
        outs_a = [f.result(timeout=120) for f in fa]
        outs_s = [f.result(timeout=240) for f in fs]
    with HMatrixServer(hm_a, max_batch=4) as srv:
        ded_a = srv.serve([f_a[:, j] for j in range(6)])
    with HMatrixSolveServer(hm_s, SIGMA2, max_batch=2, tol=1e-6, max_iter=400) as ssrv:
        ded_s = ssrv.serve([f_s[:, j] for j in range(5)])
    for j in range(6):
        np.testing.assert_array_equal(outs_a[j], ded_a[j])
    for j in range(5):
        np.testing.assert_array_equal(outs_s[j], ded_s[j])
    assert len(info_log) == 3
    assert all(info.converged for info in info_log)


# ---------------------------------------------------------------------------
# fair-share scheduling
# ---------------------------------------------------------------------------


def _interleave_gaps(order, name):
    idx = [i for i, t in enumerate(order) if t == name]
    assert idx, f"{name} never launched: {order}"
    return [b - a - 1 for a, b in zip(idx, idx[1:])]


def test_skewed_load_light_tenant_not_starved():
    def slow_launch(panel):
        time.sleep(0.005)
        return _double(panel)

    with MultiTenantRuntime(max_inflight=2) as mtr:
        heavy = mtr.add_tenant("heavy", _spec(16, 4, slow_launch))
        light = mtr.add_tenant("light", _spec(16, 4, slow_launch))
        hf = [heavy.submit(np.full(16, j, np.float32)) for j in range(160)]
        mtr.flush()
        lf = [light.submit(np.full(16, 100 + j, np.float32)) for j in range(16)]
        for j, f in enumerate(lf):
            np.testing.assert_array_equal(f.result(timeout=60), np.full(16, 2.0 * (100 + j)))
        heavy_backlog_live = not hf[-1].done()
        [f.result(timeout=60) for f in hf]
        mtr.drain()
        order = list(mtr.stats["launch_order"])
        assert heavy_backlog_live, "light tenant waited out the heavy backlog"
    assert order.count("light") == 4 and order.count("heavy") == 40
    assert max(_interleave_gaps(order, "light")) <= 3, f"light tenant starved: {order}"
    assert all(f.done() for f in lf)


def test_weighted_shares_follow_weights():
    def slow_launch(panel):
        time.sleep(0.002)
        return panel

    with MultiTenantRuntime(max_inflight=1) as mtr:
        a = mtr.add_tenant("a", _spec(8, 2, slow_launch, weight=3.0))
        b = mtr.add_tenant("b", _spec(8, 2, slow_launch, weight=1.0))
        fa = [a.submit(np.zeros(8, np.float32)) for _ in range(80)]
        fb = [b.submit(np.zeros(8, np.float32)) for _ in range(80)]
        mtr.flush()
        mtr.drain()
        order = list(mtr.stats["launch_order"])
        [f.result(timeout=60) for f in fa + fb]
    n_a = order[:40].count("a")
    assert 25 <= n_a <= 35, f"weight 3:1 not honored: {n_a}/40 in {order[:40]}"


def test_idle_tenant_banks_no_credit():
    def slow_launch(panel):
        time.sleep(0.002)
        return panel

    with MultiTenantRuntime(max_inflight=1) as mtr:
        a = mtr.add_tenant("a", _spec(8, 2, slow_launch))
        b = mtr.add_tenant("b", _spec(8, 2, slow_launch))
        fa = [a.submit(np.zeros(8, np.float32)) for _ in range(40)]
        mtr.flush()
        mtr.drain()
        fa += [a.submit(np.zeros(8, np.float32)) for _ in range(40)]
        fb = [b.submit(np.zeros(8, np.float32)) for _ in range(40)]
        mtr.flush()
        mtr.drain()
        order = list(mtr.stats["launch_order"])
        [f.result(timeout=60) for f in fa + fb]
    assert max(_interleave_gaps(order[20:], "a")) <= 3, f"b monopolized after idling: {order}"


# ---------------------------------------------------------------------------
# hot add / remove
# ---------------------------------------------------------------------------


def test_remove_tenant_mid_traffic_drains_cleanly():
    def slow_launch(panel):
        time.sleep(0.003)
        return _double(panel)

    with MultiTenantRuntime() as mtr:
        keep = mtr.add_tenant("keep", _spec(16, 4, slow_launch))
        gone = mtr.add_tenant("gone", _spec(16, 4, slow_launch))
        kf = [keep.submit(np.full(16, j, np.float32)) for j in range(40)]
        gf = [gone.submit(np.full(16, j, np.float32)) for j in range(12)]
        mtr.flush()
        mtr.remove_tenant("gone")
        assert mtr.tenants() == ("keep",)
        for j, f in enumerate(gf):
            np.testing.assert_array_equal(f.result(timeout=60), np.full(16, 2.0 * j))
        with pytest.raises(RuntimeError, match="removed"):
            gone.submit(np.zeros(16, np.float32))
        gone.flush()
        gone.drain()
        kf.append(keep.submit(np.full(16, 99.0, np.float32)))
        mtr.flush()
        for j, f in enumerate(kf[:40]):
            np.testing.assert_array_equal(f.result(timeout=60), np.full(16, 2.0 * j))
        np.testing.assert_array_equal(kf[40].result(timeout=60), np.full(16, 198.0))
        assert mtr.stats["tenants_removed"] == 1
    with pytest.raises(KeyError):
        mtr.remove_tenant("gone")


def test_add_tenant_while_serving_and_registry_validation():
    with MultiTenantRuntime() as mtr:
        a = mtr.add_tenant("a", _echo_spec())
        fa = [a.submit(np.ones(16, np.float32)) for _ in range(6)]
        b = mtr.add_tenant("b", _echo_spec(n=8, scale=3.0))
        fb = b.submit(np.ones(8, np.float32))
        mtr.flush()
        np.testing.assert_array_equal(fb.result(timeout=30), np.full(8, 3.0))
        [f.result(timeout=30) for f in fa]
        with pytest.raises(ValueError, match="already registered"):
            mtr.add_tenant("a", _echo_spec())
        with pytest.raises(TypeError):
            mtr.add_tenant("c", object())
        with pytest.raises(ValueError, match="weight"):
            mtr.add_tenant("c", _echo_spec(weight=0.0))


# ---------------------------------------------------------------------------
# per-tenant deadlines, backpressure, stats; global budget; close
# ---------------------------------------------------------------------------


def test_per_tenant_deadline_flush():
    with MultiTenantRuntime() as mtr:
        fast = mtr.add_tenant("fast", _echo_spec(deadline_s=0.05))
        slow = mtr.add_tenant("slow", _echo_spec())
        f1 = fast.submit(np.ones(16, np.float32))
        f2 = slow.submit(np.ones(16, np.float32))
        np.testing.assert_array_equal(f1.result(timeout=30), np.full(16, 2.0))
        assert fast.stats["deadline_flushes"] == 1
        assert not f2.done() and slow.queue_depth() == 1
        slow.flush()
        f2.result(timeout=30)
    assert slow.stats["deadline_flushes"] == 0


def test_per_tenant_backpressure_isolated():
    def slow_launch(panel):
        time.sleep(0.02)
        return _double(panel)

    with MultiTenantRuntime() as mtr:
        capped = mtr.add_tenant("capped", _spec(16, 2, slow_launch, max_queue=4))
        free = mtr.add_tenant("free", _echo_spec())
        futures = []

        def producer():
            for j in range(16):
                futures.append(capped.submit(np.full(16, j, np.float32)))

        t = threading.Thread(target=producer)
        t.start()
        ff = [free.submit(np.zeros(16, np.float32)) for _ in range(100)]
        t.join(timeout=60)
        assert not t.is_alive()
        mtr.flush()
        for j, f in enumerate(futures):
            np.testing.assert_array_equal(f.result(timeout=60), np.full(16, 2.0 * j))
        [f.result(timeout=30) for f in ff]
        snap = capped.stats()
        assert snap["max_queue_depth"] <= 4
        assert snap["backpressure_waits"] > 0
        assert free.stats()["backpressure_waits"] == 0
    with pytest.raises(ValueError, match="max_queue"):
        _spec(16, 8, _echo(2.0), max_queue=4)


def test_stats_snapshots_and_close_semantics():
    mtr = MultiTenantRuntime()
    a = mtr.add_tenant("a", _echo_spec())
    futs = [a.submit(np.ones(16, np.float32)) for _ in range(9)]
    mtr.flush()
    [f.result(timeout=30) for f in futs]
    mtr.drain()                         # the last panel's stats are in
    snap = a.stats()
    assert snap["submitted"] == 9 and snap["panels_launched"] == 3
    assert isinstance(snap["launched_widths"], list)
    snap["launched_widths"].append(999)
    assert 999 not in a.stats["launched_widths"]
    g = mtr.stats()
    assert g["panels_launched"] == 3
    assert mtr.tenant_stats()["a"]["panels_launched"] == 3
    mtr.close()
    mtr.close()
    with mtr:
        pass
    with pytest.raises(RuntimeError, match="closed"):
        a.submit(np.ones(16, np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        mtr.add_tenant("b", _echo_spec())
    assert futs[0].result(timeout=5) is not None


def test_precompile_is_incremental_per_tenant():
    calls = []

    def counting(name):
        def launch(panel):
            calls.append((name, panel.shape[1]))
            return panel
        return launch

    with MultiTenantRuntime() as mtr:
        mtr.add_tenant("a", _spec(16, 4, counting("a")))
        mtr.precompile()
        assert sorted(calls) == [("a", 1), ("a", 2), ("a", 4)]
        mtr.precompile()
        assert len(calls) == 3
        mtr.add_tenant("b", _spec(8, 2, counting("b")))
        mtr.precompile()
        assert sorted(calls[3:]) == [("b", 1), ("b", 2)]
        mtr.remove_tenant("a")
        mtr.add_tenant("a", _spec(16, 4, counting("a2")))
        mtr.precompile()
        assert sorted(calls[5:]) == [("a2", 1), ("a2", 2), ("a2", 4)]


def test_launch_error_contained_to_tenant():
    def broken(panel):
        raise RuntimeError("tenant on fire")

    with MultiTenantRuntime() as mtr:
        bad = mtr.add_tenant("bad", _spec(8, 2, broken))
        good = mtr.add_tenant("good", _echo_spec())
        bf = bad.submit(np.zeros(8, np.float32))
        gf = good.submit(np.ones(16, np.float32))
        mtr.flush()
        with pytest.raises(RuntimeError, match="on fire"):
            bf.result(timeout=30)
        np.testing.assert_array_equal(gf.result(timeout=30), np.full(16, 2.0))


# ---------------------------------------------------------------------------
# concurrent submitters
# ---------------------------------------------------------------------------


def test_concurrent_submitters_two_tenants_no_lost_futures():
    hm_a, _ = _system(300, 1, seed=3)
    apply_ref = make_apply(hm_a)(np.ones(300, np.float32)).numpy()
    with MultiTenantRuntime() as mtr:
        a = mtr.add_tenant("a", apply_tenant(hm_a, max_batch=4))
        b = mtr.add_tenant("b", _echo_spec(n=24, scale=5.0, max_queue=32))
        per_thread = 12
        results = {}

        def producer(tid):
            handle, n = (a, 300) if tid % 2 == 0 else (b, 24)
            futs = []
            for j in range(per_thread):
                v = np.full(n, 1.0 + tid + j / 100.0, np.float32)
                futs.append((v, handle.submit(v)))
            results[tid] = futs

        threads = [threading.Thread(target=producer, args=(tid,)) for tid in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        mtr.flush()
        for tid, futs in results.items():
            assert len(futs) == per_thread
            for v, f in futs:
                out = f.result(timeout=120)
                if tid % 2 == 0:
                    np.testing.assert_allclose(out, v[0] * apply_ref, rtol=1e-4, atol=1e-4)
                else:
                    np.testing.assert_array_equal(out, v * 5.0)
        mtr.drain()
        assert a.stats["submitted"] == 3 * per_thread
        assert b.stats["submitted"] == 3 * per_thread
        assert sum(a.stats["launched_widths"]) >= 3 * per_thread
        assert sum(b.stats["launched_widths"]) >= 3 * per_thread


def test_concurrent_submitters_single_runtime():
    rt = PanelRuntime(8, 4, lambda panel: panel + 1.0, max_queue=16, device="cpu")
    results = {}

    def producer(tid):
        futs = []
        for j in range(20):
            v = np.full(8, 10.0 * tid + j, np.float32)
            futs.append((v, rt.submit(v)))
        results[tid] = futs

    threads = [threading.Thread(target=producer, args=(tid,)) for tid in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rt.flush()
    for tid, futs in results.items():
        assert len(futs) == 20
        for v, f in futs:
            np.testing.assert_array_equal(f.result(timeout=60), v + 1.0)
    rt.drain()
    snap = rt.stats()
    assert snap["max_queue_depth"] <= 16
    assert sum(snap["launched_widths"]) == 100
    rt.close()


# ---------------------------------------------------------------------------
# onboarding from raw coordinates (tests/test_build_onboarding.py)
# ---------------------------------------------------------------------------

N_ON, MB = 768, 4
BUILD = {"c_leaf": 128, "k": 8, "precompute": True, "device": "cpu"}


def _on_pts():
    return halton(N_ON, 2, device="cpu") * 8.0


def _queries(count, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(N_ON).astype(np.float32) for _ in range(count)]


def _prebuilt_spec(pts):
    return apply_tenant(build_hmatrix_device(pts, **BUILD), max_batch=MB)


def test_onboarded_tenant_bit_identical_to_prebuilt():
    pts = _on_pts()
    qs = _queries(3 * MB)
    with MultiTenantRuntime() as mtr:
        ha = mtr.add_tenant("prebuilt", _prebuilt_spec(pts))
        hb = mtr.add_tenant("coords", apply_tenant(pts, build=BUILD, max_batch=MB))
        fa = [ha.submit(q) for q in qs]
        fb = [hb.submit(q) for q in qs]
        mtr.drain()
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x.result(timeout=60), y.result(timeout=60))
        onboard = mtr.stats()["onboard_s"]
        assert set(onboard) == {"coords"} and onboard["coords"] > 0
        assert ha.stats()["onboard_s"] is None
        assert hb.stats()["onboard_s"] == onboard["coords"]


def test_hot_onboarding_leaves_existing_tenant_undisturbed():
    pts = _on_pts()
    qs = _queries(4 * MB)
    probe = _queries(1, seed=7)[0]
    with MultiTenantRuntime() as mtr:
        h = mtr.add_tenant("base", _prebuilt_spec(pts))
        futs = [h.submit(q) for q in qs]
        mtr.drain()
        expected = [f.result(timeout=60) for f in futs]
    with MultiTenantRuntime() as mtr:
        h = mtr.add_tenant("solo", _prebuilt_spec(pts))
        f = h.submit(probe)
        mtr.drain()
        expected_first = f.result(timeout=60)
    with MultiTenantRuntime() as mtr:
        h = mtr.add_tenant("base", _prebuilt_spec(pts))
        futs = [h.submit(q) for q in qs]
        hot = mtr.add_tenant("hot", apply_tenant(pts, build=BUILD, max_batch=MB))
        f_hot = hot.submit(probe)
        mtr.drain()
        for f, e in zip(futs, expected):
            np.testing.assert_array_equal(f.result(timeout=60), e)
        np.testing.assert_array_equal(f_hot.result(timeout=60), expected_first)
        assert "hot" in mtr.stats()["onboard_s"]


def test_onboarding_under_build_chaos_serves_exact():
    pts = _on_pts()
    qs = _queries(2 * MB)
    chaotic = apply_tenant(pts, build=dict(BUILD, chaos="transient=0.6:1,seed=3"), max_batch=MB)
    with MultiTenantRuntime(chaos="") as mtr:
        ha = mtr.add_tenant("clean", _prebuilt_spec(pts))
        hb = mtr.add_tenant("survivor", chaotic)
        fa = [ha.submit(q) for q in qs]
        fb = [hb.submit(q) for q in qs]
        mtr.drain()
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x.result(timeout=60), y.result(timeout=60))
        assert mtr.stats()["onboard_s"]["survivor"] > 0


# ---------------------------------------------------------------------------
# the memory tier (tests/test_factor_store.py) and H-LU tenants
# ---------------------------------------------------------------------------


def _store_specs(n, n_tenants, k=8, c_leaf=64, max_batch=4):
    specs = []
    for i in range(n_tenants):
        pts = halton(n, 2, device="cpu") * (1.0 + 0.3 * i)
        hm = build_hmatrix(pts, k=k, c_leaf=c_leaf, precompute=True, device="cpu")
        specs.append(apply_tenant(hm, max_batch=max_batch))
    return specs


def _serve(specs, queries, plan, budget):
    with MultiTenantRuntime(device_bytes_budget=budget) as mtr:
        handles = [mtr.add_tenant(f"t{i}", s) for i, s in enumerate(specs)]
        futures = [handles[plan[j]].submit(q) for j, q in enumerate(queries)]
        mtr.flush()
        results = [f.result(timeout=60) for f in futures]
        glob = mtr.stats()
        per = {h.name: dict(h.stats()) for h in handles}
    return results, glob, per


def test_spill_reload_bit_identical_under_skewed_traffic():
    rng = np.random.RandomState(0)
    n, n_tenants, n_requests = 384, 3, 44
    specs = _store_specs(n, n_tenants)
    per_tenant = specs[0].store.nbytes()["total"]
    budget = per_tenant * n_tenants - per_tenant // 2
    queries = [rng.randn(n).astype(np.float32) for _ in range(n_requests)]
    plan = [0 if j % 11 else 1 + (j // 11) % (n_tenants - 1) for j in range(n_requests)]
    res_b, glob_b, per_b = _serve(specs, queries, plan, budget)
    res_u, _, _ = _serve(specs, queries, plan, None)
    assert glob_b["evictions"] >= 1
    assert glob_b["reloads"] >= 1
    assert any(p["spills"] >= 1 for p in per_b.values())
    reloaded = [p for p in per_b.values() if p["reloads"] >= 1]
    assert reloaded and all(p["reload_s"] > 0 for p in reloaded)
    for a, b in zip(res_b, res_u):
        np.testing.assert_array_equal(a, b)


def test_eviction_respects_byte_budget():
    rng = np.random.RandomState(1)
    n, n_tenants = 384, 3
    specs = _store_specs(n, n_tenants)
    per_tenant = specs[0].store.nbytes()["total"]
    budget = 2 * per_tenant
    with MultiTenantRuntime(device_bytes_budget=budget) as mtr:
        handles = [mtr.add_tenant(f"t{i}", s) for i, s in enumerate(specs)]
        assert mtr.stats["device_store_bytes"] <= budget
        for h in handles:
            h.submit(rng.randn(n).astype(np.float32))
            h.drain()
        glob = mtr.stats()
        per = {h.name: dict(h.stats()) for h in handles}
    assert glob["budget_bytes"] == budget
    assert glob["evictions"] >= 1
    assert glob["device_store_bytes"] <= budget
    assert sum(p["nbytes"] for p in per.values() if p["resident"]) == \
        glob["device_store_bytes"]


def test_reload_under_chaos_is_retried():
    """An injected fault on a reload takes the launch's retry path and
    leaves the store spilled for the retry; results keep their bits."""
    rng = np.random.RandomState(2)
    specs = _store_specs(384, 2)
    per_tenant = specs[0].store.nbytes()["total"]
    queries = [rng.randn(384).astype(np.float32) for _ in range(16)]
    plan = [j % 2 for j in range(16)]
    with MultiTenantRuntime(device_bytes_budget=per_tenant + per_tenant // 2,
                            chaos="transient=0.4:1,seed=5") as mtr:
        handles = [mtr.add_tenant(f"t{i}", s) for i, s in enumerate(specs)]
        futures = []
        for j, q in enumerate(queries):         # one panel at a time: a reload each
            futures.append(handles[plan[j]].submit(q))
            handles[plan[j]].drain()
        got = [f.result(timeout=60) for f in futures]
        glob = mtr.stats()
    want, _, _ = _serve(specs, queries, plan, None)
    assert glob["reloads"] >= 8 and glob["retries"] >= 1 and glob["panel_failures"] == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_solve_tenant_hlu_precond_accounting():
    rng = np.random.RandomState(3)
    hm = build_hmatrix(halton(500, 2, device="cpu") * 4.0, k=8, c_leaf=64, precompute=True,
                       device="cpu")
    spec = solve_tenant(hm, SIGMA2, max_batch=4, tol=1e-5, max_iter=200, precond="hlu",
                        hlu_opts={"tol": 1e-3})
    assert spec.precond_nbytes > 0
    assert spec.build_s is not None and spec.build_s > 0
    rt = MultiTenantRuntime()
    try:
        h = rt.add_tenant("fit", spec)
        assert h.stats()["precond_nbytes"] == spec.precond_nbytes
        assert rt.stats["device_store_bytes"] >= spec.precond_nbytes
        fut = h.submit(rng.randn(500).astype(np.float32))
        h.flush()
        assert np.isfinite(fut.result(timeout=120)).all()
        rt.remove_tenant("fit")
        assert rt.stats["device_store_bytes"] == 0
    finally:
        rt.close()
