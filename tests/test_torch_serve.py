"""Port parity and behaviour: the async panel runtime and the H-matrix servers
(``repro_torch.serve.runtime``, ``repro_torch.serve.step``).

Parity with ``repro``: ``panel_width_buckets`` gives the reference's
buckets; the reference's H-matrix (N = 1024, c_leaf 64, k 8, P mode),
carried over by ``convert.hmatrix_from_arrays``, served through
``repro.serve.step.HMatrixServer(use_pallas=False)`` and the port's server,
agrees within the apply's 1e-4 (``tests/test_torch_hmatrix.py``); the solve
servers agree within one iteration per column and rtol 1e-3 / atol 1e-4
(``tests/test_torch_solve.py``), the reference through its kernel route
(Pallas in interpret mode), whose dense leaves use the port's
direct-difference entries: its plain route's expansion-form entries part by
about 1e-4 on a domain of side 16 (ROADMAP §3, fault 5).  The port's async path is bit-identical to
its sync path.  Then the reference's ``tests/test_serve_async.py``, case for
case (not the mesh cases), on the CPU.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.parallel.hshard import pad_panel_width as j_pad_panel_width
from repro.serve.runtime import panel_width_buckets as j_panel_width_buckets
from repro.serve.step import HMatrixServer as JHMatrixServer
from repro.serve.step import HMatrixSolveServer as JHMatrixSolveServer
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import build_hmatrix, halton, make_apply
from repro_torch.serve.runtime import (LaunchPacer, PanelRuntime, pad_panel_width,
                                       panel_width_buckets, width_for)
from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer, _serve_in_panels
from repro_torch.solve import make_solver
from torch_parity_util import export_hmatrix, one_torch_thread, rel_err  # noqa: F401

SIGMA2 = 0.5


def _system(n, r, seed=0):
    rng = np.random.RandomState(seed)
    hm = build_hmatrix(halton(n, 2, device="cpu"), "gaussian", k=16, c_leaf=128,
                       precompute=True, device="cpu")
    return hm, rng.randn(n, r).astype(np.float32)


def _reference_system(n=1024, scale=1.0):
    pts = np.asarray(j_halton(n, 2)) * scale
    jhm = j_build_hmatrix(jnp.asarray(pts), "gaussian", k=8, c_leaf=64, precompute=True)
    return jhm, hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")


def _double(panel):
    return panel * 2.0


def _echo_runtime(n=32, **kw):
    return PanelRuntime(n, kw.pop("max_batch", 8), _double, device="cpu", **kw)


# ---------------------------------------------------------------------------
# parity with repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_panel_width_buckets_match_reference(n_dev):
    for r in range(1, 131):
        if r % n_dev:
            with pytest.raises(ValueError):
                panel_width_buckets(r, n_dev)
            with pytest.raises(ValueError):
                j_panel_width_buckets(r, n_dev)
            continue
        assert panel_width_buckets(r, n_dev) == j_panel_width_buckets(r, n_dev)
    assert [pad_panel_width(r, n_dev) for r in range(0, 140)] == \
        [j_pad_panel_width(r, n_dev) for r in range(0, 140)]


def test_apply_server_matches_reference_server():
    """19 requests: two panels of 8 and a ragged tail of 3 in the 4 bucket."""
    jhm, hm = _reference_system()
    rng = np.random.RandomState(7)
    queries = [rng.randn(1024).astype(np.float32) for _ in range(19)]
    with JHMatrixServer(jhm, max_batch=8, use_pallas=False) as jsrv:
        want = np.stack([np.asarray(z) for z in jsrv.serve(queries)])
    with HMatrixServer(hm, max_batch=8) as srv:
        sync = srv.serve(queries)
        outs = [f.result(timeout=60) for f in srv.serve_async(queries)]
    stats = srv.runtime.stats()                 # after close: every panel counted
    assert len(sync) == len(outs) == 19
    assert rel_err(np.stack(sync), want) <= 1e-4
    for a, b in zip(outs, sync):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
    assert stats["launched_widths"] == [8, 8, 4]
    assert len(stats["pack_s"]) == 3 and min(stats["pack_s"]) >= 0.0
    # panel 1 of serve() is the apply of its 8 columns, bit for bit
    np.testing.assert_array_equal(
        np.stack(sync[:8], axis=1),
        make_apply(hm)(torch.from_numpy(np.stack(queries[:8], axis=1))).numpy())


def test_solve_server_matches_reference_server():
    jhm, hm = _reference_system(scale=16.0)
    f = np.random.RandomState(3).randn(1024, 6).astype(np.float32)
    targets = [f[:, j] for j in range(6)]
    kw = dict(max_batch=4, tol=1e-5, max_iter=200)
    with JHMatrixSolveServer(jhm, SIGMA2, use_pallas=True, **kw) as jsrv:
        want = np.stack([np.asarray(c) for c in jsrv.serve(targets)])
        j_iters = np.concatenate([info.iters_per_column for info in jsrv.last_info])
    with HMatrixSolveServer(hm, SIGMA2, **kw) as srv:
        sync = srv.serve(targets)
        iters = np.concatenate([info.iters_per_column for info in srv.last_info])
        outs = [fut.result(timeout=120) for fut in srv.serve_async(targets)]
    # the 2-wide tail panel: iterations of its 2 real columns
    assert iters.shape == j_iters.shape == (4 + 2,)
    assert np.abs(iters - j_iters).max() <= 1
    np.testing.assert_allclose(np.stack(sync), want, rtol=1e-3, atol=1e-4)
    for a, b in zip(outs, sync):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# width buckets
# ---------------------------------------------------------------------------


def test_panel_width_buckets():
    assert panel_width_buckets(64) == (16, 32, 64)
    assert panel_width_buckets(8) == (2, 4, 8)
    assert panel_width_buckets(4) == (1, 2, 4)
    assert panel_width_buckets(8, n_dev=4) == (4, 8)
    assert panel_width_buckets(4, n_dev=4) == (4,)
    with pytest.raises(ValueError):
        panel_width_buckets(0)
    with pytest.raises(ValueError):
        panel_width_buckets(6, n_dev=4)


def test_width_for():
    assert width_for(1, (1, 2, 4)) == 1
    assert width_for(3, (1, 2, 4)) == 4
    assert width_for(4, (1, 2, 4)) == 4
    with pytest.raises(ValueError):
        width_for(5, (1, 2, 4))


# ---------------------------------------------------------------------------
# futures: order + bit-identity vs the sync path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_queries", [8, 11])
def test_async_matches_sync_bit_identical(n_queries):
    hm, f = _system(600, 11)
    queries = [f[:, j] for j in range(n_queries)]
    with HMatrixServer(hm, max_batch=4) as srv:
        sync = srv.serve(queries)
        outs = [fut.result(timeout=60) for fut in srv.serve_async(queries)]
    assert len(outs) == n_queries
    for j in range(n_queries):
        np.testing.assert_array_equal(outs[j], sync[j])
    tail = n_queries % 4 or 4
    assert list(srv.runtime.stats["launched_widths"]) == \
        [4] * (n_queries // 4) + ([width_for(tail, srv.widths)] if n_queries % 4 else [])
    assert srv.runtime.stats["panels_launched"] == -(-n_queries // 4)


def test_async_solve_server_matches_sync():
    hm, f = _system(600, 6)
    targets = [f[:, j] for j in range(6)]
    with HMatrixSolveServer(hm, SIGMA2, max_batch=4, tol=1e-6, max_iter=400) as srv:
        sync = srv.serve(targets)
        assert len(srv.last_info) == 2
        outs = [fut.result(timeout=120) for fut in srv.serve_async(targets)]
        assert len(srv.last_info) == 4
        for j in range(6):
            np.testing.assert_array_equal(outs[j], sync[j])
        for info in srv.last_info:
            assert info.converged
            assert info.iterations == info.iters_per_column.max()
            assert isinstance(info.iters_per_column, np.ndarray)


def test_lazy_solveinfo_defers_fetch():
    hm, f = _system(512, 3)
    x, info = make_solver(hm, SIGMA2, tol=1e-6, max_iter=400)(f)
    assert info._host is None
    assert "pending" in repr(info)
    assert info._host is None
    assert info.fetch() is info
    assert info._host is not None
    assert isinstance(info.iterations, int)
    assert info.iters_per_column.shape == (3,)
    assert info.residual_norms.shape == (3,)
    assert info.converged
    assert "pending" not in repr(info)


def test_servers_reject_a_mesh():
    """A mesh must be a ``PanelMesh`` (the meshed servers themselves are held
    in ``tests/test_torch_shard.py``)."""
    hm, _ = _system(300, 1)
    with pytest.raises(TypeError, match="PanelMesh"):
        HMatrixServer(hm, max_batch=4, mesh=object())
    with pytest.raises(TypeError, match="PanelMesh"):
        HMatrixSolveServer(hm, SIGMA2, max_batch=4, mesh=object())


def test_runtime_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PanelRuntime(8, 2, _double)
    with pytest.raises(RuntimeError, match="CUDA"):
        _serve_in_panels([np.zeros(8, np.float32)], 8, 2, _double)


# ---------------------------------------------------------------------------
# runtime behaviours: deadline flush, backpressure, validation
# ---------------------------------------------------------------------------


def test_deadline_flush_serves_short_panel():
    with _echo_runtime(deadline_s=0.05) as rt:
        vecs = [np.full(32, j, np.float32) for j in range(3)]
        futures = [rt.submit(v) for v in vecs]
        outs = [f.result(timeout=30) for f in futures]
    for j in range(3):
        np.testing.assert_array_equal(outs[j], vecs[j] * 2.0)
    assert list(rt.stats["launched_widths"]) == [4]


def test_backpressure_caps_queue_depth():
    def slow_launch(panel):
        time.sleep(0.03)
        return _double(panel)

    rt = PanelRuntime(32, 2, slow_launch, max_queue=4, device="cpu")
    vecs = [np.full(32, j, np.float32) for j in range(20)]
    futures = []

    def producer():
        for v in vecs:
            futures.append(rt.submit(v))

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    rt.flush()
    outs = [f.result(timeout=60) for f in futures]
    rt.close()
    for j in range(20):
        np.testing.assert_array_equal(outs[j], vecs[j] * 2.0)
    assert rt.stats["max_queue_depth"] <= 4
    assert rt.stats["backpressure_waits"] > 0
    with pytest.raises(ValueError):
        PanelRuntime(32, 8, lambda p: p, max_queue=4, device="cpu")


def test_submit_validates_and_close_rejects():
    rt = _echo_runtime()
    with pytest.raises(ValueError):
        rt.submit(np.zeros(33, np.float32))
    f = rt.submit(np.ones(32, np.float32))
    rt.close()
    np.testing.assert_array_equal(f.result(timeout=10), np.full(32, 2.0, np.float32))
    with pytest.raises(RuntimeError):
        rt.submit(np.ones(32, np.float32))


def test_close_is_idempotent():
    rt = _echo_runtime()
    f = rt.submit(np.ones(32, np.float32))
    with rt:
        rt.close()
        rt.close()
    rt.close()
    np.testing.assert_array_equal(f.result(timeout=10), np.full(32, 2.0, np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(np.ones(32, np.float32))


def test_stats_snapshot_copies_under_lock():
    with _echo_runtime() as rt:
        futs = [rt.submit(np.ones(32, np.float32)) for _ in range(9)]
        rt.flush()
        [f.result(timeout=30) for f in futs]
        rt.drain()                      # the last panel's stats are in
        snap = rt.stats()
        assert snap["panels_launched"] == 2
        assert isinstance(snap["launched_widths"], list)
        snap["launched_widths"].append(999)
        snap["panels_launched"] = -1
        assert 999 not in rt.stats["launched_widths"]
        assert rt.stats["panels_launched"] == 2


def test_launch_error_propagates_to_futures():
    def broken_launch(panel):
        raise RuntimeError("device on fire")

    rt = PanelRuntime(16, 2, broken_launch, device="cpu")
    f = rt.submit(np.zeros(16, np.float32))
    rt.flush()
    with pytest.raises(RuntimeError, match="device on fire"):
        f.result(timeout=30)
    rt.close()


def test_future_timeout():
    with _echo_runtime() as rt:
        f = rt.submit(np.zeros(32, np.float32))
        with pytest.raises(TimeoutError):
            f.result(timeout=0.05)
        rt.flush()
        f.result(timeout=30)


def test_launch_pacer_fifo_budget():
    """Strict FIFO retirement, never more than ``max_inflight`` outstanding:
    the staging-buffer guarantee rests on it."""
    class FakeDone:
        def __init__(self):
            self.synced = False

        def synchronize(self):
            self.synced = True

        def seconds(self):
            return 0.0

    pacer = LaunchPacer(max_inflight=2)
    a, b, c = FakeDone(), FakeDone(), FakeDone()
    pacer.wait_for_slot()
    pacer.commit(a)
    pacer.wait_for_slot()
    pacer.commit(b)
    assert not a.synced and not b.synced and len(pacer) == 2
    pacer.wait_for_slot()
    assert a.synced and not b.synced and len(pacer) == 1
    pacer.commit(c)
    pacer.wait_for_slot()
    assert b.synced and not c.synced
    with pytest.raises(ValueError):
        LaunchPacer(max_inflight=0)


def test_results_never_alias_the_staging_buffer():
    """A launch that returns its own panel keeps its requests after every
    staging buffer was packed again (the upload copies)."""
    seen = []

    def spy(panel):
        seen.append(panel)
        return panel

    with PanelRuntime(16, 2, spy, max_inflight=2, device="cpu") as rt:
        futs = [rt.submit(np.full(16, j, np.float32)) for j in range(10)]
        rt.drain()
        outs = [f.result(timeout=30) for f in futs]
    for j, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full(16, j, np.float32))
    for k, panel in enumerate(seen):
        np.testing.assert_array_equal(panel.numpy(), np.repeat(
            np.array([[2 * k, 2 * k + 1]], np.float32), 16, axis=0))


# ---------------------------------------------------------------------------
# the sync loop's staging
# ---------------------------------------------------------------------------


def test_empty_load_returns_without_launch():
    def boom(panel):
        raise AssertionError("launch must not run for empty input")

    assert _serve_in_panels([], 64, 4, boom, device="cpu") == []
    hm, _ = _system(512, 1)
    with HMatrixServer(hm, max_batch=4) as srv:
        srv._launch = boom
        assert srv.serve([]) == []
        assert srv.serve_async([]) == []


def test_reused_staging_buffer_rezeroes_pad():
    seen = []

    def spy_launch(panel):
        seen.append(panel.clone())
        return panel

    qs = [np.ones(16, np.float32)] * 4 + [np.full(16, 2.0, np.float32)] * 3
    outs = _serve_in_panels(qs, 16, 4, spy_launch, widths=(1, 2, 4), device="cpu")
    assert len(outs) == 7 and len(seen) == 2
    assert tuple(seen[1].shape) == (16, 4)
    np.testing.assert_array_equal(seen[1][:, 3].numpy(), np.zeros(16))
    np.testing.assert_array_equal(outs[6], np.full(16, 2.0))


def test_tail_panel_uses_width_bucket():
    widths = []
    qs = [np.ones(16, np.float32)] * 5
    _serve_in_panels(qs, 16, 16, lambda p: (widths.append(p.shape[1]), p)[1],
                     widths=(4, 8, 16), device="cpu")
    assert widths == [8]
