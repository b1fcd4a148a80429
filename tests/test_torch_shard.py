"""Sharded execution (``repro_torch.parallel.hshard``) against the
single-device executors, on a CPU mesh that names one device four times.

``tests/test_shard.py`` case for case, with its bounds: the sharded apply
within 1e-5 of ``make_apply`` (both shardings, P and NP mode, R = 8, 5, 1),
the vector contract, the sharded solver within 1e-5 with the same trip
count and per-column counts, the ragged and single-vector solves within
rtol 1e-3 / atol 1e-4, and the meshed servers.  Then parity with
``repro``'s single-device results on its own H-matrix (carried over by
``convert.hmatrix_from_arrays``): the apply within 1e-4 and the solve's
per-column counts within one, as ``tests/test_torch_hmatrix.py`` and
``tests/test_torch_solve.py`` hold the single-device port.  The forced
multi-device runs of ``repro`` are not used as oracles (ROADMAP §3, fault
11).  Last, the mesh itself, the refusals, the meshed tenants, and the
single-device solve's bits across the split of ``pcg_tree_ordered``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.core import make_apply as j_make_apply
from repro.parallel.hshard import pad_panel_width as j_pad_panel_width
from repro.solve import make_solver as j_make_solver
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import build_hmatrix, halton, make_apply
from repro_torch.core.clustering import permute_to_tree
from repro_torch.core.hmatrix import apply_in_tree_order
from repro_torch.harith.hlu import HLUFactors, hlu_solve_panels
from repro_torch.parallel import (PanelMesh, make_panel_mesh, make_sharded_apply,
                                  make_sharded_solver, map_shards, mesh_device_count,
                                  mesh_panel, pad_panel_width)
from repro_torch.parallel.hshard import share_bounds
from repro_torch.serve.step import HMatrixServer, HMatrixSolveServer
from repro_torch.serve.tenancy import MultiTenantRuntime, apply_tenant, solve_tenant
from repro_torch.solve import build_preconditioner, make_solver, pcg_tree_ordered
from torch_parity_util import export_hmatrix, one_torch_thread, rel_err  # noqa: F401

N_DEV = 4
SIGMA2 = 0.5


@pytest.fixture(scope="module")
def mesh():
    return make_panel_mesh(devices=("cpu",) * N_DEV)


def _system(n, r, seed=0, precompute=True):
    hm = build_hmatrix(halton(n, 2, device="cpu"), "gaussian", k=16, c_leaf=128,
                       precompute=precompute, device="cpu")
    return hm, torch.from_numpy(np.random.RandomState(seed).randn(n, r).astype(np.float32))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / (1e-30 + torch.linalg.vector_norm(b)))


# ---------------------------------------------------------------------------
# tests/test_shard.py, case for case
# ---------------------------------------------------------------------------


def test_pad_panel_width():
    assert pad_panel_width(8, 4) == 8
    assert pad_panel_width(5, 4) == 8
    assert pad_panel_width(1, 4) == 4
    assert pad_panel_width(0, 4) == 4  # empty panels still shard
    assert all(pad_panel_width(r, d) == j_pad_panel_width(r, d)
               for r in range(0, 40) for d in (1, 2, 3, 4, 8))


@pytest.mark.parametrize("shard", ["columns", "rows"])
@pytest.mark.parametrize("r", [8, 5, 1])
@pytest.mark.parametrize("precompute", [True, False])
def test_sharded_apply_matches_single_device(shard, r, precompute, mesh):
    hm, x = _system(700, r, seed=r, precompute=precompute)
    z0 = make_apply(hm)(x)
    zs = make_apply(hm, mesh=mesh, shard=shard)(x)
    assert zs.shape == z0.shape and zs.device == hm.device
    assert _rel(zs, z0) < 1e-5, (shard, r, precompute)


def test_sharded_apply_vector_contract(mesh):
    hm, x = _system(700, 1)
    for shard in ("columns", "rows"):
        apply_s = make_sharded_apply(hm, mesh, shard=shard)
        z_vec = apply_s(x[:, 0])
        assert z_vec.shape == (700,)
        torch.testing.assert_close(z_vec, apply_s(x)[:, 0], rtol=1e-5, atol=1e-6)
        assert apply_s(torch.zeros(700, 0)).shape == (700, 0)
    with pytest.raises(ValueError):
        make_sharded_apply(hm, mesh)(torch.zeros(701))
    with pytest.raises(ValueError):
        make_sharded_apply(hm, mesh, shard="diagonal")


@pytest.mark.parametrize("precondition", [True, False])
def test_sharded_solver_matches_single_device(precondition, mesh):
    """An evenly divisible panel: each column's arithmetic is the
    single-device solver's, and the lockstep trips give its trip count."""
    hm, f = _system(700, 8)
    kw = dict(tol=1e-6, max_iter=600, precondition=precondition)
    c0, info0 = make_solver(hm, SIGMA2, **kw)(f)
    cs, infos = make_solver(hm, SIGMA2, mesh=mesh, **kw)(f)
    assert infos.converged
    assert _rel(cs, c0) < 1e-5
    assert infos.iterations == info0.iterations == int(infos.iters_per_column.max())
    np.testing.assert_array_equal(infos.iters_per_column, info0.iters_per_column)


def test_sharded_solver_ragged_panel(mesh):
    """R = 3 on 4 shards: the zero pad column starts converged."""
    hm, f = _system(700, 3)
    kw = dict(tol=1e-6, max_iter=600)
    c0, _ = make_solver(hm, SIGMA2, **kw)(f)
    cs, infos = make_sharded_solver(hm, SIGMA2, mesh, **kw)(f)
    assert cs.shape == (700, 3)
    assert infos.iters_per_column.shape == (3,) and infos.residual_norms.shape == (3,)
    assert infos.converged and infos.iterations == int(infos.iters_per_column.max())
    torch.testing.assert_close(cs, c0, rtol=1e-3, atol=1e-4)


def test_sharded_solver_single_vector(mesh):
    hm, f = _system(512, 1)
    c_vec, info = make_sharded_solver(hm, SIGMA2, mesh, tol=1e-6, max_iter=600)(f[:, 0])
    assert c_vec.shape == (512,)
    assert info.converged and info.iters_per_column.shape == (1,)
    c0, _ = make_solver(hm, SIGMA2, tol=1e-6, max_iter=600)(f[:, 0])
    torch.testing.assert_close(c_vec, c0, rtol=1e-3, atol=1e-4)


def test_meshed_servers_match_unmeshed(mesh):
    """The apply server's row shards take its width as it is, the solve
    server's width rounds up to the shard count, a load wider than the panel
    splits, and the results match the single-device executors."""
    hm, f = _system(512, 8)
    srv = HMatrixServer(hm, max_batch=6, mesh=mesh)
    assert srv.max_batch == 6 and srv.widths == HMatrixServer(hm, max_batch=6).widths
    queries = [f[:, j] for j in range(8)] + [f[:, 0], f[:, 1], f[:, 2]]
    outs = srv.serve(queries)                       # 11 queries > one panel
    assert len(outs) == len(queries)
    base = make_apply(hm)
    for q, z in zip(queries, outs):
        np.testing.assert_allclose(z, base(q).numpy(), rtol=1e-4, atol=1e-5)
    async_outs = [fut.result(timeout=120) for fut in srv.serve_async(queries)]
    assert all(np.array_equal(a, b) for a, b in zip(async_outs, outs))
    srv.close()

    ssrv = HMatrixSolveServer(hm, SIGMA2, max_batch=3, tol=1e-6, max_iter=600, mesh=mesh)
    assert ssrv.max_batch == 4 and all(w % N_DEV == 0 for w in ssrv.widths)
    souts = ssrv.serve([f[:, j] for j in range(6)])
    assert len(souts) == 6 and len(ssrv.last_info) == 2
    solver = make_solver(hm, SIGMA2, tol=1e-6, max_iter=600)
    for j, cj in enumerate(souts):
        ref, _ = solver(f[:, j])
        np.testing.assert_allclose(cj, ref.numpy(), rtol=1e-2, atol=1e-4)
    ssrv.close()


def test_meshed_server_nan_relaunch_runs_the_sharded_launch(mesh):
    """Under injected NaN and transient faults a meshed server's one counted
    relaunch re-runs its own launch, the sharded apply: the chaos-free bits."""
    from repro_torch.serve.faults import ResiliencePolicy
    hm, f = _system(700, 12, seed=6)
    queries = [f[:, j].numpy() for j in range(12)]
    with HMatrixServer(hm, max_batch=3, mesh=mesh, chaos="") as clean_srv:
        clean = clean_srv.serve(queries)
    with HMatrixServer(hm, max_batch=3, mesh=mesh, chaos="transient=0.3:1,nan=0.5,seed=7",
                       resilience=ResiliencePolicy(validate_outputs=True)) as srv:
        assert srv.max_batch == 3
        outs = [fut.result(timeout=120) for fut in srv.serve_async(queries)]
    stats = srv.runtime.stats()
    for a, b in zip(clean, outs):
        np.testing.assert_array_equal(a, b)
    assert stats["faults_injected"]["nan"] >= 1
    assert stats["fallback_launches"] == stats["faults_injected"]["nan"]
    assert stats["panel_failures"] == 0


# ---------------------------------------------------------------------------
# parity with repro's single-device results
# ---------------------------------------------------------------------------


def _reference_system(n, scale, r, seed, precompute=True):
    pts = np.asarray(j_halton(n, 2)) * scale
    jhm = j_build_hmatrix(jnp.asarray(pts), "gaussian", k=8, c_leaf=64, precompute=precompute)
    f = np.random.RandomState(seed).randn(n, r).astype(np.float32)
    return jhm, hmatrix_from_arrays(export_hmatrix(jhm), device="cpu"), f


@pytest.mark.parametrize("shard", ["columns", "rows"])
@pytest.mark.parametrize("r", [8, 1])
def test_sharded_apply_matches_reference(shard, r, mesh):
    jhm, hm, x = _reference_system(700, 1.0, r, seed=20 + r)
    want = np.asarray(j_make_apply(jhm, use_pallas=True)(jnp.asarray(x)))
    got = make_apply(hm, mesh=mesh, shard=shard)(x).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4


def test_sharded_solver_matches_reference(mesh):
    """``tests/test_torch_solve.py``'s system: the reference's kernel route
    (Pallas in interpret mode), iterations per column within one."""
    jhm, hm, f = _reference_system(512, 16.0, 8, seed=512)
    kw = dict(tol=1e-5, max_iter=200)
    c_j, info_j = j_make_solver(jhm, SIGMA2, use_pallas=True, **kw)(jnp.asarray(f))
    c_t, info_t = make_solver(hm, SIGMA2, mesh=mesh, **kw)(torch.from_numpy(f))
    assert info_j.converged and info_t.converged
    assert np.abs(info_t.iters_per_column - info_j.iters_per_column).max() <= 1
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the mesh, the row shares, and what is refused
# ---------------------------------------------------------------------------


def test_panel_mesh_axes_and_shards(mesh):
    assert mesh.axis_names == ("data",)
    assert mesh.distinct_devices == (torch.device("cpu"),)
    assert mesh_device_count(mesh) == N_DEV and mesh_device_count(None) == 1
    assert mesh_panel(6, mesh) == (8, N_DEV) and mesh_panel(6, None) == (6, 1)
    with pytest.raises(ValueError):
        mesh_panel(0, mesh)
    with pytest.raises(TypeError, match="PanelMesh"):
        mesh_device_count(("cpu",) * N_DEV)
    outs = map_shards(mesh, lambda i, dev, a, b: (i, dev.type, f"{a}{b}"), [1, 2, 3, 4], "abcd")
    assert outs == [(0, "cpu", "1a"), (1, "cpu", "2b"), (2, "cpu", "3c"), (3, "cpu", "4d")]
    with pytest.raises(ValueError):
        PanelMesh(())


def test_row_shares_are_contiguous_and_ragged():
    for n_blocks in (0, 1, 3, 4, 9, 130):
        b = share_bounds(n_blocks, N_DEV)
        sizes = np.diff(b)
        assert b[0] == 0 and b[-1] == n_blocks and sizes.max() - sizes.min() <= 1
        assert list(sizes) == sorted(sizes, reverse=True)


def test_make_panel_mesh_needs_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_panel_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_panel_mesh(2)
    assert make_panel_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_panel_mesh(3, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_panel_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="2 visible"):
        make_panel_mesh(3)            # never shrunk quietly


def test_spilled_store_and_hlu_with_a_mesh_raise(mesh):
    hm, x = _system(700, 4)
    assert hm.factors.nbytes()["total"] > 0
    apply_s = make_apply(hm, mesh=mesh)            # captures the store now
    z0 = apply_s(x)
    hm.factors.spill()
    try:
        for shard in ("columns", "rows"):
            with pytest.raises(RuntimeError, match="spilled"):
                make_apply(hm, mesh=mesh, shard=shard)
        with pytest.raises(RuntimeError, match="spilled"):
            make_solver(hm, SIGMA2, mesh=mesh)
        assert torch.equal(apply_s(x), z0)         # the captured store serves on
    finally:
        hm.factors.reload()
    with pytest.raises(ValueError, match="single-device"):
        make_solver(hm, SIGMA2, mesh=mesh, precond="hlu")
    with pytest.raises(TypeError, match="PanelMesh"):
        make_sharded_solver(hm, SIGMA2, mesh=("cpu",) * 4)


def test_sharded_applies_and_solves_are_bit_identical_run_to_run(mesh):
    hm, x = _system(700, 5)
    for shard in ("columns", "rows"):
        apply_s = make_apply(hm, mesh=mesh, shard=shard)
        assert torch.equal(apply_s(x), apply_s(x))
    solve = make_solver(hm, SIGMA2, tol=1e-6, max_iter=600, mesh=mesh)
    (c1, i1), (c2, i2) = solve(x), solve(x)
    assert torch.equal(c1, c2)
    np.testing.assert_array_equal(i1.iters_per_column, i2.iters_per_column)


def test_meshed_tenants_match_dedicated_servers(mesh):
    """``tests/test_tenancy.py``'s meshed case: a solve tenant's width
    buckets stay multiples of the shard count, and results are bit-identical
    to each tenant's own meshed server; meshed tenants stay out of the
    memory tier."""
    hm, f = _system(512, 8, seed=4)
    with HMatrixServer(hm, max_batch=6, mesh=mesh) as srv, \
            HMatrixSolveServer(hm, SIGMA2, max_batch=4, tol=1e-6, max_iter=400,
                               mesh=mesh) as ssrv:
        queries = [f[:, j].numpy() for j in range(7)]          # ragged
        targets = [f[:, j].numpy() for j in range(5)]          # ragged
        ded_q = srv.serve(queries)
        ded_t = ssrv.serve(targets)
        with MultiTenantRuntime() as mtr:
            tq = mtr.add_tenant("apply", srv)
            tt = mtr.add_tenant("solve", ssrv)
            assert tq.widths == srv.widths and all(w % N_DEV == 0 for w in tt.widths)
            fq = [tq.submit(q) for q in queries]
            ft = [tt.submit(t) for t in targets]
            mtr.flush()
            for fut, want in zip(fq + ft, ded_q + ded_t):
                np.testing.assert_array_equal(fut.result(timeout=240), want)
    hm, _ = _system(700, 1)                         # a P-mode store with factors
    spec = apply_tenant(hm, max_batch=6, mesh=mesh)
    assert (spec.max_batch, spec.n_dev, spec.store) == (6, 1, None)
    spec = solve_tenant(hm, SIGMA2, max_batch=3, mesh=mesh)
    assert (spec.max_batch, spec.n_dev, spec.store) == (4, N_DEV, None)
    spec = apply_tenant(hm, max_batch=6)
    assert (spec.max_batch, spec.n_dev, spec.store) == (6, 1, hm.factors)


# ---------------------------------------------------------------------------
# the single-device solve across the split of pcg_tree_ordered
# ---------------------------------------------------------------------------


def _pcg_before_split(tree, plan, kernel, k, use_kernels, sigma2, tol2, max_iter, points,
                      factors, groups, chol, b_pad):
    """``pcg_tree_ordered`` as it was before its split into init and step."""
    n, n_pad = tree.n, tree.n_pad
    c = plan.c_leaf
    n_leaf = n_pad // c
    r_width = b_pad.shape[1]
    pad_rows = (torch.arange(n_pad, device=b_pad.device) < n)[:, None] \
        if n_pad > n else None
    zero = torch.zeros((), dtype=b_pad.dtype, device=b_pad.device)

    def _mask(v):
        return v if pad_rows is None else torch.where(pad_rows, v, zero)

    def apply_op(v):
        z = apply_in_tree_order(tree, plan, kernel, k, use_kernels, points, factors,
                                groups, v)
        return _mask(z + sigma2 * v)

    def prec(r):
        if chol is None:
            return r
        if isinstance(chol, HLUFactors):
            return _mask(hlu_solve_panels(chol, r))
        from repro_torch.kernels.batched_block_solve.ops import batched_block_cholesky_solve
        return _mask(batched_block_cholesky_solve(chol, r.reshape(n_leaf, c, r_width))
                     .reshape(n_pad, r_width))

    r = b_pad
    p = prec(r)
    rr = (r * r).sum(0)
    rs = (r * p).sum(0)
    active = rr > tol2
    x = torch.zeros_like(b_pad)
    iters_col = torch.zeros(r_width, dtype=torch.int32, device=b_pad.device)
    it = 0
    one = torch.ones((), dtype=b_pad.dtype, device=b_pad.device)
    while it < max_iter and bool(active.any()):
        ap = apply_op(p)
        den = (p * ap).sum(0)
        ok = active & (den > 0)
        alpha = torch.where(ok, rs / torch.where(ok, den, one), zero)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rr_new = torch.where(active, (r * r).sum(0), rr)
        z = prec(r)
        rs_new = (r * z).sum(0)
        still = active & (rr_new > tol2)
        beta = torch.where(still, rs_new / torch.where(active, rs, one), zero)
        p = torch.where(still[None, :], z + beta[None, :] * p, p)
        rs = torch.where(still, rs_new, rs)
        iters_col = torch.where(active, torch.full_like(iters_col, it + 1), iters_col)
        rr, active = rr_new, still
        it += 1
    return x, it, iters_col, rr


@pytest.mark.parametrize("precondition", [True, False])
def test_single_device_solve_bits_unchanged_by_the_split(precondition):
    hm, f = _system(700, 5, seed=9)
    tree = hm.tree
    chol = build_preconditioner(hm, SIGMA2) if precondition else None
    args = (tree, hm.plan, hm.kernel, hm.k, True, SIGMA2, 1e-12, 600, tree.points, hm.factors,
            hm.groups, chol, permute_to_tree(tree, f))
    want = _pcg_before_split(*args)
    got = pcg_tree_ordered(*args)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    c, info = make_solver(hm, SIGMA2, tol=1e-6, max_iter=600, precondition=precondition)(f)
    assert info.iterations == want[1]
    np.testing.assert_array_equal(info.iters_per_column, want[2].numpy())


@pytest.mark.parametrize("shard", ["columns", "rows"])
def test_axis_selects_the_shards_of_a_two_axis_mesh(shard, mesh):
    """``axis=``, ``repro``'s argument: by default every axis, flattened in
    row-major order (a (2, 2) mesh gives the bits of the one-axis mesh of
    four); one axis shards over its devices alone."""
    hm, x = _system(700, 8, seed=11)
    two = PanelMesh(("cpu",) * N_DEV, ("data", "model"), (2, 2))
    assert mesh_device_count(two) == N_DEV and mesh_device_count(two, "model") == 2
    assert mesh_device_count(mesh, None) == N_DEV
    z1 = make_sharded_apply(hm, mesh, shard=shard)(x)
    assert torch.equal(make_sharded_apply(hm, two, shard=shard)(x), z1)
    assert torch.equal(make_sharded_apply(hm, two, shard=shard, axis=("data", "model"))(x), z1)
    z2 = make_sharded_apply(hm, make_panel_mesh(devices=("cpu",) * 2), shard=shard)(x)
    assert torch.equal(make_sharded_apply(hm, two, shard=shard, axis="model")(x), z2)
    with pytest.raises(ValueError, match="not in mesh axes"):
        make_sharded_apply(hm, two, shard=shard, axis="pod")
    if shard == "columns":
        c1, i1 = make_sharded_solver(hm, SIGMA2, mesh, tol=1e-5)(x)
        c2, i2 = make_sharded_solver(hm, SIGMA2, two, tol=1e-5)(x)
        assert torch.equal(c1, c2)
        assert np.array_equal(i1.iters_per_column, i2.iters_per_column)
