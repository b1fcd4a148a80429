"""Port parity: the memory tier (recompression, spill / reload).

The port's plain recompression (``kernels/batched_recompress/ref.py``, the
QR + SVD oracle in PyTorch) is held against ``repro``'s oracle, and the
port's ``recompress_store`` / ``build_hmatrix(recompress_tol=)`` against
``repro``'s.  Tolerances:

* ranks equal, and each block's reconstruction error within ``2 tol`` of
  its Frobenius norm (the bound of ``tests/test_factor_store.py``); the two
  oracles' products within 1e-5 of that norm (another LAPACK, the same
  algorithm);
* the recompressed apply within ``5 tol`` of the flat store's
  (``test_recompress_tol_sweep_error_bound``'s bound);
* per-level widths and rank tables equal, except a block whose float64
  singular value at the cut lies within ``CUT_MARGIN`` (1e-4 sigma_0, fp32
  rounding of the factors) of ``tol sigma_0``: there the two QR + SVD may
  part.  Such blocks are counted, and every difference must be one;
* spill / reload bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import halton as j_halton
from repro.core import recompress_store as j_recompress_store
from repro.kernels.batched_recompress.ref import batched_recompress_ref as j_recompress_ref
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import (RecompressReport, build_hmatrix, build_hmatrix_device,
                              build_hmatrix_device_report, make_apply, recompress_store)
from repro_torch.kernels.batched_recompress.ops import GRAM_TOL_FLOOR, batched_recompress
from repro_torch.kernels.batched_recompress.ref import batched_recompress_ref
from test_build_device import CASES
from torch_parity_util import export_hmatrix, rel_err

CUT_MARGIN = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decaying_factors(rng, b=6, m=48, n=40, k=12):
    """Batched factors with a geometric singular-value decay, as
    ``tests/test_factor_store.py`` makes them."""
    scale = (0.35 ** np.arange(k)).astype(np.float32)
    u = rng.randn(b, m, k).astype(np.float32) * scale
    v = rng.randn(b, n, k).astype(np.float32)
    return u, v


def _products(u, v):
    return np.einsum("bik,bjk->bij", np.asarray(u, np.float64), np.asarray(v, np.float64))


@pytest.mark.parametrize("tol", [1e-1, 1e-2, 1e-3])
def test_recompress_oracle_matches_reference(tol):
    u, v = _decaying_factors(np.random.RandomState(11))
    a0 = _products(u, v)
    scale = np.linalg.norm(a0.reshape(a0.shape[0], -1), axis=1)
    uj, vj, rj = (np.asarray(t) for t in j_recompress_ref(jnp.asarray(u), jnp.asarray(v), tol))
    ut, vt, rt = batched_recompress_ref(torch.from_numpy(u), torch.from_numpy(v), tol)
    assert rt.dtype == torch.int32 and rt.shape == (u.shape[0],)
    np.testing.assert_array_equal(rt.numpy(), rj)
    for uu, vv in ((ut.numpy(), vt.numpy()), (uj, vj)):
        err = np.linalg.norm((_products(uu, vv) - a0).reshape(a0.shape[0], -1), axis=1)
        assert (err <= 2.0 * tol * scale).all()
    diff = np.abs(_products(ut.numpy(), vt.numpy()) - _products(uj, vj)).max(axis=(1, 2))
    assert (diff <= 1e-5 * scale).all()


def test_recompress_dispatch_layout_on_cpu():
    """CPU tensors take the oracle: descending sigma, columns past the rank
    exactly zero in both factors, zero blocks rank 0 and finite."""
    u, v = _decaying_factors(np.random.RandomState(3), b=5)
    u[1] = 0.0
    v[3] = 0.0
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    u2, v2, ranks = batched_recompress(ut, vt, 1e-2)
    want = batched_recompress_ref(ut, vt, 1e-2)
    for got, ref in zip((u2, v2, ranks), want):
        assert torch.equal(got, ref)
    assert ranks[1] == 0 and ranks[3] == 0
    assert bool(torch.isfinite(u2).all()) and bool(torch.isfinite(v2).all())
    for b, r in enumerate(ranks.tolist()):
        assert bool((u2[b, :, r:] == 0).all()) and bool((v2[b, :, r:] == 0).all())
        sig = torch.linalg.vector_norm(u2[b, :, :r].double(), dim=0)   # Qu W S: norms = sigma
        assert bool((sig[1:] <= sig[:-1] * (1 + 1e-6)).all())
    assert GRAM_TOL_FLOOR == 3e-4


def _sigma64(u, v):
    """float64 singular values of U V^T for one block (descending)."""
    _, ru = np.linalg.qr(np.asarray(u, np.float64))
    _, rv = np.linalg.qr(np.asarray(v, np.float64))
    return np.linalg.svd(ru @ rv.T, compute_uv=False)


def _near_cut(u, v, tol) -> bool:
    s = _sigma64(u, v)
    return s[0] > 0 and float(np.abs(s - tol * s[0]).min()) <= CUT_MARGIN * s[0]


@pytest.mark.parametrize("tol", [1e-1, 1e-2, 1e-3])
def test_build_hmatrix_recompress_tol_matches_reference(tol):
    """The port's ``build_hmatrix(recompress_tol=)`` against ``repro``'s at
    ``test_recompress_tol_sweep_error_bound``'s size."""
    pts = np.asarray(j_halton(1200, 2)) * 8.0
    x = np.random.RandomState(11).randn(1200, 2).astype(np.float32)
    flat = build_hmatrix(pts, k=16, c_leaf=128, precompute=True, device="cpu")
    hm = build_hmatrix(pts, k=16, c_leaf=128, precompute=True, recompress_tol=tol,
                       device="cpu")
    jhm = j_build_hmatrix(jnp.asarray(pts), k=16, c_leaf=128, precompute=True,
                          recompress_tol=tol)
    y0 = make_apply(flat)(x).numpy()
    assert rel_err(make_apply(hm)(x).numpy(), y0) <= 5.0 * tol
    assert hm.factors.nbytes()["total"] <= flat.factors.nbytes()["total"]
    assert sorted(hm.factors.keys()) == sorted(jhm.factors.keys())
    differing = near = 0
    for lv in hm.factors.keys():
        mine, ref = hm.factors.rank_table(lv).numpy(), np.asarray(jhm.factors.rank_table(lv))
        u, v = flat.factors[lv]
        for b in np.nonzero(mine != ref)[0]:
            differing += 1
            near += _near_cut(u[b].numpy(), v[b].numpy(), tol)
        if (mine == ref).all():
            assert hm.factors[lv][0].shape[2] == jhm.factors[lv][0].shape[2]
    assert near == differing, f"{differing - near} rank differences away from the cut"


def test_recompress_store_report_bytes_match_reference():
    factory, c_leaf, eta = CASES["halton2d"]
    jhm = j_build_hmatrix(jnp.asarray(factory()), c_leaf=c_leaf, eta=eta, k=16,
                          precompute=True)
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")    # the same factors
    j_report = j_recompress_store(jhm.factors, 1e-2)
    report = recompress_store(hm.factors, 1e-2)
    assert isinstance(report, RecompressReport)
    assert (report.bytes_before, report.bytes_after) == (j_report.bytes_before,
                                                         j_report.bytes_after)
    assert report.per_level_k == {int(lv): tuple(k) for lv, k in j_report.per_level_k.items()}
    assert report.bytes_after == hm.factors.nbytes()["total"] < report.bytes_before
    assert 0.0 < report.ratio < 1.0
    for lv, (k_old, k_new) in report.per_level_k.items():
        assert 1 <= k_new <= k_old
        np.testing.assert_array_equal(hm.factors.rank_table(lv).numpy(),
                                      np.asarray(jhm.factors.rank_table(lv)))


def test_spill_reload_roundtrip_bitwise_and_spilled_apply_raises():
    factory, c_leaf, eta = CASES["halton2d"]
    pts = factory()
    hm = build_hmatrix(pts, c_leaf=c_leaf, eta=eta, k=8, precompute=True,
                       recompress_tol=1e-2, device="cpu")
    x = np.random.RandomState(5).randn(pts.shape[0], 3).astype(np.float32)
    apply_h = make_apply(hm)
    z0 = apply_h(x)
    store = hm.factors
    before = {lv: (u.clone(), v.clone()) for lv, (u, v) in store.items()}
    tables = {lv: t.clone() for lv, t in store.rank_tables.items()}
    freed = store.spill()
    assert store.is_spilled and freed == store.nbytes()["total"] > 0
    assert store.spill() == 0
    with pytest.raises(RuntimeError, match="spilled"):
        apply_h(x)
    with pytest.raises(RuntimeError, match="spilled"):
        recompress_store(store, 1e-1)
    assert store.reload() == freed
    assert not store.is_spilled and store.reload() == 0
    for lv, (u0, v0) in before.items():
        u1, v1 = store[lv]
        assert torch.equal(u0, u1) and torch.equal(v0, v1)
        assert torch.equal(tables[lv], store.rank_table(lv))
    assert torch.equal(apply_h(x), z0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_device_build_recompress_tol_equals_recompressing_its_store(use_kernels):
    factory, c_leaf, eta = CASES["nonpow2-3d"]
    pts = factory()
    hm, report = build_hmatrix_device_report(pts, c_leaf=c_leaf, eta=eta, k=12,
                                             precompute=True, recompress_tol=1e-2,
                                             use_kernels=use_kernels, device="cpu")
    flat = build_hmatrix_device(pts, c_leaf=c_leaf, eta=eta, k=12, precompute=True,
                                use_kernels=use_kernels, device="cpu")
    recompress_store(flat.factors, 1e-2, use_kernels=use_kernels)
    assert report.recompress_s > 0.0
    assert report.total_s >= report.plan_s + report.factors_s + report.recompress_s - 1e-9
    for lv in flat.factors.keys():
        assert torch.equal(hm.factors.rank_table(lv), flat.factors.rank_table(lv))
        for a, b in zip(hm.factors[lv], flat.factors[lv]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# A float32 model of the CUDA kernel's chain (csrc/recompress.cu): the Gram
# Cholesky factors with dropped pivots, the circle-method Jacobi pair order
# with Z taken through the same rotations (the kernel's replay), the transforms
# T_u = X_u (M . keep) and T_v = X_v (Z . keep), held to the QR + SVD
# oracle by chip_smoke.check_recompress_group's criteria.
# ---------------------------------------------------------------------------

TINY = 1e-30


def _pair_order(big_k):
    """The kernel's rounds for K (a power of two) columns, the circle method:
    lane j starts with columns (j, K-1-j); after each round position 0
    stays, s0 moves down a lane, s1 up a lane, the last lane's s1 turns into
    its s0 and lane 1's s0 into lane 0's s1."""
    h = big_k // 2
    s0, s1 = list(range(h)), [big_k - 1 - j for j in range(h)]
    rounds = []
    for _ in range(big_k - 1):
        rounds.append(list(zip(s0, s1)))
        if h > 1:
            s0, s1 = ([s0[0]] + [s0[j + 1] for j in range(1, h - 1)] + [s1[h - 1]],
                      [s0[1]] + [s1[j - 1] for j in range(1, h)])
    return rounds


def _cholesky_dropped(g, jit):
    """The reference's right-looking Cholesky (rank-1 updates) in float32,
    a pivot at or below max(jitter, TINY) dropped (its column zero)."""
    k = g.shape[-1]
    g, low = g.clone(), torch.zeros_like(g)
    floor = jit.clamp(min=TINY)
    for j in range(k):
        d2 = g[:, j, j]
        dinv = torch.where(d2 > floor, 1.0 / torch.sqrt(d2), torch.zeros_like(d2))
        col = g[:, :, j] * dinv[:, None]
        col[:, :j] = 0.0
        low[:, :, j] = col
        g = g - col[:, :, None] * col[:, None, :]
    return low


def _inv_upper(low):
    """X = (L^T)^-1 by k-step back substitution; a zero pivot gives a zero
    row and column of X."""
    b, k, _ = low.shape
    r = low.transpose(1, 2)
    y = torch.eye(k).expand(b, k, k).clone()
    for i in range(k - 1, -1, -1):
        dd = r[:, i, i]
        d = torch.where(dd.abs() > TINY, dd, torch.full_like(dd, TINY))
        xi = torch.where((dd != 0)[:, None], y[:, i, :] / d[:, None], torch.zeros_like(y[:, i]))
        y[:, :i, :] -= r[:, :i, i:i + 1] * xi[:, None, :]
        y[:, i, :] = xi
    return y


def _kernel_model(u, v, tol):
    """float32 model of csrc/recompress.cu -> (u2, v2, ranks, sweeps)."""
    b, _, k = u.shape
    big_k = max(2, 1 << (k - 1).bit_length())
    gu, gv = u.transpose(1, 2) @ u, v.transpose(1, 2) @ v
    ju = (1e-7 / k) * gu.diagonal(dim1=1, dim2=2).sum(1)
    jv = (1e-7 / k) * gv.diagonal(dim1=1, dim2=2).sum(1)
    eye = torch.eye(k)
    lu = _cholesky_dropped(gu + ju[:, None, None] * eye, ju)
    lv = _cholesky_dropped(gv + jv[:, None, None] * eye, jv)
    mm = torch.zeros(b, big_k, big_k)
    mm[:, :k, :k] = lu.transpose(1, 2) @ lv
    zz = torch.eye(big_k).expand(b, big_k, big_k).clone()
    active = torch.ones(b, dtype=torch.bool)
    sweeps = torch.zeros(b, dtype=torch.int32)
    rounds = _pair_order(big_k)
    for _ in range(8):
        rotated = torch.zeros(b, dtype=torch.bool)
        for pairs in rounds:
            p = torch.tensor([a for a, _ in pairs])
            q = torch.tensor([c for _, c in pairs])
            mp, mq = mm[:, :, p], mm[:, :, q]
            app, aqq, apq = (mp * mp).sum(1), (mq * mq).sum(1), (mp * mq).sum(1)
            rot = (apq.abs() > TINY) & active[:, None]
            tau = (aqq - app) / (2.0 * torch.where(rot, apq, torch.ones_like(apq)))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            c = torch.where(rot, 1.0 / torch.sqrt(1.0 + t * t), torch.ones_like(t))
            s = torch.where(rot, c * t, torch.zeros_like(t))
            mm[:, :, p] = c[:, None] * mp - s[:, None] * mq
            mm[:, :, q] = s[:, None] * mp + c[:, None] * mq
            zp, zq = zz[:, :, p], zz[:, :, q]
            zz[:, :, p] = c[:, None] * zp - s[:, None] * zq
            zz[:, :, q] = s[:, None] * zp + c[:, None] * zq
            rotated |= rot.any(1)
        sweeps += active.to(torch.int32)
        active &= rotated
        if not bool(active.any()):
            break
    mm = mm[:, :k, :k]
    sig = torch.sqrt((mm * mm).sum(1))
    keep = sig > tol * sig.amax(1, keepdim=True)
    key = torch.where(keep, sig, torch.zeros_like(sig))
    t_u = _inv_upper(lu) @ (mm * keep[:, None, :])
    t_v = _inv_upper(lv) @ (zz[:, :k, :k] * keep[:, None, :])
    order = torch.argsort(-key, dim=1, stable=True)[:, None, :].expand(-1, k, -1)
    return (u @ torch.gather(t_u, 2, order), v @ torch.gather(t_v, 2, order),
            keep.sum(1).to(torch.int32), sweeps)


def _blocks(kind, b, m, k, seed):
    """Decaying blocks, rank-deficient H-LU concatenations [u | -u C],
    [w | x] (U's second half in the span of its first), or a mix of those
    with all-zero blocks.  The deficient blocks' nonzero singular values
    stay within the Gram route's fp32 resolution (~3e-4 of sigma_0), as
    H-LU's do: below it the route parts from the QR + SVD oracle (the
    parent kernel's chain as much as this one's)."""
    rng = np.random.RandomState(seed)
    if kind == "decaying":
        return _decaying_factors(rng, b, m, m, k)
    half = k // 2
    u1 = rng.randn(b, m, half)
    c = np.linalg.qr(rng.randn(b, k - half, k - half))[0][:, :half]
    u = np.concatenate([u1, -u1 @ c], axis=2).astype(np.float32)
    v = rng.randn(b, m, k).astype(np.float32)
    if kind == "mixed":
        du, dv = _decaying_factors(rng, b, m, m, k)
        u[1::3], v[1::3] = du[1::3], dv[1::3]
        u[::3] = 0.0
    return u, v


@pytest.mark.parametrize("big_k", [2, 4, 8, 16, 32, 64])
def test_recompress_kernel_pair_order_meets_every_pair_once(big_k):
    rounds = _pair_order(big_k)
    assert len(rounds) == big_k - 1
    met = set()
    for pairs in rounds:
        assert sorted(c for pair in pairs for c in pair) == list(range(big_k))
        met |= {tuple(sorted(pair)) for pair in pairs}
    assert len(met) == big_k * (big_k - 1) // 2


@pytest.mark.parametrize("kind,b,m,k,tol", [("decaying", 6, 256, 64, 1e-3),
                                            ("decaying", 4, 2048, 16, 1e-2),
                                            ("deficient", 6, 256, 64, 1e-3),
                                            ("mixed", 6, 256, 64, 1e-3),
                                            ("mixed", 9, 70, 7, 1e-1),
                                            ("decaying", 3, 50, 1, 1e-2)])
def test_recompress_kernel_model_matches_the_oracle(kind, b, m, k, tol):
    u, v = (torch.from_numpy(a) for a in _blocks(kind, b, m, k, seed=m + k))
    u2, v2, ranks, sweeps = _kernel_model(u, v, tol)
    ur, vr, rr = batched_recompress_ref(u, v, tol)
    a0 = _products(u.numpy(), v.numpy())
    norm = np.linalg.norm(a0, axis=(1, 2))
    safe = np.where(norm > 0, norm, 1.0)
    rel = np.linalg.norm(_products(u2.numpy(), v2.numpy()) - a0, axis=(1, 2)) / safe
    rel_ref = np.linalg.norm(_products(ur.numpy(), vr.numpy()) - a0, axis=(1, 2)) / safe
    same = (ranks == rr).numpy()
    assert (rel <= 2 * tol).all(), rel
    assert (np.abs(rel - rel_ref)[same] <= 0.1 * tol).all()
    assert bool(((sweeps >= 1) & (sweeps <= 8)).all())
    for blk, r in enumerate(ranks.tolist()):
        assert bool((u2[blk, :, r:] == 0).all()) and bool((v2[blk, :, r:] == 0).all())
    zero = norm == 0
    assert (ranks.numpy()[zero] == 0).all()
