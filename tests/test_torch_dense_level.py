"""Port parity: the dense leaves read in place (``batched_kernel_matmat_level``).

The level entry takes the tree-ordered points and padded panel with leaf
ids, as the apply holds them, instead of gathered (B, C, d) and (B, C, R)
copies.  On the CPU its plain version gathers and calls the gathered plain
version, so:

* it is held against ``repro``'s Pallas ``batched_kernel_matmat_t`` (and
  ``batched_kernel_matvec_t``) in interpret mode on the gathered inputs,
  relative (Frobenius) error 1e-5 (float32, another summation order);
* ``_dense_apply_points`` through it equals, bit for bit, the gathered route
  it replaced (the same plain product on the same gathered operands).

On the card the level entry and the gathered entry run the same CUDA code
(``tests/test_torch_cuda.py``).  The kernel's route is a function of the
panel's width alone (``dense_route``): narrow up to 8 columns, wide above,
and a launch adds to the wide route's count exactly when it takes it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_dense_matvec.kernel import (batched_kernel_matmat_t,
                                                       batched_kernel_matvec_t)
from repro_torch import _build
from repro_torch.core import build_hmatrix
from repro_torch.core.clustering import permute_to_tree
from repro_torch.core.hmatrix import _dense_apply_points, _scatter_rows
from repro_torch.kernels.batched_dense_matvec import kernel as dense_kernel
from repro_torch.kernels.batched_dense_matvec.ops import (batched_kernel_matmat,
                                                          batched_kernel_matmat_level,
                                                          batched_kernel_matvec,
                                                          batched_kernel_matvec_level)
from repro_torch.kernels.batched_dense_matvec.ref import (batched_kernel_matmat_level_ref,
                                                          batched_kernel_matvec_level_ref)
from torch_parity_util import one_torch_thread  # noqa: F401


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _level_inputs(seed, d, r, n_leaf=6, c=48):
    rng = np.random.RandomState(seed)
    points = (rng.rand(n_leaf * c, d) * 2).astype(np.float32)
    x_pad = rng.randn(n_leaf * c, r).astype(np.float32)
    # repeated and unordered leaf ids, as a dense group holds them
    rows = np.array([4, 0, 4, 2, 5, 1, 4], np.int64)
    cols = np.array([1, 0, 5, 2, 5, 3, 0], np.int64)
    return points, x_pad, rows, cols, c


def _gathered(points, x_pad, rows, cols, c):
    leaf = points.reshape(-1, c, points.shape[1])
    return leaf[rows], leaf[cols], x_pad.reshape(-1, c, x_pad.shape[1])[cols]


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("r", [1, 8])
def test_level_ref_matches_pallas_on_gathered_inputs(kernel, d, r):
    points, x_pad, rows, cols, c = _level_inputs(100 + 10 * d + r, d, r)
    g_rows, g_cols, g_x = _gathered(points, x_pad, rows, cols, c)
    want = np.asarray(batched_kernel_matmat_t(
        jnp.asarray(np.swapaxes(g_rows, 1, 2)), jnp.asarray(np.swapaxes(g_cols, 1, 2)),
        jnp.asarray(g_x), kernel, interpret=True))
    args = (torch.from_numpy(points), torch.from_numpy(rows), torch.from_numpy(cols))
    got = batched_kernel_matmat_level_ref(*args, torch.from_numpy(x_pad), c, kernel).numpy()
    assert got.shape == (rows.shape[0], c, r)
    assert _rel(got, want) <= 1e-5
    # the dispatcher takes the plain version for CPU tensors
    assert np.array_equal(batched_kernel_matmat_level(*args, torch.from_numpy(x_pad), c,
                                                      kernel).numpy(), got)
    if r == 1:
        want_v = np.asarray(batched_kernel_matvec_t(
            jnp.asarray(np.swapaxes(g_rows, 1, 2)), jnp.asarray(np.swapaxes(g_cols, 1, 2)),
            jnp.asarray(g_x[:, :, 0]), kernel, interpret=True))
        got_v = batched_kernel_matvec_level(*args, torch.from_numpy(x_pad[:, 0]), c,
                                            kernel).numpy()
        assert got_v.shape == (rows.shape[0], c)
        assert _rel(got_v, want_v) <= 1e-5


@pytest.mark.parametrize("r", [1, 8])
def test_level_ref_equals_the_gathered_plain_version(r):
    points, x_pad, rows, cols, c = _level_inputs(7 + r, 2, r)
    g = [torch.from_numpy(a) for a in _gathered(points, x_pad, rows, cols, c)]
    args = (torch.from_numpy(points), torch.from_numpy(rows), torch.from_numpy(cols))
    assert torch.equal(batched_kernel_matmat_level_ref(*args, torch.from_numpy(x_pad), c),
                       batched_kernel_matmat(*g))
    if r == 1:
        assert torch.equal(batched_kernel_matvec_level_ref(*args, torch.from_numpy(x_pad[:, 0]),
                                                           c),
                           batched_kernel_matvec(g[0], g[1], g[2][:, :, 0]))


def _gathered_route(hm, x_pad, z_pad):
    """The dense-leaf route before the level entry: gather the leaves'
    points and panel slices, then the gathered dispatchers."""
    g, c = hm.groups["dense"], hm.plan.c_leaf
    r = x_pad.shape[1]
    pts = hm.tree.points.reshape(hm.plan.n_pad // c, c, -1)
    x_blk = x_pad.reshape(-1, c, r)[g.cols]
    if r == 1:
        y = batched_kernel_matvec(pts[g.rows], pts[g.cols], x_blk[:, :, 0],
                                  hm.kernel_name)[:, :, None]
    else:
        y = batched_kernel_matmat(pts[g.rows], pts[g.cols], x_blk, hm.kernel_name)
    return _scatter_rows(z_pad, y, g)


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("r", [1, 8])
def test_dense_apply_points_equals_the_gathered_route(kernel, r):
    pts = np.random.RandomState(3).rand(2000, 2).astype(np.float32)
    hm = build_hmatrix(pts, kernel, k=8, c_leaf=128, device="cpu")
    x = torch.from_numpy(np.random.RandomState(4 + r).randn(2000, r).astype(np.float32))
    x_pad = permute_to_tree(hm.tree, x)
    want = _gathered_route(hm, x_pad, torch.zeros_like(x_pad))
    for use_kernels in (True, False):
        got = _dense_apply_points(hm.tree.points, hm.plan, hm.kernel, hm.groups["dense"], x_pad,
                                  torch.zeros_like(x_pad), use_kernels)
        assert torch.equal(got, want)


@pytest.mark.parametrize("r,route", [(1, "narrow"), (8, "narrow"), (9, "wide"), (16, "wide"),
                                     (64, "wide"), (65, "wide")])
def test_dense_route_splits_at_eight_columns(r, route):
    assert dense_kernel.dense_route(r) == route


@pytest.mark.parametrize("r", [1, 8, 9, 13, 16, 27, 32, 64, 80])
def test_dense_launch_counts_the_wide_route(r, monkeypatch):
    monkeypatch.setitem(_build.LAUNCHES, "batched_kernel_matmat", 0)
    monkeypatch.setitem(_build.LAUNCHES, "batched_kernel_matmat_wide", 0)
    dense_kernel._count_launch("batched_kernel_matmat", r)
    assert _build.LAUNCHES["batched_kernel_matmat"] == 1
    assert _build.LAUNCHES["batched_kernel_matmat_wide"] == (r > 8)
