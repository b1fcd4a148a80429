"""Port parity of the low-rank apply's level entry (kernel #4, ``batched_lowrank_matmat_level``).

The level entry takes the tree-ordered panels and a level group's
``BlockGroup`` instead of gathered (B, n, R) slices, and adds each row
cluster's blocks into Z itself.  On the CPU its plain version gathers,
calls ``batched_lowrank_matmat_ref`` and scatters with ``_scatter_rows``, so:

* it equals that route bit for bit (row clusters with several blocks and
  pad slots; k in {1, 3, 16}; R in {1, 8}; and a panel with k * R > 1024,
  which the kernel takes in column chunks);
* the port's CPU apply gives the same bits as before the level entry;
* a float32 model of the CUDA kernel's summation order (``csrc/lowrank_matmat.cu``:
  row lanes, xor shuffles, warps, splits in order, then U T as chains over
  quads of k summed as a pairwise tree) lies within 1e-5 of ``repro``'s Pallas
  ``batched_lowrank_matmat_t`` in interpret mode (float32, another
  summation order).

On the card the level entry must equal the gathered kernel followed by
``_scatter_rows`` bit for bit (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_aca.kernel import batched_lowrank_matmat_t
from repro_torch.core import build_hmatrix, make_apply
from repro_torch.core.clustering import permute_from_tree, permute_to_tree
from repro_torch.core.hmatrix import _dense_apply_points, _scatter_rows, block_group
from repro_torch.kernels.batched_aca.kernel import MAX_KR, lowrank_column_chunks
from repro_torch.kernels.batched_aca.ops import batched_lowrank_matmat_level
from repro_torch.kernels.batched_aca.ref import (batched_lowrank_matmat_level_ref,
                                                 batched_lowrank_matmat_ref)
from torch_parity_util import one_torch_thread  # noqa: F401

# a level of 8 clusters: row clusters 3 and 5 hold several blocks (and the
# others pad slots of the table), cluster 6 none
ROWS = np.array([3, 0, 3, 5, 3, 1, 5, 0, 7, 3], np.int64)
COLS = np.array([1, 6, 4, 2, 0, 7, 3, 2, 5, 6], np.int64)


def _group(rows=ROWS, cols=COLS):
    return block_group(np.stack([rows, cols], axis=1), "cpu")


def _operands(seed, k, r, m=24, n_clusters=8, b=len(ROWS)):
    rng = np.random.RandomState(seed)
    u = torch.from_numpy(rng.randn(b, m, k).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, m, k).astype(np.float32))
    x_pad = torch.from_numpy(rng.randn(n_clusters * m, r).astype(np.float32))
    z_pad = torch.from_numpy(rng.randn(n_clusters * m, r).astype(np.float32))
    return u, v, x_pad, z_pad


def _gather_product_scatter(u, v, x_pad, g, z_pad):
    """The low-rank route before the level entry."""
    m, r = u.shape[1], x_pad.shape[1]
    y = batched_lowrank_matmat_ref(u, v, x_pad.reshape(-1, m, r)[g.cols])
    return _scatter_rows(z_pad, y, g)


def test_block_group_lists_are_the_table_without_pads():
    g = _group()
    table = g.table.tolist()
    offsets, blocks = g.offsets.tolist(), g.blocks.tolist()
    assert offsets[0] == 0 and offsets[-1] == len(ROWS) == len(blocks)
    for i, row in enumerate(table):
        assert blocks[offsets[i]:offsets[i + 1]] == [t for t in row if t != len(ROWS)]
    counts = np.diff(offsets)
    order = g.longest_first.tolist()
    assert sorted(order) == list(range(len(table)))
    assert all(counts[a] >= counts[b] for a, b in zip(order, order[1:]))
    assert counts[order[0]] == 4                 # cluster 3's four blocks first
    assert g.offsets.dtype == g.blocks.dtype == g.longest_first.dtype == torch.int64


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("r", [1, 8])
def test_level_ref_equals_gather_product_scatter(k, r):
    g = _group()
    u, v, x_pad, z_pad = _operands(10 * k + r, k, r)
    want = _gather_product_scatter(u, v, x_pad, g, z_pad.clone())
    z = z_pad.clone()
    got = batched_lowrank_matmat_level_ref(u, v, x_pad, g.cols, g, z)
    assert got is z                              # in place, as the kernel
    assert torch.equal(got, want)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(batched_lowrank_matmat_level(u, v, x_pad, g.cols, g, z_pad.clone()),
                       want)
    # rows of cluster 6 (no block) keep their values
    assert torch.equal(got[6 * 24:7 * 24], z_pad[6 * 24:7 * 24])


def test_level_ref_on_a_panel_the_kernel_takes_in_column_chunks():
    """k * R = 16 * 80 > 1024: the kernel's launches cover every column once,
    each within MAX_KR, and the columns of the product are independent, so
    the chunks' results are the whole panel's bit for bit."""
    k, r = 16, 80
    chunks = lowrank_column_chunks(k, r)
    assert [c0 for c0, _ in chunks] == [0, 64]
    assert sum(w for _, w in chunks) == r and all(k * w <= MAX_KR for _, w in chunks)
    g = _group()
    u, v, x_pad, z_pad = _operands(5, k, r)
    whole = batched_lowrank_matmat_level_ref(u, v, x_pad, g.cols, g, z_pad.clone())
    assert torch.equal(whole, _gather_product_scatter(u, v, x_pad, g, z_pad.clone()))
    for c0, w in chunks:
        part = batched_lowrank_matmat_level_ref(u, v, x_pad[:, c0:c0 + w].contiguous(), g.cols,
                                                g, z_pad[:, c0:c0 + w].contiguous())
        assert torch.equal(part, whole[:, c0:c0 + w])


def _apply_before_level_entry(hm, x):
    """make_apply's route before the level entry: per level group, gather the
    X slices, the plain product and _scatter_rows; then the dense leaves."""
    tree, plan = hm.tree, hm.plan
    x_pad = permute_to_tree(tree, x)
    z_pad = torch.zeros_like(x_pad)
    for level in plan.aca_levels:
        u, v = hm.factors[level]
        z_pad = _gather_product_scatter(u, v, x_pad, hm.groups[level], z_pad)
    z_pad = _dense_apply_points(tree.points, plan, hm.kernel, hm.groups["dense"], x_pad, z_pad,
                                True)
    return permute_from_tree(tree, z_pad)


@pytest.mark.parametrize("r", [1, 8])
def test_cpu_apply_keeps_its_bits(r):
    pts = np.random.RandomState(21).rand(2500, 2).astype(np.float32)
    hm = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, precompute=True, device="cpu")
    assert len(hm.plan.aca_levels) >= 2
    assert max(g.table.shape[1] for g in hm.groups.values()) > 1
    x = torch.from_numpy(np.random.RandomState(22 + r).randn(2500, r).astype(np.float32))
    want = _apply_before_level_entry(hm, x)
    for use_kernels in (True, False):
        assert torch.equal(make_apply(hm, use_kernels=use_kernels)(x), want)


def _next_pow2(v):
    p = 1
    while p < v:
        p *= 2
    return p


def _lowrank_model(u, v, x, chunk, nt=256):
    """float32 model of csrc/lowrank_matmat.cu's order.  V^T X: a team of G
    threads shares a row (quads of k x column tiles of RT, G a power of
    two), so a split's rows are dealt to nt / G row lanes in turn; each lane
    sums its rows in ascending order, the lanes of a warp are combined by xor
    shuffles (pairs at distance 1, 2, ... lanes), the warps (or, for G >= 32,
    the lanes) in order; T sums the splits in order.  U T: per quad of k a
    chain over its 4 values, then the quads (zero-padded to a power of two)
    summed as a pairwise tree.  (The kernel's chains are fused
    multiply-adds; the model rounds the product and the sum apart.)"""
    b, n, k = v.shape
    r = x.shape[2]
    rt = 1 if r == 1 else 8
    g = _next_pow2(-(-k // 4) * -(-r // rt))
    lanes = nt // g
    per_warp = 32 // g if g < 32 else 1
    t = None
    for s0 in range(0, n, chunk):
        rows = min(chunk, n - s0)
        iters = -(-rows // lanes)
        pad = iters * lanes - rows
        vs = torch.cat([v[:, s0:s0 + rows], v.new_zeros(b, pad, k)], 1).reshape(b, iters, lanes, k)
        xs = torch.cat([x[:, s0:s0 + rows], x.new_zeros(b, pad, r)], 1).reshape(b, iters, lanes, r)
        acc = torch.zeros(b, lanes, k, r)
        for it in range(iters):
            acc = acc + vs[:, it, :, :, None] * xs[:, it, :, None, :]
        if per_warp > 1:                          # xor shuffles inside each warp
            acc = acc.reshape(b, lanes // per_warp, per_warp, k, r)
            d = 1
            while d < per_warp:
                idx = torch.arange(per_warp) ^ d
                acc = acc + acc[:, :, idx]
                d *= 2
            acc = acc[:, :, 0]
        part = acc[:, 0]
        for w in range(1, acc.shape[1]):
            part = part + acc[:, w]
        t = part if t is None else t + part
    tq = _next_pow2(-(-k // 4))
    quads = []
    for q0 in range(0, 4 * tq, 4):
        y = torch.zeros(b, u.shape[1], r)
        for kk in range(q0, min(k, q0 + 4)):
            y = y + u[:, :, kk, None] * t[:, None, kk, :]
        quads.append(y)
    while len(quads) > 1:
        quads = [quads[i] + quads[i + 1] for i in range(0, len(quads), 2)]
    return quads[0]


@pytest.mark.parametrize("k,r", [(16, 8), (16, 1), (3, 8), (7, 13)])
def test_kernel_order_model_matches_pallas(k, r):
    rng = np.random.RandomState(30 + k + r)
    u = rng.randn(3, 96, k).astype(np.float32)
    v = (rng.randn(3, 300, k) * 0.1).astype(np.float32)
    x = rng.randn(3, 300, r).astype(np.float32)
    want = np.asarray(batched_lowrank_matmat_t(jnp.asarray(u), jnp.asarray(v), jnp.asarray(x),
                                               interpret=True))
    # splits of 64 rows (the kernel's are 2048) so that the split order shows
    got = _lowrank_model(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(x), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = batched_lowrank_matmat_ref(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
