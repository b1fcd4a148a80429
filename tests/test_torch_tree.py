"""Port parity: Morton order, cluster tree, block tree, ACA and FactorStore.

Integer results are held EXACTLY against ``repro``: Morton codes,
permutations, plans and rank tables.  Bounding boxes are min/max of the
same float32 points, so they are exact too.  ACA factors: rtol 1e-4 /
atol 1e-5 (the matvecs ``U @ V[j]`` sum in another order than XLA's), and
``U V^T`` against the block where a near-tie flips a pivot.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aca as jaca
from repro.core import morton as jmorton
from repro.core.block_tree import build_block_tree as j_build_block_tree
from repro.core.clustering import build_cluster_tree as j_build_cluster_tree
from repro.core.factor_store import effective_ranks as j_effective_ranks
from repro.core.geometry import get_kernel as j_get_kernel
from repro.core.hmatrix import build_hmatrix as j_build_hmatrix
from repro_torch.core import (FactorStore, batched_aca, build_block_tree, build_cluster_tree,
                              build_hmatrix, effective_ranks, get_kernel, morton_encode,
                              permute_from_tree, permute_to_tree)
from repro_torch.core.morton import quantize
from test_build_device import CASES
from torch_parity_util import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("d", [1, 2, 3])
def test_morton_code_is_hi_lo_concatenation(d):
    rng = np.random.RandomState(d)
    pts = rng.rand(500, d).astype(np.float32)
    pts[:3] = [[0.0] * d, [1.0] * d, [0.5] * d]           # box corners and centre
    hi, lo = jmorton.morton_encode(jnp.asarray(pts))
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    got = morton_encode(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(quantize(torch.ones(1, d), jmorton.bits_per_dim(d)).max()) \
        == 2 ** jmorton.bits_per_dim(d) - 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_and_plan_match_reference_exactly(case):
    factory, c_leaf, eta = CASES[case]
    pts = np.array(factory(), np.float32)
    jt = j_build_cluster_tree(jnp.asarray(pts), c_leaf=c_leaf)
    tt = build_cluster_tree(torch.from_numpy(pts), c_leaf=c_leaf)
    assert (tt.n, tt.n_pad, tt.c_leaf, tt.n_levels) == (jt.n, jt.n_pad, jt.c_leaf, jt.n_levels)
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tt.points.numpy(), np.asarray(jt.points))
    for lv in range(jt.n_levels + 1):
        np.testing.assert_array_equal(tt.bb_min[lv].numpy(), np.asarray(jt.bb_min[lv]))
        np.testing.assert_array_equal(tt.bb_max[lv].numpy(), np.asarray(jt.bb_max[lv]))
    jp = j_build_block_tree(jt, eta=eta)
    tp = build_block_tree(tt, eta=eta)
    assert (tp.c_leaf, tp.n_pad, tp.n_levels, tp.eta) == (jp.c_leaf, jp.n_pad, jp.n_levels, jp.eta)
    assert sorted(tp.aca_levels) == sorted(jp.aca_levels)
    for lv, blocks in jp.aca_levels.items():
        np.testing.assert_array_equal(tp.aca_levels[lv], blocks)
    np.testing.assert_array_equal(tp.dense_blocks, jp.dense_blocks)
    assert tp.coverage_check()


def test_permutations_round_trip_and_zero_the_pad():
    pts = torch.rand(300, 2, generator=torch.Generator().manual_seed(3))
    tree = build_cluster_tree(pts, c_leaf=64)
    x = torch.randn(300, 3, generator=torch.Generator().manual_seed(4))
    xp = permute_to_tree(tree, x)
    assert xp.shape == (tree.n_pad, 3)
    assert bool((xp[300:] == 0).all())
    assert torch.equal(permute_from_tree(tree, xp), x)


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("k", [4, 16])
def test_batched_aca_matches_reference(kernel, k):
    """Factors equal the reference's to rtol 1e-4 / atol 1e-5 block by block,
    except where a pivot flips.  The kernel entries agree bit for bit, but
    the residual ``A[:, j] - U V[j]`` sums its k terms in another order than
    XLA's vectorised dot, and on near-ties of |residual| (symmetric point
    layouts, residuals at noise level once the block's rank is exhausted)
    that picks another pivot.  Such blocks must still share the first
    column (no residual yet) and approximate the block as well as the
    reference's factors do (to twice its error, above float32 noise)."""
    pts = np.asarray(CASES["halton2d"][0](), np.float32) / 8.0
    jhm = j_build_hmatrix(jnp.asarray(pts), kernel, k=k, c_leaf=128)
    tree, plan = jhm.tree, jhm.plan
    kfn = get_kernel(kernel)
    n_blocks = n_flipped = 0
    for lv, blocks in plan.aca_levels.items():
        m = tree.n_pad >> lv
        cl = np.asarray(tree.points).reshape(1 << lv, m, -1)
        rp, cp = cl[blocks[:, 0]], cl[blocks[:, 1]]
        ju, jv = jaca.batched_aca(jnp.asarray(rp), jnp.asarray(cp), j_get_kernel(kernel), k)
        ju, jv = np.asarray(ju), np.asarray(jv)
        tu, tv = batched_aca(torch.from_numpy(rp), torch.from_numpy(cp), kfn, k)
        tu, tv = tu.numpy(), tv.numpy()
        exact = kfn(torch.from_numpy(rp), torch.from_numpy(cp)).numpy()
        for b in range(blocks.shape[0]):
            n_blocks += 1
            if np.allclose(tu[b], ju[b], rtol=1e-4, atol=1e-5) \
                    and np.allclose(tv[b], jv[b], rtol=1e-4, atol=1e-5):
                assert effective_ranks(torch.from_numpy(tu[b:b + 1]),
                                       torch.from_numpy(tv[b:b + 1])).item() \
                    == int(np.asarray(j_effective_ranks(ju[b:b + 1], jv[b:b + 1]))[0])
                continue
            n_flipped += 1
            np.testing.assert_allclose(tu[b][:, 0], ju[b][:, 0], rtol=1e-4, atol=1e-5)
            scale = np.abs(exact[b]).max()
            err_t = np.abs(tu[b] @ tv[b].T - exact[b]).max()
            err_j = np.abs(ju[b] @ jv[b].T - exact[b]).max()
            # 3e-5 * scale: the float32 noise floor of a rank-16 sum U V^T
            assert err_t <= 2.0 * err_j + 3e-5 * scale, (lv, b, err_t, err_j)
    assert n_flipped < n_blocks


def test_batched_aca_degenerate_block_gives_exact_zero_columns():
    """Duplicate points: the block has rank 1, later pivots hit the 1e-30
    guard and write zero columns, so the rank table reads 1."""
    rows = torch.full((2, 32, 2), 0.25)
    cols = torch.full((2, 32, 2), 3.0)
    u, v = batched_aca(rows, cols, get_kernel("gaussian"), 6)
    assert effective_ranks(u, v).tolist() == [1, 1]
    full = get_kernel("gaussian")(rows, cols)
    torch.testing.assert_close(u @ v.transpose(1, 2), full, rtol=1e-6, atol=1e-12)


def test_factor_store_ranks_bytes_and_claim_check():
    hm = build_hmatrix(np.asarray(CASES["halton2d"][0]()), k=8, c_leaf=128,
                       precompute=True, device="cpu")
    store = hm.factors
    assert isinstance(store, FactorStore) and len(store) == len(hm.plan.aca_levels)
    total = sum(u.numel() * 4 + v.numel() * 4 for u, v in store.values())
    nb = store.nbytes()
    assert nb["low_rank"] == total and nb["total"] == total + nb["ranks"]
    assert hm.memory_report()["factor_bytes"] == nb["total"]
    lv = next(iter(store))
    u, v = store[lv]
    FactorStore.from_factors({lv: (u, v)}, ranks={lv: np.full(u.shape[0], 8)})
    with pytest.raises(ValueError, match="claimed rank"):
        FactorStore.from_factors({lv: (u, v)}, ranks={lv: np.zeros(u.shape[0], np.int32)})
    with pytest.raises(ValueError, match="outside"):
        FactorStore.from_factors({lv: (u, v)}, ranks={lv: np.full(u.shape[0], 9)})
    with pytest.raises(ValueError, match="plan lists"):
        FactorStore.from_factors({lv: (u[:1], v[:1])}, plan=hm.plan)
