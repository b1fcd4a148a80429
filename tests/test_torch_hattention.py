"""Port parity of H-matrix attention (``core/hattention.py``).

Against ``repro.core.hattention`` on the same inputs (made with numpy):
the plan and its coverage exactly, ``aca_bilinear``'s ``U V^T`` within 1e-5
relative (Frobenius), ``h_attention`` within 1e-4 relative on smooth
inputs, and on random inputs its exact region (rows < 2 c_leaf, which only
touch dense blocks) within 1e-5 absolute.  On random scores ACA pivots may
flip on near-ties (ROADMAP §3), so the far field is compared on smooth
inputs only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hattention as hat_jax
from repro_torch.core import hattention as hat

from torch_parity_util import rel_err


@pytest.mark.parametrize("seq,c_leaf", [(256, 32), (512, 64), (1024, 64)])
def test_plan_and_coverage_equal_the_reference(seq, c_leaf):
    assert hat.causal_hmatrix_plan(seq, c_leaf) == hat_jax.causal_hmatrix_plan(seq, c_leaf)
    cov = hat._plan_coverage(seq, c_leaf)
    np.testing.assert_array_equal(cov, hat_jax._plan_coverage(seq, c_leaf))
    np.testing.assert_array_equal(cov, np.tril(np.ones((seq, seq), np.int32)))


def test_plan_rejects_a_leaf_count_that_is_no_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        hat.causal_hmatrix_plan(384, 64)


def test_scatter_passes_hold_distinct_rows_in_plan_order():
    for lvl, (rows, _) in hat.causal_hmatrix_plan(1024, 32)["levels"].items():
        passes = hat._scatter_passes(rows)
        assert sorted(b for p in passes for b in p) == list(range(len(rows)))
        for p in passes:
            assert len({rows[b] for b in p}) == len(p) and p == sorted(p)


def test_aca_bilinear_matches_reference_on_low_rank_block():
    R = C = 64
    t_r = np.linspace(2.0, 3.0, R)[:, None]
    t_c = np.linspace(0.0, 1.0, C)[:, None]
    q = np.concatenate([np.sin(t_r), np.cos(t_r), t_r * 0.1], 1).astype(np.float32)
    k = np.concatenate([np.sin(t_c), np.cos(t_c), t_c * 0.1], 1).astype(np.float32)
    m = np.zeros((R,), np.float32)
    u_j, v_j = hat_jax.aca_bilinear(jnp.asarray(q), jnp.asarray(m), jnp.asarray(k), rank=8)
    u, v = hat.aca_bilinear(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(k), 8)
    assert u.shape == (R, 8) and v.shape == (C, 8)
    want = np.asarray(u_j) @ np.asarray(v_j).T
    assert rel_err((u @ v.T).numpy(), want) <= 1e-5
    a = np.exp(np.clip(q @ k.T, -30, 30))
    assert np.abs(a - (u @ v.T).numpy()).max() / a.max() < 1e-3


def test_aca_bilinear_batches_blocks_independently():
    """Leading dimensions are independent blocks: the batched call equals
    block-by-block calls."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 3, 32, 8).astype(np.float32) * 0.3)
    k = torch.from_numpy(rng.randn(2, 3, 40, 8).astype(np.float32) * 0.3)
    m = torch.from_numpy(rng.randn(2, 3, 32).astype(np.float32) * 0.1)
    u, v = hat.aca_bilinear(q, m, k, 5)
    for i in range(2):
        for j in range(3):
            u1, v1 = hat.aca_bilinear(q[i, j], m[i, j], k[i, j], 5)
            torch.testing.assert_close(u[i, j] @ v[i, j].T, u1 @ v1.T, rtol=1e-6, atol=1e-6)


def _smooth_qkv(rng, b, s, h, hkv, d):
    """q/k as smooth functions of position => smooth attention landscape
    (``tests/test_hattention.py``'s inputs)."""
    t = np.linspace(0, 4 * np.pi, s)
    feats = np.stack([np.sin(t * (i + 1) / d) for i in range(d)], -1)
    q = np.tile(feats[None, :, None, :], (b, 1, h, 1)) * 2.0
    k = np.tile(feats[None, :, None, :], (b, 1, hkv, 1)) * 2.0
    q = q + 0.01 * rng.randn(*q.shape)
    k = k + 0.01 * rng.randn(*k.shape)
    v = rng.randn(b, s, hkv, d)
    return tuple(a.astype(np.float32) for a in (q, k, v))


def _both(q, k, v, c_leaf, rank):
    out_j = hat_jax.h_attention(*(jnp.asarray(a) for a in (q, k, v)), c_leaf=c_leaf, rank=rank)
    out = hat.h_attention(*(torch.from_numpy(a) for a in (q, k, v)), c_leaf=c_leaf, rank=rank)
    return out.numpy(), np.asarray(out_j)


def test_h_attention_matches_reference_on_smooth_scores():
    q, k, v = _smooth_qkv(np.random.RandomState(0), 1, 512, 2, 1, 16)
    out, out_j = _both(q, k, v, 64, 12)
    assert out.shape == (1, 512, 2, 16) and out.dtype == np.float32
    assert rel_err(out, out_j) <= 1e-4


def test_h_attention_exact_region_matches_reference_on_random_scores():
    rng = np.random.RandomState(1)
    q = rng.randn(2, 256, 4, 16).astype(np.float32)
    k = rng.randn(2, 256, 2, 16).astype(np.float32)
    v = rng.randn(2, 256, 2, 16).astype(np.float32)
    out, out_j = _both(q, k, v, 64, 8)
    np.testing.assert_allclose(out[:, :128], out_j[:, :128], rtol=0, atol=1e-5)
    assert np.isfinite(out).all()


def test_h_attention_keeps_the_input_dtype():
    q, k, v = _smooth_qkv(np.random.RandomState(2), 1, 256, 2, 2, 16)
    out = hat.h_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          c_leaf=64, rank=4)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 256, 2, 16)
