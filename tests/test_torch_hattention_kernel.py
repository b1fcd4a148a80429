"""Port parity of the H-attention near field (kernel #11, ``kernels/hattention_block``).

The port's ``hattention_nearfield_op`` on the CPU (its plain version, what
the CUDA kernel ``csrc/hattention_nearfield.cu`` computes) against
``repro``'s ``hattention_nearfield_op`` (the Pallas kernel in interpret
mode) on the same inputs, at the shapes of ``tests/test_hattention_kernel.py``
and with its limits: ``m`` within 1e-5 absolute, ``num`` and ``den`` within
1e-4.  The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hattention_block.ops import hattention_nearfield_op as nearfield_jax
from repro_torch.kernels.hattention_block.ops import hattention_nearfield_op
from repro_torch.kernels.hattention_block.ref import hattention_nearfield_ref


def _qkv(bh, nl, c, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(bh, nl, c, d) / np.sqrt(d)).astype(np.float32)
    k = rng.randn(bh, nl, c, d).astype(np.float32)
    v = rng.randn(bh, nl, c, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bh,nl,c,d", [(2, 4, 64, 32), (1, 8, 128, 16), (3, 2, 32, 64)])
def test_nearfield_matches_reference_kernel(bh, nl, c, d):
    q, k, v = _qkv(bh, nl, c, d, seed=bh * 100 + c + d)
    num_j, den_j, m_j = nearfield_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    num, den, m = hattention_nearfield_op(*(torch.from_numpy(a) for a in (q, k, v)))
    assert num.shape == (bh, nl, c, d) and den.shape == m.shape == (bh, nl, c)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=1e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(num.numpy(), np.asarray(num_j), rtol=1e-4, atol=1e-4)


def test_nearfield_leaf0_is_exact_causal_attention():
    """Leaf 0 sees only its causal diagonal block: num / den is exact softmax
    attention there, and the absent predecessor adds nothing."""
    q, k, v = _qkv(1, 2, 32, 16, seed=7)
    num, den, _ = hattention_nearfield_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    out = (num[0, 0] / den[0, 0][:, None]).numpy()
    s = q[0, 0] @ k[0, 0].T
    s = np.where(np.tril(np.ones((32, 32), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    np.testing.assert_allclose(out, (p / p.sum(-1, keepdims=True)) @ v[0, 0],
                               rtol=1e-4, atol=1e-4)


def _online_nearfield(q, k, v, tk=64):
    """float32 model of the CUDA kernel's one online pass
    (``csrc/hattention_nearfield.cu``): per row, the key tiles of 64 of the
    previous leaf, then those of its own leaf, each folded in with m_new =
    max(m, tile max), num and den rescaled by exp(m - m_new), p = exp(s -
    m_new)."""
    bh, nl, c, d = q.shape
    neg = -1e30
    m = torch.full((bh, nl, c), neg)
    den = torch.zeros(bh, nl, c)
    num = torch.zeros(bh, nl, c, d)
    kp = torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
    rows = torch.arange(c)
    has_prev = (torch.arange(nl) > 0)[None, :, None, None]
    for prev in (True, False):
        for t0 in range(0, c, tk):
            keys = torch.arange(t0, min(c, t0 + tk))
            kk, vv = ((kp, vp) if prev else (k, v))
            s = torch.einsum("bncd,bnkd->bnck", q, kk[:, :, keys])
            vis = has_prev.expand(1, nl, c, len(keys)) if prev else \
                (keys[None, :] <= rows[:, None])[None, None]
            s = torch.where(vis, s, torch.full_like(s, neg))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(vis, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
            den = den * alpha + p.sum(-1)
            num = num * alpha[..., None] + torch.einsum("bnck,bnkd->bncd", p, vv[:, :, keys])
            m = m_new
    return num, den, m


def _rising_qkv(bh, nl, c, d, seed):
    """q with a positive mean and keys whose mean grows along the sequence:
    a row's max rises in later key tiles, so the rescaling runs."""
    rng = np.random.RandomState(seed)
    q = ((rng.randn(bh, nl, c, d) + 1.0) / np.sqrt(d)).astype(np.float32)
    pos = (np.arange(nl * c).reshape(nl, c) / (nl * c))[None, :, :, None]
    k = (rng.randn(bh, nl, c, d) + 3.0 * pos).astype(np.float32)
    v = rng.randn(bh, nl, c, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bh,nl,c,d", [(2, 3, 100, 16), (1, 1, 64, 32), (2, 3, 512, 16),
                                       (1, 3, 192, 128)])
@pytest.mark.parametrize("rising", [False, True])
def test_online_recurrence_matches_the_plain_near_field(bh, nl, c, d, rising):
    make = _rising_qkv if rising else _qkv
    q, k, v = (torch.from_numpy(a) for a in make(bh, nl, c, d, seed=bh + nl + c + d))
    num, den, m = _online_nearfield(q, k, v)
    num_r, den_r, m_r = hattention_nearfield_ref(q, k, v)
    assert float((m - m_r).abs().max()) <= 1e-5
    assert float(torch.linalg.vector_norm(den - den_r) / torch.linalg.vector_norm(den_r)) <= 1e-4
    assert float(torch.linalg.vector_norm(num - num_r) / torch.linalg.vector_norm(num_r)) <= 1e-4
