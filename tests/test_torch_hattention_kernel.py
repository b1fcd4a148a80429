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
