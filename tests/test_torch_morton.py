"""Port parity of the Morton encode (kernel #7, ``kernels/morton``).

The plain version (what the CUDA kernel ``csrc/morton.cu`` computes) must
equal ``(hi << 32) | lo`` of the reference's Pallas kernel
``morton_encode_t`` run in interpret mode, exactly: the codes are integers.
The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.morton.kernel import TILE, morton_encode_t
from repro_torch.core.morton import bits_per_dim
from repro_torch.kernels.morton.ops import morton_encode
from repro_torch.kernels.morton.ref import morton_encode_ref


def _unit_points(n, d, seed):
    pts = np.random.RandomState(seed).rand(n, d).astype(np.float32)
    pts[0] = 0.0                              # the box corners and centre
    pts[1] = 1.0
    pts[2] = 0.5
    pts[3, 0] = 1.0                           # one coordinate exactly 1.0
    pts[4, -1] = np.nextafter(np.float32(1.0), np.float32(0.0))
    return pts


@pytest.mark.parametrize("d", [1, 2, 3])
def test_plain_encode_matches_reference_kernel_exactly(d):
    pts = _unit_points(2 * TILE, d, seed=d)
    hi, lo = morton_encode_t(jnp.asarray(pts.T), interpret=True)
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    got = morton_encode(torch.from_numpy(pts))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0
    assert int(got.max()) < 1 << (bits_per_dim(d) * d)


@pytest.mark.parametrize("d", [2, 3])
def test_quantiser_clamps_after_the_cast(d):
    """float32(2^nb - 1) rounds up to 2^nb for nb >= 25 (d = 2: nb = 31):
    a coordinate of 1.0 must still give the all-ones code, not overflow."""
    nb = bits_per_dim(d)
    one = morton_encode_ref(torch.ones(1, d))
    assert int(one[0]) == (1 << (nb * d)) - 1
    outside = morton_encode_ref(torch.tensor([[2.0] * d, [-1.0] * d]))
    assert outside.tolist() == [(1 << (nb * d)) - 1, 0]
