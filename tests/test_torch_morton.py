"""Port parity of the Morton encode (kernel #7, ``kernels/morton``).

The plain version (what the CUDA kernel ``csrc/morton.cu`` computes) must
equal ``(hi << 32) | lo`` of the reference's Pallas kernel
``morton_encode_t`` run in interpret mode, exactly: the codes are integers.
The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; here a numpy model of
its magic-number bit spread must give the plain version's codes.
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


def _spread2(x):
    """bits 0..15 to the even bits of a 32-bit word, as csrc/morton.cu."""
    x = x.astype(np.uint32)
    for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << np.uint32(shift))) & np.uint32(mask)
    return x


def _spread3(x):
    """bits 0..20 to bits 0, 3, ..., 60 of a 64-bit word, as csrc/morton.cu."""
    x = x.astype(np.uint64)
    for shift, mask in ((32, 0x001F00000000FFFF), (16, 0x001F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def _magic_encode(pts):
    """The CUDA kernel's arithmetic: the quantiser clamped after the cast,
    then the magic-number spread (d = 2 in two 32-bit halves)."""
    d = pts.shape[1]
    nb = bits_per_dim(d)
    scaled = np.clip(pts, 0.0, 1.0).astype(np.float32) * np.float32(2.0 ** nb - 1.0)
    q = np.minimum(scaled.astype(np.int64), (1 << nb) - 1).astype(np.uint64)
    if d == 1:
        return q[:, 0].astype(np.int64)
    if d == 2:
        a, b = q[:, 0].astype(np.uint32), q[:, 1].astype(np.uint32)
        lo = _spread2(a & np.uint32(0xFFFF)) | (_spread2(b & np.uint32(0xFFFF)) << np.uint32(1))
        hi = _spread2(a >> np.uint32(16)) | (_spread2(b >> np.uint32(16)) << np.uint32(1))
        return ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).astype(np.int64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1))
            | (_spread3(q[:, 2]) << np.uint64(2)))
    return code.astype(np.int64)


def _edge_points(n, d, seed):
    """Random points with the box's corners, 1.0, the float just below 1.0,
    points outside the box and (d = 1) the nb >= 25 clamp."""
    pts = np.random.RandomState(seed).rand(n, d).astype(np.float32)
    below = np.nextafter(np.float32(1.0), np.float32(0.0))
    edges = [[0.0] * d, [1.0] * d, [below] * d, [-0.5] * d, [2.0] * d, [1.0] + [0.0] * (d - 1),
             [0.0] * (d - 1) + [below], [0.5] * d]
    pts[:min(n, len(edges))] = np.asarray(edges[:n], dtype=np.float32)
    return pts


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 1001])
def test_magic_number_spread_equals_the_plain_encode(d, n):
    """The kernel's spread gives the plain version's codes bit for bit,
    also for an odd N (the kernel encodes two points a thread)."""
    pts = _edge_points(n, d, seed=10 * d + n)
    want = morton_encode_ref(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(_magic_encode(pts), want)
