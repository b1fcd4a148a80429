"""Port parity: geometry, kernel functions and the kernels' plain phi.

The same inputs go through ``repro`` (JAX, CPU) and ``repro_torch`` (CPU).
Tolerances: Halton points within 1 ulp (the same float32 digit loop);
kernel values to rtol 1e-6 (float32 elementwise maths; the expansion-form
distances agree up to the order of a length-d dot product).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.kernels import _phi as jphi
from repro_torch.core import geometry as tgeo
from repro_torch.kernels import phi as tphi
from torch_parity_util import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,d", [(1, 2), (100, 2), (1500, 2), (777, 3), (300, 1)])
def test_halton_matches_reference_within_one_ulp(n, d):
    want = np.asarray(jgeo.halton(n, d))
    got = tgeo.halton(n, d).numpy()
    assert got.dtype == np.float32 and got.shape == (n, d)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def _point_pairs(seed, d, scale):
    rng = np.random.RandomState(seed)
    a = (rng.rand(3, 40, d) * scale).astype(np.float32)
    b = (rng.rand(3, 30, d) * scale).astype(np.float32)
    b[:, :5] = a[:, :5]                       # exact coincident pairs (r = 0)
    return a, b


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d,scale", [(2, 1.0), (2, 4.0), (3, 2.0)])
def test_kernel_functions_match_reference(kernel, d, scale):
    a, b = _point_pairs(1, d, scale)
    want = np.asarray(jgeo.get_kernel(kernel)(jnp.asarray(a), jnp.asarray(b)))
    got = tgeo.get_kernel(kernel)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_plain_phi_matches_reference_kernel_maths(kernel, d):
    """The port's direct-difference phi == repro.kernels._phi on (d, n) layouts."""
    a, b = _point_pairs(2, d, 3.0)
    want = np.stack([np.asarray(jphi.phi_from_sqdist(
        jphi.pairwise_sqdist_t(jnp.asarray(a[i].T), jnp.asarray(b[i].T)), kernel, d))
        for i in range(a.shape[0])])
    got = tphi.phi_from_sqdist(tphi.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)),
                               kernel, d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_bessel_k1_matches_reference_across_both_branches():
    x = np.concatenate([np.linspace(1e-6, 2.0, 300), np.linspace(2.0, 40.0, 300)])
    x = x.astype(np.float32)
    want = np.asarray(jgeo._bessel_k1(jnp.asarray(x)))
    got = tgeo.bessel_k1(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sinusoid_targets_and_dense_matrix_match_reference():
    pts = np.asarray(jgeo.halton(200, 2)) * 32.0
    want = np.asarray(jgeo.sinusoid_targets(pts, 11, 32.0))
    got = tgeo.sinusoid_targets(torch.from_numpy(pts), 11, 32.0).numpy()
    np.testing.assert_array_equal(got, want)
    dense_want = np.asarray(jgeo.dense_kernel_matrix(jnp.asarray(pts[:50] / 32.0)))
    dense_got = tgeo.dense_kernel_matrix(torch.from_numpy(pts[:50] / 32.0)).numpy()
    np.testing.assert_allclose(dense_got, dense_want, rtol=1e-6, atol=1e-7)


def test_unknown_kernel_names_raise():
    with pytest.raises(KeyError):
        tgeo.get_kernel("laplace")
    with pytest.raises(ValueError):
        tphi.phi_from_sqdist(torch.zeros(2), "laplace", 2)
    with pytest.raises(ValueError):
        tgeo.kernel_name_of(lambda a, b: a)
