"""Port parity: H-matrix build and apply.

The reference's H-matrix (tree, plan and ACA factors) is carried into the
port through ``repro_torch.convert.hmatrix_from_arrays``, so both sides
apply the SAME factors.  Tolerances: relative (Frobenius) error 1e-4
against ``repro``'s Pallas apply (interpret mode) and against the dense
oracle, the float32 bound the reference's own tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import diagonal_blocks as j_diagonal_blocks
from repro.core import halton as j_halton
from repro.core import make_apply as j_make_apply
from repro_torch.convert import hmatrix_from_arrays
from repro_torch.core import (build_hmatrix, dense_matvec_oracle, diagonal_blocks, make_apply,
                              make_matvec)
from repro_torch.core.hmatrix import block_group
from torch_parity_util import export_hmatrix, rel_err


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: beside XLA's own pool in the same process, more
    threads only contend (and the suite runs several workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(n, kernel, seed, c_leaf=64, k=8, precompute=True):
    pts = np.asarray(j_halton(n, 2))
    jhm = j_build_hmatrix(jnp.asarray(pts), kernel, k=k, c_leaf=c_leaf, precompute=precompute)
    x = np.random.RandomState(seed).randn(n, 8).astype(np.float32)
    return pts, jhm, x


@pytest.mark.parametrize("kernel,n,r", [("gaussian", 700, 1), ("gaussian", 700, 8),
                                        ("matern", 512, 8), ("matern", 700, 1)])
def test_apply_matches_reference_pallas_and_oracle(kernel, n, r):
    pts, jhm, x = _problem(n, kernel, seed=n + r)
    x = x[:, 0] if r == 1 else x
    want = np.asarray(j_make_apply(jhm, use_pallas=True)(jnp.asarray(x)))
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    got = make_apply(hm)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4
    oracle = dense_matvec_oracle(pts, kernel, x, device="cpu").numpy()
    assert rel_err(got, oracle) <= 1e-4
    # the plain (use_kernels=False) formulation agrees as well
    assert rel_err(make_apply(hm, use_kernels=False)(x).numpy(), oracle) <= 1e-4


def test_port_build_matches_converted_reference():
    """The port's own build gives the same plan as the reference, and its
    apply (its own ACA factors) meets the dense oracle."""
    pts, jhm, x = _problem(700, "gaussian", seed=1)
    hm = build_hmatrix(pts, "gaussian", k=8, c_leaf=64, precompute=True, device="cpu")
    conv = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    for lv, blocks in conv.plan.aca_levels.items():
        np.testing.assert_array_equal(hm.plan.aca_levels[lv], blocks)
    np.testing.assert_array_equal(hm.plan.dense_blocks, conv.plan.dense_blocks)
    oracle = dense_matvec_oracle(pts, "gaussian", x, device="cpu").numpy()
    assert rel_err(make_apply(hm)(x).numpy(), oracle) <= 1e-4
    assert rel_err(make_matvec(hm)(x[:, 0]).numpy(), oracle[:, 0]) <= 1e-4


def test_np_mode_on_cpu_matches_p_mode():
    """The plain NP route recomputes the P-mode build's factors (``core.aca``
    on the kernel function); the kernel route's direct-difference entries are
    held to the oracle in the next test."""
    pts, _, x = _problem(512, "gaussian", seed=2)
    hm_np = build_hmatrix(pts, "gaussian", k=8, c_leaf=64, device="cpu")
    hm_p = build_hmatrix(pts, "gaussian", k=8, c_leaf=64, precompute=True, device="cpu")
    assert hm_np.factors is None
    torch.testing.assert_close(make_apply(hm_np, use_kernels=False)(x), make_apply(hm_p)(x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["gaussian", "matern"])
def test_np_mode_kernel_route_meets_the_oracle(kernel):
    pts, _, x = _problem(512, kernel, seed=5, precompute=False)
    hm_np = build_hmatrix(pts, kernel, k=8, c_leaf=64, device="cpu")
    oracle = dense_matvec_oracle(pts, kernel, x, device="cpu").numpy()
    assert rel_err(make_apply(hm_np)(x).numpy(), oracle) <= 1e-4
    assert rel_err(make_apply(hm_np)(x[:, 3]).numpy(), oracle[:, 3]) <= 1e-4


def test_diagonal_blocks_match_reference_with_ragged_last_leaf():
    pts, jhm, _ = _problem(600, "gaussian", seed=3, c_leaf=128)
    want = np.asarray(j_diagonal_blocks(jhm))
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    got = diagonal_blocks(hm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(diagonal_blocks(hm, leaves_per_chunk=1).numpy(), got)


def test_block_group_reduces_in_fixed_block_order():
    blocks = np.array([[2, 0], [0, 1], [2, 3], [1, 1], [2, 2], [0, 0]], np.int32)
    g = block_group(blocks, "cpu")
    assert g.out_rows.tolist() == [0, 1, 2]
    assert g.table.tolist() == [[1, 5, 6], [3, 6, 6], [0, 2, 4]]
    assert g.cols.tolist() == [0, 1, 3, 1, 2, 0]


def test_apply_operand_checks_and_empty_panel():
    pts, jhm, x = _problem(300, "gaussian", seed=4)
    hm = hmatrix_from_arrays(export_hmatrix(jhm), device="cpu")
    apply_h = make_apply(hm)
    with pytest.raises(ValueError):
        apply_h(np.zeros(301, np.float32))
    with pytest.raises(ValueError):
        apply_h(np.zeros((300, 2, 2), np.float32))
    assert apply_h(np.zeros((300, 0), np.float32)).shape == (300, 0)
    z1, z2 = apply_h(x), apply_h(x)
    assert torch.equal(z1, z2)
    with pytest.raises(NotImplementedError):
        make_apply(hm, mesh=object())
    # recompression at build time: a smaller store whose apply stays within
    # 5 tol of the flat one (tests/test_factor_store.py's bound)
    hm_rc = build_hmatrix(pts, device="cpu", precompute=True, recompress_tol=1e-2, k=8,
                          c_leaf=64)
    flat = build_hmatrix(pts, device="cpu", precompute=True, k=8, c_leaf=64)
    assert hm_rc.memory_report()["factor_bytes"] <= flat.memory_report()["factor_bytes"]
    assert rel_err(make_apply(hm_rc)(x).numpy(), make_apply(flat)(x).numpy()) <= 5e-2
    report = hm.memory_report()
    assert report["factor_bytes"] > 0 and report["dense_equivalent_bytes"] == 300 * 300 * 4
