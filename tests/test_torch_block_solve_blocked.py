"""The block-Jacobi solve's tile order (kernel #6, ``csrc/block_cholesky_solve.cu``).

The CUDA kernel solves ``(L L^T) Y = X`` as two blocked sweeps over row
tiles of 32 and reads L in one fixed order through a ring of shared-memory
slots: forward, each diagonal tile then the panel below it in slots of 128
rows; back, from the last tile up, each diagonal tile then the panel above
it read as rows of L (L^T's columns) in slots of 128 columns.  On the CPU:

* a float32 model of that order (diagonal steps with the division by the
  pivot, panel updates in ascending pivot order, tile 32 with a ragged last
  tile) lies within 1e-4 of ``repro``'s Pallas
  ``batched_block_cholesky_solve_t`` in interpret mode and of the port's
  plain version (c sequential substitution steps per sweep, as
  ``tests/test_torch_kernels.py`` holds the plain version);
* the read order, mirrored from the kernel's ``advance``, reads every entry
  of the lower triangle exactly once per sweep, each slot within its
  bounds, and no slot before the diagonal tile that its rows wait for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_block_solve.kernel import batched_block_cholesky_solve_t
from repro_torch.kernels.batched_block_solve.ref import batched_block_cholesky_solve_ref

TB, PR = 32, 128


def _spd_factor(rng, b, c):
    q = rng.randn(b, c, c)
    return np.linalg.cholesky(q @ np.swapaxes(q, 1, 2) + c * np.eye(c)).astype(np.float32)


def _blocked_model(l, x):
    """float32 model of the kernel's arithmetic: each entry's updates in the
    kernel's order (the kernel fuses each multiply-add)."""
    c = l.shape[1]
    y = x.clone()
    for j0 in range(0, c, TB):                              # forward
        j1 = min(c, j0 + TB)
        for jj in range(j0, j1):
            q = y[:, jj] / l[:, jj, jj, None]
            y[:, jj] = q
            y[:, jj + 1:j1] -= l[:, jj + 1:j1, jj, None] * q[:, None]
        for k in range(j0, j1):                             # panel below, pivots ascending
            y[:, j1:] -= l[:, j1:, k, None] * y[:, None, k]
    for j0 in reversed(range(0, c, TB)):                    # back
        j1 = min(c, j0 + TB)
        for jj in reversed(range(j0, j1)):
            q = y[:, jj] / l[:, jj, jj, None]
            y[:, jj] = q
            y[:, j0:jj] -= l[:, jj, j0:jj, None] * q[:, None]
        for k in range(j0, j1):                             # panel above, read as rows of L
            y[:, :j0] -= l[:, k, :j0, None] * y[:, None, k]
    return y


@pytest.mark.parametrize("c", [64, 80])
@pytest.mark.parametrize("r", [1, 3, 8])
def test_tile_order_model_matches_pallas(c, r):
    rng = np.random.RandomState(70 + c + r)
    l_mat = _spd_factor(rng, 2, c)
    x = rng.randn(2, c, r).astype(np.float32)
    want = np.asarray(batched_block_cholesky_solve_t(jnp.asarray(l_mat), jnp.asarray(x),
                                                     interpret=True))
    got = _blocked_model(torch.from_numpy(l_mat), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = batched_block_cholesky_solve_ref(torch.from_numpy(l_mat), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)


def _read_order(c):
    """The kernel's slots in order (``advance`` in csrc/block_cholesky_solve.cu):
    (kind, j0, p0)."""
    last = (c - 1) // TB * TB
    it, out = ("fwd_diag", 0, 0), []
    while it[0] != "done":
        out.append(it)
        kind, j0, p0 = it
        if kind == "fwd_diag":
            it = ("fwd_panel", j0, j0 + TB) if j0 + TB < c else ("back_diag", last, 0)
        elif kind == "fwd_panel":
            it = ("fwd_panel", j0, p0 + PR) if p0 + PR < c else ("fwd_diag", j0 + TB, 0)
        elif kind == "back_diag":
            it = ("back_panel", j0, 0) if j0 > 0 else ("done", 0, 0)
        else:
            it = ("back_panel", j0, p0 + PR) if p0 + PR < j0 else ("back_diag", j0 - TB, 0)
    return out


def _entries(kind, j0, p0, c):
    """Entries (row, col) of L that a slot holds, inside c and the triangle."""
    if kind.endswith("diag"):
        rows, cols = range(j0, min(c, j0 + TB)), range(j0, min(c, j0 + TB))
    elif kind == "fwd_panel":
        rows, cols = range(p0, min(c, p0 + PR)), range(j0, min(c, j0 + TB))
    else:
        rows, cols = range(j0, min(c, j0 + TB)), range(p0, min(j0, p0 + PR))
    return {(i, j) for i in rows for j in cols if j <= i}


@pytest.mark.parametrize("c", [1, 32, 80, 100, 256, 300])
def test_read_order_covers_the_triangle_once_per_sweep(c):
    order = _read_order(c)
    triangle = {(i, j) for i in range(c) for j in range(i + 1)}
    for sweep in ("fwd", "back"):
        seen = []
        for kind, j0, p0 in order:
            if kind.startswith(sweep):
                seen.extend(_entries(kind, j0, p0, c))
        assert len(seen) == len(set(seen)) and set(seen) == triangle
    # every panel comes after its own diagonal tile, and the tiles come in
    # the sweeps' orders
    diag = [(k, j0) for k, j0, _ in order if k.endswith("diag")]
    tiles = list(range(0, c, TB))
    assert diag == [("fwd_diag", j) for j in tiles] + [("back_diag", j) for j in reversed(tiles)]
    current = None
    for kind, j0, _ in order:
        if kind.endswith("diag"):
            current = (kind[:4], j0)
        else:
            assert current == (kind[:4], j0)
