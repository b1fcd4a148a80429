"""The batched Cholesky's blocking (kernel #5, ``csrc/block_cholesky.cu``).

The CUDA kernel has two routes, picked by c alone:

* route S (c <= 288): the whole lower triangle in shared memory as 32 x 32
  tiles; per panel of 32 columns the diagonal tile by rank-1 steps, the rows
  below it by substitution against it (the reference's rule
  ``L[:, j] = residual[:, j] * dinv_j``), then the rank-32 trailing update;
* route L (c > 288): steps of 128 columns, each the diagonal tile by route
  S's code, the panel below it by four 32-column substitutions each
  followed by the update of the columns to its right, then the trailing
  update: after an even step only the next step's 128 columns (depth
  128), after an odd step the whole trailing triangle with both steps'
  panels (depth 256).

On the CPU:

* a float32 model of both routes lies within 1e-4 of ``repro``'s Pallas
  ``batched_block_cholesky_t`` in interpret mode and of the port's plain
  version, also with a zeroed row and column (a clamped pivot);
* route S's limit follows from the 227 KB of shared memory a CTA may use,
  and the CUDA source states that limit;
* route L's final writes (the diagonal tiles with the zeros above them, the
  panels with the zeros mirrored above the diagonal) cover every entry of
  L exactly once, so no copy of A into L is needed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_block_solve.kernel import batched_block_cholesky_t
from repro_torch.kernels.batched_block_solve.ref import batched_block_cholesky_ref
from torch_parity_util import one_torch_thread  # noqa: F401

TB, NB, TILE_STRIDE = 32, 128, 36
SMEM_MAX = 232448        # bytes of shared memory a CTA may use on the H100
TINY = 1e-30
SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/block_cholesky.cu"


def _tri(n):
    return n * (n + 1) // 2


def _shared_route_max_c():
    nt = 1
    while _tri(nt + 1) * TB * TILE_STRIDE * 4 <= SMEM_MAX:
        nt += 1
    return nt * TB


def _spd(rng, b, c):
    q = rng.randn(b, c, c).astype(np.float32)
    return (q @ np.swapaxes(q, 1, 2) + c * np.eye(c, dtype=np.float32)).astype(np.float32)


def _factor_diag(t):
    """The diagonal tile by rank-1 steps: (lower factor, dinv)."""
    t = t.clone()
    n = t.shape[1]
    dinv = torch.empty(t.shape[:2], dtype=t.dtype)
    for j in range(n):
        dj = torch.rsqrt(torch.clamp(t[:, j, j], min=TINY))
        dinv[:, j] = dj
        t[:, j:, j] *= dj[:, None]
        t[:, j + 1:, j + 1:] -= t[:, j + 1:, j, None] * t[:, None, j + 1:, j]
    return torch.tril(t), dinv


def _solve_rows32(x, lt, dinv):
    """Rows against a factored diagonal tile, right-looking: each entry's
    updates in ascending pivot order, then the multiplication by dinv."""
    x = x.clone()
    for j in range(x.shape[2]):
        x[:, :, j] *= dinv[:, j, None]
        x[:, :, j + 1:] -= x[:, :, j, None] * lt[:, None, j + 1:, j]
    return x


def _route_s(w, j0, n):
    """The n x n sub-block at (j0, j0) of w: (lower factor, dinv)."""
    w = w[:, j0:j0 + n, j0:j0 + n].clone()
    out = torch.zeros_like(w)
    dinv = torch.empty(w.shape[:2], dtype=w.dtype)
    for p0 in range(0, n, TB):
        p1 = min(n, p0 + TB)
        lt, dv = _factor_diag(w[:, p0:p1, p0:p1])
        out[:, p0:p1, p0:p1], dinv[:, p0:p1] = lt, dv
        if p1 == n:
            break
        panel = _solve_rows32(w[:, p1:, p0:p1], lt, dv)
        out[:, p1:, p0:p1] = panel
        w[:, p1:, p1:] -= torch.bmm(panel, panel.transpose(1, 2))
    return out, dinv


def _route_l(a):
    c = a.shape[1]
    w, lmat = a.clone(), torch.zeros_like(a)
    for j0 in range(0, c, NB):
        j1 = min(c, j0 + NB)
        l11, dinv = _route_s(w, j0, j1 - j0)
        lmat[:, j0:j1, j0:j1] = l11
        if j1 == c:
            break
        x = w[:, j1:, j0:j1].clone()
        for q0 in range(0, NB, TB):
            q1 = q0 + TB
            x[:, :, q0:q1] = _solve_rows32(x[:, :, q0:q1], l11[:, q0:q1, q0:q1], dinv[:, q0:q1])
            x[:, :, q1:] -= torch.bmm(x[:, :, q0:q1], l11[:, q1:, q0:q1].transpose(1, 2))
        lmat[:, j1:, j0:j1] = x
        if (j0 // NB) % 2 == 0:              # the next step's columns, depth 128
            j2 = min(c, j1 + NB)
            w[:, j1:, j1:j2] -= torch.bmm(x, x[:, :j2 - j1].transpose(1, 2))
        else:                                # the trailing triangle, depth 256
            panels = lmat[:, j1:, j0 - NB:j1]
            w[:, j1:, j1:] -= torch.bmm(panels, panels.transpose(1, 2))
    return lmat


def _model(a):
    c = a.shape[1]
    return _route_s(a, 0, c)[0] if c <= _shared_route_max_c() else _route_l(a)


def test_shared_route_limit_follows_from_shared_memory():
    assert _shared_route_max_c() == 288
    stated = re.search(r"static_assert\(C_S == (\d+)", SOURCE.read_text())
    assert stated and int(stated.group(1)) == _shared_route_max_c()


@pytest.mark.parametrize("c", [1, 31, 33, 100, 300, 520])
def test_blocked_model_matches_pallas(c):
    a = _spd(np.random.RandomState(90 + c), 2, c)
    want = np.asarray(batched_block_cholesky_t(jnp.asarray(a), interpret=True))
    got = _model(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = batched_block_cholesky_ref(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    assert (torch.triu(got, diagonal=1) == 0).all()


@pytest.mark.parametrize("c", [100, 300])
def test_blocked_model_clamps_a_zero_pivot_as_the_plain_version(c):
    """Row and column 40 zeroed: the pivot is clamped to 1e-30, column 40
    of L is exactly zero and the rest agrees with the plain version."""
    a = _spd(np.random.RandomState(7 + c), 1, c)
    a[:, 40, :] = 0.0
    a[:, :, 40] = 0.0
    got = _model(torch.from_numpy(a))
    plain = batched_block_cholesky_ref(torch.from_numpy(a))
    assert (got[:, :, 40] == 0).all() and (plain[:, :, 40] == 0).all()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", [289, 300, 512, 2048])
def test_wide_route_final_writes_cover_every_entry_once(c):
    """Each step's diagonal launch writes its 128 x 128 tile (zeros above
    the diagonal); its panel launch writes the rows below and the zeros in
    the mirrored columns to the right.  Together: every entry once."""
    count = np.zeros((c, c), dtype=np.int32)
    launches = 0
    for j0 in range(0, c, NB):
        j1 = min(c, j0 + NB)
        count[j0:j1, j0:j1] += 1
        launches += 1
        if j1 == c:
            break
        count[j1:, j0:j1] += 1
        count[j0:j1, j1:] += 1
        launches += 2
    assert (count == 1).all()
    assert launches == 3 * ((c + NB - 1) // NB) - 2


@pytest.mark.parametrize("c", [289, 520, 1000, 2048])
def test_wide_route_updates_reach_every_block_once_before_its_step(c):
    """Route L's two-level trailing update, by 128 x 128 blocks: when step J
    reads its column of blocks (the diagonal tile and the panel below it),
    each block holds the update of every earlier panel exactly once."""
    nb = (c + NB - 1) // NB
    got = {(i, j): [] for j in range(nb) for i in range(j, nb)}
    for k in range(nb):
        assert all(sorted(got[i, k]) == list(range(k)) for i in range(k, nb))
        if k + 1 == nb:
            break
        if k % 2 == 0:                      # the next step's column of blocks
            for i in range(k + 1, nb):
                got[i, k + 1].append(k)
        else:                               # the trailing triangle, both panels
            for j in range(k + 1, nb):
                for i in range(j, nb):
                    got[i, j].extend([k - 1, k])
