"""K's H-LU re-truncation workload, the batches the recompression kernel
(#8, ``csrc/recompress.cu``) is designed for, counted from the plan-only
schedule of ``repro_torch.harith`` (no factorization runs).

Problem K (``chip_smoke.py``): N = 2^15 Halton points scaled by 32,
gaussian, k = 16, c_leaf = 256, eta = 1.5; H-LU at tol 1e-3 with the
default working width kp = 32.  Every low-rank Schur slot of a step
(``sll_l``, ``smx_l``) is one call on (B, 256, 2 kp) concatenations, B
padded to a power of two onto the all-zero scratch tile.  The counts are
exact integers of the plan.
"""
from repro_torch.core import build_hmatrix, halton
from repro_torch.harith import hlu
from torch_parity_util import one_torch_thread  # noqa: F401

RETRUNCATION_SLOTS = {"sll_l": 2, "smx_l": 3}   # slot -> column of the target tile


def _retruncations(meta):
    """(padded B, real blocks) of every re-truncation call of a schedule."""
    calls = []
    for step in meta.schedule.steps:
        for slot, col in RETRUNCATION_SLOTS.items():
            tab = getattr(step, slot)
            if tab.shape[0]:
                calls.append((tab.shape[0], int((tab[:, col] != meta.grid.n_lr).sum())))
    return calls


def test_k_hlu_retruncation_workload_from_the_plan():
    pts = halton(1 << 15, 2, device="cpu") * 32.0
    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=256, eta=1.5, device="cpu",
                       precompute=False)
    meta = hlu._factorize_hlu(hm, 1e-2, tol=1e-3, kp=None, use_kernels=True, _plan_only=True)
    calls = _retruncations(meta)
    assert meta.kp == 32 and hm.plan.c_leaf == 256       # (B, 256, 64) blocks
    assert len(calls) == 223
    assert sum(b for b, _ in calls) == 268_587
    assert sum(r for _, r in calls) == 185_506
    assert all(b & (b - 1) == 0 for b, _ in calls)      # powers of two
    assert max(b for b, _ in calls) == 8192


def test_retruncation_count_matches_the_calls_of_a_factorization(monkeypatch):
    """The counting above against the re-truncations a small H-LU makes on
    the CPU (the plain versions behind the kernel wrappers)."""
    from repro_torch.kernels.batched_schur_update import ops
    pts = halton(2048, 2, device="cpu") * 8.0
    hm = build_hmatrix(pts, "gaussian", k=8, c_leaf=128, eta=1.5, device="cpu")
    meta = hlu._factorize_hlu(hm, 1e-2, tol=1e-3, kp=None, use_kernels=True, _plan_only=True)
    seen = []
    orig = hlu._kernels

    def counting(use_kernels):
        fns = orig(use_kernels)

        def retruncate(u, v, tol, kp):
            seen.append((u.shape[0], u.shape[1], u.shape[2]))
            return ops.batched_schur_retruncate(u, v, tol, kp)
        return fns[:3] + (retruncate,)

    monkeypatch.setattr(hlu, "_kernels", counting)
    hlu._factorize_hlu(hm, 1e-2, tol=1e-3, kp=None, use_kernels=True)
    assert [b for b, _, _ in seen] == [b for b, _ in _retruncations(meta)]
    assert all(m == 128 and k == 2 * meta.kp for _, m, k in seen)
