"""The batched ACA's route picker (``kernels/batched_aca/kernel.py:aca_route``).

The CUDA kernel ``csrc/aca.cu`` has two routes that give the same bits: a
resident one (a block's factors in the shared memory of one cluster of
1..8 CTAs for all k steps) and a streamed one (a block split over CTAs, two
launches per step).  The picker is a pure function of the block shape and
the card's shared memory per block, so its choices are checked here on the
CPU: on every level group of problems P and K at an H100's 227 KB (232,448
bytes) per block, and on a grid of shapes and shared-memory sizes, that it
never gives a CTA more shared memory than the card has.  The routes' bits
are compared on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import itertools

import pytest

from repro_torch.core import build_hmatrix, halton
from repro_torch.kernels.batched_aca.kernel import (RESIDENT_CLUSTERS, RESIDENT_MAX_LOCAL,
                                                    RESIDENT_STATIC_SMEM, RESIDENT_TARGET_SMEM,
                                                    aca_route, resident_fits,
                                                    resident_smem_bytes)
from torch_parity_util import one_torch_thread  # noqa: F401

H100_SMEM_PER_BLOCK = 232448
# problem P (N = 2^20, c_leaf = 2048; PERF.md section 4): level -> (blocks, m)
P_GROUPS = {3: (4, 131072), 4: (98, 65536), 5: (130, 32768), 6: (848, 16384),
            7: (1270, 8192), 8: (5050, 4096), 9: (6700, 2048)}
P_ROUTES = {3: ("streamed", 0), 4: ("streamed", 0), 5: ("streamed", 0), 6: ("streamed", 0),
            7: ("resident", 8), 8: ("resident", 8), 9: ("resident", 4)}
# problem K (N = 2^15 x 32, c_leaf = 256)
K_GROUPS = {3: (8, 4096), 4: (104, 2048), 5: (82, 1024), 6: (822, 512), 7: (948, 256)}
K_ROUTES = {3: ("resident", 8), 4: ("resident", 4), 5: ("resident", 2), 6: ("resident", 1),
            7: ("resident", 1)}


@pytest.mark.parametrize("level", sorted(P_GROUPS))
def test_route_of_every_group_of_problem_p(level):
    m = P_GROUPS[level][1]
    assert aca_route(m, m, 16, 2, H100_SMEM_PER_BLOCK) == P_ROUTES[level]


def test_route_of_every_group_of_problem_k():
    pts = halton(1 << 15, 2, device="cpu") * 32.0
    hm = build_hmatrix(pts, "gaussian", k=16, c_leaf=256, eta=1.5, device="cpu")
    groups = {lv: (int(b.shape[0]), hm.tree.n_pad >> lv) for lv, b in hm.plan.aca_levels.items()}
    assert groups == K_GROUPS
    for level, (_, m) in groups.items():
        assert aca_route(m, m, 16, 2, H100_SMEM_PER_BLOCK) == K_ROUTES[level]


def test_resident_share_of_problem_p():
    """Levels 7-9 of P take the resident route: 13,020 of its 14,100 blocks."""
    resident = [lv for lv in P_GROUPS if P_ROUTES[lv][0] == "resident"]
    assert resident == [7, 8, 9]
    assert sum(P_GROUPS[lv][0] for lv in resident) == 13020


SHAPES = [(2048, 2048), (4096, 4096), (8192, 8192), (16384, 16384), (300, 200), (10, 12),
          (5000, 5000), (64, 64), (1, 1), (256, 4096), (12345, 77), (20000, 1)]


@pytest.mark.parametrize("smem", [49152, 101376, 166912, H100_SMEM_PER_BLOCK])
@pytest.mark.parametrize("k,d", [(1, 1), (8, 2), (16, 2), (16, 3), (64, 3)])
def test_resident_route_never_exceeds_the_shared_memory(smem, k, d):
    for m, n in SHAPES:
        route, cluster = aca_route(m, n, k, d, smem)
        fits = [cs for cs in RESIDENT_CLUSTERS
                if resident_smem_bytes(m, n, k, d, cs) + RESIDENT_STATIC_SMEM <= smem
                and max(-(-m // cs), -(-n // cs)) <= RESIDENT_MAX_LOCAL]
        assert fits == [cs for cs in RESIDENT_CLUSTERS if resident_fits(m, n, k, d, cs, smem)]
        if route == "resident":
            assert cluster in RESIDENT_CLUSTERS
            assert resident_smem_bytes(m, n, k, d, cluster) + RESIDENT_STATIC_SMEM <= smem
            # 64 used-pivot bits a thread: at most 64 x 256 rows and columns a CTA
            assert max(-(-m // cluster), -(-n // cluster)) <= RESIDENT_MAX_LOCAL
            small = [cs for cs in fits if resident_smem_bytes(m, n, k, d, cs) <=
                     RESIDENT_TARGET_SMEM]
            # the smallest cluster within the target, else the smallest that fits
            assert cluster == (small[0] if small else fits[0])
        else:
            assert (route, cluster) == ("streamed", 0)
            assert not fits                 # streamed only when no cluster fits


def test_resident_smem_counts_factors_and_points():
    assert resident_smem_bytes(2048, 2048, 16, 2, 4) == 4 * 18 * (512 + 512)
    assert resident_smem_bytes(300, 200, 16, 3, 8) == 4 * 19 * (38 + 25)
    for m, n, k, d in itertools.product((1, 7, 4096), (3, 4096), (1, 64), (1, 3)):
        sizes = [resident_smem_bytes(m, n, k, d, cs) for cs in RESIDENT_CLUSTERS]
        assert sizes == sorted(sizes, reverse=True)
