"""The apply in batches of whole row clusters (``core/hmatrix.py``,
``APPLY_BATCH_BYTES``).

Each stage of an apply, the dense leaves and every admissible level group,
runs in batches planned at build time (``BlockGroup.batches``) so that its
working set stays under one byte budget; in NP mode each batch's factors
are regenerated by the ACA just before its low-rank product.  At N = 2^13
with leaves of 128 and a budget cut to a few MiB (or to one row cluster a
batch) every stage splits, and:

* the batched apply gives the one-batch apply's bits, in P and NP mode, for
  R in {1, 8, 64};
* the plan covers every block once, in whole row clusters under the budget
  taken by decreasing block count, each row cluster's blocks in the whole
  group's order;
* NP mode agrees with a float64 plain reference (``hbench/reference/exact.py``),
  and a TF32 control does not;
* traced, the spans count the batches.

The card's kernels hold the same bit equality (``tests/test_torch_cuda.py``).
"""
import importlib.util
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import halton
from repro_torch.core import hmatrix as H
from torch_parity_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N, K, C_LEAF = 1 << 13, 16, 128
BUDGETS = {"few_mib": 4 << 20, "one_row_cluster": 1}
# NP mode against float64 kernel rows at 256 sampled rows: rank-16 ACA on
# clusters of 128 to 1024 points reads 2.3e-6 at worst over 64 columns
# (the Gaussian, N = 2^13); the TF32 control reads 8.7e-5 at best
NP_REL_ERR = 2e-5


def _exact():
    spec = importlib.util.spec_from_file_location("hbench_exact",
                                                  ROOT / "hbench/reference/exact.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batched_groups(hm, budget):
    saved = H.APPLY_BATCH_BYTES
    H.APPLY_BATCH_BYTES = budget
    try:
        return H.block_groups(hm.plan, "cpu", hm.k)
    finally:
        H.APPLY_BATCH_BYTES = saved


@pytest.fixture(scope="module")
def points():
    return halton(N, 2, device="cpu")


@pytest.fixture(scope="module", params=["P", "NP"])
def hms(request, points):
    """The one-batch H-matrix of a mode and its batched twins by budget."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # before the autouse fixture: a module fixture's set-up
    try:
        hm = H.build_hmatrix(points, "gaussian", k=K, c_leaf=C_LEAF, eta=1.5,
                             precompute=request.param == "P", device="cpu")
    finally:
        torch.set_num_threads(threads)
    return hm, {name: replace(hm, groups=_batched_groups(hm, b)) for name, b in BUDGETS.items()}


def _panel(r, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(N, r).astype(np.float32))


def test_the_build_s_groups_are_one_batch_each(hms):
    hm, _ = hms
    assert all(g.batches == () and g.parts() == (g,) for g in hm.groups.values())


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("r", [1, 8, 64])
def test_batched_apply_gives_the_one_batch_bits(hms, budget, r):
    hm, batched = hms
    hb = batched[budget]
    counts = {lv: len(g.parts()) for lv, g in hb.groups.items()}
    assert counts["dense"] >= 3, counts
    if budget == "one_row_cluster":
        assert all(n >= 3 for n in counts.values()), counts
    else:
        assert sum(n >= 3 for lv, n in counts.items() if lv != "dense") >= 2, counts
    x = _panel(r, seed=r)
    assert torch.equal(H.make_apply(hb)(x), H.make_apply(hm)(x))
    assert torch.equal(H.make_apply(hb)(x[:, 0]), H.make_apply(hm)(x[:, 0]))


def test_batch_plan_covers_every_block_once_in_whole_row_clusters(hms):
    hm, batched = hms
    budget = BUDGETS["few_mib"]
    for key, g in batched["few_mib"].groups.items():
        whole = hm.groups[key]
        size = hm.plan.c_leaf if key == "dense" else hm.plan.n_pad >> key
        k = None if key == "dense" else hm.k
        if not g.batches:
            assert H.batch_bytes(size, whole.size, whole.out_rows.shape[0], k) <= budget
            continue
        members = torch.cat([p.members for p in g.batches])
        assert torch.equal(torch.sort(members).values, torch.arange(whole.size))
        shortest = None
        for part in g.batches:
            assert torch.equal(part.rows, whole.rows[part.members])
            assert torch.equal(part.cols, whole.cols[part.members])
            # whole row clusters, taken by decreasing block count
            assert torch.equal(torch.isin(whole.rows, part.out_rows).nonzero()[:, 0],
                               part.members)
            lengths = part.offsets[1:] - part.offsets[:-1]
            assert shortest is None or int(lengths.max()) <= shortest
            shortest = int(lengths.min())
            cost = H.batch_bytes(size, part.size, part.out_rows.shape[0], k)
            assert cost <= budget or part.out_rows.shape[0] == 1, (key, cost)
            # each row cluster's blocks in the whole group's table order
            for u, row in enumerate(part.out_rows.tolist()):
                w = int((whole.out_rows == row).nonzero()[0, 0])
                mine = part.members[part.blocks[part.offsets[u]:part.offsets[u + 1]]]
                assert torch.equal(mine, whole.blocks[whole.offsets[w]:whole.offsets[w + 1]])


def test_np_apply_agrees_with_the_float64_reference(points):
    exact = _exact()
    hm = H.build_hmatrix(points, "gaussian", k=K, c_leaf=C_LEAF, eta=1.5, precompute=False,
                         device="cpu")
    hb = replace(hm, groups=_batched_groups(hm, BUDGETS["few_mib"]))
    x = _panel(64, seed=5)
    rows = torch.from_numpy(np.sort(np.random.RandomState(5).choice(N, 256, replace=False)))
    ref = exact.exact_rows(points, rows, x.t().contiguous(), "gaussian").numpy()
    ctl = exact.control_rows(points, rows, x.t().contiguous(), "gaussian",
                             {"dtype": "float32", "tf32": False}).numpy()

    def rel(got):
        return np.linalg.norm(got - ref, axis=0) / np.linalg.norm(ref, axis=0)

    assert rel(H.make_apply(hb)(x).numpy()[rows.numpy()]).max() <= NP_REL_ERR
    assert rel(ctl).min() > NP_REL_ERR


def test_traced_spans_count_the_batches(hms):
    hm, batched = hms
    hb = batched["few_mib"]
    dense = hb.groups["dense"].parts()
    lowrank = sum(len(hb.groups[lv].parts()) for lv in hb.plan.aca_levels)
    obs.enable()
    try:
        H.make_apply(hb)(_panel(8))
        spans = obs.collect()["spans"]
    finally:
        obs.disable()
        obs.collect()
    named = {}
    for s in spans:
        named.setdefault(s["name"], []).append(s)
    assert [s["batches"] for s in named["apply.lowrank"]] == [lowrank]
    assert [(s["blocks"], s["batches"]) for s in named["apply.dense"]] == \
        [(p.size, len(dense)) for p in dense]
    assert [s["blocks"] for s in named["apply.scatter"]] == [p.size for p in dense]
    aca = [s["blocks"] for s in named.get("apply.aca", [])]
    if hm.factors is None:
        assert aca == [p.size for lv in hb.plan.aca_levels for p in hb.groups[lv].parts()]
    else:
        assert aca == []


@pytest.mark.parametrize("d,kernel", [(2, "gaussian"), (3, "matern")])
def test_the_paper_s_problems_at_2_20_run_each_stage_in_one_batch(d, kernel):
    """The benchmark's N = 2^20 cells keep one launch a stage: the budget
    is above their largest stage (the Matern 3-D dense leaves)."""
    from repro_torch.core import build_block_tree, build_cluster_tree
    tree = build_cluster_tree(halton(1 << 20, d, device="cpu"), c_leaf=2048)
    plan = build_block_tree(tree, eta=1.5)
    groups = H.block_groups(plan, "cpu", K)
    assert all(g.batches == () for g in groups.values())
    rows = np.unique(plan.dense_blocks[:, 0]).size
    largest = H.batch_bytes(plan.c_leaf, plan.num_dense_blocks, rows, None)
    assert largest <= H.APPLY_BATCH_BYTES < 1.1 * largest or kernel == "gaussian"


def test_a_closed_runtime_gives_back_its_pinned_rows(monkeypatch):
    """At N = 2^24 a 64-wide panel's rows are 4 GiB of pinned host memory:
    once its scheduler has stopped, a runtime drops its staging rows and
    has the caching host allocator release the blocks no result holds."""
    from repro_torch.serve import runtime
    released = []
    monkeypatch.setattr(runtime, "release_pinned_host_memory", lambda: released.append(1))
    rt = runtime.PanelRuntime(16, 4, lambda panel: panel * 2.0, device="cpu")
    futs = [rt.submit(np.ones(16, np.float32)) for _ in range(4)]
    assert all(np.array_equal(f.result(timeout=60), np.full(16, 2.0, np.float32))
               for f in futs)
    assert rt._lane._staging and not released
    rt.close()
    assert rt._lane._staging == [] and released == [1]
    assert np.array_equal(futs[0].result(), np.full(16, 2.0, np.float32))
    rt.close()
    assert released == [1]
