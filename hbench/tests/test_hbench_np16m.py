"""The NP cell's readers (``aca_roofline``, ``aca_ms``) on hand-made records
of a traced run, and the two flood cells of the Gaussian configuration at a
CPU test's size: sound, correct; the NP one's factors regenerated."""
from __future__ import annotations

import pytest

from hb_util import small_cell

SHAPES = {"dense_blocks": 10, "c": 64, "d": 2, "k": 4, "kernel": "gaussian", "n_pad": 256,
          "groups": [{"level": 1, "blocks": 2, "m": 128, "rows": 2, "cols": 2},
                     {"level": 2, "blocks": 6, "m": 64, "rows": 4, "cols": 4}]}


def record(aca_s=(0.003, 0.001), panels=2, complete=True, trace=True):
    kernels = ([("aca_resident_kernel<2, 0>", s) for s in aca_s]
               + [("aca_stream_row_kernel<2>", 0.002), ("dense_matmat_kernel<2, 0, 8>", 0.01)])
    tr = {"kernels": kernels, "busy_s": 0.02, "window_s": 0.04, "device_ops": [],
          "idle_gaps": []}
    return {"stats": {"panels": panels, "complete": complete, "widths": [64] * panels,
                      "requests": 64 * panels, "pack_s": [0.001] * panels},
            "shapes": SHAPES, "trace": tr if trace else None, "store_bytes": 0, "build_s": 1.0}


def read(name, run):
    from harness import cells
    return cells.load_reader(name)(run)


def test_aca_readers_by_hand():
    from harness import work
    k, d = 4, 2
    least = 0.0
    for g in SHAPES["groups"]:
        ops = g["blocks"] * 2 * g["m"] * (k * (3 * d + 2) + k * (k - 1))
        nbytes = 4 * (g["blocks"] * 2 * g["m"] * k + 256 * d)
        least += max(ops / work.PEAK_FP32, nbytes / work.PEAK_BYTES)
    assert read("aca_roofline.np16m", record()) == pytest.approx(100 * 2 * least / 0.006)
    assert read("aca_ms.np16m", record()) == pytest.approx(3.0)        # 6 ms over 2 panels


@pytest.mark.parametrize("name", ["aca_roofline.np16m", "aca_ms.np16m"])
def test_aca_readers_read_nothing_without_the_aca(name):
    run = record()
    run["trace"]["kernels"] = [kv for kv in run["trace"]["kernels"]
                               if not kv[0].startswith("aca_")]
    assert read(name, run) is None                           # P mode: no aca_ kernel
    assert read(name, record(trace=False)) is None
    assert read(name, record(complete=False)) is None
    assert read(name, record(panels=0)) is None


def test_the_regeneration_of_problem_p_is_bound_by_its_bytes():
    """At 2^20 (problem P's seven level groups) the regeneration's least
    time is U and V written once: 8.33 GiB at 3.35 TB/s, about 2.67 ms
    (``chip_smoke.py``'s ``bound_ms`` for #3, PERF.md §6 row 3)."""
    import importlib.util

    from harness import cells, inputs, work
    from repro_torch.core import build_block_tree, build_cluster_tree
    cfg = cells.resolve("gauss2d.flood").config
    tree = build_cluster_tree(inputs.points(cfg, "cpu"), c_leaf=cfg["c_leaf"])
    shapes = work.plan_shapes(build_block_tree(tree, eta=cfg["eta"]), cfg["k"],
                              cfg["kernel"], cfg["dim"])
    spec = importlib.util.spec_from_file_location("aca_roofline",
                                                  cells.metric_file("aca_roofline.np16m"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    uv = sum(4.0 * g["blocks"] * 2 * g["m"] * cfg["k"] for g in shapes["groups"])
    assert uv / 2 ** 30 == pytest.approx(8.33, abs=0.01)
    assert module.regeneration_least_s(shapes) * 1e3 == pytest.approx(2.67, abs=0.02)


@pytest.mark.parametrize("name", ["gauss2d.flood", "gauss2d-16m-np.flood"])
def test_the_flood_cells_run_correct_at_a_small_size(name, monkeypatch):
    from harness import bench
    from repro_torch.kernels.batched_aca import ref
    regenerated = []
    level_ref = ref.batched_aca_level_ref
    monkeypatch.setattr("repro_torch.kernels.batched_aca.ops.batched_aca_level_ref",
                        lambda *a, **kw: (regenerated.append(1), level_ref(*a, **kw))[1])
    cell = small_cell(name, n=2048)
    res = bench.run_cell(cell, 2 ** 31 + 123, 1.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert bool(regenerated) == (not cell.config["precompute"])
    assert (res["run"]["store_bytes"] == 0) == (not cell.config["precompute"])
