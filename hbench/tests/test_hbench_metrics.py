"""Each per-layer reader on a hand-made record of a traced run: what it
reads, and nothing where there is nothing to read."""
from __future__ import annotations

import pytest

SHAPES = {"dense_blocks": 10, "c": 64, "d": 2, "k": 4, "kernel": "gaussian", "n_pad": 256,
          "groups": [{"level": 1, "blocks": 2, "m": 128, "rows": 2, "cols": 2}]}


def record(trace=True, widths=(16, 32), complete=True, requests=36):
    from harness import work
    dense = [work.dense_least_s(SHAPES, w) * 4 for w in widths]      # 25% of the roofline
    lowrank = [work.lowrank_least_s(SHAPES, w) * 2 for w in widths]  # 50%
    kernels = ([("dense_matmat_kernel<2, 0, 8>", s) for s in dense]
               + [("lowrank_vtx_kernel<4>", s / 2) for s in lowrank]
               + [("lowrank_ut_kernel<4, 4, true>", s / 2) for s in lowrank]
               + [("elementwise", 1e-3)])
    busy = sum(s for _, s in kernels)
    tr = {"kernels": kernels, "busy_s": busy, "window_s": 4 * busy,
          "device_ops": [], "idle_gaps": []}
    return {"stats": {"panels": len(widths), "complete": complete, "widths": list(widths),
                      "requests": requests if widths else 0,
                      "pack_s": [0.002, 0.004][:len(widths)]},
            "shapes": SHAPES, "trace": tr if trace else None, "store_bytes": 3 << 30,
            "build_s": 1.5}


def read(name, run):
    from harness import cells
    return cells.load_reader(name)(run)


def test_readers_by_hand():
    from harness import work
    run = record()
    tr = run["trace"]
    assert read("dense_roofline.flood", run) == pytest.approx(25.0)
    assert read("lowrank_roofline.steady", run) == pytest.approx(50.0)
    assert read("idle_share.flood", run) == pytest.approx(75.0)
    # the work the 36 requests need: two panels at 18 occupied columns, not 16 + 32
    least = 2 * (work.dense_least_s(SHAPES, 18) + work.lowrank_least_s(SHAPES, 18))
    assert read("apply_mfu.steady", run) == pytest.approx(100 * least / tr["window_s"])
    padded = sum(work.dense_least_s(SHAPES, w) + work.lowrank_least_s(SHAPES, w)
                 for w in (16, 32))
    assert least < padded
    assert read("apply_gpu_ms.flood", run) == pytest.approx(1e3 * tr["busy_s"] / 2)
    assert read("pack_ms.flood", run) == pytest.approx(3.0)
    assert read("panel_width.steady", run) == pytest.approx(18.0)      # requests a panel
    assert read("pad_share.steady", run) == pytest.approx(25.0)        # 12 of 48 columns
    assert read("store_gib", run) == pytest.approx(3.0)
    assert read("build_s", run) == 1.5


@pytest.mark.parametrize("name", ["dense_roofline.flood", "lowrank_roofline.flood",
                                  "idle_share.flood", "apply_mfu.flood", "apply_gpu_ms.flood"])
def test_device_readers_read_nothing_without_a_trace(name):
    assert read(name, record(trace=False)) is None


def test_nothing_to_read_returns_none():
    run = record()
    run["trace"]["kernels"] = [k for k in run["trace"]["kernels"]
                               if not k[0].startswith("dense")]
    assert read("dense_roofline.steady", run) is None      # launches != panels
    assert read("pack_ms.flood", record(complete=False)) is None
    assert read("panel_width.steady", record(widths=())) is None
    assert read("pad_share.steady", record(widths=())) is None
    assert read("pad_share.steady", record(complete=False)) is None
