"""The dry run (``repro_torch.launch.dryrun``): its extrapolation over periods,
microbatches and sLSTM's per-token loop equals a full trace exactly, on
smoke configs cut to 3 periods (one dense, one MoE, the Mamba2 hybrid with
its tail, the encoder-decoder, and xLSTM for the per-token loop); and one
full-width cell runs with finite terms."""
import math

import pytest

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke
from repro_torch.launch import dryrun
from torch_parity_util import one_torch_thread  # noqa: F401

# smoke configs at 3 periods (zamba2: 3 periods of 3 and a tail of 1)
CONFIGS = {
    "dense": get_smoke("qwen2.5-14b").replace(n_layers=3),
    "moe": get_smoke("granite-moe-1b-a400m").replace(n_layers=3),
    "hybrid": get_smoke("zamba2-7b").replace(n_layers=10),
    "encdec": get_smoke("whisper-tiny").replace(n_layers=3, n_enc_layers=3),
}
# a train step of 3 microbatches extrapolates over them too (the dense
# config); the others trace their 2 microbatches, to keep the file short
SHAPES = {"train": (ShapeConfig("t", 16, 4, "train"), 2),
          "prefill": (ShapeConfig("p", 64, 2, "prefill"), 1),
          "decode": (ShapeConfig("d", 64, 2, "decode"), 1)}


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("family", list(CONFIGS))
def test_extrapolation_equals_a_full_trace(family, kind):
    cfg = CONFIGS[family]
    shape, mb = SHAPES[kind]
    if family == "dense" and kind == "train":
        shape, mb = ShapeConfig("t", 16, 6, "train"), 3
    assert dryrun.depth_split(cfg)[0] == 3
    got = dryrun.cell_counts(cfg, shape, mb)
    want = dryrun.trace_step(cfg, kind, shape.global_batch, shape.seq_len, mb)
    assert got.dot_flops == want.dot_flops > 0
    assert got.traffic_bytes == want.traffic_bytes > 0
    assert got.collective_bytes is None
    trips = {loop["body"]: loop["trip"] for loop in got.loops if "body" in loop}
    assert trips["period of block_pattern"] == 3
    if kind == "train":
        assert trips["microbatch"] == mb


@pytest.mark.parametrize("kind,layers,chunk,seq", [("prefill", 12, 4, 12), ("train", 4, 2, 10)])
def test_extrapolation_over_the_per_token_loop(kind, layers, chunk, seq):
    """xLSTM: a prefill at 3 periods of 3 chunks from 0 and 1 period at 1
    and 2 chunks; a train step (one period, traced) at 5 chunks from 2, 3
    and 4."""
    cfg = get_smoke("xlstm-1.3b").replace(n_layers=layers, ssm_chunk=chunk)
    shape = ShapeConfig("x", seq, 2, kind)
    got = dryrun.cell_counts(cfg, shape, 1)
    want = dryrun.trace_step(cfg, kind, shape.global_batch, shape.seq_len)
    assert got.dot_flops == want.dot_flops and got.traffic_bytes == want.traffic_bytes
    trips = {loop["body"]: loop["trip"] for loop in got.loops if "body" in loop}
    assert trips["token (sLSTM's per-token loop)"] == seq
    traced = [p for loop in got.loops if "traced_at" in loop for p in loop["traced_at"]]
    assert max(p["seq"] for p in traced) < seq


def test_a_full_width_cell_has_finite_terms(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    (rec,) = dryrun.run([("qwen2.5-14b-hmatrix", "prefill_32k")], (False,), log=lambda _m: None)
    assert not rec["skipped"] and rec["chips"] == 256
    terms = rec["roofline"]
    for key in ("compute_s", "memory_s", "step_time_s", "flops_per_chip"):
        assert math.isfinite(terms[key]) and terms[key] > 0
    assert terms["collective_s"] is None and rec["traced"]["collective_bytes"] is None
    assert 0.5 <= rec["traced"]["dot_flops"] / rec["model_flops_global"] <= 3
    b = rec["bytes_per_device"]
    assert b["activations"] is None and b["params"] > 0 and b["batch"] > 0
    assert (tmp_path / "qwen2.5-14b-hmatrix--prefill_32k--single.json").exists()


def test_skipped_cells_are_recorded():
    (rec,) = dryrun.analyze_cell("qwen2.5-14b", "long_500k", (True,))
    assert rec["skipped"] and rec["mesh"] == "multi"
