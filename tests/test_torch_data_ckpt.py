"""The port's data pipeline, checkpoints, preemption flag and training
launcher (``data/pipeline.py``, ``runtime/``, ``launch/train.py``).

Inputs from fixed seeds.  Exact checks throughout: a batch is a pure
function of (seed, step); a checkpoint restores every leaf bit for bit
(bfloat16 included); training resumed from a checkpoint equals a straight
run bit for bit.
"""
import os
import signal

import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import DataConfig, DataIterator, make_batch
from repro_torch.launch import train as train_launch
from repro_torch.models.lm import init_params
from repro_torch.runtime.checkpoint import CheckpointManager, flatten_state
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step

DCFG = DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=3)


def test_batch_is_a_pure_function_of_seed_and_step():
    a, b = make_batch(DCFG, 5, device="cpu"), make_batch(DCFG, 5, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], make_batch(DCFG, 6, device="cpu")["tokens"])
    other_seed = DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=4)
    assert not torch.equal(a["tokens"], make_batch(other_seed, 5, device="cpu")["tokens"])
    tok, lab = a["tokens"], a["labels"]
    assert tok.shape == lab.shape == (4, 64) and tok.dtype == torch.int64
    assert int(tok.min()) >= 0 and int(tok.max()) < 512
    assert torch.equal(lab[:, :-1], tok[:, 1:]) and bool((lab[:, -1] == -1).all())
    # the motif: a position copies the draw 7 back with probability 1/2, so
    # it equals the token 7 back about a quarter of the time
    copies = float((tok[:, 7:] == tok[:, :-7]).float().mean())
    assert 0.2 < copies < 0.35
    # the same batch on another device
    meta = make_batch(DCFG, 5, device="meta")
    assert meta["tokens"].device.type == "meta" and meta["tokens"].shape == (4, 64)


def test_data_iterator_state_round_trip():
    it = DataIterator(DCFG, device="cpu")
    first = [next(it) for _ in range(3)]
    assert it.state() == {"step": 3, "seed": 3}
    again = DataIterator.from_state(DCFG, {"step": 1, "seed": 3}, device="cpu")
    assert torch.equal(next(again)["tokens"], first[1]["tokens"])
    with pytest.raises(ValueError, match="seed"):
        DataIterator.from_state(DCFG, {"step": 1, "seed": 9}, device="cpu")


def test_batch_lands_on_the_card_unless_asked():
    """``make_batch`` and ``DataIterator`` run on the card by default, as
    every entry point of the port does, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(DCFG, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataIterator(DCFG)


def _state(dtype, seed):
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype=dtype)
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    opt = init_opt_state(params, AdamWConfig(compression="bf16_ef"))
    for i, t in enumerate(v for group in opt.values() for v in group.values()):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i)))
    return {"step": seed, "params": params, "opt": opt}


def _leaves_equal(a, b) -> bool:
    fa, fb = flatten_state(a), flatten_state(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, dtype, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    saved = _state(dtype, 7)
    mgr.save(7, saved, extra={"data_step": 7})
    # async: the snapshot was taken at save(); later writes do not reach the file
    snapshot = _state(dtype, 7)
    with torch.no_grad():
        saved["params"].embed.add_(1)
    mgr.wait()
    fresh = _state(dtype, 1)
    assert not _leaves_equal(fresh, snapshot)
    restored, manifest = mgr.restore(fresh)
    assert restored is fresh and manifest["extra"] == {"data_step": 7}
    assert _leaves_equal(restored, snapshot) and restored["step"] == 7
    dtypes = {leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes == {"int", "float32", dtype}


def test_checkpoint_keeps_the_last_k_and_ignores_unfinished_writes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"step": 0, "w": torch.arange(4.0)}
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.list_steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(tmp_path / "step_000000009.tmp")       # a write cut short
    assert mgr.latest_step() == 3
    with pytest.raises(ValueError, match="match"):
        mgr.restore({"step": 0, "v": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_resume_equals_a_straight_run(tmp_path):
    """4 steps straight == 2 steps, save, a fresh restore, 2 more steps."""
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, compression="bf16_ef")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2, seed=0)
    init_state, train_step = make_train_step(cfg, opt_cfg, microbatches=2, device="cpu")
    straight = init_state(torch.Generator().manual_seed(0))
    for step in range(4):
        straight, _ = train_step(straight, make_batch(dcfg, step, device="cpu"))

    first = init_state(torch.Generator().manual_seed(0))
    for step in range(2):
        first, _ = train_step(first, make_batch(dcfg, step, device="cpu"))
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, first, extra={"data_step": 2})
    resumed, manifest = mgr.restore(init_state(torch.Generator().manual_seed(1)))
    for step in range(manifest["extra"]["data_step"], 4):
        resumed, _ = train_step(resumed, make_batch(dcfg, step, device="cpu"))
    assert resumed["step"] == straight["step"] == 4
    assert _leaves_equal(resumed, straight)


def test_preemption_handler_sets_its_flag_on_sigterm():
    handler = PreemptionHandler().install()
    try:
        assert not handler.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.preempted
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not None


def _argv(tmp_path, steps):
    return ["--arch", "qwen2.5-14b-hmatrix", "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", "2", "--seq-len", "128", "--ckpt-dir", str(tmp_path),
            "--log-every", "1", "--microbatches", "2"]


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    state = train_launch.main(_argv(tmp_path, 2))
    assert state["step"] == 2 and CheckpointManager(tmp_path).latest_step() == 2
    out = capsys.readouterr().out
    assert "step      1" in out and "[restore]" not in out
    state = train_launch.main(_argv(tmp_path, 3))
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "step      2" in out
    assert state["step"] == 3
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())


def test_launch_train_raises_without_cuda_when_no_device_is_given(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--arch", "qwen2.5-14b-hmatrix", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
