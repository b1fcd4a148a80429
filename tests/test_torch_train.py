"""Port parity of training: AdamW (``train/optimizer.py``), the train step
(``train/step.py``) and one step of the H-attention LM against ``repro``.

Inputs from numpy seeds (or ``repro``'s own state and batch, carried over
by ``train_state_from_arrays``).  Limits: the schedule within 1e-7;
``apply_updates`` within 1e-6 relative (Frobenius) per tensor over three
steps, both compressions, clip on and off; ``repro``'s optimizer and step
tests mirrored with their limits; the loss of ``qwen2.5-14b-smoke`` down
by 0.4 nats over 40 steps; one step of ``qwen2.5-14b-hmatrix-smoke`` in
float32 at S = 256 and 512: the loss within 1e-5, the gradient norm and
each parameter's gradient within 1e-3 (ACA pivots are on the path: ROADMAP
§3 fault 4).  At S = 512 ``repro``'s gradient holds NaN entries in layer
0's attention path and the embedding (ROADMAP §3 fault 15): there the
port's gradient must be finite everywhere and is compared on the entries
where the reference's is finite, its norm not at all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as get_smoke_jax
from repro.data.pipeline import DataConfig as DataConfigJax
from repro.data.pipeline import make_batch as make_batch_jax
from repro.train import optimizer as opt_jax
from repro.train.step import make_loss_fn as make_loss_fn_jax
from repro.train.step import make_train_step as make_train_step_jax
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.train.optimizer import (AdamWConfig, apply_updates, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.step import make_loss_fn, make_train_step

from torch_parity_util import rel_err


def _jax_cfg(cfg: AdamWConfig):
    return opt_jax.AdamWConfig(**dataclasses.asdict(cfg))


def test_lr_schedule_matches_reference():
    for cfg in (AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
                AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7, min_lr_ratio=0.0)):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            want = float(opt_jax.lr_schedule(_jax_cfg(cfg), jnp.asarray(step)))
            got = float(lr_schedule(cfg, step))
            assert abs(got - want) <= 1e-7 * max(abs(want), 1e-30), (step, got, want)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1e-3) < 1e-9          # peak at the end of warmup
    assert lrs[3] < lrs[2] and lrs[4] < lrs[3]  # cosine decay


@pytest.mark.parametrize("compression", ["none", "bf16_ef"])
@pytest.mark.parametrize("grad_clip", [0.0, 0.5])
def test_apply_updates_matches_reference(compression, grad_clip):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=grad_clip,
                      compression=compression)
    rng = np.random.RandomState(5)
    shapes = {"b": (6,), "e": (4, 3, 2), "w": (8, 6)}    # repro's tree order
    params_np = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    params_j = {n: jnp.asarray(a) for n, a in params_np.items()}
    params = {n: torch.from_numpy(a.copy()) for n, a in params_np.items()}
    state_j = opt_jax.init_opt_state(params_j, _jax_cfg(cfg))
    state = init_opt_state(params, cfg)
    for step in range(3):
        grads_np = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
        params_j, state_j, m_j = opt_jax.apply_updates(
            params_j, {n: jnp.asarray(a) for n, a in grads_np.items()}, state_j,
            jnp.asarray(step), _jax_cfg(cfg))
        _, _, m = apply_updates(params, {n: torch.from_numpy(a) for n, a in grads_np.items()},
                                state, step, cfg)
        assert abs(float(m["lr"]) - float(m_j["lr"])) <= 1e-7 * float(m_j["lr"])
        assert rel_err(float(m["grad_norm"]), float(m_j["grad_norm"])) <= 1e-6
        for n in shapes:
            assert rel_err(params[n].numpy(), np.asarray(params_j[n])) <= 1e-6, (step, n)
            for key in state_j:
                assert rel_err(state[key][n].numpy(), np.asarray(state_j[key][n])) <= 1e-6


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -2.0])}
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000, weight_decay=0.0, grad_clip=0.0)
    opt = init_opt_state(params, cfg)
    for step in range(200):
        apply_updates(params, {"w": 2.0 * params["w"]}, opt, step, cfg)   # d/dw of w^2
    assert float(params["w"].abs().max()) < 0.2


def test_bf16_error_feedback_compression_converges():
    """bf16 gradient compression with error feedback reaches the same
    neighbourhood as uncompressed AdamW."""
    def run(compression):
        params = {"w": torch.linspace(-1, 1, 64)}
        cfg = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=2000, weight_decay=0.0,
                          grad_clip=0.0, compression=compression)
        opt = init_opt_state(params, cfg)
        for step in range(300):
            apply_updates(params, {"w": 2.0 * params["w"] + 0.001}, opt, step, cfg)
        return float((params["w"] + 0.0005).abs().max())

    assert run("bf16_ef") < 0.05
    assert abs(run("bf16_ef") - run("none")) < 0.05


def _smoke_step(cfg, opt_cfg, microbatches=1, seed=0):
    init_state, train_step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                             device="cpu")
    return init_state(torch.Generator().manual_seed(seed)), train_step


def test_microbatch_grad_equivalence():
    """Same batch, microbatches = 1 vs 4 -> the same updated parameters."""
    cfg = get_smoke("qwen2.5-14b").replace(dtype="float32")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10, grad_clip=0.0)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
                                  seed=1), 0, device="cpu")
    outs = []
    for mb in (1, 4):
        state, train_step = _smoke_step(cfg, opt_cfg, mb)
        state, _ = train_step(state, batch)
        outs.append([p.detach().clone() for p in state["params"].parameters()])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_grad_clipping_metric():
    cfg = get_smoke("qwen2.5-14b").replace(dtype="float32")
    state, train_step = _smoke_step(cfg, AdamWConfig(grad_clip=1e-9, warmup_steps=0,
                                                     total_steps=10))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                                  seed=0), 0, device="cpu")
    before = [p.detach().clone() for p in state["params"].parameters()]
    state, m = train_step(state, batch)
    delta = max(float((p.detach() - b).abs().max())
                for p, b in zip(state["params"].parameters(), before))
    assert delta < 1e-3                            # a near-zero clip barely moves them
    assert float(m["grad_norm"]) > 0 and state["step"] == 1


def test_loss_decreases_qwen_smoke():
    """repro's test_loss_decreases_smollm_smoke on qwen2.5-14b-smoke (smollm
    is not ported): the stream carries ~0.5 nats of learnable structure."""
    cfg = get_smoke("qwen2.5-14b").replace(dtype="float32")
    state, train_step = _smoke_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2,
                                                     total_steps=200, weight_decay=0.0))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    losses = []
    for step in range(40):
        state, m = train_step(state, make_batch(dcfg, step, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < losses[0] - 0.4, losses


_STATES: dict = {}


def _reference_state(seq):
    """repro's initial train state of the hmatrix smoke config (float32) with
    seeded random biases and norm gains, and repro's batch at ``seq``."""
    if "state" not in _STATES:
        cfg_j = get_smoke_jax("qwen2.5-14b-hmatrix").replace(dtype="float32")
        init_state, _ = make_train_step_jax(cfg_j, opt_jax.AdamWConfig(warmup_steps=1,
                                                                       total_steps=10))
        state = init_state(jax.random.PRNGKey(3))
        rng = np.random.RandomState(4)

        def leaf(path, x):
            if path[-1].key in ("bq", "bk", "bv", "w"):
                return jnp.asarray(0.1 * rng.randn(*x.shape).astype(np.float32))
            return x
        state["params"] = jax.tree_util.tree_map_with_path(leaf, state["params"])
        _STATES.update(cfg_j=cfg_j, state=state)
    batch = make_batch_jax(DataConfigJax(vocab_size=512, seq_len=seq, global_batch=2, seed=6), 0)
    return _STATES["cfg_j"], _STATES["state"], {"tokens": batch["tokens"],
                                                "labels": batch["labels"]}


@pytest.mark.parametrize("seq", [256, 512])
def test_hmatrix_train_step_matches_reference(seq):
    cfg_j, state_j, batch_j = _reference_state(seq)
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    loss_j, grads_j = jax.value_and_grad(make_loss_fn_jax(cfg_j))(state_j["params"], batch_j)
    state = train_state_from_arrays(jax.tree.map(np.asarray, state_j), cfg, device="cpu")
    assert state["step"] == 0 and set(state["opt"]) == {"m", "v"}
    batch = {key: torch.from_numpy(np.array(a)).long() for key, a in batch_j.items()}
    params = state["params"]
    loss = make_loss_fn(cfg)(params, batch)
    names, plist = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, plist)))
    assert rel_err(float(loss.detach()), float(loss_j)) <= 1e-5
    want = dict(lm_params_from_arrays(jax.tree.map(np.asarray, grads_j), cfg,
                                      device="cpu").named_parameters())
    assert set(want) == set(grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    ref_finite = all(bool(torch.isfinite(w).all()) for w in want.values())
    assert ref_finite == (seq == 256)
    if ref_finite:
        assert rel_err(float(global_norm(grads.values())),
                       float(opt_jax.global_norm(grads_j))) <= 1e-3
    for name, g in grads.items():
        w = want[name].detach()
        ok = torch.isfinite(w)
        if bool(ok.any()):
            assert rel_err(g[ok].numpy(), w[ok].numpy()) <= 1e-3, name
