"""Port parity of training the LM families (``train/step.py`` for every
block kind and the encoder-decoder, ``models/encdec.py``'s remat, the
``embeds`` stream of ``data/pipeline.py``, ``convert.train_state_from_arrays``,
``runtime/checkpoint.py`` and ``launch/train.py``).

``repro``'s initial train state of each assigned smoke config, in float32,
with its constant-initialised leaves replaced by seeded random values
(``torch_parity_util.randomise``), is carried into the port by
``train_state_from_arrays``; both packages see ``repro``'s batch (B = 2, S
= 72: past mixtral-smoke's window of 64, no multiple of ``ssm_chunk``;
whisper's with 72 frames of ``embeds``).  MoE runs at its capacity factor
1.25, which drops assignments.  Limits: the loss within 1e-5 relative;
every parameter's gradient within 1e-4 relative (Frobenius) of
``jax.value_and_grad(repro.train.step.make_loss_fn(cfg))``; one 2-microbatch
``train_step`` against ``repro``'s jitted one: loss within 1e-5, grad norm
within 1e-4, the AdamW moments m within 1e-4 and v (a square) within 2e-4
relative, and every updated
parameter within 1e-5 relative on the entries whose first moment has the
reference's sign and at least 1e-3 of its tensor's rms, or is zero in both
(at least 95% of them): AdamW's first step moves an entry by lr g / (|g| +
eps), so an entry whose gradient lies within its rounding of zero may step
either way.  The key bias of
attention without RoPE (whisper) has a zero gradient in exact arithmetic
(softmax ignores a shift shared by all keys): there both packages' norms
must lie below 1e-6 of the global gradient norm.  Remat on and off,
batches, checkpoints and the launcher's resume are held exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as registry_jax
from repro.data.pipeline import DataConfig as DataConfigJax
from repro.data.pipeline import make_batch as make_batch_jax
from repro.train import optimizer as opt_jax
from repro.train.step import make_loss_fn as make_loss_fn_jax
from repro.train.step import make_train_step as make_train_step_jax
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.data.pipeline import DataConfig, DataIterator, make_batch
from repro_torch.launch import train as train_launch
from repro_torch.runtime.checkpoint import CheckpointManager, flatten_state
from repro_torch.train.optimizer import AdamWConfig, apply_updates
from repro_torch.train.step import make_loss_fn, make_train_step

from torch_parity_util import one_torch_thread, randomise, rel_err  # noqa: F401

SEQ, BATCH = 72, 2
LOSS_LIMIT, GRAD_LIMIT, PARAM_LIMIT, MOMENT_LIMIT = 1e-5, 1e-4, 1e-5, 1e-4
ZERO_LIMIT, SURE_SHARE = 1e-6, 0.95
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
_CACHE: dict = {}


def _reference(arch):
    """``repro``'s randomised initial train state, its batch, and both configs."""
    if arch not in _CACHE:
        cfg_j = registry_jax.get_smoke(arch).replace(dtype="float32")
        cfg = registry.get_smoke(arch).replace(dtype="float32")
        init_state, _ = make_train_step_jax(cfg_j, opt_jax.AdamWConfig(warmup_steps=1,
                                                                       total_steps=10))
        state_j = init_state(jax.random.PRNGKey(1))
        state_j["params"] = randomise(state_j["params"], np.random.RandomState(2))
        batch_j = make_batch_jax(DataConfigJax(vocab_size=cfg_j.vocab_size, seq_len=SEQ,
                                               global_batch=BATCH, seed=5), 0,
                                 d_model=cfg_j.d_model, with_embeds=cfg_j.is_encoder_decoder)
        _CACHE[arch] = (cfg_j, cfg, state_j, batch_j)
    return _CACHE[arch]


def _port_batch(batch_j) -> dict:
    return {key: torch.from_numpy(np.array(a)).long() if key != "embeds"
            else torch.from_numpy(np.array(a)) for key, a in batch_j.items()}


def _port_state(arch):
    cfg_j, cfg, state_j, batch_j = _reference(arch)
    return cfg, train_state_from_arrays(jax.tree.map(np.asarray, state_j), cfg, device="cpu")


def _zero_in_exact(cfg, name: str) -> bool:
    """A key bias where no RoPE turns it with the key's position."""
    return cfg.rope_theta <= 0 and name.endswith(".bk")


def _close(cfg, name: str, got: np.ndarray, want: np.ndarray, scale: float, limit: float):
    """``got`` within ``limit`` relative of ``want``; an all-zero ``want``
    (an expert no kept assignment reached) exactly; a gradient that is zero
    in exact arithmetic below ZERO_LIMIT of ``scale`` in both."""
    if _zero_in_exact(cfg, name):
        assert max(np.linalg.norm(got), np.linalg.norm(want)) <= ZERO_LIMIT * scale, name
    elif not np.any(want):
        assert not np.any(got), name
    else:
        assert rel_err(got, want) <= limit, name


def _grads(params, batch, loss_fn):
    names, plist = zip(*params.named_parameters())
    loss = loss_fn(params, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, plist)))


@pytest.mark.parametrize("arch", registry.ASSIGNED)
def test_gradients_match_reference(arch):
    cfg_j, cfg, state_j, batch_j = _reference(arch)
    loss_j, grads_j = jax.value_and_grad(make_loss_fn_jax(cfg_j))(state_j["params"], batch_j)
    cfg, state = _port_state(arch)
    loss, grads = _grads(state["params"], _port_batch(batch_j), make_loss_fn(cfg))
    assert rel_err(float(loss), float(loss_j)) <= LOSS_LIMIT
    want = dict(lm_params_from_arrays(jax.tree.map(np.asarray, grads_j), cfg,
                                      device="cpu").named_parameters())
    assert set(want) == set(grads)
    assert all(bool(torch.isfinite(w).all()) for w in want.values())
    norm = float(opt_jax.global_norm(grads_j))
    for name, g in grads.items():
        _close(cfg, name, g.numpy(), want[name].detach().numpy(), norm, GRAD_LIMIT)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b", "xlstm-1.3b", "whisper-tiny",
                                  "qwen2.5-14b"])
def test_two_microbatch_train_step_matches_reference(arch):
    cfg_j, cfg, state_j, batch_j = _reference(arch)
    _, train_step_j = make_train_step_jax(cfg_j, opt_jax.AdamWConfig(lr=OPT.lr, warmup_steps=1,
                                                                     total_steps=10),
                                          microbatches=2)
    new_j, metrics_j = jax.jit(train_step_j)(state_j, batch_j)
    cfg, state = _port_state(arch)
    assert set(state["opt"]) == {"m", "v"}
    names = [name for name, _ in state["params"].named_parameters()]
    assert all(list(state["opt"][key]) == names for key in ("m", "v"))
    _, train_step = make_train_step(cfg, OPT, microbatches=2, device="cpu")
    state, metrics = train_step(state, _port_batch(batch_j))
    assert state["step"] == 1 and int(new_j["step"]) == 1
    assert rel_err(float(metrics["loss"]), float(metrics_j["loss"])) <= LOSS_LIMIT
    assert rel_err(float(metrics["grad_norm"]), float(metrics_j["grad_norm"])) <= GRAD_LIMIT
    assert abs(float(metrics["lr"]) - float(metrics_j["lr"])) <= 1e-7 * float(metrics_j["lr"])
    want = train_state_from_arrays(jax.tree.map(np.asarray, new_j), cfg, device="cpu")
    want_params = dict(want["params"].named_parameters())
    for name, p in state["params"].named_parameters():
        m, m_ref = state["opt"]["m"][name].numpy(), want["opt"]["m"][name].numpy()
        sure = np.ones(m.shape, bool)
        if not _zero_in_exact(cfg, name):
            rms = np.sqrt(np.mean(np.square(m_ref)))
            sure = ((m == 0) & (m_ref == 0)) | (
                (np.sign(m) == np.sign(m_ref)) & (np.abs(m_ref) >= 1e-3 * rms))
        assert sure.mean() >= SURE_SHARE, name
        assert rel_err(p.detach().numpy()[sure],
                       want_params[name].detach().numpy()[sure]) <= PARAM_LIMIT, name
    # the moments after one step: m = (1 - b1) g and v = (1 - b2) g^2 of the
    # clipped gradient, so m's scale is (1 - b1) of the clipped norm
    scale = (1 - OPT.b1) * min(1.0, OPT.grad_clip / float(metrics_j["grad_norm"])) \
        * float(metrics_j["grad_norm"])
    for name in names:
        _close(cfg, name, state["opt"]["m"][name].numpy(), want["opt"]["m"][name].numpy(),
               scale, MOMENT_LIMIT)
        _close(cfg, name, state["opt"]["v"][name].numpy(), want["opt"]["v"][name].numpy(),
               scale ** 2, 2 * MOMENT_LIMIT)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b", "xlstm-1.3b", "whisper-tiny"])
def test_remat_gives_the_same_gradients(arch):
    cfg, state = _port_state(arch)
    batch = _port_batch(_reference(arch)[3])
    loss_r, with_remat = _grads(state["params"], batch, make_loss_fn(cfg, remat=True))
    loss_p, plain = _grads(state["params"], batch, make_loss_fn(cfg, remat=False))
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(with_remat[name], plain[name]) for name in plain)


def test_encdec_forward_takes_remat_in_every_mode():
    cfg, state = _port_state("whisper-tiny")
    batch = _port_batch(_reference("whisper-tiny")[3])
    params = state["params"]
    with torch.no_grad():
        plain, _ = params(batch["tokens"], batch["embeds"], mode="train")
        remat, _ = params(batch["tokens"], batch["embeds"], mode="train", remat=True)
        pre, caches = params(batch["tokens"], batch["embeds"], mode="prefill", remat=True)
    assert plain.shape == (BATCH, SEQ, cfg.padded_vocab) and torch.equal(plain, remat)
    assert pre.shape == (BATCH, 1, cfg.padded_vocab) and len(caches) == cfg.n_layers
    assert torch.allclose(pre[:, 0], plain[:, -1], rtol=0, atol=1e-5)


def test_weight_decay_falls_where_the_reference_stacks_layers():
    """``repro`` decays leaves of rank >= 2, and its stacked layers make every
    vector of a layer before the tail a matrix; the shared block, the tail,
    the final norm and the encoder-decoder's final norms stay vectors."""
    zamba = _port_state("zamba2-7b")[1]["params"]          # 7 layers, periods of 3
    names = zamba.stacked_parameter_names()
    assert "layers.0.ln.w" in names and "layers.4.mamba.a_log" in names
    assert not any(n.startswith(("layers.6.", "shared.", "final_norm")) for n in names)
    whisper = _port_state("whisper-tiny")[1]["params"]
    names = whisper.stacked_parameter_names()
    assert "enc_layers.0.ln1.w" in names and "dec_layers.1.self_attn.bq" in names
    assert not any(n.startswith(("enc_norm", "dec_norm", "embed", "dec_pos")) for n in names)
    # one AdamW step from zero moments: a stacked vector shrinks by lr * wd on
    # top of its update, the tail's does not
    cfg, state = _port_state("zamba2-7b")
    params = state["params"]
    grads = {name: torch.zeros_like(p) for name, p in params.named_parameters()}
    before = {name: p.detach().clone() for name, p in params.named_parameters()}
    apply_updates(params, grads, state["opt"], 0, OPT)
    after = dict(params.named_parameters())
    factor = 1 - OPT.lr * OPT.weight_decay
    assert torch.allclose(after["layers.0.ln.w"], before["layers.0.ln.w"] * factor,
                          rtol=1e-6, atol=0)
    assert torch.equal(after["layers.6.ln.w"], before["layers.6.ln.w"])
    assert torch.equal(after["shared.ln1.w"], before["shared.ln1.w"])


DCFG = DataConfig(vocab_size=512, seq_len=40, global_batch=4, seed=3)


def test_make_batch_with_embeds():
    a = make_batch(DCFG, 5, d_model=24, with_embeds=True, device="cpu")
    b = make_batch(DCFG, 5, d_model=24, with_embeds=True, device="cpu")
    plain = make_batch(DCFG, 5, device="cpu")
    assert set(a) == {"tokens", "labels", "embeds"} and set(plain) == {"tokens", "labels"}
    assert a["embeds"].shape == (4, 40, 24) and a["embeds"].dtype == torch.float32
    assert all(torch.equal(a[key], b[key]) for key in a)
    # the embeds are a third draw: tokens and labels are those of a batch without them
    assert torch.equal(a["tokens"], plain["tokens"]) and torch.equal(a["labels"], plain["labels"])
    assert not torch.equal(a["embeds"], make_batch(DCFG, 6, d_model=24, with_embeds=True,
                                                   device="cpu")["embeds"])
    assert 0.08 < float(a["embeds"].std()) < 0.12 and abs(float(a["embeds"].mean())) < 0.01
    with pytest.raises(ValueError, match="d_model"):
        make_batch(DCFG, 0, with_embeds=True, device="cpu")


def test_data_iterator_passes_embeds_through():
    it = DataIterator(DCFG, d_model=8, with_embeds=True, device="cpu")
    first = [next(it) for _ in range(2)]
    again = DataIterator.from_state(DCFG, {"step": 1, "seed": 3}, d_model=8, with_embeds=True,
                                    device="cpu")
    assert torch.equal(next(again)["embeds"], first[1]["embeds"])
    assert first[0]["embeds"].shape == (4, 40, 8)


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_after_a_step(tmp_path, arch, dtype):
    """One step of the smoke config (whisper's encoder-decoder, zamba2's one
    shared block), saved, then restored into a fresh state bit for bit."""
    cfg = registry.get_smoke(arch).replace(dtype=dtype)
    init_state, train_step = make_train_step(cfg, OPT, microbatches=2, device="cpu")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=0)
    state = init_state(torch.Generator().manual_seed(0))
    state, _ = train_step(state, make_batch(dcfg, 0, d_model=cfg.d_model,
                                            with_embeds=cfg.is_encoder_decoder, device="cpu"))
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state, extra={"data_step": 1})
    restored, manifest = mgr.restore(init_state(torch.Generator().manual_seed(9)))
    a, b = flatten_state(restored), flatten_state(state)
    assert [p for p, _ in a] == [p for p, _ in b] and restored["step"] == 1
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(a, b))
    if arch == "zamba2-7b":       # one weight set for every shared_attn layer
        paths = [p for p, _ in a]
        assert sum(p.startswith("params/shared.") for p in paths) > 0
        assert sum(".attn.wq" in p for p in paths if p.startswith("params/")) == 1
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {"int", "float32", dtype}


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-7b"])
def test_launch_train_runs_and_resumes_the_families_on_the_cpu(tmp_path, capsys, arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq-len", "48",
            "--ckpt-dir", str(tmp_path), "--log-every", "1", "--microbatches", "2"]
    state = train_launch.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert state["step"] == 2 and "[restore]" not in out and "step      1" in out
    state = train_launch.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "step      2" in out
    assert state["step"] == 3 and CheckpointManager(tmp_path).latest_step() == 3
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())

