"""Port parity of the encoder-decoder (``models/encdec.py``; whisper-tiny).

``repro.models.encdec.init_params`` of ``whisper-tiny-smoke`` in float32,
with its zero biases and its layernorm gains and biases replaced by seeded
random values, is carried into the port by ``lm_params_from_arrays``; both
packages see the same frames and tokens.  Limits as in
``test_torch_families.py``: train-mode logits within 1e-4 relative, prefill
caches within 1e-5 (relative to the entry's largest value where that passes
1), 8 greedy decode steps within 1e-4 with equal tokens.  ``repro``'s self
K / V are grown for decoding, its cross K / V are not (``repro.launch.serve``
pads those too, and decode then attends to zero keys: ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as get_smoke_jax
from repro.models import encdec as encdec_jax
from repro.serve.step import greedy_sample as greedy_jax
from repro.serve.step import make_decode_step as decode_jax
from repro.serve.step import make_prefill_step as prefill_jax
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_launch
from repro_torch.models import encdec
from repro_torch.models.api import count_params, get_model
from repro_torch.serve.step import greedy_sample, make_decode_step, make_prefill_step

from torch_parity_util import one_torch_thread, randomise, rel_err  # noqa: F401

ARCH = "whisper-tiny"
_CACHE: dict = {}


def _models():
    if not _CACHE:
        cfg_j = get_smoke_jax(ARCH).replace(dtype="float32")
        cfg = get_smoke(ARCH).replace(dtype="float32")
        params_j = randomise(encdec_jax.init_params(jax.random.PRNGKey(1), cfg_j),
                             np.random.RandomState(2))
        model = lm_params_from_arrays(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
        _CACHE.update(cfg_j=cfg_j, params_j=params_j, cfg=cfg, model=model,
                      prefill_j=jax.jit(prefill_jax(cfg_j)), decode_j=jax.jit(decode_jax(cfg_j)))
    return _CACHE


def _inputs(b, s_dec, s_enc, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 512, (b, s_dec)).astype(np.int32),
            rng.randn(b, s_enc, 64).astype(np.float32))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=what)


def test_converted_params_keep_names_and_count():
    m = _models()
    model, params_j = m["model"], m["params_j"]
    assert isinstance(model, encdec.EncDec)
    assert count_params(model) == sum(x.size for x in jax.tree.leaves(params_j))
    names = dict(model.named_parameters())
    np.testing.assert_array_equal(names["dec_layers.1.cross_attn.bv"].detach().numpy(),
                                  np.asarray(params_j["dec_layers"]["cross_attn"]["bv"][1]))
    np.testing.assert_array_equal(names["enc_layers.0.mlp.wu"].detach().numpy(),
                                  np.asarray(params_j["enc_layers"]["mlp"]["wu"][0]))
    assert names["dec_pos"].shape == (4096, 64)


@pytest.mark.parametrize("s_dec,s_enc", [(40, 48), (72, 24)])
def test_train_logits_match_reference(s_dec, s_enc):
    m = _models()
    tok, frames = _inputs(2, s_dec, s_enc, seed=s_dec)
    want, _ = encdec_jax.forward(m["params_j"], m["cfg_j"], tokens=jnp.asarray(tok),
                                 embeds=jnp.asarray(frames), mode="train")
    with torch.no_grad():
        got, caches = encdec.forward(m["model"], m["cfg"], torch.from_numpy(tok),
                                     torch.from_numpy(frames), mode="train")
    assert caches is None and got.shape == (2, s_dec, m["cfg"].padded_vocab)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4


def test_prefill_and_greedy_decode_match_reference():
    m = _models()
    cfg_j, cfg, params_j, model = m["cfg_j"], m["cfg"], m["params_j"], m["model"]
    b, s, steps = 2, 40, 8
    tok, frames = _inputs(b, s, s, seed=9)
    logits_j, caches_j = m["prefill_j"](params_j, jnp.asarray(tok), jnp.asarray(frames))
    logits, caches = make_prefill_step(cfg)(model, torch.from_numpy(tok),
                                            torch.from_numpy(frames))
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert rel_err(logits.numpy(), np.asarray(logits_j)) <= 1e-4
    for i, layer in enumerate(caches):
        for part in ("self", "cross"):
            for g, w in zip(layer[part], caches_j[part]):
                _close(g, w[i], f"layer {i} {part}")

    caches_j = {"self": tuple(jnp.pad(a, [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)])
                              for a in caches_j["self"]), "cross": caches_j["cross"]}
    caches = serve_launch.grow_caches(caches, steps, cfg)
    assert caches[0]["cross"][0].shape[1] == s and caches[0]["self"][0].shape[1] == s + steps
    decode = make_decode_step(cfg)
    t_j = greedy_jax(logits_j, cfg_j.vocab_size)
    t = greedy_sample(logits, cfg.vocab_size)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    for i in range(steps):
        logits_j, caches_j = m["decode_j"](params_j, t_j, caches_j, jnp.asarray(s + i, jnp.int32))
        logits, caches = decode(model, t, caches, s + i)
        assert rel_err(logits.numpy(), np.asarray(logits_j)) <= 1e-4, i
        t_j = greedy_jax(logits_j, cfg_j.vocab_size)
        t = greedy_sample(logits, cfg.vocab_size)
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


def test_decoder_positions_past_the_table_are_clipped():
    """``repro`` clips decoder positions at row 4,095 of the learned table:
    a decode step at cache_len 5,000 reads that row, as ``repro``'s does."""
    m = _models()
    cfg_j, cfg, params_j, model = m["cfg_j"], m["cfg"], m["params_j"], m["model"]
    tok, frames = _inputs(1, 1, 16, seed=3)
    caches_j = jax.tree.map(lambda a: jnp.asarray(np.random.RandomState(4).randn(*a.shape)
                                                  .astype(np.float32)),
                            encdec_jax.init_caches(cfg_j, 1, 5002, 16))
    caches = [{"self": tuple(torch.from_numpy(np.array(a[i])) for a in caches_j["self"]),
               "cross": tuple(torch.from_numpy(np.array(a[i])) for a in caches_j["cross"])}
              for i in range(cfg.n_layers)]
    want, _ = m["decode_j"](params_j, jnp.asarray(tok), caches_j, jnp.asarray(5000, jnp.int32))
    got, _ = make_decode_step(cfg)(model, torch.from_numpy(tok), caches, 5000)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4


def test_get_model_dispatches_the_encoder_decoder():
    cfg = get_smoke(ARCH).replace(dtype="float32")
    model = get_model(cfg, "cpu")
    params = model["init_params"](torch.Generator().manual_seed(0))
    assert isinstance(params, encdec.EncDec)
    caches = model["init_caches"](2, 20, enc_seq=12)
    assert caches[0]["self"][0].shape == (2, 20, 2, 32)
    assert caches[1]["cross"][1].shape == (2, 12, 2, 32)


def test_launch_serve_runs_whisper_on_the_cpu():
    out = serve_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "24", "--decode-steps", "4"])
    assert out["tokens"].shape == (2, 4)
    assert torch.isfinite(out["logits"]).all()
    assert out["caches"][0]["cross"][0].shape == (2, 24, 2, 32)
