"""Port parity of the LM families beyond ``dense`` (``models/{moe,mamba2,xlstm}.py``,
``banded_attention``, ``models/lm.py``'s block kinds, ``convert.py``, the
serving steps and ``configs/registry.py``).

``repro``'s ``init_params`` of each decoder-only smoke config, in float32,
with the zero biases and norm gains and the SSM and xLSTM constants
(``a_log``, ``dt_bias``, ``d_skip``, ``f_bias``, ``bias``) replaced by seeded
random values, is carried into the port by ``lm_params_from_arrays``; both
packages then see the same tokens.  Limits: train-mode logits within 1e-4
relative (Frobenius), prefill caches and states within 1e-5 of the
reference, relative to the entry's largest value where that passes 1
(sLSTM's c and n grow with the sequence; the residual stream grows through
Mamba2 layers, so the K / V after them carry ~1e-6 relative fp32 rounding
that an absolute 1e-5 would not admit), 8 greedy decode steps within 1e-4
relative with equal tokens.  ``repro``'s
caches are grown for decoding by self-attention K / V only, as the port's
``grow_caches`` grows them.  S = 72 is no multiple of the smoke configs'
``ssm_chunk`` (16) and passes mixtral-smoke's window (64).  MoE runs at its
capacity factor 1.25, which drops assignments in train mode and at decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as registry_jax
from repro.models import lm as lm_jax
from repro.serve.step import greedy_sample as greedy_jax
from repro.serve.step import make_decode_step as decode_jax
from repro.serve.step import make_prefill_step as prefill_jax
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_launch
from repro_torch.models import lm
from repro_torch.models.api import count_params
from repro_torch.serve.step import greedy_sample, make_decode_step, make_prefill_step

from torch_parity_util import one_torch_thread, randomise, rel_err  # noqa: F401

ARCHS = ["gemma-7b", "smollm-135m", "phi3-medium-14b", "chameleon-34b",
         "granite-moe-1b-a400m", "mixtral-8x7b", "xlstm-1.3b", "zamba2-7b"]
SEQ = 72
_CACHE: dict = {}

def _models(arch):
    if arch not in _CACHE:
        cfg_j = registry_jax.get_smoke(arch).replace(dtype="float32")
        cfg = registry.get_smoke(arch).replace(dtype="float32")
        params_j = randomise(lm_jax.init_params(jax.random.PRNGKey(1), cfg_j),
                             np.random.RandomState(2))
        model = lm_params_from_arrays(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
        _CACHE[arch] = (cfg_j, params_j, cfg, model, jax.jit(prefill_jax(cfg_j)),
                        jax.jit(decode_jax(cfg_j)))
    return _CACHE[arch]


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(np.int32)


def _layer_entry(tree, cfg, i):
    """Layer ``i``'s entry of ``repro``'s ``{"pattern", "tail"}`` cache tree."""
    n_p = len(cfg.block_pattern)
    periods = cfg.n_layers // n_p
    if i < periods * n_p:
        return jax.tree.map(lambda a: np.asarray(a[i // n_p]), tree["pattern"][i % n_p])
    return jax.tree.map(np.asarray, tree["tail"][i - periods * n_p])


def _grow_reference(caches_j, cfg, extra):
    """``repro``'s prefill caches grown by self-attention K / V only."""
    def grow(tree, axis):
        pad = [(0, 0)] * tree.ndim
        pad[axis] = (0, extra)
        return jnp.pad(tree, pad)
    n_p = len(cfg.block_pattern)
    tail_kinds = cfg.layer_kinds[(cfg.n_layers // n_p) * n_p:]
    return {"pattern": [tuple(grow(a, 2) for a in c) if kind in lm.ATTN_KINDS else c
                        for c, kind in zip(caches_j["pattern"], cfg.block_pattern)],
            "tail": [tuple(grow(a, 1) for a in c) if kind in lm.ATTN_KINDS else c
                     for c, kind in zip(caches_j["tail"], tail_kinds)]}


def _as_list(entry):
    return list(entry) if isinstance(entry, (tuple, list)) else [entry]


_PROBE = {"dense": "attn.wq", "moe": "moe.wg", "mamba": "mamba.w_in", "mlstm": "mlstm.w_up",
          "slstm": "slstm.r_h"}


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_keep_names_and_count(arch):
    """Every layer holds its own period's slice (the tail too); the shared
    block is listed once, as ``shared``."""
    cfg_j, params_j, cfg, model, *_ = _models(arch)
    assert count_params(model) == sum(x.size for x in jax.tree.leaves(params_j))
    names = dict(model.named_parameters())
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "shared_attn":
            assert not any(n.startswith(f"layers.{i}.") for n in names)
            continue
        sub, leaf = _PROBE[kind].split(".")
        np.testing.assert_array_equal(names[f"layers.{i}.{sub}.{leaf}"].detach().numpy(),
                                      _layer_entry(params_j, cfg, i)[sub][leaf])
    if "shared_attn" in cfg.layer_kinds:
        np.testing.assert_array_equal(names["shared.attn.wq"].detach().numpy(),
                                      np.asarray(params_j["shared"]["attn"]["wq"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    cfg_j, params_j, cfg, model, *_ = _models(arch)
    tok = _tokens(2, SEQ, seed=11)
    want, _ = lm_jax.forward(params_j, cfg_j, tokens=jnp.asarray(tok), mode="train")
    with torch.no_grad():
        got, caches = lm.forward(model, cfg, torch.from_numpy(tok), mode="train")
    assert caches is None and got.shape == (2, SEQ, cfg.padded_vocab)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg_j, params_j, cfg, model, prefill_j, decode_j = _models(arch)
    b, s, steps = 2, SEQ, 8
    tok = _tokens(b, s, seed=5)
    logits_j, caches_j = prefill_j(params_j, jnp.asarray(tok))
    logits, caches = make_prefill_step(cfg)(model, torch.from_numpy(tok))
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert rel_err(logits.numpy(), np.asarray(logits_j)) <= 1e-4
    for i, entry in enumerate(caches):
        want = _as_list(_layer_entry(caches_j, cfg, i))
        got = _as_list(entry)
        assert len(got) == len(want), i
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                       err_msg=f"layer {i}")

    caches_j = _grow_reference(caches_j, cfg_j, steps)
    caches = serve_launch.grow_caches(caches, steps, cfg)
    decode = make_decode_step(cfg)
    t_j = greedy_jax(logits_j, cfg_j.vocab_size)
    t = greedy_sample(logits, cfg.vocab_size)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    for i in range(steps):
        logits_j, caches_j = decode_j(params_j, t_j, caches_j, jnp.asarray(s + i, jnp.int32))
        logits, caches = decode(model, t, caches, s + i)
        assert rel_err(logits.numpy(), np.asarray(logits_j)) <= 1e-4, i
        t_j = greedy_jax(logits_j, cfg_j.vocab_size)
        t = greedy_sample(logits, cfg.vocab_size)
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_grow_caches_grows_self_attention_only(arch):
    cfg = registry.get_smoke(arch).replace(dtype="float32")
    caches = lm.init_caches(cfg, 2, 10, device="cpu")
    grown = serve_launch.grow_caches(caches, 3, cfg)
    for kind, old, new in zip(cfg.layer_kinds, caches, grown):
        if kind in lm.ATTN_KINDS:
            assert all(t.shape[1] == 13 for t in new)
        else:
            assert all(a is b for a, b in zip(_as_list(old), _as_list(new)))


# ---------------------------------------------------------------------------
# unit parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,chunk,q_offset", [(24, 16, 0), (40, 32, 0), (24, 16, 32)])
def test_banded_attention_matches_reference(window, chunk, q_offset):
    """Window below S and several q chunks: the clipped first spans too."""
    from repro.models.layers import banded_attention as banded_jax
    from repro_torch.models.layers import banded_attention
    rng = np.random.RandomState(window + chunk)
    q = rng.randn(2, 96, 4, 16).astype(np.float32)
    k = rng.randn(2, 96, 2, 16).astype(np.float32)
    v = rng.randn(2, 96, 2, 16).astype(np.float32)
    want = banded_jax(*(jnp.asarray(a) for a in (q, k, v)), window=window, chunk=chunk,
                      q_offset=q_offset)
    got = banded_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                           chunk=chunk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sinusoidal_positions_match_reference():
    from repro.models.layers import sinusoidal_positions as sin_jax
    from repro_torch.models.layers import sinusoidal_positions
    want = np.asarray(sin_jax(300, 64, jnp.float32))
    got = sinusoidal_positions(300, 64, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _ssd_inputs(s, seed):
    rng = np.random.RandomState(seed)
    b, h, p, n = 2, 3, 8, 6
    return (rng.randn(b, s, h, p).astype(np.float32),
            np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32),
            (0.5 * rng.randn(h)).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32), rng.randn(b, s, n).astype(np.float32),
            (1.0 + 0.1 * rng.randn(h)).astype(np.float32))


def test_ssd_chunked_and_step_match_reference():
    """``ssd_chunked`` at S = 40 padded to chunks of 16 (dt = 0 on the pad,
    as ``mamba_block`` pads), its final state against ``repro``'s, then 3
    ``ssd_step`` updates from it."""
    from repro.models import mamba2 as m_jax
    from repro_torch.models import mamba2
    x, dt, a_log, bm, cm, d_skip = _ssd_inputs(40, seed=3)
    pad = [(0, 0), (0, 8)]
    xp, dtp, bp, cp = (np.pad(a, pad + [(0, 0)] * (a.ndim - 2)) for a in (x, dt, bm, cm))
    want, st_j = m_jax.ssd_chunked(*(jnp.asarray(a) for a in (xp, dtp, a_log, bp, cp, d_skip)),
                                   chunk=16)
    got, st = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in (xp, dtp, a_log, bp, cp,
                                                                  d_skip)), chunk=16)
    np.testing.assert_allclose(got.numpy()[:, :40], np.asarray(want)[:, :40], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5, atol=1e-5)
    for t in range(3):
        y_j, st_j = m_jax.ssd_step(st_j, *(jnp.asarray(a[:, t]) for a in (x, dt)),
                                   jnp.asarray(a_log), jnp.asarray(bm[:, t]),
                                   jnp.asarray(cm[:, t]), jnp.asarray(d_skip))
        y, st = mamba2.ssd_step(st, *(torch.from_numpy(a[:, t]) for a in (x, dt)),
                                torch.from_numpy(a_log), torch.from_numpy(bm[:, t]),
                                torch.from_numpy(cm[:, t]), torch.from_numpy(d_skip))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5, atol=1e-5)


def test_mlstm_chunked_and_step_match_reference():
    """``mlstm_chunked`` at S = 40 in chunks of 16, padded with ``repro``'s
    i = -30, f = +30, its (C, n, m) against ``repro``'s, then 3 steps."""
    from repro.models import xlstm as x_jax
    from repro_torch.models import xlstm
    rng = np.random.RandomState(4)
    b, s, h, d = 2, 40, 2, 8
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    i_pre = rng.randn(b, s, h).astype(np.float32)
    f_pre = (3.0 + rng.randn(b, s, h)).astype(np.float32)
    pad4 = [(0, 0), (0, 8), (0, 0), (0, 0)]
    args = [np.pad(a, pad4) for a in (q, k, v)] + [
        np.pad(i_pre, pad4[:3], constant_values=-30.0),
        np.pad(f_pre, pad4[:3], constant_values=30.0)]
    want, st_j = x_jax.mlstm_chunked(*(jnp.asarray(a) for a in args), chunk=16)
    got, st = xlstm.mlstm_chunked(*(torch.from_numpy(a) for a in args), chunk=16)
    np.testing.assert_allclose(got.numpy()[:, :s], np.asarray(want)[:, :s], rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(st, st_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    for t in range(3):
        y_j, st_j = x_jax.mlstm_step(st_j, *(jnp.asarray(a[:, t]) for a in (q, k, v, i_pre,
                                                                            f_pre)))
        y, st = xlstm.mlstm_step(st, *(torch.from_numpy(a[:, t]) for a in (q, k, v, i_pre,
                                                                           f_pre)))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)


def test_slstm_block_matches_reference_and_carries_its_state():
    """23 tokens through the per-token loop, then 2 decode steps from the
    carried (c, n, m, h)."""
    from repro.models import xlstm as x_jax
    from repro_torch.models import xlstm
    cfg = registry.get_smoke("xlstm-1.3b").replace(dtype="float32")
    p_j = randomise(x_jax.make_slstm_params(jax.random.PRNGKey(3), cfg, jnp.float32),
                    np.random.RandomState(5))
    p = xlstm.SLSTM(*(torch.from_numpy(np.asarray(p_j[n])) for n in ("w_x", "r_h", "bias",
                                                                      "w_out")))
    x = np.random.RandomState(6).randn(2, 23, cfg.d_model).astype(np.float32)
    want, st_j = x_jax.slstm_block(p_j, cfg, jnp.asarray(x), mode="prefill")
    with torch.no_grad():
        got, st = xlstm.slstm_block(p, cfg, torch.from_numpy(x), mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for g, w in zip(st, st_j):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        for t in range(2):
            xt = x[:, t:t + 1] * 0.5
            want, st_j = x_jax.slstm_block(p_j, cfg, jnp.asarray(xt), mode="decode", state=st_j)
            got, st = xlstm.slstm_block(p, cfg, torch.from_numpy(xt), mode="decode", state=st)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _moe_case(arch):
    from repro.models import moe as moe_jax
    from repro_torch.models import moe
    cfg = registry.get_smoke(arch).replace(dtype="float32")
    p_j = moe_jax.make_moe_params(jax.random.PRNGKey(7), cfg, jnp.float32)
    p = moe.MoE(*(torch.from_numpy(np.asarray(p_j[n])) for n in ("router", "wg", "wu", "wd")))
    rng = np.random.RandomState(8)
    # a direction shared by every token tilts the router towards a few
    # experts, so that cf 1.25 drops assignments
    x = (rng.randn(2, 48, cfg.d_model) + 2.0 * rng.randn(cfg.d_model)).astype(np.float32)
    return cfg, p_j, p, x


def _reference_drops(p_j, cfg, x) -> int:
    """The assignments ``repro``'s ``moe_block`` drops: its routing, count and
    scan, at its ``capg`` (one group)."""
    t = x.shape[0] * x.shape[1]
    e, topk = cfg.num_experts, cfg.experts_per_token
    capg = int(max(1, (t * topk * cfg.moe_capacity_factor) // e))
    gates = jax.nn.softmax(jnp.asarray(x.reshape(t, -1)) @ p_j["router"], axis=-1)
    _, top_e = jax.lax.top_k(gates, topk)
    onehot = jax.nn.one_hot(top_e.reshape(-1), e, dtype=jnp.int32)
    slot = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return int((slot >= capg).sum())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-moe-1b-a400m"])
def test_moe_block_drops_as_the_reference_does(arch):
    """cf 1.25 on 96 tokens: assignments are dropped (> 0), the same number
    as ``repro`` drops, and the outputs agree."""
    from repro.models import moe as moe_jax
    from repro_torch.models import moe
    cfg, p_j, p, x = _moe_case(arch)
    want = moe_jax.moe_block(p_j, cfg, jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_block(p, cfg, torch.from_numpy(x))
        top_g, top_e, _ = moe.route(p, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model))
        _, keep = moe.dispatch(top_e, cfg.num_experts, moe.capacity(96, cfg))
    dropped = int((~keep).sum())
    assert dropped > 0 and dropped == _reference_drops(p_j, cfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_moe_capacity_is_one_slot_at_decode():
    """ROADMAP §3: a decode step of 2 sequences gets one slot per expert on
    Mixtral and Granite, as ``repro``'s expression gives."""
    from repro_torch.models import moe
    for arch in ("mixtral-8x7b", "granite-moe-1b-a400m"):
        assert moe.capacity(2, registry.get_arch(arch)) == 1
    assert moe.capacity(16384, registry.get_arch("mixtral-8x7b")) == 5120


def test_router_aux_loss_matches_reference():
    from repro.models import moe as moe_jax
    from repro_torch.models import moe
    cfg, p_j, p, x = _moe_case("granite-moe-1b-a400m")
    want = float(moe_jax.router_aux_loss(p_j, cfg, jnp.asarray(x)))
    with torch.no_grad():
        got = float(moe.router_aux_loss(p, cfg, torch.from_numpy(x)))
    assert abs(got - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b", "mixtral-8x7b"])
def test_launch_serve_runs_the_families_on_the_cpu(arch):
    out = serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "40", "--decode-steps", "4"])
    assert out["tokens"].shape == (2, 4)
    assert 0 <= int(out["tokens"].min()) and int(out["tokens"].max()) < 512
    assert torch.isfinite(out["logits"]).all()
