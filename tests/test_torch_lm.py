"""Port parity of the LM serving path (``models``, ``serve/step.py``, ``launch/serve.py``).

``repro``'s ``init_params`` of ``qwen2.5-14b-smoke`` (attention backend
``full``) and ``qwen2.5-14b-hmatrix-smoke`` (``hmatrix``, c_leaf 64, rank
8), in float32, with the zero biases and norm gains replaced by seeded
random values, are carried into the port by ``lm_params_from_arrays``.
Both packages then see the same tokens.  Limits: logits within 1e-4
relative (Frobenius) in ``train`` mode at S = 256 and 512 (4 and 8 leaves)
and at each of 8 decode steps; prefill caches within 1e-5 absolute; greedy
tokens equal.  The registry's configs and its 40 cells equal ``repro``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as registry_jax
from repro.configs.registry import get_smoke as get_smoke_jax
from repro.models import lm as lm_jax
from repro.serve.step import greedy_sample as greedy_jax
from repro.serve.step import make_decode_step as decode_jax
from repro.serve.step import make_prefill_step as prefill_jax
from repro_torch.configs import registry
from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_launch
from repro_torch.models import lm
from repro_torch.models.api import count_params, count_params_analytic
from repro_torch.serve.step import greedy_sample, make_decode_step, make_prefill_step

from torch_parity_util import one_torch_thread, rel_err  # noqa: F401

ARCHS = ["qwen2.5-14b", "qwen2.5-14b-hmatrix"]
_CACHE: dict = {}


def _randomise(tree, rng):
    """Zero-initialised biases and norm gains -> seeded random values."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "w"):
            return jnp.asarray(0.1 * rng.randn(*x.shape).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _models(arch):
    if arch not in _CACHE:
        cfg_j = get_smoke_jax(arch).replace(dtype="float32")
        cfg = get_smoke(arch).replace(dtype="float32")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        params_j = _randomise(lm_jax.init_params(jax.random.PRNGKey(1), cfg_j),
                              np.random.RandomState(2))
        arrays = jax.tree.map(np.asarray, params_j)
        _CACHE[arch] = (cfg_j, params_j, cfg, lm_params_from_arrays(arrays, cfg, device="cpu"))
    return _CACHE[arch]


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_keep_names_and_count(arch):
    cfg_j, params_j, cfg, model = _models(arch)
    names = dict(model.named_parameters())
    assert {"embed", "final_norm.w", "lm_head", "layers.0.ln1.w", "layers.1.attn.wq",
            "layers.1.attn.bq", "layers.0.ln2.w", "layers.1.mlp.wd"} <= set(names)
    assert count_params(model) == sum(x.size for x in jax.tree.leaves(params_j))
    np.testing.assert_array_equal(names["layers.1.attn.wk"].detach().numpy(),
                                  np.asarray(params_j["pattern"][0]["attn"]["wk"][1]))


def test_full_width_config_counts_14_77_billion_parameters():
    cfg = get_arch("qwen2.5-14b-hmatrix")
    analytic = count_params_analytic(cfg)["total"]
    norms_and_biases = cfg.n_layers * (2 * cfg.d_model + (cfg.n_heads + 2 * cfg.n_kv_heads)
                                       * cfg.head_dim_) + cfg.d_model
    assert analytic + norms_and_biases == 14_770_033_664
    assert (cfg.h_c_leaf, cfg.h_rank, cfg.rope_theta) == (512, 16, 10000.0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [256, 512])
def test_train_logits_match_reference(arch, seq):
    cfg_j, params_j, cfg, model = _models(arch)
    tok = _tokens(2, seq, seed=seq)
    want, _ = lm_jax.forward(params_j, cfg_j, tokens=jnp.asarray(tok), mode="train")
    with torch.no_grad():
        got, caches = lm.forward(model, cfg, torch.from_numpy(tok), mode="train")
    assert caches is None and got.shape == (2, seq, cfg.padded_vocab)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg_j, params_j, cfg, model = _models(arch)
    b, s, steps = 2, 256, 8
    tok = _tokens(b, s, seed=5)
    logits_j, caches_j = jax.jit(prefill_jax(cfg_j))(params_j, jnp.asarray(tok))
    logits, caches = make_prefill_step(cfg)(model, torch.from_numpy(tok))
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert rel_err(logits.numpy(), np.asarray(logits_j)) <= 1e-4
    k_j, v_j = caches_j["pattern"][0]
    for i, (k, v) in enumerate(caches):
        np.testing.assert_allclose(k.numpy(), np.asarray(k_j[i]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j[i]), rtol=0, atol=1e-5)

    caches_j = jax.tree.map(lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]),
                            caches_j)
    caches = serve_launch.grow_caches(caches, steps, cfg)
    decode_j = jax.jit(decode_jax(cfg_j))
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


def test_launch_serve_runs_on_the_cpu():
    out = serve_launch.main(["--arch", "qwen2.5-14b-hmatrix", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "256", "--decode-steps", "4"])
    assert out["tokens"].shape == (2, 4)
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 512
    assert torch.isfinite(out["prefill_logits"]).all()
    assert out["caches"][0][0].shape == (2, 260, 2, 16)


@pytest.mark.parametrize("name", registry_jax.list_archs())
def test_registry_configs_equal_reference(name):
    assert registry.list_archs() == registry_jax.list_archs()
    assert dataclasses.asdict(registry.get_arch(name)) == dataclasses.asdict(
        registry_jax.get_arch(name))
    assert dataclasses.asdict(registry.get_smoke(name)) == dataclasses.asdict(
        registry_jax.get_smoke(name))


def test_iter_cells_yield_the_reference_cells():
    def rows(cells):
        return [(dataclasses.asdict(a), dataclasses.asdict(s), runs, reason)
                for a, s, runs, reason in cells]
    got = rows(registry.iter_cells())
    assert len(got) == 40 and got == rows(registry_jax.iter_cells())
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")
    with pytest.raises(KeyError):
        registry.get_smoke("no-such-arch")


@pytest.mark.parametrize("window,chunk,q_offset", [(0, 64, 0), (48, 64, 0), (0, 32, 64)])
def test_chunked_attention_matches_reference(window, chunk, q_offset):
    """Several KV chunks (the online-softmax loop), a window and an offset."""
    from repro.models.layers import chunked_attention as chunked_jax
    from repro_torch.models.layers import chunked_attention
    rng = np.random.RandomState(chunk + window)
    sq = 256 - q_offset
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, 256, 2, 16).astype(np.float32)
    v = rng.randn(2, 256, 2, 16).astype(np.float32)
    want = chunked_jax(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
                       chunk=chunk, q_offset=q_offset)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                            window=window, chunk=chunk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_attention_in_bfloat16_matches_reference():
    """A bf16 cache: scores and numerator in fp32, the probabilities rounded
    to bf16 before the product with V, as in repro; outputs agree to one
    bf16 rounding (2^-8 relative)."""
    from repro.models.layers import decode_attention as decode_attention_jax
    from repro_torch.models.layers import decode_attention
    rng = np.random.RandomState(4)
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    k = rng.randn(2, 40, 2, 16).astype(np.float32)
    v = rng.randn(2, 40, 2, 16).astype(np.float32)
    want = decode_attention_jax(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 33)
    got = decode_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 33)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("mlp_type,norm_type", [("geglu", "layernorm"), ("gelu", "rmsnorm")])
def test_other_mlp_and_norm_types_match_reference(mlp_type, norm_type):
    from repro.models import layers as layers_jax
    from repro_torch.models import layers
    cfg = get_smoke("qwen2.5-14b").replace(mlp_type=mlp_type, norm_type=norm_type)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    wg, wu = (rng.randn(cfg.d_model, cfg.d_ff).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.randn(cfg.d_ff, cfg.d_model).astype(np.float32) * 0.1
    w, b = rng.randn(cfg.d_model).astype(np.float32), rng.randn(cfg.d_model).astype(np.float32)
    p_j = {"wu": wu, "wd": wd} if mlp_type == "gelu" else {"wg": wg, "wu": wu, "wd": wd}
    mlp = layers.MLP(torch.from_numpy(wu), torch.from_numpy(wd),
                     wg=None if mlp_type == "gelu" else torch.from_numpy(wg))
    n_j = {"w": w, "b": b} if norm_type == "layernorm" else {"w": w}
    norm = layers.Norm(torch.from_numpy(w), torch.from_numpy(b) if norm_type == "layernorm"
                       else None)
    with torch.no_grad():
        h = layers.apply_norm(norm_type, norm, torch.from_numpy(x))
        got = layers.mlp_block(mlp, cfg, h)
    want = layers_jax.mlp_block(jax.tree.map(jnp.asarray, p_j), cfg,
                                layers_jax.apply_norm(norm_type, n_j, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
