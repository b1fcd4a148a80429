"""GPipe over a mesh axis (``repro_torch.parallel.pipeline``) against the
sequential stack: ``repro``'s own case (``tests/test_pipeline.py``: S = 4
stages, 6 microbatches of 2, D = 8, ``tanh(x @ w_i)``) on four CPU shards
against ``jax.numpy``'s sequential stack on the same arrays, and a 2-layer
``qwen2.5-14b-hmatrix`` smoke stack in 2 stages, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.models import lm
from repro_torch.parallel.mesh_ctx import PanelMesh, use_mesh
from repro_torch.parallel.pipeline import pipeline_apply
from torch_parity_util import one_torch_thread  # noqa: F401

S, NM, MB, D = 4, 6, 2, 8


def _case(seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(S, D, D) * 0.3).astype(np.float32)
    xs = rng.randn(NM, MB, D).astype(np.float32)
    return w, xs


def _stage(p, x):
    return torch.tanh(x @ p)


def test_pipeline_matches_the_sequential_stack_of_jax():
    w, xs = _case()
    ref = jnp.asarray(xs)
    for i in range(S):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    mesh = PanelMesh(("cpu",) * S, ("stage",))
    with use_mesh(mesh):
        out = pipeline_apply(torch.from_numpy(w), torch.from_numpy(xs), axis="stage",
                             n_stages=S, stage_fn=_stage)
        per_stage = pipeline_apply([torch.from_numpy(w[i]) for i in range(S)],
                                   torch.from_numpy(xs), axis="stage", n_stages=S,
                                   stage_fn=_stage)
    assert out.shape == (NM, MB, D)
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < 1e-6
    assert torch.equal(out, per_stage)


def test_pipeline_on_one_axis_of_a_two_axis_mesh():
    w, xs = _case(1)
    seq = torch.from_numpy(xs)
    for i in range(S):
        seq = _stage(torch.from_numpy(w[i]), seq)
    mesh = PanelMesh(("cpu",) * (2 * S), ("data", "stage"), (2, S))
    with use_mesh(mesh):
        out = pipeline_apply({"w": torch.from_numpy(w)}, torch.from_numpy(xs), axis="stage",
                             n_stages=S, stage_fn=lambda p, x: _stage(p["w"], x))
    assert torch.equal(out, seq)


def _blocks_fn(cfg, kinds):
    def run(blocks, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for block, kind in zip(blocks, kinds):
            x, _ = lm.apply_block(block, cfg, kind, x, mode="train", cache=None,
                                  cache_len=None, positions=positions)
        return x
    return run


def test_smoke_lm_stack_in_two_stages_is_bit_identical():
    cfg = get_smoke("qwen2.5-14b-hmatrix").replace(dtype="float32")
    gen = torch.Generator().manual_seed(3)
    params = lm.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (3, 1, 256), generator=gen)
    with torch.no_grad():
        xs = [lm.embed_tokens(params.embed, t) for t in tokens]
        run = _blocks_fn(cfg, cfg.layer_kinds[:1])
        seq = [run(params.layers[1:], run(params.layers[:1], x)) for x in xs]
        with use_mesh(PanelMesh(("cpu",) * 2, ("stage",))):
            out = pipeline_apply([params.layers[:1], params.layers[1:]], xs, axis="stage",
                                 n_stages=2, stage_fn=run)
    assert out.shape == (3, 1, 256, cfg.d_model)
    for got, want in zip(out, seq):
        assert torch.equal(got, want)


def test_pipeline_needs_an_active_mesh_with_the_axis():
    w, xs = _case()
    with pytest.raises(RuntimeError, match="active mesh"):
        pipeline_apply(torch.from_numpy(w), torch.from_numpy(xs), axis="stage", n_stages=S,
                       stage_fn=_stage)
    with use_mesh(PanelMesh(("cpu",) * 2, ("stage",))):
        with pytest.raises(ValueError, match="n_stages"):
            pipeline_apply(torch.from_numpy(w), torch.from_numpy(xs), axis="stage",
                           n_stages=S, stage_fn=_stage)
        with pytest.raises(ValueError):
            pipeline_apply(torch.from_numpy(w), torch.from_numpy(xs), axis="model",
                           n_stages=2, stage_fn=_stage)
