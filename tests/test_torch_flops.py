"""Port parity of ``analysis/flops.py``: ``model_flops`` and
``attention_extra_flops`` equal ``repro.analysis.flops``' exactly in all 40
cells of ``iter_cells()`` (and for the hmatrix config), from the two
packages' own configs, which must be equal field by field."""
import dataclasses

import pytest

from repro.analysis import flops as flops_jax
from repro.configs import registry as registry_jax
from repro_torch.analysis import flops
from repro_torch.configs import registry
from torch_parity_util import one_torch_thread  # noqa: F401

CELLS = [(arch.name, shape.name) for arch, shape, _, _ in registry.iter_cells()]


def test_the_cells_are_the_reference_cells():
    want = [(arch.name, shape.name) for arch, shape, _, _ in registry_jax.iter_cells()]
    assert CELLS == want and len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_equal_the_reference(arch, shape):
    cfg, cfg_j = registry.get_arch(arch), registry_jax.get_arch(arch)
    sh, sh_j = registry.get_shape(shape), registry_jax.get_shape(shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert dataclasses.asdict(sh) == dataclasses.asdict(sh_j)
    assert flops.model_flops(cfg, sh) == flops_jax.model_flops(cfg_j, sh_j)
    assert flops.attention_extra_flops(cfg, sh) == flops_jax.attention_extra_flops(cfg_j, sh_j)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_equal_the_reference_for_the_hmatrix_config(shape):
    cfg = registry.get_arch("qwen2.5-14b-hmatrix")
    cfg_j = registry_jax.get_arch("qwen2.5-14b-hmatrix")
    sh, sh_j = registry.get_shape(shape), registry_jax.get_shape(shape)
    assert flops.model_flops(cfg, sh) == flops_jax.model_flops(cfg_j, sh_j)
    assert flops.attention_extra_flops(cfg, sh) == flops_jax.attention_extra_flops(cfg_j, sh_j)


def test_train_flops_of_a_cut_shape():
    """The quantity phase g of ``chip_smoke.py`` divides by: a train step of 2
    x 4,096 tokens of a depth-cut config, 6 N_active D plus the attention term."""
    for arch in ("mixtral-8x7b", "zamba2-7b", "whisper-tiny"):
        cfg = registry.get_arch(arch).replace(n_layers=2)
        cfg_j = registry_jax.get_arch(arch).replace(n_layers=2)
        sh = registry.ShapeConfig("train", 4096, 2, "train")
        sh_j = registry_jax.ShapeConfig("train", 4096, 2, "train")
        got = flops.model_flops(cfg, sh) + flops.attention_extra_flops(cfg, sh)
        assert got == flops_jax.model_flops(cfg_j, sh_j) + flops_jax.attention_extra_flops(
            cfg_j, sh_j) and got > 0
