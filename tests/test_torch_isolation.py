"""The port stands alone and never falls back.

* every module of ``repro_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` and ``repro`` made unimportable, and no source names them;
* entry points default to CUDA and raise where there is none;
* every kernel dispatcher sends non-CPU tensors to its kernel, whose
  wrapper raises on what it cannot launch: no quiet route to the plain
  version.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import _build
from repro_torch.core import build_hmatrix, build_hmatrix_device, dense_matvec_oracle
from repro_torch.kernels.batched_aca import kernel as aca_kernel
from repro_torch.kernels.batched_aca.ops import batched_aca_level, batched_lowrank_matmat
from repro_torch.kernels.batched_block_solve import kernel as solve_kernel
from repro_torch.kernels.batched_block_solve.ops import (batched_block_cholesky,
                                                         batched_block_cholesky_solve)
from repro_torch.kernels.batched_dense_matvec import kernel as dense_kernel
from repro_torch.kernels.batched_dense_matvec.ops import (batched_kernel_matmat,
                                                          batched_kernel_matvec)
from repro_torch.kernels.batched_recompress import kernel as recompress_kernel
from repro_torch.kernels.batched_recompress.ops import batched_recompress
from repro_torch.kernels.batched_schur_update import kernel as schur_kernel
from repro_torch.kernels.batched_schur_update.ops import (batched_schur_dense,
                                                          batched_schur_retruncate)
from repro_torch.kernels.batched_trsm_lowrank import kernel as trsm_kernel
from repro_torch.kernels.batched_trsm_lowrank.ops import batched_trsm_panels
from repro_torch.kernels.morton import kernel as morton_kernel
from repro_torch.kernels.morton.ops import morton_encode
from repro_torch.kernels.hattention_block import kernel as nearfield_kernel
from repro_torch.kernels.hattention_block.ops import hattention_nearfield_op
from repro_torch.configs.registry import get_smoke
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import get_model
from torch_parity_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(" ".join(names))
print(len(names))
"""
# the parallel and tooling layer: each must be walked (and import without jax)
LAYER_MODULES = ("repro_torch.parallel.mesh_ctx", "repro_torch.parallel.sharding",
                 "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.analysis.roofline", "repro_torch.analysis.opcount")


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert int(lines[-1]) >= 20
    walked = set(lines[-2].split())
    assert set(LAYER_MODULES) <= walked, set(LAYER_MODULES) - walked


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_of_the_port_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_no_try_around_a_launch_in_the_kernel_packages():
    for path in (PORT / "kernels").rglob("*.py"):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    pts = torch.rand(64, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hmatrix(pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hmatrix_device(pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        dense_matvec_oracle(pts, "gaussian", torch.ones(64))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hmatrix(pts, precompute=True, recompress_tol=1e-2)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(get_smoke("qwen2.5-14b-hmatrix"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launch.main(["--arch", "qwen2.5-14b-hmatrix", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_debug_mesh()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_dispatchers_send_non_cpu_tensors_to_the_kernel_and_raise():
    """A request on another device than the CPU never reaches a plain
    version: the dispatcher hands it to the CUDA wrapper, which refuses it."""
    with pytest.raises(ValueError, match="CUDA"):
        batched_kernel_matmat(_meta(2, 8, 2), _meta(2, 8, 2), _meta(2, 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        batched_kernel_matvec(_meta(2, 8, 2), _meta(2, 8, 2), _meta(2, 8))
    ids = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        batched_aca_level(_meta(16, 2), ids, ids, 1, "gaussian", 4)
    with pytest.raises(ValueError, match="CUDA"):
        morton_encode(_meta(16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        batched_lowrank_matmat(_meta(2, 8, 4), _meta(2, 8, 4), _meta(2, 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        batched_block_cholesky(_meta(2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        batched_block_cholesky_solve(_meta(2, 8, 8), _meta(2, 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        batched_recompress(_meta(2, 8, 4), _meta(2, 8, 4), 1e-2)
    with pytest.raises(ValueError, match="CUDA"):
        batched_trsm_panels(_meta(1, 8, 8), _meta(2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        batched_schur_dense(_meta(2, 8, 8), _meta(2, 8, 3), _meta(2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        batched_schur_retruncate(_meta(2, 8, 8), _meta(2, 8, 8), 1e-2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hattention_nearfield_op(_meta(2, 2, 8, 16), _meta(2, 2, 8, 16), _meta(2, 2, 8, 16))
    with pytest.raises(ValueError, match="several devices"):
        batched_block_cholesky_solve(torch.zeros(2, 8, 8), _meta(2, 8, 1))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        dense_kernel.batched_kernel_matmat_cuda(torch.zeros(2, 8, 2), torch.zeros(2, 8, 2), x)
    with pytest.raises(ValueError, match="CUDA"):
        dense_kernel.batched_kernel_matvec_cuda(torch.zeros(2, 8, 2), torch.zeros(2, 8, 2),
                                                x[:, :, 0])
    with pytest.raises(ValueError, match="CUDA"):
        aca_kernel.batched_aca_level_cuda(torch.zeros(16, 2), torch.zeros(2, dtype=torch.int64),
                                          torch.zeros(2, dtype=torch.int64), 1, "gaussian", 4)
    with pytest.raises(ValueError, match="CUDA"):
        morton_kernel.morton_encode_cuda(torch.zeros(16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        aca_kernel.batched_lowrank_matmat_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), x)
    with pytest.raises(ValueError, match="CUDA"):
        solve_kernel.batched_block_cholesky_cuda(torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        solve_kernel.batched_block_cholesky_solve_cuda(torch.zeros(2, 8, 8), x)
    with pytest.raises(ValueError, match="CUDA"):
        recompress_kernel.batched_recompress_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4),
                                                  1e-2)
    with pytest.raises(ValueError, match="CUDA"):
        trsm_kernel.batched_trsm_panels_cuda(torch.zeros(1, 8, 8), x)
    with pytest.raises(ValueError, match="CUDA"):
        schur_kernel.batched_schur_dense_cuda(torch.zeros(2, 8, 8), x, x)
    with pytest.raises(ValueError, match="CUDA"):
        nearfield_kernel.hattention_nearfield_cuda(*(torch.zeros(2, 2, 8, 16),) * 3)
    assert all(count == 0 for count in _build.LAUNCHES.values())
    assert all(count == 0 for count in _build.ORACLE_CALLS.values())


def test_cuda_requests_fail_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        batched_block_cholesky(torch.zeros(2, 8, 8, device="cuda"))
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_all()
