"""The port's examples (``examples/torch_*.py``) on the CPU at small sizes,
each held to ``repro``'s example of the same name at the same size and seed.

* quickstart: the same plan (block counts), the matvec within 1e-4 of the
  dense oracle (the fp32 bound), and within 1e-5 of ``repro``'s matvec;
* kernel regression: the same PCG iteration count for every target, the
  solve's residual against the dense oracle within twice the solver's
  tolerance (1e-3 a column), and the relative residual printed within 1e-4;
* long-context H-attention: within 1e-5 of ``repro``'s ``h_attention`` on
  the same inputs, and its agreement with exact attention within 1e-4;
* serve_lm and train_lm run their launchers to the end with ``repro``'s
  flags and ``--device cpu``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_hmatrix as j_build_hmatrix
from repro.core import dense_matvec_oracle as j_dense_matvec_oracle
from repro.core import halton as j_halton
from repro.core import make_matvec as j_make_matvec
from repro.core import sinusoid_targets as j_sinusoid_targets
from repro.core.hattention import h_attention as j_h_attention
from repro.solve import make_solver as j_make_solver
from torch_parity_util import one_torch_thread, rel_err  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import torch_kernel_regression  # noqa: E402
import torch_long_context_hattention  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_lm  # noqa: E402
import torch_train_lm  # noqa: E402


def test_quickstart_matches_the_reference_example():
    n = 4096
    out = torch_quickstart.run("cpu", n=n)
    pts = j_halton(n, 2)
    jhm = j_build_hmatrix(pts, kernel="gaussian", k=16, c_leaf=256, eta=1.5)
    x = jnp.asarray(np.random.RandomState(0).randn(n).astype(np.float32))
    z = np.asarray(j_make_matvec(jhm)(x))
    z_dense = np.asarray(j_dense_matvec_oracle(pts, "gaussian", x))
    assert (out["aca_blocks"], out["dense_blocks"]) == (jhm.plan.num_aca_blocks,
                                                        jhm.plan.num_dense_blocks)
    assert out["aca_blocks"] > 0
    assert out["rel_err"] <= 1e-4 and rel_err(z, z_dense) <= 1e-4
    assert rel_err(out["z"], z) <= 1e-5


def test_kernel_regression_matches_the_reference_example():
    n, sigma2 = 1024, 1e-2
    out = torch_kernel_regression.run("cpu", n=n)
    pts = j_halton(n, 2) * torch_kernel_regression.DOMAIN
    f = j_sinusoid_targets(pts, 8, torch_kernel_regression.DOMAIN)
    jhm = j_build_hmatrix(pts, "gaussian", k=16, c_leaf=256, precompute=True)
    _, info = j_make_solver(jhm, sigma2, tol=1e-3, max_iter=300, precondition=True)(f)
    assert out["iters_per_column"] == info.iters_per_column.tolist()
    assert out["iterations"] == info.iterations
    # the solve's residual with the exact dense operator
    np.testing.assert_array_equal(out["points"], np.asarray(pts))
    a = np.asarray(j_dense_matvec_oracle(pts, "gaussian", jnp.eye(n, dtype=jnp.float32)),
                   np.float64)
    c = out["coef"].astype(np.float64)
    resid = a @ c + sigma2 * c - out["targets"]
    # the PCG stops each column at |r| <= tol = 1e-3 on the H-operator; the
    # dense operator may add as much again (the H-approximation's share)
    assert np.linalg.norm(resid) <= 2 * 1e-3 * np.sqrt(8)
    assert out["rel_residual"] <= 1e-4


def test_long_context_hattention_matches_the_reference_example():
    s, c_leaf, rank = 1024, 128, 16
    out = torch_long_context_hattention.run("cpu", s=s, c_leaf=c_leaf, rank=rank,
                                            model_seq=256)
    q, k, v = (jnp.asarray(a) for a in torch_long_context_hattention.smooth_qkv(s))
    ref = np.asarray(j_h_attention(q, k, v, c_leaf=c_leaf, rank=rank))
    assert out["admissible_blocks"] > 0
    assert rel_err(out["out_h"], ref) <= 1e-5
    assert out["rel_agreement"] <= 1e-4
    assert out["finite"] and out["logits_shape"][:2] == (1, 256)


def _run_example(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)


def test_serve_lm_example_runs_the_launcher_with_the_reference_flags(tmp_path):
    cmd = torch_serve_lm.command("cpu")
    assert cmd[1:] == ["-m", "repro_torch.launch.serve", "--arch", "qwen2.5-14b", "--smoke",
                       "--batch", "4", "--prompt-len", "32", "--decode-steps", "16",
                       "--device", "cpu"]
    res = _run_example([sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"),
                        "--device", "cpu"], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "prefill: 4x32 tokens" in res.stdout
    tokens = res.stdout.split("generated token ids (first row):")[1].strip()
    assert len(tokens.strip("[]").split(",")) == 16


@pytest.mark.parametrize("full", [False, True])
def test_train_lm_example_flags(full):
    cmd = torch_train_lm.command(steps=300, full=full, device="cpu", ckpt_dir="ck")
    assert cmd[1:3] == ["-m", "repro_torch.launch.train"]
    flags = cmd[3:]
    assert flags[:flags.index("--device")] == [
        "--arch", "smollm-135m", "--steps", "300", "--batch", "2" if full else "8",
        "--seq-len", "128", "--ckpt-dir", "ck", "--ckpt-every", "100",
        "--log-every", "20"] + ([] if full else ["--smoke"])
    default_dir = Path(torch_train_lm.CKPT_DIR).resolve()
    assert default_dir.parent == ROOT / "build"


def test_train_lm_example_trains_and_logs(tmp_path):
    res = _run_example([sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
                        "--device", "cpu", "--steps", "2", "--ckpt-dir",
                        str(tmp_path / "ckpt")], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    for ln in lines:
        loss, lr, gnorm = (float(ln.split(key)[1].split()[0]) for key in ("loss", "lr", "gnorm"))
        assert np.isfinite([loss, lr, gnorm]).all() and 5.0 < loss < 7.0
