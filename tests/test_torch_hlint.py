"""hlint_torch (scripts/hlint_torch): must-fire / must-not-fire fixtures per
rule family, suppressions with the port's own tag, the baseline round trip,
and the meta-test that the committed baseline equals a fresh run of the port.
"""
import ast
import importlib.util
import json
import shutil
import sys
import textwrap
from pathlib import Path

import pytest

from torch_parity_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

from hlint_torch import framework, run  # noqa: E402
from hlint_torch import rules_host_sync, rules_kernel_contract, rules_lock  # noqa: E402

STRICT = "src/repro_torch/solve/fixture.py"          # strict device-path scope
WRAPPER = "src/repro_torch/kernels/fixture_pkg/kernel.py"
ORCH = "examples/torch_fixture.py"                   # orchestration scope
OUT = "src/repro_torch/models/fixture.py"            # neither


def lint(path, src):
    return framework.check_source(path, textwrap.dedent(src))


def rules_of(findings, rule="host-sync"):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

ITEM = """\
    import torch
    def f(x):
        r = torch.sum(x)
        return r.item()
    """


def test_item_in_a_strict_module_fires():
    fs = rules_of(lint(STRICT, ITEM))
    assert len(fs) == 1 and ".item()" in fs[0].message and fs[0].qualname == "f"


@pytest.mark.parametrize("path,count", [(WRAPPER, 1), (ORCH, 1), (OUT, 0)])
def test_item_fires_in_wrappers_and_orchestration_not_elsewhere(path, count):
    assert len(rules_of(lint(path, ITEM))) == count


@pytest.mark.parametrize("conv", ["int", "float", "bool"])
def test_python_scalar_of_a_tensor_fires(conv):
    fs = rules_of(lint(STRICT, f"""\
        import torch
        def f(x):
            return {conv}(torch.max(x))
        """))
    assert len(fs) == 1 and f"{conv}()" in fs[0].message


def test_untainted_float_and_len_are_fine():
    fs = lint(STRICT, """\
        import torch
        def f(tol, x):
            y = torch.zeros(3)
            return float(tol) * 2 + len(y) + int(y.shape[0]) + y.numel()
        """)
    assert rules_of(fs) == []


def test_a_parameter_shadows_an_enclosing_tensor():
    fs = lint(STRICT, """\
        import torch
        x = torch.zeros(3)
        def f(x):
            return float(x)
        def g():
            return float(x)
        """)
    assert [f.qualname for f in rules_of(fs)] == ["g"]


def test_tensor_annotated_parameter_is_a_device_value():
    fs = rules_of(lint(STRICT, """\
        import torch
        def f(x: torch.Tensor, n: int):
            return x.sum().tolist(), float(n)
        """))
    assert len(fs) == 1 and ".tolist()" in fs[0].message


def test_explicit_fetch_is_flagged_in_strict_scope_only():
    src = """\
        import torch
        def f(x: torch.Tensor):
            host = x.cpu()
            arr = torch.exp(x).numpy()
            back = x.to("cpu")
            return float(host.sum()), arr, back
        """
    strict = rules_of(lint(STRICT, src))
    assert len(strict) == 3
    for f, what in zip(strict, (".cpu()", ".numpy()", ".to(<host device>)")):
        assert f"host boundary: {what}" in f.message
    # the sanctioned way across the boundary in orchestration code, and the
    # fetched value is host data: float() on it is not a sync
    assert rules_of(lint(ORCH, src)) == []


def test_to_host_is_a_host_boundary_in_strict_scope():
    src = """\
        from repro_torch._device import to_host
        def f(x):
            return to_host(x).numpy()
        """
    assert len(rules_of(lint(STRICT, src))) == 1
    assert rules_of(lint(ORCH, src)) == []


def test_iterating_a_tensor_fires_but_a_list_of_tensors_does_not():
    fs = rules_of(lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            parts = [x, x * 2]
            for p in parts:
                p.add_(1)
            for a, b in zip(parts, parts):
                a.add_(b)
            for row in x.t():
                row.add_(1)
        """))
    assert len(fs) == 1 and fs[0].line == 8 and "iterating" in fs[0].message


def test_tensor_as_a_branch_test_fires_but_identity_tests_do_not():
    fs = rules_of(lint(STRICT, """\
        import torch
        def f(x: torch.Tensor, y=None):
            if y is None:
                y = x
            while (x > 0).any():
                x = x - 1
            return x if x.sum() else y
        """))
    assert [f.line for f in fs] == [5, 7]


def test_blocking_waits_fire_in_strict_scope_only():
    src = """\
        import torch
        def f(stream, event):
            torch.cuda.synchronize()
            stream.synchronize()
            event.synchronize()
        """
    assert len(rules_of(lint(STRICT, src))) == 3
    assert rules_of(lint(ORCH, src)) == []


def test_data_dependent_shapes_fire_in_strict_scope():
    fs = rules_of(lint(STRICT, """\
        import torch
        def f(x: torch.Tensor, counts: torch.Tensor, n: int):
            a = torch.nonzero(x)
            b = x.unique()
            c = x[x > 0]
            mask = torch.isfinite(x)
            d = x[mask]
            e = torch.where(x > 0)
            g = x.repeat_interleave(counts)
            h = x.repeat_interleave(counts, output_size=n)
            i = x.repeat_interleave(2)
            j = torch.where(x > 0, x, 0.0)
            return a, b, c, d, e, g, h, i, j
        """))
    assert [f.line for f in fs] == [3, 4, 5, 7, 8, 9]
    assert all("data-dependent" in f.message or "boolean mask" in f.message for f in fs)


def test_entry_point_callables_and_nn_modules_are_tainted():
    fs = rules_of(lint(STRICT, """\
        import torch
        from torch import nn
        from repro_torch.core import make_apply

        def f(hm, x):
            apply = make_apply(hm)
            z = apply(x)
            return float(z.sum())

        class Head(nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = nn.Linear(4, 4)

            def score(self, h):
                y = self.lin(h)
                return y.max().item()
        """))
    assert [(f.qualname, f.line) for f in fs] == [("f", 8), ("Head.score", 17)]


def test_metadata_clears_the_taint():
    fs = rules_of(lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            n = x.shape[0]
            d = x.device
            if n > 2 and x.ndim == 2 and x.numel():
                return int(n)
        """))
    assert fs == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------


def test_justified_suppression_drops_the_finding():
    fs = lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            return x.item()  # hlint-torch: disable=host-sync -- documented fetch
        """)
    assert fs == []


def test_own_line_suppression_applies_to_the_next_line():
    fs = lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            # hlint-torch: disable=host-sync -- documented fetch
            a = x.item()
            return a, x.item()
        """)
    assert [f.line for f in fs] == [5]


def test_bare_suppression_is_reported():
    fs = lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            return x.item()  # hlint-torch: disable=host-sync
        """)
    assert [f.rule for f in fs] == ["hlint-bare-suppression"]
    assert "no justification" in fs[0].message


def test_the_jax_linters_tag_does_not_suppress_and_cannot_see_ours(monkeypatch):
    fs = lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            return x.item()  # hlint: disable=host-sync -- the JAX linter's tag
        """)
    assert len(rules_of(fs)) == 1
    spec = importlib.util.spec_from_file_location("repro_hlint_framework",
                                                  ROOT / "scripts" / "hlint" / "framework.py")
    jax_fw = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "repro_hlint_framework", jax_fw)
    spec.loader.exec_module(jax_fw)
    assert jax_fw.SUPPRESS_RE.search("x()  # hlint-torch: disable=host-sync -- why") is None
    assert framework.SUPPRESS_RE.search("x()  # hlint: disable=host-sync -- why") is None


def test_suppression_lists_several_rules_and_ignores_other_rules():
    sups = framework.parse_suppressions(
        ["x = 1  # hlint-torch: disable=host-sync, lock-discipline -- both"])
    assert sups[0].rules == ("host-sync", "lock-discipline")
    fs = lint(STRICT, """\
        import torch
        def f(x: torch.Tensor):
            return x.item()  # hlint-torch: disable=lock-discipline -- other rule
        """)
    assert len(rules_of(fs)) == 1


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

RUNTIME = "src/repro_torch/serve/runtime.py"


def test_unlocked_read_of_a_registry_field_fires():
    fs = rules_of(lint(RUNTIME, """\
        class PanelRuntime:
            def __init__(self):
                self._pending = []
            def queue_depth(self):
                return len(self._pending)
        """), "lock-discipline")
    assert len(fs) == 1 and "'._pending'" in fs[0].message and fs[0].qualname == \
        "PanelRuntime.queue_depth"


def test_locked_access_locked_methods_and_wait_for_lambdas_are_fine():
    fs = rules_of(lint(RUNTIME, """\
        class PanelRuntime:
            def queue_depth(self):
                with self._cv:
                    self._cv.wait_for(lambda: not self._pending or self._closing)
                    return len(self._pending)
            def _launchable(self, now):
                return len(self._pending) > 0
        """), "lock-discipline")
    assert fs == []


def test_locked_method_called_outside_the_lock_fires():
    fs = rules_of(lint(RUNTIME, """\
        class PanelRuntime:
            def submit(self):
                self._check_admission()
                with self._cv:
                    self._check_admission()
        """), "lock-discipline")
    assert [f.line for f in fs] == [3]


def test_function_defined_under_the_lock_runs_without_it():
    fs = rules_of(lint(RUNTIME, """\
        class PanelRuntime:
            def later(self):
                with self._cv:
                    def cb():
                        return self._launched
                return cb
        """), "lock-discipline")
    assert len(fs) == 1 and fs[0].qualname == "PanelRuntime.later.cb"


def test_stats_subscript_and_rebind_modes():
    fs = rules_of(lint(RUNTIME, """\
        class PanelRuntime:
            def bump(self):
                self.stats["retries"] += 1
                snap = self.stats()
                with self._cv:
                    self.stats["retries"] += 1
                return snap
        """), "lock-discipline")
    assert [f.line for f in fs] == [3]
    fs = rules_of(lint("src/repro_torch/serve/step.py", """\
        class HMatrixSolveServer:
            def __init__(self):
                self.last_info = []
            def serve(self):
                self.last_info.clear()
                self.last_info = []
        """), "lock-discipline")
    assert [f.line for f in fs] == [6]


def test_tenant_fields_are_guarded_on_any_receiver():
    fs = rules_of(lint("src/repro_torch/serve/tenancy.py", """\
        class TenantHandle:
            def depth(self):
                return len(self._tenant.pending), self._tenant.resident
        """), "lock-discipline")
    assert len(fs) == 2


def test_injected_registry_is_honoured(monkeypatch):
    monkeypatch.setitem(rules_lock.LOCK_REGISTRY, "src/repro_torch/serve/fixture.py",
                        {"full": {"_depth"}, "subscript": set(), "no_rebind": set(),
                         "locked_methods": set()})
    fs = rules_of(lint("src/repro_torch/serve/fixture.py", """\
        class R:
            def read(self):
                return self._depth
        """), "lock-discipline")
    assert len(fs) == 1


def test_live_stats_subscript_outside_serve_fires():
    fs = rules_of(lint(ORCH, """\
        def report(srv):
            ok = srv.runtime.stats()["retries"]
            return srv.runtime.stats["retries"], ok
        """), "lock-discipline")
    assert [f.line for f in fs] == [3]


# ---------------------------------------------------------------------------
# kernel-contract (on a copy of a real package in tmp_path)
# ---------------------------------------------------------------------------

PKG_SRC = ROOT / "src" / "repro_torch" / "kernels" / "morton"


def _contract_tree(tmp_path: Path) -> Path:
    """A minimal checkout: the morton package, _build.SOURCES, its source,
    a parity test and chip_smoke.py naming its entry points."""
    kdir = tmp_path / "src" / "repro_torch" / "kernels" / "morton"
    kdir.mkdir(parents=True)
    for name in ("kernel.py", "ops.py", "ref.py"):
        shutil.copy(PKG_SRC / name, kdir / name)
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "csrc").mkdir()
    (pkg / "csrc" / "morton.cu").write_text("// kernel\n")
    (pkg / "_build.py").write_text('SOURCES = ("morton",)\n')
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_morton.py").write_text("morton_encode\n")
    (tmp_path / "chip_smoke.py").write_text("morton_encode_cuda\n")
    return tmp_path


def _contract(root):
    return [f.message for f in rules_kernel_contract.kernel_contract_rule(root)]


def test_contract_copy_of_a_real_package_is_clean(tmp_path):
    assert _contract(_contract_tree(tmp_path)) == []


def test_contract_ref_reached_on_the_cuda_path_fires(tmp_path):
    root = _contract_tree(tmp_path)
    ops = root / "src/repro_torch/kernels/morton/ops.py"
    text = ops.read_text()
    assert "    return morton_encode_cuda(coords)" in text
    ops.write_text(text.replace("    return morton_encode_cuda(coords)",
                                "    return morton_encode_ref(coords)"))
    msgs = _contract(root)
    assert any("'morton_encode_ref' reached outside the on_cpu(...) branch" in m for m in msgs)


def test_contract_try_around_a_cuda_call_fires(tmp_path):
    root = _contract_tree(tmp_path)
    ops = root / "src/repro_torch/kernels/morton/ops.py"
    ops.write_text(ops.read_text().replace(
        "    return morton_encode_cuda(coords)",
        "    try:\n        return morton_encode_cuda(coords)\n"
        "    except RuntimeError:\n        raise"))
    msgs = _contract(root)
    assert any("'morton_encode_cuda()' inside a try block" in m for m in msgs)


def test_contract_dispatcher_without_on_cpu_fires(tmp_path):
    root = _contract_tree(tmp_path)
    ops = root / "src/repro_torch/kernels/morton/ops.py"
    ops.write_text(ops.read_text().replace('if on_cpu("morton_encode", coords):',
                                           "if coords.device.type == 'cpu':"))
    msgs = _contract(root)
    assert any("does not test on_cpu" in m for m in msgs)


@pytest.mark.parametrize("mutation,expect", [
    ("missing_ref", "missing 'ref.py'"),
    ("ref_names_cuda", "ref.py names 'torch.cuda'"),
    ("extra_source", "csrc/extra.cu is not in _build.SOURCES"),
    ("unknown_source", "_build.SOURCES names 'ghost'"),
    ("unloaded_source", "source 'morton' is built but no kernel.py loads it"),
    ("untested", "is not named in any tests/test_torch_*.py"),
    ("not_in_smoke", "'morton_encode_cuda' is not named in chip_smoke.py"),
    ("tf32", "writes '.allow_tf32'"),
    ("matmul_precision", "calls torch.set_float32_matmul_precision()"),
])
def test_contract_structure_findings(tmp_path, mutation, expect):
    root = _contract_tree(tmp_path)
    pkg = root / "src/repro_torch"
    kdir = pkg / "kernels/morton"
    if mutation == "missing_ref":
        (kdir / "ref.py").unlink()
    elif mutation == "ref_names_cuda":
        (kdir / "ref.py").write_text((kdir / "ref.py").read_text()
                                     + "\nDEV = torch.cuda.current_device\n")
    elif mutation == "extra_source":
        (pkg / "csrc" / "extra.cu").write_text("")
    elif mutation == "unknown_source":
        (pkg / "_build.py").write_text('SOURCES = ("morton", "ghost")\n')
    elif mutation == "unloaded_source":
        (kdir / "kernel.py").write_text((kdir / "kernel.py").read_text().replace(
            '"morton", "repro_morton_encode"', '"elsewhere", "repro_morton_encode"'))
    elif mutation == "untested":
        (root / "tests" / "test_torch_morton.py").write_text("nothing\n")
    elif mutation == "not_in_smoke":
        (root / "chip_smoke.py").write_text("nothing\n")
    elif mutation == "tf32":
        (pkg / "flags.py").write_text("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n")
    elif mutation == "matmul_precision":
        (pkg / "flags.py").write_text("import torch\ntorch.set_float32_matmul_precision('high')\n")
    assert any(expect in m for m in _contract(root)), _contract(root)


def test_contract_on_this_checkout_has_only_its_baselined_findings():
    keys = {f.key() for f in rules_kernel_contract.kernel_contract_rule(ROOT)}
    baselined = {framework.baseline_key(e) for e in framework.load_baseline()
                 if e["rule"] == "kernel-contract"}
    assert keys == baselined


# ---------------------------------------------------------------------------
# baseline and the meta-tests
# ---------------------------------------------------------------------------


def test_baseline_round_trip_line_numbers_and_todo(tmp_path):
    f1 = framework.Finding("host-sync", "a.py", 3, "f", "m")
    f2 = framework.Finding("host-sync", "a.py", 30, "f", "m")     # moved: same key
    f3 = framework.Finding("host-sync", "b.py", 1, "g", "m")
    path = tmp_path / "baseline.json"
    framework.save_baseline([{"rule": "host-sync", "path": "a.py", "qualname": "f",
                              "message": "m", "justification": "why"},
                             {"rule": "host-sync", "path": "c.py", "qualname": "h",
                              "message": "m", "justification": "TODO"}], path)
    new, matched, stale, unjustified = framework.reconcile([f1, f2, f3],
                                                           framework.load_baseline(path))
    assert new == [f3] and len(matched) == 1
    assert [e["path"] for e in stale] == ["c.py"] and [e["path"] for e in unjustified] == ["c.py"]


def test_committed_baseline_equals_a_fresh_run_of_the_port(capsys):
    findings = framework.walk_repo(ROOT)
    baseline = framework.load_baseline()
    assert {f.key() for f in findings} == {framework.baseline_key(e) for e in baseline}
    assert all(e["justification"].strip() and e["justification"] != "TODO" for e in baseline)
    assert run.main([]) == 0
    assert "hlint-torch: clean" in capsys.readouterr().out


def test_the_baseline_file_is_what_update_baseline_writes(tmp_path, monkeypatch):
    committed = json.loads(framework.BASELINE_PATH.read_text())
    monkeypatch.setattr(framework, "BASELINE_PATH", tmp_path / "baseline.json")
    framework.save_baseline(committed)
    assert run.main(["--update-baseline"]) == 0
    assert json.loads((tmp_path / "baseline.json").read_text()) == committed


def test_linter_and_new_examples_import_neither_jax_nor_repro():
    files = sorted((ROOT / "scripts" / "hlint_torch").glob("*.py")) \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) >= 10
    for p in files:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "repro", "hlint", "framework", "rules_host_sync",
                                   "rules_lock", "rules_kernel_contract"), (p, m)


def test_walked_files_are_the_port_and_its_examples_only():
    rels = {p.relative_to(ROOT).as_posix() for p in framework.walked_files(ROOT)}
    assert "src/repro_torch/serve/runtime.py" in rels
    assert "examples/torch_quickstart.py" in rels
    assert not any(r.startswith("src/repro/") or r == "examples/quickstart.py"
                   or r == "chip_smoke.py" or r.startswith("scripts/") for r in rels)
    assert rules_host_sync.scope_of("src/repro_torch/kernels/morton/kernel.py") == "strict"
    assert rules_host_sync.scope_of("src/repro_torch/launch/serve.py") == "orch"
