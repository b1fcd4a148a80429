"""kernel-contract rule: the structure of ``src/repro_torch/kernels/*``.

The port's contract is the opposite of ``repro``'s.  ``repro`` requires a
``VMEM_BUDGET`` and a route to ``*_ref`` above it; on the card the port has
no quiet route to a plain version (``kernels/__init__.py``): a CUDA tensor
goes to the kernel, which launches or raises.  So:

* each ``kernels/<pkg>/`` has ``kernel.py``, ``ops.py`` and ``ref.py``;
* every public dispatcher in ``ops.py`` (a public function that names a
  ``*_ref`` or a ``*_cuda``) tests ``on_cpu(...)`` and reaches a ``*_ref``
  only in that branch (a public function naming neither composes other
  dispatchers and is not one itself);
* no ``try`` surrounds a ``*_cuda`` call in ``ops.py`` or ``kernel.py``
  (a failed launch raises; it never turns into the plain version);
* ``ref.py`` never names ``torch.cuda`` or a ``*_cuda``;
* every ``*_ref`` a dispatcher names is defined in the package's ``ref.py``;
* ``_build.SOURCES`` equals the set of ``csrc/*.cu``, and each source is
  loaded by some ``kernel.py`` (``_build.c_function("<source>", ...)`` or
  ``_build.library("<source>")``);
* every public dispatcher is named in a ``tests/test_torch_*.py``, and every
  public ``*_cuda`` wrapper of a ``kernel.py`` in ``chip_smoke.py`` (which
  holds each kernel against its plain version on the card);
* fault 1: nothing in the package writes ``allow_tf32`` or
  ``fp32_precision``, or calls ``torch.set_float32_matmul_precision``.

``repro``'s jit-hygiene family has no twin: the port traces and compiles
nothing (no ``torch.compile``, no ``jax.jit``), so there is no retrace to
guard against.

A project rule: inline suppressions do not apply.  Fix the package, or
baseline the finding with its reason.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .framework import Finding, dotted, project_rule

RULE = "kernel-contract"
REQUIRED = ("kernel.py", "ref.py", "ops.py")
PKG = Path("src") / "repro_torch"
TF32_ATTRS = ("allow_tf32", "fp32_precision")


def _parse(path: Path):
    try:
        return ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return None


def _public_functions(tree: ast.AST):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            yield node


def _names(node: ast.AST) -> set:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _is_on_cpu(test: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func)[-1:] == ("on_cpu",)
               for n in ast.walk(test))


def _ref_outside_cpu_branch(fn: ast.AST) -> list:
    """``*_ref`` names a dispatcher reaches outside the body of an ``if
    on_cpu(...)`` branch, as ``(name, line)``."""
    inside = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.If) and _is_on_cpu(n.test):
            for stmt in n.body:
                inside.update(id(x) for x in ast.walk(stmt))
    out = []
    for n in ast.walk(fn):
        name = n.id if isinstance(n, ast.Name) else (n.attr if isinstance(n, ast.Attribute)
                                                     else None)
        if name and name.endswith("_ref") and id(n) not in inside:
            out.append((name, n.lineno))
    return out


def _top_level_defs(tree) -> set:
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _cuda_calls_in_try(tree) -> list:
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Try):
            for stmt in n.body:
                for c in ast.walk(stmt):
                    if isinstance(c, ast.Call) and dotted(c.func)[-1:] \
                            and dotted(c.func)[-1].endswith("_cuda"):
                        out.append((dotted(c.func)[-1], c.lineno))
    return out


def _loaded_sources(tree) -> set:
    """First arguments of ``_build.c_function`` / ``_build.library`` calls."""
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and dotted(n.func)[-1:] in (("c_function",), ("library",)) \
                and n.args and isinstance(n.args[0], ast.Constant):
            out.add(n.args[0].value)
    return out


def _build_sources(root: Path):
    tree = _parse(root / PKG / "_build.py")
    if tree is None:
        return None
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "SOURCES"
                                             for t in n.targets):
            try:
                return set(ast.literal_eval(n.value))
            except ValueError:
                return None
    return None


def _scoped_nodes(tree, qual: str = "<module>"):
    """Every node with the dotted qualname of its enclosing def or class."""
    for child in ast.iter_child_nodes(tree):
        yield child, qual
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield from _scoped_nodes(child, child.name if qual == "<module>"
                                     else f"{qual}.{child.name}")
        else:
            yield from _scoped_nodes(child, qual)


def _tf32_writes(path: str, tree) -> list:
    out = []
    for n, qual in _scoped_nodes(tree):
        targets = []
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr in TF32_ATTRS:
                out.append(Finding(RULE, path, n.lineno, qual,
                                   f"writes '.{t.attr}' — the package never flips a TF32 flag "
                                   f"(fault 1): the entry points raise while it is on"))
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d[-1:] == ("set_float32_matmul_precision",) or (
                    d == ("setattr",) and len(n.args) > 1 and isinstance(n.args[1], ast.Constant)
                    and n.args[1].value in TF32_ATTRS):
                out.append(Finding(RULE, path, n.lineno, qual,
                                   f"calls {'.'.join(d)}() on a TF32 setting — the package "
                                   f"never flips it (fault 1)"))
    return out


@project_rule
def kernel_contract_rule(root: Path) -> list:
    findings: list[Finding] = []
    pkg_dir = root / PKG
    kdir = pkg_dir / "kernels"
    if not kdir.is_dir():
        return findings
    tests = sorted((root / "tests").glob("test_torch_*.py")) if (root / "tests").is_dir() else []
    test_blob = "".join(p.read_text() for p in tests)
    smoke = root / "chip_smoke.py"
    smoke_blob = smoke.read_text() if smoke.is_file() else ""
    loaded: set = set()

    for pkg in sorted(p for p in kdir.iterdir() if p.is_dir()):
        if pkg.name.startswith(("_", ".")):
            continue
        rel = pkg.relative_to(root).as_posix()
        for req in REQUIRED:
            if not (pkg / req).is_file():
                findings.append(Finding(RULE, rel, 1, pkg.name,
                                        f"kernel package is missing '{req}' (contract: "
                                        f"kernel.py + ops.py + ref.py)"))
        ref_tree = _parse(pkg / "ref.py")
        ref_defs = _top_level_defs(ref_tree) if ref_tree is not None else set()
        if ref_tree is not None:
            for n in ast.walk(ref_tree):
                d = dotted(n) if isinstance(n, ast.Attribute) else ()
                if d[:2] == ("torch", "cuda") or (isinstance(n, ast.Name)
                                                  and n.id.endswith("_cuda")):
                    what = ".".join(d[:2]) if d else n.id
                    findings.append(Finding(RULE, f"{rel}/ref.py", n.lineno, pkg.name,
                                            f"ref.py names '{what}' — the plain version "
                                            f"never reaches the card's kernels or CUDA API"))
        for fname in ("ops.py", "kernel.py"):
            tree = _parse(pkg / fname)
            if tree is None:
                continue
            for name, line in _cuda_calls_in_try(tree):
                findings.append(Finding(RULE, f"{rel}/{fname}", line, pkg.name,
                                        f"'{name}()' inside a try block — a failed launch "
                                        f"must raise, never turn into another route"))
            if fname == "kernel.py":
                loaded |= _loaded_sources(tree)
                for fn in _public_functions(tree):
                    if fn.name.endswith("_cuda") and fn.name not in smoke_blob:
                        findings.append(Finding(
                            RULE, f"{rel}/kernel.py", fn.lineno, fn.name,
                            f"CUDA wrapper '{fn.name}' is not named in chip_smoke.py — each "
                            f"wrapper is held against its plain version on the card"))
                continue
            for fn in _public_functions(tree):
                names = _names(fn)
                refs = {n for n in names if n.endswith("_ref")}
                cudas = {n for n in names if n.endswith("_cuda")}
                if not refs and not cudas:
                    continue            # composes other dispatchers
                if not any(isinstance(n, ast.If) and _is_on_cpu(n.test) for n in ast.walk(fn)):
                    findings.append(Finding(
                        RULE, f"{rel}/ops.py", fn.lineno, fn.name,
                        "dispatcher does not test on_cpu(...) — CPU tensors take the plain "
                        "version, CUDA tensors the kernel, by device alone"))
                for name, line in _ref_outside_cpu_branch(fn):
                    findings.append(Finding(
                        RULE, f"{rel}/ops.py", line, fn.name,
                        f"'{name}' reached outside the on_cpu(...) branch — a CUDA tensor "
                        f"must go to the kernel, not to the plain version"))
                for name in sorted(refs - ref_defs):
                    findings.append(Finding(
                        RULE, f"{rel}/ops.py", fn.lineno, fn.name,
                        f"dispatcher names '{name}', which the package's ref.py does not "
                        f"define"))
                if fn.name not in test_blob:
                    findings.append(Finding(
                        RULE, f"{rel}/ops.py", fn.lineno, fn.name,
                        f"public dispatcher '{fn.name}' is not named in any "
                        f"tests/test_torch_*.py — each entry point needs its parity test"))

    sources = _build_sources(root)
    cu = {p.stem for p in (pkg_dir / "csrc").glob("*.cu")}
    build_rel = (PKG / "_build.py").as_posix()
    if sources is None:
        findings.append(Finding(RULE, build_rel, 1, "<module>",
                                "_build.SOURCES is missing or not a literal"))
    else:
        for name in sorted(cu - sources):
            findings.append(Finding(RULE, build_rel, 1, "<module>",
                                    f"csrc/{name}.cu is not in _build.SOURCES: it is never "
                                    f"built"))
        for name in sorted(sources - cu):
            findings.append(Finding(RULE, build_rel, 1, "<module>",
                                    f"_build.SOURCES names '{name}', which has no csrc/{name}.cu"))
        for name in sorted(sources - loaded):
            findings.append(Finding(RULE, build_rel, 1, "<module>",
                                    f"source '{name}' is built but no kernel.py loads it"))

    for p in sorted(pkg_dir.rglob("*.py")):
        tree = _parse(p)
        if tree is not None:
            findings.extend(_tf32_writes(p.relative_to(root).as_posix(), tree))
    return findings
