"""hlint_torch rule framework: findings, suppressions, baseline, file walker.

A copy of ``scripts/hlint``'s framework retargeted at the PyTorch port
(stdlib only; it imports neither torch nor the JAX linter):

* A **rule** is a named check.  File rules get ``(path, tree, lines)`` per
  Python file and yield findings; project rules run once against the repo
  root (structure checks, e.g. the kernel contract).
* A **finding** is ``(rule, path, line, qualname, message)``.  Its baseline
  key drops the line number, so unrelated edits above a baselined site do
  not invalidate the baseline.
* **Suppressions** are inline comments with a tag of their own, which the
  JAX linter's ``# hlint: disable=`` pattern does not match::

      host = rows.cpu()   # hlint-torch: disable=host-sync -- the lazy fetch

  The rule list may hold several comma-separated names.  The reason after
  ``--`` is MANDATORY: a bare ``# hlint-torch: disable=...`` is itself
  reported (rule ``hlint-bare-suppression``).  A suppression on a line of
  its own applies to the next code line.
* The **baseline** (``scripts/hlint_torch/baseline.json``) holds findings
  accepted with a reason rather than fixed.  Every entry needs a non-empty
  ``justification`` (``--update-baseline`` writes ``TODO``, which fails the
  run until filled in), and entries no longer found fail the run too.

Walked: ``src/repro_torch/`` and ``examples/torch_*.py``.  ``chip_smoke.py``
and ``scripts/*.py`` are not: they measure, and so synchronize on purpose.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

# (directory, glob) pairs walked for file rules; tests/ is left out (test
# bodies fetch results eagerly, and tests/test_torch_hlint.py holds
# must-fire fixtures)
WALK = (("src/repro_torch", "**/*.py"), ("examples", "torch_*.py"))

TAG = "hlint-torch"
SUPPRESS_RE = re.compile(
    r"#\s*hlint-torch:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*))?$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    qualname: str      # enclosing module/class/function, dotted
    message: str

    def key(self) -> tuple:
        return (self.rule, self.path, self.qualname, self.message)

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.qualname}: {self.message}"


@dataclass
class Suppression:
    line: int
    rules: tuple
    justification: str
    own_line: bool     # comment-only line: applies to the NEXT code line
    used: bool = field(default=False)


def parse_suppressions(lines: list[str]) -> list[Suppression]:
    out = []
    for i, raw in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = (m.group(2) or "").strip()
        own = raw.split("#", 1)[0].strip() == ""
        out.append(Suppression(i, rules, just, own))
    return out


def apply_suppressions(findings: list[Finding], sups: list[Suppression]) -> list[Finding]:
    """Drop findings covered by a justified suppression on the same line
    (or, for comment-only suppressions, the line below); report bare
    suppressions as findings themselves."""
    by_line: dict[int, list[Suppression]] = {}
    for s in sups:
        target = s.line + 1 if s.own_line else s.line
        by_line.setdefault(target, []).append(s)

    kept = []
    for f in findings:
        hit = next((s for s in by_line.get(f.line, []) if f.rule in s.rules), None)
        if hit is None:
            kept.append(f)
            continue
        hit.used = True
        if not hit.justification:
            kept.append(Finding(
                "hlint-bare-suppression", f.path, hit.line, f.qualname,
                f"suppression of [{f.rule}] carries no justification — use "
                f"'# {TAG}: disable={f.rule} -- <reason>'"))
    return kept


class QualnameVisitor(ast.NodeVisitor):
    """Base visitor that tracks the dotted qualname of the enclosing scope."""

    def __init__(self, path: str):
        self.path = path
        self.stack: list[str] = []
        self.findings: list[Finding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def emit(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(rule, self.path, node.lineno, self.qualname, message))

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped


def dotted(node: ast.AST) -> tuple:
    """('torch', 'cuda', 'synchronize') for torch.cuda.synchronize, else ()."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


# -- rule registry -----------------------------------------------------------

FILE_RULES: list = []      # callables (path, tree, lines) -> [Finding]
PROJECT_RULES: list = []   # callables (root) -> [Finding]


def file_rule(fn):
    FILE_RULES.append(fn)
    return fn


def project_rule(fn):
    PROJECT_RULES.append(fn)
    return fn


def check_source(path: str, text: str) -> list[Finding]:
    """Run every file rule on one source blob (``path`` is repo-relative —
    rules scope themselves by it).  Applies inline suppressions."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("hlint-parse", path, e.lineno or 1, "<module>",
                        f"file does not parse: {e.msg}")]
    lines = text.splitlines()
    findings: list[Finding] = []
    for rule in FILE_RULES:
        findings.extend(rule(path, tree, lines))
    return apply_suppressions(findings, parse_suppressions(lines))


def walked_files(root: Path) -> list[Path]:
    files = []
    for d, pattern in WALK:
        base = root / d
        if base.is_dir():
            files.extend(sorted(base.glob(pattern)))
    return files


def walk_repo(root: Path | None = None) -> list[Finding]:
    root = root or REPO_ROOT
    findings: list[Finding] = []
    for p in walked_files(root):
        findings.extend(check_source(p.relative_to(root).as_posix(), p.read_text()))
    for rule in PROJECT_RULES:
        findings.extend(rule(root))
    return findings


# -- baseline ----------------------------------------------------------------

def load_baseline(path: Path | None = None) -> list[dict]:
    path = path or BASELINE_PATH
    if not path.is_file():
        return []
    return json.loads(path.read_text())


def save_baseline(entries: list[dict], path: Path | None = None):
    path = path or BASELINE_PATH
    path.write_text(json.dumps(entries, indent=2, sort_keys=True) + "\n")


def baseline_key(entry: dict) -> tuple:
    return (entry["rule"], entry["path"], entry["qualname"], entry["message"])


def reconcile(findings: list[Finding], baseline: list[dict]):
    """Split findings against the baseline.

    Returns ``(new, matched, stale, unjustified)``: findings not baselined,
    baseline entries that matched, baseline entries no longer found, and
    baseline entries missing a real justification.
    """
    keys = {baseline_key(e): e for e in baseline}
    found_keys = set()
    new = []
    for f in findings:
        if f.key() in keys:
            found_keys.add(f.key())
        else:
            new.append(f)
    matched = [e for k, e in keys.items() if k in found_keys]
    stale = [e for k, e in keys.items() if k not in found_keys]
    unjustified = [e for e in baseline
                   if not str(e.get("justification", "")).strip()
                   or e.get("justification") == "TODO"]
    return new, matched, stale, unjustified
