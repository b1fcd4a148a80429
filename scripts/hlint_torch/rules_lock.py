"""lock-discipline rule: guarded fields touched outside the runtime lock.

The port's serving schedulers (``serve/runtime.py``: ``PanelRuntime``;
``serve/tenancy.py``: ``MultiTenantRuntime`` and its ``_Tenant`` records)
share mutable state between the submitting threads and the scheduler thread
under one condition variable, ``_cv``.  A field mutated under the lock
somewhere must be read under it everywhere: a lone unlocked read is a data
race even where it "usually works".

``LOCK_REGISTRY`` lists, per file, the attribute names read from the port's
code (tests inject their own registry):

* ``full``      — every load and store must lie lexically inside ``with
                  <obj>._cv:`` or inside a method of ``locked_methods``
                  (whose contract is "the caller holds the lock");
                  ``__init__`` / ``__post_init__`` are exempt (nothing else
                  sees the object yet).  Names match on any receiver.
* ``subscript`` — only a subscript needs the lock (``self.stats["retries"]``);
                  passing the object on, or calling it (``_Stats.__call__``,
                  the snapshot taken under the lock), is fine.
* ``no_rebind`` — may be mutated in place, but never rebound outside
                  ``__init__`` (another thread keeps the old object).

Outside ``serve/`` (``launch/``, ``examples/torch_*.py``), subscripting a
live ``.stats`` attribute is flagged: call ``.stats()`` for a snapshot.
"""
from __future__ import annotations

import ast

from .framework import QualnameVisitor, file_rule

RULE = "lock-discipline"
LOCK_ATTR = "_cv"

_RESILIENCE = {"gate", "allow_submit", "on_success", "decide_failure", "breaker_state"}

LOCK_REGISTRY = {
    "src/repro_torch/serve/runtime.py": {
        # PanelRuntime's queue, counters and thread; LaneResilience too
        "full": {"_pending", "_flush_goal", "_launched", "_submitted", "_in_launch",
                 "_closing", "_closed", "_thread", "_res"},
        "subscript": {"stats"},
        "no_rebind": set(),
        "locked_methods": {"_check_open", "_check_admission", "_sync_breaker_stat", "_event",
                           "_ensure_thread", "_next_deadline", "_launchable",
                           "_handle_failure"} | _RESILIENCE,
        # _count_relaunch is not a locked method: the NaN guard calls it on a
        # fetching client thread, and it takes the lock itself
    },
    "src/repro_torch/serve/tenancy.py": {
        "full": {"_tenants", "_compiled", "_launch_seq", "_closing", "_closed", "_thread",
                 "_monitor", "_resident_bytes",
                 # _Tenant's scheduling and residency state
                 "pending", "submitted", "launched", "flush_goal", "in_launch", "weight",
                 "deficit", "last_served", "removing", "resident", "res"},
        "subscript": {"stats"},
        "no_rebind": set(),
        "locked_methods": {"drained", "_check_open", "_check_submittable", "_check_admission",
                           "_tenant_event", "_select", "_ensure_thread_locked", "_ready",
                           "_next_wake", "_pick", "_enforce_budget_locked", "_handle_failure",
                           # StragglerMonitor, owned by the runtime
                           "record", "forget", "stragglers"} | _RESILIENCE,
        # _make_on_relaunch / _make_on_retire are factories whose closures
        # take the lock themselves (fetching and retiring threads)
    },
    "src/repro_torch/serve/faults.py": {
        # LaneResilience / CircuitBreaker: every method runs with the owning
        # runtime's _cv held (submit-side admission, scheduler-side verdicts)
        "full": {"attempts", "not_before", "failures", "opened_at", "state"},
        "subscript": set(),
        "no_rebind": set(),
        "locked_methods": {"on_panel_success", "on_panel_failure"} | _RESILIENCE,
    },
    "src/repro_torch/serve/step.py": {
        "full": set(),
        "subscript": set(),
        # HMatrixSolveServer.last_info: the launch appends on the scheduler
        # thread while a client reads or clears it
        "no_rebind": {"last_info"},
        "locked_methods": set(),
    },
}

LIVE_STATS_PREFIXES = ("src/repro_torch/launch/", "examples/torch_")


def _is_lock_ctx(expr: ast.AST) -> bool:
    return isinstance(expr, ast.Attribute) and expr.attr == LOCK_ATTR


class _LockVisitor(QualnameVisitor):
    def __init__(self, path: str, reg: dict):
        super().__init__(path)
        self.reg = reg
        self.lock_depth = 0
        self.method_stack: list[str] = []

    def _exempt(self) -> bool:
        if self.lock_depth > 0:
            return True
        return any(m in ("__init__", "__post_init__") or m in self.reg["locked_methods"]
                   for m in self.method_stack)

    def _scoped_fn(self, node):
        # a function defined under the lock runs later, without it
        depth, self.lock_depth = self.lock_depth, 0
        self.method_stack.append(node.name)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()
        self.method_stack.pop()
        self.lock_depth = depth

    visit_FunctionDef = _scoped_fn
    visit_AsyncFunctionDef = _scoped_fn

    def visit_Lambda(self, node):
        # a lambda handed to _cv.wait_for runs under the lock; any other
        # lambda is checked where it stands
        self.generic_visit(node)

    def visit_With(self, node):
        locked = any(_is_lock_ctx(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        self.lock_depth += locked
        for stmt in node.body:
            self.visit(stmt)
        self.lock_depth -= locked

    def visit_Assign(self, node):
        for t in node.targets:
            if isinstance(t, ast.Attribute) and t.attr in self.reg["no_rebind"] \
                    and "__init__" not in self.method_stack:
                self.emit(RULE, t, f"rebinding guarded attribute '.{t.attr}' outside __init__ "
                                   f"— another thread keeps the orphaned old object; mutate "
                                   f"it in place (.clear()) instead")
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if node.attr in self.reg["full"] and not self._exempt():
            self.emit(RULE, node, f"guarded attribute '.{node.attr}' accessed outside 'with "
                                  f"...{LOCK_ATTR}:' — fields mutated under the lock must be "
                                  f"read under it too")
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if isinstance(node.value, ast.Attribute) and node.value.attr in self.reg["subscript"] \
                and not self._exempt():
            self.emit(RULE, node, f"subscripting guarded '.{node.value.attr}' outside the lock "
                                  f"— a concurrent scheduler mutation races this access")
            for child in ast.iter_child_nodes(node.value):
                self.visit(child)
            self.visit(node.slice)
            return
        self.generic_visit(node)

    def visit_Call(self, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in self.reg["locked_methods"] and not self._exempt():
            self.emit(RULE, node, f"'{node.func.attr}()' assumes the caller holds {LOCK_ATTR} "
                                  f"but is called outside 'with ...{LOCK_ATTR}:'")
        self.generic_visit(node)


class _LiveStatsVisitor(QualnameVisitor):
    """Outside serve/: ``obj.stats[...]`` reads a live, lock-guarded dict."""

    def visit_Subscript(self, node):
        if isinstance(node.value, ast.Attribute) and node.value.attr == "stats":
            self.emit(RULE, node, "subscripting a live '.stats' attribute — call '.stats()' "
                                  "for a snapshot taken under the runtime lock")
        self.generic_visit(node)


@file_rule
def lock_rule(path: str, tree: ast.AST, lines: list) -> list:
    reg = LOCK_REGISTRY.get(path)
    if reg is not None:
        v = _LockVisitor(path, reg)
    elif path.startswith(LIVE_STATS_PREFIXES):
        v = _LiveStatsVisitor(path)
    else:
        return []
    v.visit(tree)
    return v.findings
