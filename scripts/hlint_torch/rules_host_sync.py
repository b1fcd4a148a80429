"""host-sync rule: host <-> device synchronization on the port's device paths.

Two scopes, as in ``scripts/hlint``:

* **strict** device-path modules: ``solve/``, ``serve/``,
  ``core/hmatrix.py``, ``parallel/hshard.py``, ``obs.py`` (the launch's
  :class:`Completion` and the tracer's event reads), and every
  ``kernels/<pkg>/ops.py`` and ``kernels/<pkg>/kernel.py`` (a launch
  wrapper must not synchronize).  Besides the implicit syncs below, every
  host boundary (``.cpu()``, ``.numpy()``, ``.to(<host device>)``,
  ``to_host(...)``), every blocking wait (``torch.cuda.synchronize()``,
  ``<stream or event>.synchronize()``) and every operation whose result
  shape depends on the data (``torch.nonzero`` / ``argwhere`` /
  ``unique`` / ``masked_select``, one-argument ``torch.where``,
  ``x[bool_mask]``, ``repeat_interleave`` with tensor repeats and no
  ``output_size``: PyTorch reads the size back from the card) is flagged.
  Only documented fetch and wait sites are exempt (suppression or baseline).
* **orchestration** modules: ``launch/`` and ``examples/torch_*.py``.  An
  explicit fetch (``.cpu()``, ``.numpy()``, ``.to("cpu")``) is the
  sanctioned way across the boundary there, so only IMPLICIT syncs are
  flagged.

Implicit syncs, flagged in both scopes: ``.item()`` / ``.tolist()``,
``int()`` / ``float()`` / ``bool()`` on a tensor, a tensor as the test of
``if`` / ``while`` / a conditional expression, and iterating a tensor.

Device values are tracked by an intra-function taint.  The results of
``torch.*`` calls (those that return tensors), of the port's entry points
(``make_apply`` / ``make_solver`` / ... return tainted CALLABLES; kernel
dispatchers and wrappers, ``apply_in_tree_order``, ``h_attention`` and the
like return tensors) and of ``nn.Module`` calls (a name or ``self``
attribute bound to ``nn.<Module>(...)``) are device values, and so are
parameters annotated ``torch.Tensor``.  Taint flows through names,
attributes, arithmetic, subscripts, method calls on a tainted value and
calls fed a tainted operand.  ``.shape``, ``.dtype``, ``.device``,
``.ndim``, ``.numel()``, ``len()`` and the explicit fetches clear it.
Python containers of tensors (list / tuple displays and comprehensions)
carry the taint to their elements, and iterating one is not a finding.
"""
from __future__ import annotations

import ast

from .framework import QualnameVisitor, dotted, file_rule

RULE = "host-sync"

PKG = "src/repro_torch/"
STRICT_PREFIXES = (PKG + "solve/", PKG + "serve/")
STRICT_FILES = (PKG + "core/hmatrix.py", PKG + "parallel/hshard.py", PKG + "obs.py")
ORCH_PREFIXES = (PKG + "launch/", "examples/torch_")

# attributes and methods that read metadata, never device data; SolveInfo's
# fields are host values (its documented lazy fetch)
STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout", "requires_grad",
                "is_leaf", "names", "itemsize",
                "iterations", "iters_per_column", "residual_norms", "converged"}
STATIC_METHODS = {"numel", "nelement", "dim", "size", "element_size", "stride",
                  "is_contiguous", "data_ptr", "is_pinned", "get_device", "storage_offset",
                  "is_floating_point", "is_complex"}
# explicit host boundaries: the result is host data (flagged in strict scope)
HOST_METHODS = {"cpu", "numpy"}
HOST_FUNCS = {"to_host"}
# the port's predicates that return host booleans (their bodies are linted)
HOST_PREDICATES = {"on_cpu", "any_active"}
IMPLICIT_METHODS = {"item", "tolist"}
# builtins whose result is a host value whatever they are fed
HOST_BUILTINS = {"int", "float", "bool", "len", "str", "repr", "range", "isinstance",
                 "hasattr", "getattr", "type", "id", "print", "callable", "round", "format"}
# torch.* calls that return no tensor
NON_TENSOR_TORCH = {"device", "Generator", "finfo", "iinfo", "is_tensor", "get_default_dtype",
                    "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
                    "is_grad_enabled", "Size", "get_float32_matmul_precision", "manual_seed",
                    "cuda", "backends", "profiler", "utils", "distributed", "_C", "Stream",
                    "Event", "dtype", "is_floating_point", "numel", "compile", "jit",
                    "get_num_threads", "set_num_threads", "use_deterministic_algorithms",
                    "are_deterministic_algorithms_enabled", "library", "nn", "fx", "overrides"}
# the port's entry points that return a device-valued CALLABLE
DEVICE_FACTORIES = {"make_apply", "make_matvec", "make_solver", "make_sharded_apply",
                    "make_sharded_solver", "make_prefill_step", "make_decode_step",
                    "make_train_step", "make_loss_fn", "panel_entry"}
# the port's entry points and kernel dispatchers that return tensors (and
# every ``batched_*`` dispatcher and ``*_cuda`` wrapper)
DEVICE_FUNCS = {"apply_in_tree_order", "pcg_tree_ordered", "h_attention", "permute_to_tree",
                "permute_from_tree", "operand", "dense_matvec_oracle", "halton",
                "sinusoid_targets", "hlu_solve_panels", "morton_encode",
                "hattention_nearfield_op", "hattention_nearfield_bwd_op"}
# data-dependent result shapes: PyTorch reads the size back from the card
DATA_DEPENDENT = {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select"}
MASK_FUNCS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or", "logical_not",
              "logical_xor", "isclose", "eq", "ne", "lt", "le", "gt", "ge", "bool"}


def scope_of(path: str) -> str | None:
    if path.startswith(STRICT_PREFIXES) or path in STRICT_FILES:
        return "strict"
    parts = path.split("/")
    if path.startswith(PKG + "kernels/") and len(parts) == 5 \
            and parts[4] in ("ops.py", "kernel.py"):
        return "strict"
    if path.startswith(ORCH_PREFIXES):
        return "orch"
    return None


def _callee(call: ast.Call) -> str:
    """The last name of a call's callee (``torch.nonzero`` -> ``nonzero``)."""
    d = dotted(call.func)
    return d[-1] if d else ""


def _is_nn_module_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func)
    return (d[:1] == ("nn",) and len(d) == 2) or (d[:2] == ("torch", "nn") and len(d) == 3)


def _tensor_annotation(ann: ast.AST | None) -> bool:
    return ann is not None and any(isinstance(n, (ast.Name, ast.Attribute)) and
                                   (getattr(n, "id", None) == "Tensor"
                                    or getattr(n, "attr", None) == "Tensor")
                                   for n in ast.walk(ann))


def _host_target(node: ast.Call) -> bool:
    """``.to(...)`` whose target is the host."""
    cands = list(node.args[:1]) + [kw.value for kw in node.keywords if kw.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Constant) and isinstance(c.value, str) and c.value.startswith("cpu"):
            return True
        if isinstance(c, ast.Call) and dotted(c.func)[-1:] == ("device",) and c.args \
                and isinstance(c.args[0], ast.Constant) and str(c.args[0].value).startswith("cpu"):
            return True
    return False


class Tainter:
    """Intra-function device-value taint."""

    def __init__(self, tainted=(), containers=(), masks=(), callables=()):
        self.tainted = set(tainted)
        self.containers = set(containers)
        self.masks = set(masks)
        self.callables = set(callables)

    def copy(self) -> "Tainter":
        return Tainter(self.tainted, self.containers, self.masks, self.callables)

    def _name(self, node) -> str:
        return ".".join(dotted(node))

    def is_host_call(self, node: ast.Call) -> bool:
        d = dotted(node.func)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in STATIC_METHODS or attr in HOST_METHODS or attr in IMPLICIT_METHODS:
                return True
            if attr == "to" and _host_target(node):
                return True
        if len(d) == 1 and d[0] in HOST_BUILTINS:
            return True
        return _callee(node) in HOST_FUNCS or _callee(node) in HOST_PREDICATES

    def is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            if self.is_host_call(node):
                return False
            d = dotted(node.func)
            if d[:1] == ("torch",):
                return len(d) > 1 and d[1] not in NON_TENSOR_TORCH
            name = ".".join(d)
            if name and name in self.callables:
                return True
            callee = _callee(node)
            if callee in DEVICE_FUNCS or callee.startswith("batched_") \
                    or callee.endswith("_cuda"):
                return True
            if isinstance(node.func, ast.Attribute) and self.is_device(node.func.value):
                return True
            return any(self.is_device(a) for a in node.args) \
                or any(self.is_device(kw.value) for kw in node.keywords)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self._name(node) in self.tainted or self.is_device(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_device(node.value)
        if isinstance(node, ast.Starred):
            return self.is_device(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_device(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.is_device(node.left) or any(self.is_device(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_device(e) for e in node.elts)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.is_device(node.elt) or any(self.is_device(g.iter)
                                                   for g in node.generators)
        if isinstance(node, ast.IfExp):
            return self.is_device(node.body) or self.is_device(node.orelse)
        return False

    def is_container(self, node: ast.AST) -> bool:
        """A Python container (of tensors): iterating it is not a sync."""
        if isinstance(node, (ast.Tuple, ast.List, ast.ListComp, ast.GeneratorExp, ast.Set,
                             ast.SetComp, ast.Dict, ast.DictComp)):
            return True
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d in (("list",), ("tuple",), ("zip",), ("enumerate",), ("reversed",),
                     ("sorted",), ("map",), ("dict",)):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "items", "values", "keys", "parameters", "named_parameters", "buffers",
                    "children", "modules"):
                return True
            # torch's splitting functions return tuples of views; map_shards
            # a list of per-shard results
            if _callee(node) in ("split", "tensor_split", "chunk", "unbind", "map_shards"):
                return True
        if isinstance(node, ast.Name):
            return node.id in self.containers
        if isinstance(node, ast.Attribute):
            return self._name(node) in self.containers
        return False

    def is_mask(self, node: ast.AST) -> bool:
        """A boolean tensor (a comparison of device values and the like)."""
        if isinstance(node, ast.Compare):
            return self.is_device(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.Invert, ast.Not)):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr,
                                                                ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            if _callee(node) in MASK_FUNCS and self.is_device(node):
                return True
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Attribute):
            return self._name(node) in self.masks
        return False

    def assign(self, target: ast.AST, value: ast.AST | None, device: bool):
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.assign(e.value if isinstance(e, ast.Starred) else e, None, device)
            return
        name = self._name(target) if isinstance(target, (ast.Name, ast.Attribute)) else ""
        if not name:
            return
        for s in (self.tainted, self.containers, self.masks, self.callables):
            s.discard(name)
        if isinstance(value, ast.Call) and (_callee(value) in DEVICE_FACTORIES
                                            or _is_nn_module_ctor(value)):
            self.callables.add(name)
        elif device:
            self.tainted.add(name)
            if value is not None and self.is_container(value):
                self.containers.add(name)
            if value is not None and self.is_mask(value):
                self.masks.add(name)


def _class_callables(cls: ast.ClassDef) -> set:
    """``self.<attr>`` bound to ``nn.<Module>(...)`` anywhere in the class."""
    out = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_nn_module_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and dotted(t)[:1] == ("self",):
                    out.add(".".join(dotted(t)))
    return out


class _HostSyncVisitor(QualnameVisitor):
    def __init__(self, path: str, scope: str):
        super().__init__(path)
        self.scope = scope
        self.taint_stack = [Tainter()]
        self.class_callables: list[set] = [set()]

    @property
    def strict(self) -> bool:
        return self.scope == "strict"

    @property
    def taint(self) -> Tainter:
        return self.taint_stack[-1]

    def visit_ClassDef(self, node):
        self.class_callables.append(_class_callables(node))
        self._scoped(node)
        self.class_callables.pop()

    def _scoped_fn(self, node):
        # a function sees its enclosing scope's taint (closures), its class's
        # nn.Module attributes, and of its parameters only those annotated
        # as tensors
        env = self.taint.copy()
        env.callables |= self.class_callables[-1]
        args = node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            env.assign(ast.Name(id=a.arg), None, _tensor_annotation(a.annotation))
        self.taint_stack.append(env)
        self.stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self.stack.pop()
        self.taint_stack.pop()

    visit_FunctionDef = _scoped_fn
    visit_AsyncFunctionDef = _scoped_fn

    # -- bindings ---------------------------------------------------------

    def visit_Assign(self, node):
        self.generic_visit(node)
        dev = self.taint.is_device(node.value)
        for t in node.targets:
            self.taint.assign(t, node.value, dev)

    def visit_AnnAssign(self, node):
        self.generic_visit(node)
        if node.value is not None:
            self.taint.assign(node.target, node.value, self.taint.is_device(node.value))

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        if self.taint.is_device(node.value):
            self.taint.assign(node.target, None, True)

    def visit_withitem(self, node):
        self.generic_visit(node)
        if node.optional_vars is not None:
            self.taint.assign(node.optional_vars, node.context_expr,
                              self.taint.is_device(node.context_expr))

    # -- implicit syncs ---------------------------------------------------

    def _iterated(self, node, iter_node, target):
        if self.taint.is_device(iter_node):
            if not self.taint.is_container(iter_node):
                self.emit(RULE, node, "iterating a tensor reads it row by row on the host — "
                                      "keep the loop on the device, or fetch once and iterate "
                                      "the host copy")
            self.taint.assign(target, None, True)

    def visit_For(self, node):
        self.visit(node.iter)
        self._iterated(node, node.iter, node.target)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_comprehension(self, node):
        self.visit(node.iter)
        self._iterated(node.iter, node.iter, node.target)
        for cond in node.ifs:
            self.visit(cond)

    def _visit_comp(self, node):
        # generators first, so that their targets are bound for the element
        for g in node.generators:
            self.visit(g)
        for child in ("elt", "key", "value"):
            if hasattr(node, child):
                self.visit(getattr(node, child))

    visit_ListComp = visit_SetComp = visit_GeneratorExp = visit_DictComp = _visit_comp

    def _test(self, node, test, what: str):
        if self.taint.is_device(test) and not self.taint.is_container(test):
            self.emit(RULE, node, f"a tensor as the test of {what} reads it back to the host "
                                  f"(an implicit bool())")

    def visit_If(self, node):
        self._test(node, node.test, "'if'")
        self.generic_visit(node)

    def visit_While(self, node):
        self._test(node, node.test, "'while'")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._test(node, node.test, "a conditional expression")
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if self.strict and self.taint.is_device(node.value) and self.taint.is_mask(node.slice):
            self.emit(RULE, node, "indexing by a boolean mask sizes its result by the data: "
                                  "PyTorch reads the count back from the card")
        self.generic_visit(node)

    def visit_Call(self, node):
        d = dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        args_dev = any(self.taint.is_device(a) for a in node.args)
        recv_dev = attr is not None and self.taint.is_device(node.func.value)

        if len(d) == 1 and d[0] in ("int", "float", "bool") and args_dev \
                and not self.taint.is_container(node.args[0]):
            self.emit(RULE, node, f"implicit device->host sync: {d[0]}() on a tensor blocks "
                                  f"until it is computed and copied")
        elif attr in IMPLICIT_METHODS and recv_dev:
            self.emit(RULE, node, f"implicit device->host sync: .{attr}() on a tensor")
        elif self.strict:
            self._strict_call(node, d, attr, args_dev, recv_dev)
        self.generic_visit(node)

    def _strict_call(self, node, d, attr, args_dev, recv_dev):
        if attr in HOST_METHODS and recv_dev:
            self.emit(RULE, node, f"host boundary: .{attr}() in a device-path module — only "
                                  f"documented fetch sites are exempt")
        elif attr == "to" and recv_dev and _host_target(node):
            self.emit(RULE, node, "host boundary: .to(<host device>) in a device-path module "
                                  "— only documented fetch sites are exempt")
        elif _callee(node) in HOST_FUNCS:
            self.emit(RULE, node, f"host boundary: {d[-1]}() in a device-path module — only "
                                  f"documented fetch sites are exempt")
        elif d == ("torch", "cuda", "synchronize"):
            self.emit(RULE, node, "blocking wait: torch.cuda.synchronize() waits for the "
                                  "whole device")
        elif attr == "synchronize":
            self.emit(RULE, node, "blocking wait: .synchronize() on a stream, event or "
                                  "completion holds this thread until the card gets there")
        elif attr in DATA_DEPENDENT and (recv_dev or d[:1] == ("torch",)):
            self.emit(RULE, node, f"data-dependent shape: {attr}() reads its result size back "
                                  f"from the card")
        elif d == ("torch", "where") and len(node.args) == 1 and not node.keywords:
            self.emit(RULE, node, "data-dependent shape: one-argument torch.where() reads its "
                                  "result size back from the card")
        elif attr == "repeat_interleave" and not any(kw.arg == "output_size"
                                                     for kw in node.keywords):
            repeats = node.args[1] if d[:1] == ("torch",) and len(node.args) > 1 \
                else (node.args[0] if d[:1] != ("torch",) and node.args else None)
            one_arg = d[:1] == ("torch",) and len(node.args) == 1
            if one_arg or (repeats is not None and self.taint.is_device(repeats)):
                self.emit(RULE, node, "data-dependent shape: repeat_interleave() with tensor "
                                      "repeats and no output_size reads the total back from "
                                      "the card")
        elif len(d) == 1 and d[0] == "print" and args_dev:
            self.emit(RULE, node, "printing a tensor in a device-path module copies it to the "
                                  "host")


@file_rule
def host_sync_rule(path: str, tree: ast.AST, lines: list) -> list:
    scope = scope_of(path)
    if scope is None:
        return []
    v = _HostSyncVisitor(path, scope)
    v.visit(tree)
    return v.findings
