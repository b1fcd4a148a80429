"""Operation counts of a function run on fake tensors: the port's twin of
``repro.analysis.hlo``.

``repro`` compiles each cell for 256 or 512 chips and reads the optimised
HLO text; the port has no such compiler.  Here a ``TorchDispatchMode`` sees
every ATen operation of a function run eagerly (on fake tensors, under
``FakeTensorMode``, nothing is computed or allocated; backward passes run
inside count too) and returns the same record, :class:`ModuleStats`:

  * ``dot_flops``: the FLOPs of the products -- ``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` (``einsum`` and ``matmul`` reach the mode as these),
    scaled-dot-product attention and convolutions -- by
    ``torch.utils.flop_counter``'s formulas (2 m n k for a product), exact
    Python ints;
  * ``traffic_bytes``: a first-order model of HBM traffic, as ``repro``
    states its own: a product reads its operands and writes its result; every
    other operation that is not a view writes its result only (the analogue
    of ``repro``'s "fusion: result only": its reads are charged at the
    producers of what it reads); views (and allocations without a write)
    move nothing;
  * ``collective_bytes``: ``None``: a single-process trace has no
    collectives, so this is not measured (never 0);
  * ``loops``: filled by callers that scale a trace (``launch.dryrun``
    extrapolates over periods, microbatches and per-token loops, as
    ``repro`` multiplies a ``while`` body by its trip count).

The count is of the operations the eager program issues, so it depends on
the device of its tensors only where the program does: on fake CPU
tensors every kernel dispatcher (``kernels/*/ops.py``) takes its plain
version, so H-attention's near field counts the plain version's products,
the work kernel #11 does.  All numbers are for the whole function; the dry
run divides by the chips.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# not views, but they move no bytes: allocations and metadata-only reshapes
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten._unsafe_view,
               _aten.detach, _aten.alias, _aten.lift_fresh}
# what each operator is to the counter, by operator (cached)
_PRODUCT, _RESULT, _FREE, _COMPOSITE = range(4)
_KINDS: dict = {}


def _kind(func) -> int:
    kind = _KINDS.get(func)
    if kind is None:
        packet = func._overloadpacket
        if packet in flop_registry:
            kind = _PRODUCT
        elif func.namespace == "aten" and any(
                torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), key)
                for key in ("CompositeImplicitAutograd", "CompositeImplicitAutogradNestedTensor")):
            kind = _COMPOSITE
        elif func.is_view or packet in _NO_TRAFFIC or func.namespace != "aten":
            kind = _FREE
        else:
            kind = _RESULT
        _KINDS[func] = kind
    return kind


@dataclass
class ModuleStats:
    dot_flops: int = 0
    traffic_bytes: int = 0
    collective_bytes: None = None
    collectives: list = field(default_factory=list)
    loops: list = field(default_factory=list)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the ATen operations run inside it (see the module docstring);
    ``stats`` holds the running :class:`ModuleStats`."""

    def __init__(self):
        super().__init__()
        self.stats = ModuleStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind == _COMPOSITE:
            # under inference_mode composite ops (matmul, einsum, linear)
            # arrive whole: count what they decompose into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            kind = _KINDS[func] = _FREE if func.is_view else _RESULT
        out = func(*args, **kwargs)
        if kind == _PRODUCT:
            self.stats.dot_flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.stats.traffic_bytes += _bytes((args, kwargs)) + _bytes(out)
        elif kind == _RESULT:
            self.stats.traffic_bytes += (out.numel() * out.element_size()
                                         if isinstance(out, torch.Tensor) else _bytes(out))
        return out


def count_ops(fn, *args, **kwargs) -> ModuleStats:
    """The :class:`ModuleStats` of ``fn(*args, **kwargs)`` (its result is
    dropped)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.stats
