"""FactorStore: level-grouped low-rank factors with rank tables and bytes.

Port of the essentials of ``repro.core.factor_store``: level group
``level`` holds ``U: (B, m, k)`` and ``V: (B, n, k)`` with
``B = plan.aca_levels[level].shape[0]`` and ``m = n = n_pad >> level``;
``rank_tables[level]`` is a ``(B,)`` int32 table of effective ranks (columns
at or beyond it are exactly zero in both factors).  The store reads like a
``{level: (U, V)}`` dict.  ``k`` may differ per level after recompression.

Memory tier.  ``spill()`` copies every tensor to host memory (pinned when the
store lies on a card) and drops the device tensors; ``reload()`` copies them
back.  Both are all-or-nothing: every copy is made before the store switches
over.  A spilled store refuses to hand out its factors, so an apply against
it raises instead of reading host memory.  ``recompress_store`` truncates
every level group to a relative tolerance (kernel ``batched_recompress``).
Dense leaf storage (``repro``'s ``dense=``) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def effective_ranks(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-block effective rank: index of the last nonzero column + 1.

    A column counts as used if it is nonzero in either factor.
    """
    nz = (u != 0).any(dim=1) | (v != 0).any(dim=1)            # (B, k)
    k = u.shape[2]
    has = nz.any(dim=1)
    last = k - torch.argmax(nz.flip(1).to(torch.int32), dim=1)
    return torch.where(has, last, torch.zeros_like(last)).to(torch.int32)


class FactorStore:
    """Packed, level-grouped factor storage with rank tables and byte
    accounting; mapping-compatible with a ``{level: (U, V)}`` dict."""

    __slots__ = ("levels", "rank_tables", "_device")

    def __init__(self, levels, rank_tables):
        self.levels = dict(levels)
        self.rank_tables = dict(rank_tables)
        self._device = None                # set while spilled: where to reload
        if set(self.levels) != set(self.rank_tables):
            raise ValueError(
                f"rank table levels {sorted(self.rank_tables)} != factor "
                f"levels {sorted(self.levels)}")

    @classmethod
    def from_factors(cls, factors, plan=None, ranks=None):
        """Wrap a ``{level: (U, V)}`` dict.

        With ``ranks`` the claimed tables are checked against the arrays:
        no claim may exceed the pad width, and columns at or beyond a
        block's claimed rank must be exactly zero.  Without, the tables are
        measured (``effective_ranks``).
        """
        levels = {int(lv): (u, v) for lv, (u, v) in factors.items()}
        tables = {}
        for lv, (u, v) in levels.items():
            if u.ndim != 3 or v.ndim != 3:
                raise ValueError(f"level {lv}: factors must be (B, m, k); "
                                 f"got {tuple(u.shape)} / {tuple(v.shape)}")
            if u.shape[0] != v.shape[0] or u.shape[2] != v.shape[2]:
                raise ValueError(f"level {lv}: U {tuple(u.shape)} and V "
                                 f"{tuple(v.shape)} disagree on batch or rank")
            if plan is not None:
                b_plan = int(plan.aca_levels[lv].shape[0])
                if u.shape[0] != b_plan:
                    raise ValueError(
                        f"level {lv}: {u.shape[0]} factor blocks but plan "
                        f"lists {b_plan} admissible blocks")
            k = int(u.shape[2])
            if ranks is None:
                tables[lv] = effective_ranks(u, v)
                continue
            table = torch.as_tensor(ranks[lv], dtype=torch.int32).to(u.device)
            if tuple(table.shape) != (u.shape[0],):
                raise ValueError(f"level {lv}: rank table shape "
                                 f"{tuple(table.shape)} != ({u.shape[0]},)")
            tab = table.cpu()
            if int(tab.min()) < 0 or int(tab.max()) > k:
                raise ValueError(
                    f"level {lv}: claimed ranks [{int(tab.min())}, "
                    f"{int(tab.max())}] outside [0, {k}] for pad width {k}")
            measured = effective_ranks(u, v).cpu()
            if bool((measured > tab).any()):
                bad = int(torch.argmax((measured > tab).to(torch.int32)))
                raise ValueError(
                    f"level {lv} block {bad}: claimed rank {int(tab[bad])} "
                    f"but column {int(measured[bad]) - 1} is nonzero")
            tables[lv] = table
        return cls(levels, tables)

    # -- dict compatibility ---------------------------------------------

    def _check_resident(self):
        if self._device is not None:
            raise RuntimeError("FactorStore is spilled to host; reload() before using it "
                               "in a device computation")

    def __getitem__(self, level):
        self._check_resident()
        return self.levels[level]

    def __contains__(self, level):
        return level in self.levels

    def __iter__(self):
        return iter(self.levels)

    def __len__(self):
        return len(self.levels)

    def __bool__(self):
        return bool(self.levels)

    def keys(self):
        return self.levels.keys()

    def values(self):
        self._check_resident()
        return self.levels.values()

    def items(self):
        self._check_resident()
        return self.levels.items()

    @property
    def is_spilled(self) -> bool:
        return self._device is not None

    def rank_table(self, level):
        return self.rank_tables[level]

    def nbytes(self):
        """Exact byte accounting from tensor metadata (never syncs)."""
        def nb(t):
            return t.numel() * t.element_size()
        per_level = {lv: nb(u) + nb(v) for lv, (u, v) in self.levels.items()}
        rank_b = sum(nb(t) for t in self.rank_tables.values())
        low = sum(per_level.values())
        return {"low_rank": low, "ranks": rank_b, "per_level": per_level,
                "total": low + rank_b}

    # -- memory tier -----------------------------------------------------

    def _tensors(self):
        return [t for uv in self.levels.values() for t in uv] + list(self.rank_tables.values())

    def _rebuild(self, copied):
        it = iter(copied)
        self.levels = {lv: (next(it), next(it)) for lv in self.levels}
        self.rank_tables = {lv: next(it) for lv in self.rank_tables}

    def spill(self) -> int:
        """Copy every tensor to host memory and drop the device tensors.

        Returns the bytes released (0 if already spilled).  The copies are
        pinned when the store lies on a card, so ``reload`` copies at full
        rate; all of them are made before the store switches over.
        """
        if self.is_spilled:
            return 0
        tensors = self._tensors()
        device = tensors[0].device if tensors else torch.device("cpu")
        pin = device.type == "cuda"
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            h.copy_(t)
            host.append(h)
        freed = self.nbytes()["total"]
        self._rebuild(host)
        self._device = device
        return freed

    def reload(self) -> int:
        """Copy the host tensors back to the device they were spilled from.

        All-or-nothing: if a copy fails the store stays spilled with its host
        copies intact.  Returns the bytes restored (0 if not spilled).
        """
        if not self.is_spilled:
            return 0
        back = [t.to(self._device, non_blocking=True) for t in self._tensors()]
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        self._rebuild(back)
        self._device = None
        return self.nbytes()["total"]


@dataclass(frozen=True)
class RecompressReport:
    """What one recompression pass did to a store."""

    tol: float
    bytes_before: int
    bytes_after: int
    per_level_k: dict   # level -> (k_before, k_after)

    @property
    def ratio(self) -> float:
        return self.bytes_after / max(self.bytes_before, 1)


def recompress_store(store: FactorStore, tol: float, use_kernels: bool = True) -> RecompressReport:
    """SVD-truncate every level group of ``store`` in place.

    Block ``b`` keeps singular values ``sigma_i > tol * sigma_0(b)``, so its
    spectral error is at most ``tol * sigma_0(b)``.  Each level is re-packed
    to its largest surviving rank (one host read of that rank per level) and
    its rank table refreshed.  ``use_kernels`` routes through the dispatcher
    (kernel ``batched_recompress`` for CUDA tensors, the QR + SVD oracle on
    the CPU and below the Gram floor); ``False`` takes the oracle on any
    device.
    """
    if store.is_spilled:
        raise RuntimeError("cannot recompress a spilled store; reload() first")
    if use_kernels:
        from ..kernels.batched_recompress.ops import batched_recompress as fn
    else:
        from ..kernels.batched_recompress.ref import batched_recompress_ref as fn
    before = store.nbytes()["total"]
    per_level = {}
    for level in sorted(store.keys()):
        u, v = store[level]
        k_old = int(u.shape[2])
        u2, v2, ranks = fn(u, v, tol)
        k_new = min(max(int(ranks.max()), 1), k_old) if ranks.numel() else 1
        store.levels[level] = (u2[:, :, :k_new].contiguous(), v2[:, :, :k_new].contiguous())
        store.rank_tables[level] = ranks
        per_level[level] = (k_old, k_new)
    return RecompressReport(tol=float(tol), bytes_before=before,
                            bytes_after=store.nbytes()["total"], per_level_k=per_level)
