"""FactorStore: level-grouped low-rank factors with rank tables and bytes.

Port of the essentials of ``repro.core.factor_store``: level group
``level`` holds ``U: (B, m, k)`` and ``V: (B, n, k)`` with
``B = plan.aca_levels[level].shape[0]`` and ``m = n = n_pad >> level``;
``rank_tables[level]`` is a ``(B,)`` int32 table of effective ranks (columns
at or beyond it are exactly zero in both factors).  The store reads like a
``{level: (U, V)}`` dict.  Dense leaf storage, spill, reload and
recompression are not ported yet.
"""
from __future__ import annotations

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

    __slots__ = ("levels", "rank_tables")

    def __init__(self, levels, rank_tables):
        self.levels = dict(levels)
        self.rank_tables = dict(rank_tables)
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

    def __getitem__(self, level):
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
        return self.levels.values()

    def items(self):
        return self.levels.items()

    def nbytes(self):
        """Exact byte accounting from tensor metadata (never syncs)."""
        def nb(t):
            return t.numel() * t.element_size()
        per_level = {lv: nb(u) + nb(v) for lv, (u, v) in self.levels.items()}
        rank_b = sum(nb(t) for t in self.rank_tables.values())
        low = sum(per_level.values())
        return {"low_rank": low, "ranks": rank_b, "per_level": per_level,
                "total": low + rank_b}
