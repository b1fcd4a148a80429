"""The comparison that decides ``correct``.

Every request due in the window is judged: its served vector, at the rows
sampled from the seed (original point order), against the reference's
exact rows for the same request vector.  The number compared is the worst
request's relative error over those rows; a request that never came back
or failed counts in ``unanswered``, whose limit is 0.
"""
from __future__ import annotations

import numpy as np


def rel_errors(samples: np.ndarray, pool_index: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per request: ``|served - exact| / |exact|`` over the sampled rows.
    samples (n, S) served rows; pool_index (n,); ref (S, P) exact rows."""
    want = ref[:, pool_index].T.astype(np.float64)
    got = samples.astype(np.float64)
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def judge(samples: np.ndarray, pool_index: np.ndarray, ref: np.ndarray,
          unanswered: int, limit: float) -> tuple[bool, dict]:
    """``(correct, checks)``; ``checks`` maps each number to its value and limit."""
    errs = rel_errors(samples, pool_index, ref) if len(samples) else np.zeros(0)
    worst = float(errs.max()) if errs.size else float("inf")
    checks = {"rel_err": {"value": worst, "limit": float(limit)},
              "unanswered": {"value": int(unanswered), "limit": 0}}
    correct = bool(np.isfinite(worst) and worst <= limit and unanswered == 0)
    return correct, checks
