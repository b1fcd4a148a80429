"""The numerics of #11b's tensor-core products, emulated on the CPU.

Kernel #11b (``src/repro_torch/csrc/hattention_nearfield_bwd.cu``) runs all
five products of the near field's backward (the scores q k^T, gnum v^T,
ds K, ds^T Q and p^T gnum) on the tensor cores as 3xTF32: each fp32 operand
x is split into hi = ``cvt.rna.tf32.f32(x)`` (round to nearest, ties away
from zero, to 10 mantissa bits) and lo = x - hi, of which the tensor core
reads the tf32 part (the low 13 bits dropped), and lo hi' + hi lo' + hi hi'
is summed in fp32.  p = exp(s - m) takes those scores.  The arg-max term
does not: it goes to the entries whose score in #11's order (one fp32 fma
chain over d ascending) equals #11's m, which is the max of those scores.

This file emulates the split in plain torch through an int32 view, puts it
into the algebra of the plain derivative (``ref.hattention_nearfield_bwd_ref``)
as the kernel takes it (``split_bwd``), and holds dq, dk and dv within 1e-5
(relative, per gradient) of the plain derivative run in float64, at the
card test's shapes (40 heads cut to 2): leaf 0, maxima tied inside a leaf
and across its two blocks, near-tie rows (a key two ulps below the row's
max) and scores up to about +-30.  The emulation sums each product in one
einsum; the tensor core's own accumulation within an 8-wide step is not
modelled.  One-pass TF32 (hi hi' alone) misses that limit on the same
inputs; run the file as a script to print both errors:

    PYTHONPATH=src python tests/test_torch_nearfield_bwd_split.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.hattention_block.ref import (NEG, hattention_nearfield_bwd_ref,
                                                      hattention_nearfield_ref)
from torch_parity_util import one_torch_thread  # noqa: F401

SPLIT_LIMIT = 1e-5
# the kernel recomputes in #11's order every score within CAND |q| |k| of
# its row's max (csrc/hattention_nearfield_bwd.cu: CAND)
CAND = 2.0 ** -10

# (bh, nl, c, d, inputs): the shapes of tests/test_torch_cuda.py's #11b cases
CASES = [(2, 4, 64, 32, "random"), (3, 3, 100, 32, "ties"), (2, 2, 96, 64, "ties"),
         (4, 3, 512, 128, "ties"), (2, 2, 512, 128, "random"), (2, 3, 100, 16, "ties"),
         (1, 1, 33, 16, "random"), (3, 3, 100, 32, "near_tie"), (4, 3, 512, 128, "near_tie"),
         (2, 2, 96, 16, "near_tie"), (3, 3, 100, 64, "large"), (4, 3, 512, 128, "large"),
         (2, 2, 33, 16, "large")]


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, nearest, ties away from zero
    (``cvt.rna.tf32.f32``): half an ulp of tf32 added to the magnitude
    bits, then the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The tf32 part of a float32 as the tensor core reads it: the low 13
    bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo exactly in float32; the kernel hands lo over as is and the
    tensor core reads ``trunc_tf32(lo)``."""
    hi = rna_tf32(x)
    return hi, trunc_tf32(x - hi)


def product(spec: str, a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``einsum(spec, a, b)`` as the kernel's tensor cores take it: ``3xtf32``
    (the small terms first) or ``tf32`` (one pass)."""
    if mode == "tf32":
        return torch.einsum(spec, rna_tf32(a), rna_tf32(b))
    ah, al = split(a)
    bh, bl = split(b)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)) + torch.einsum(spec, ah, bh)


def visible(nl: int, c: int) -> torch.Tensor:
    """(1, nl, c, 2c) bool: row r of leaf i sees every key of leaf i - 1
    (none for leaf 0) and keys 0..r of leaf i, in that order."""
    ii = torch.arange(c)
    vis = torch.cat([torch.ones(c, c, dtype=torch.bool), ii[:, None] >= ii[None, :]], 1)
    return vis[None, None] & torch.cat([(torch.arange(nl) > 0)[:, None, None].expand(nl, c, c),
                                        torch.ones(nl, c, c, dtype=torch.bool)], 2)[None]


def with_previous(x: torch.Tensor) -> torch.Tensor:
    """(bh, nl, c, d) -> (bh, nl, 2c, d): leaf i - 1's rows (zeros for leaf
    0), then leaf i's."""
    return torch.cat([torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1), x], dim=2)


def split_bwd(q, k, v, num, den, m, gnum, gden, gm, mode: str, tie=None):
    """``hattention_nearfield_bwd_ref``'s algebra as #11b takes it: all five
    products by ``product(..., mode)``, p from those scores, and the arg-max
    term on the entries whose score in #11's order equals m (``m`` being
    #11's: the max of those scores; ``tie``, those entries, from
    ``fma_max_and_ties`` if not given), split as JAX splits it."""
    bh, nl, c, d = q.shape
    keys, vals = with_previous(k), with_previous(v)
    vis = visible(nl, c)
    s = product("bncd,bnkd->bnck", q, keys, mode)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    dm = gm - ((gnum * num).sum(-1) + gden * den)
    tie = fma_max_and_ties(q, keys, vis)[1] if tie is None else tie
    n_prev, n_diag = tie[..., :c].sum(-1), tie[..., c:].sum(-1)
    half = lambda other: torch.where(other > 0, 0.5, 1.0)       # noqa: E731
    coef_prev = torch.where(n_prev > 0, dm * half(n_diag) / n_prev.clamp_min(1), 0.0)
    coef_diag = torch.where(n_diag > 0, dm * half(n_prev) / n_diag.clamp_min(1), 0.0)
    coef = torch.cat([coef_prev[..., None].expand(bh, nl, c, c),
                      coef_diag[..., None].expand(bh, nl, c, c)], -1)
    ds = p * (product("bncd,bnkd->bnck", gnum, vals, mode) + gden[..., None]) + tie * coef
    dq = product("bnck,bnkd->bncd", ds, keys, mode)
    dk2 = product("bnck,bncd->bnkd", ds, q, mode)       # against [leaf i-1 | leaf i]'s keys
    dv2 = product("bnck,bncd->bnkd", p, gnum, mode)
    # leaf i's keys: its own rows, then leaf i + 1's, which see them in full
    nxt = lambda x: torch.cat([x[:, 1:, :c], torch.zeros_like(x[:, :1, :c])], dim=1)  # noqa: E731
    return dq, dk2[:, :, c:] + nxt(dk2), dv2[:, :, c:] + nxt(dv2)


def case_inputs(bh, nl, c, d, kind):
    """q, k, v and cotangents (float32) as the card tests build them:
    ``ties`` copies key 3 into key 5 of every leaf and into key 7 of the
    leaf before, and aligns rows 9, 40 and c - 1 with it; ``near_tie``
    makes those rows 2 e_0 and key 3 17 e_0 (score 34) and key 5 key 3
    times (1 - 2^-22), two ulps below (every score of keys 3 and 5 is one
    rounded product, the same in any order and precision); ``large`` scales
    q by 7.5."""
    rng = np.random.RandomState(c + d + (7 if kind in ("near_tie", "large") else 0))
    q = (rng.randn(bh, nl, c, d) / np.sqrt(d)).astype(np.float32)
    k = rng.randn(bh, nl, c, d).astype(np.float32)
    v = rng.randn(bh, nl, c, d).astype(np.float32)
    if kind == "ties":
        k[:, :, 5] = k[:, :, 3]
        k[:, :-1, 7] = k[:, 1:, 3]
        for r in (9, 40, c - 1):
            q[:, :, r] = k[:, :, 3] / np.float32(np.sqrt(d))
    elif kind == "near_tie":
        for r in (9, 40, c - 1):
            q[:, :, r] = 0.0
            q[:, :, r, 0] = 2.0
        k[:, :, 3] = 0.0
        k[:, :, 3, 0] = 17.0
        k[:, :, 5] = k[:, :, 3] * np.float32(1.0 - 2.0 ** -22)
    elif kind == "large":
        q *= np.float32(7.5)
    g = [rng.randn(bh, nl, c, d), rng.randn(bh, nl, c), rng.randn(bh, nl, c)]
    return [torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in (q, k, v, *g)]


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))


def split_errors(bh, nl, c, d, kind) -> dict:
    """Relative errors of dq, dk, dv against the float64 plain derivative,
    for the 3xTF32 split and for one-pass TF32, from #11's m (the max of
    the scores in its order) and the plain forward's num and den."""
    q, k, v, gnum, gden, gm = case_inputs(bh, nl, c, d, kind)
    num, den, _ = hattention_nearfield_ref(q, k, v)
    m, tie, _, _ = fma_max_and_ties(q, with_previous(k), visible(nl, c))
    args = (q, k, v, num, den, m, gnum, gden, gm)
    want = hattention_nearfield_bwd_ref(*(t.double() for t in args))
    out = {}
    for mode in ("3xtf32", "tf32"):
        got = split_bwd(*args, mode=mode, tie=tie)
        out[mode] = {name: _rel(a, b) for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    return out


def fma_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last dim as #11 takes a score: one fp32 fma chain over
    d ascending, each step rounded once.  The product is exact in float64;
    TwoSum keeps what rounding the float64 sum dropped, which settles the
    one case where rounding that sum to fp32 would round twice (an exact
    midpoint)."""
    s = torch.zeros(a.shape[:-1], dtype=torch.float32)
    inf = torch.tensor(float("inf"))
    for d in range(a.shape[-1]):
        p = a[..., d].double() * b[..., d].double()
        c = s.double()
        tot = p + c
        bp = tot - c
        rest = (p - bp) + (c - (tot - bp))
        r = tot.float()
        diff = tot - r.double()
        other = torch.nextafter(r, torch.where(diff > 0, inf, -inf))
        mid = (diff != 0) & (2.0 * diff.abs() == (other.double() - r.double()).abs())
        s = torch.where(mid & (rest != 0) & ((rest > 0) == (diff > 0)), other, r)
    return s


def fma_max_and_ties(q, keys, vis):
    """#11's m (the row max of the visible scores in #11's order) and the
    entries that attain it, (bh, nl, c) and (bh, nl, c, 2c).  Only the
    entries whose plain fp32 score lies within CAND |q| |k| of its row's
    plain max can attain it (the two orders part by ~1e-6 |q| |k|): their
    index tuple ``at`` and their scores in #11's order are returned too."""
    bh, nl, c, _ = q.shape
    s = torch.where(vis, torch.einsum("bncd,bnkd->bnck", q, keys), torch.tensor(NEG))
    scale = torch.linalg.vector_norm(q, dim=-1)[..., :, None] * \
        torch.linalg.vector_norm(keys, dim=-1)[..., None, :]
    at = (vis & (s >= s.amax(-1, keepdim=True) - CAND * scale)).nonzero(as_tuple=True)
    s_at = fma_dots(q[at[:3]], keys[at[0], at[1], at[3]])
    row = (at[0] * nl + at[1]) * c + at[2]
    m = torch.full((bh * nl * c,), NEG).scatter_reduce(0, row, s_at, "amax").view(bh, nl, c)
    tie = torch.zeros(s.shape, dtype=torch.bool)
    tie[at] = s_at == m[at[:3]]
    return m, tie, at, s_at


def candidate_check(bh, nl, c, d, kind) -> dict:
    """The kernel's arg-max test on the scores of both blocks: every visible
    entry that attains its row's max in #11's order must have a 3xTF32
    score within CAND |q| |k| below the max (a candidate, recomputed exactly);
    returns whether all do, how many ties and candidates there are, and the
    largest distance between the two scores in units of |q| |k| among the
    entries that could attain the max (``fma_max_and_ties``'s)."""
    q, k, _, _, _, _ = case_inputs(bh, nl, c, d, kind)
    keys = with_previous(k)                                   # (bh, nl, 2c, d): [leaf i-1 | leaf i]
    vis = visible(nl, c)
    m, ties, at, s_at = fma_max_and_ties(q, keys, vis)
    s_tc = product("bncd,bnkd->bnck", q, keys, "3xtf32")
    scale = torch.linalg.vector_norm(q, dim=-1)[..., :, None] * \
        torch.linalg.vector_norm(keys, dim=-1)[..., None, :]
    cand = vis & (s_tc >= m[..., None] - CAND * scale)
    gap = (s_tc[at] - s_at).abs() / scale[at].clamp_min(1e-30)
    return {"ties_are_candidates": bool((cand | ~ties).all()), "ties": int(ties.sum()),
            "candidates": int(cand.sum()), "max_gap": float(gap.max())}


def test_tf32_emulation_rounds_as_the_card():
    """cvt.rna.tf32.f32: nearest, ties away from zero, 10 mantissa bits; the
    split is exact and lo is what the tensor core reads of it."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11,
                      3.0, -0.1], dtype=torch.float32)
    hi = rna_tf32(x)
    assert hi[:4].tolist() == [one, -one, 1.0, one + 2.0 ** -10]
    assert hi[4] == 3.0 and abs(float(hi[5]) + 0.1) <= 2.0 ** -11 * 0.1
    hi, lo = split(x)
    assert torch.equal(trunc_tf32(hi), hi)
    assert float((hi.double() + lo.double() - x.double()).abs().max()) <= 2.0 ** -21 * 0.2


def test_fma_emulation_rounds_each_step_once():
    """The emulated fma chain rounds each step once where rounding the
    float64 sum to fp32 would round twice: after s = 1 + 2^-23, the step
    adds (1 + 2^-18) 2^-24 (1 - 2^-18) = 2^-24 - 2^-60, which leaves the sum
    just below the midpoint 1 + 3 2^-24 (float64 lands on it, and fp32's
    ties to even would then give 1 + 2^-22)."""
    a = torch.tensor([[1.0, 1.0 + 2.0 ** -18]], dtype=torch.float32)
    b = torch.tensor([[1.0 + 2.0 ** -23, 2.0 ** -24 * (1.0 - 2.0 ** -18)]], dtype=torch.float32)
    assert float(fma_dots(a, b)) == 1.0 + 2.0 ** -23
    assert float(fma_dots(-a, b)) == -(1.0 + 2.0 ** -23)
    twice = (a[0, 0].double() * b[0, 0].double() + a[0, 1].double() * b[0, 1].double()).float()
    assert float(twice) == 1.0 + 2.0 ** -22


@pytest.mark.parametrize("bh,nl,c,d,kind", CASES)
def test_split_products_keep_fp32_accuracy(bh, nl, c, d, kind):
    """3xTF32 in the four products keeps dq, dk, dv within 1e-5 of the
    float64 plain derivative; one-pass TF32 does not."""
    err = split_errors(bh, nl, c, d, kind)
    assert all(e <= SPLIT_LIMIT for e in err["3xtf32"].values()), err
    assert max(err["tf32"].values()) > SPLIT_LIMIT, err


@pytest.mark.parametrize("bh,nl,c,d,kind", CASES)
def test_arg_max_candidates_hold_every_tie(bh, nl, c, d, kind):
    """Every entry that attains its row's max in #11's fma order is a
    candidate of the kernel's exact test (its 3xTF32 score within CAND |q|
    |k| of the max), and the two scores lie far inside that bound."""
    out = candidate_check(bh, nl, c, d, kind)
    assert out["ties_are_candidates"], out
    assert out["max_gap"] <= CAND / 64, out
    assert out["candidates"] < 2 * out["ties"] + bh * nl * c, out


if __name__ == "__main__":
    print("bh nl c d inputs | 3xTF32 dq dk dv | one-pass TF32 dq dk dv (relative, "
          "against the float64 plain derivative)")
    for case in CASES:
        err = split_errors(*case)
        print(" ".join(map(str, case)), "|",
              " ".join(f"{err['3xtf32'][n]:.2e}" for n in ("dq", "dk", "dv")), "|",
              " ".join(f"{err['tf32'][n]:.2e}" for n in ("dq", "dk", "dv")), flush=True)
    print("bh nl c d inputs | ties, candidates, largest |s_3xtf32 - s_fma| / (|q| |k|)")
    for case in CASES:
        out = candidate_check(*case)
        print(" ".join(map(str, case)), "|", out["ties"], out["candidates"],
              f"{out['max_gap']:.2e}", "(every tie a candidate)" if out["ties_are_candidates"]
              else "(A TIE MISSED)", flush=True)
