"""Port parity of the gradients on the training path: the near field's
backward (#11b's plain version and ``NearField``), ``h_attention``'s
gradient, ``aca_bilinear`` under autograd, and ``chunked_attention``'s
custom VJP.

Inputs come from numpy seeds.  Limits: the near field's plain derivative
within 1e-5 relative (Frobenius) of ``jax.vjp`` of ``repro``'s plain
version, also with tied row maxima; ``NearField`` through
``torch.autograd.gradcheck`` in float64; ``h_attention``'s dk and dv
within 1e-4 of ``jax.grad`` of ``repro``'s on smooth inputs, dq within 1e-3:
the far field's ACA divides by its pivots, and ``jax.grad``'s own dq moves
by up to 4.4e-4 (the port's by 4.6e-4) when q moves by 1e-7 relative (S =
512, c_leaf 64, rank 8); ``aca_bilinear``'s forward bit for bit the in-place version
it replaced; ``chunked_attention``'s gradients within 1e-5 of ``jax.grad``
of ``repro``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hattention as hat_jax
from repro.kernels.hattention_block.ref import hattention_nearfield_ref as nearfield_jax
from repro.models.layers import chunked_attention as chunked_jax
from repro_torch.core import hattention as hat
from repro_torch.kernels.hattention_block import kernel as nearfield_kernel
from repro_torch.kernels.hattention_block import ops as nearfield_ops
from repro_torch.kernels.hattention_block.ref import (hattention_nearfield_bwd_ref,
                                                      hattention_nearfield_ref)
from repro_torch.models.layers import chunked_attention

from torch_parity_util import rel_err
from test_torch_hattention import _smooth_qkv


def _nearfield_case(bh, nl, c, d, seed, ties):
    """Operands and cotangents; with ``ties``, rows 9 and c - 1 of every leaf
    see their max at key 3 and at its copies (key 5 of the same leaf, key 7
    of the previous one)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, nl, c, d) / np.sqrt(d)
    k = rng.randn(bh, nl, c, d)
    v = rng.randn(bh, nl, c, d)
    if ties:
        k[:, :, 5] = k[:, :, 3]
        k[:, :-1, 7] = k[:, 1:, 3]
        for r in (9, c - 1):
            q[:, :, r] = k[:, :, 3] / np.sqrt(d)
    cot = (rng.randn(bh, nl, c, d), rng.randn(bh, nl, c), rng.randn(bh, nl, c))
    return [a.astype(np.float32) for a in (q, k, v, *cot)]


@pytest.mark.parametrize("bh,nl,c,d,ties", [(2, 4, 32, 16, False), (3, 3, 20, 8, False),
                                            (2, 3, 24, 32, True), (1, 1, 16, 16, True)])
def test_nearfield_bwd_ref_matches_jax_vjp(bh, nl, c, d, ties):
    q, k, v, gnum, gden, gm = _nearfield_case(bh, nl, c, d, bh + nl + c + d, ties)
    out_j, vjp = jax.vjp(nearfield_jax, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(tuple(jnp.asarray(a) for a in (gnum, gden, gm)))
    t = [torch.from_numpy(a) for a in (q, k, v, gnum, gden, gm)]
    num, den, m = hattention_nearfield_ref(*t[:3])
    got = hattention_nearfield_bwd_ref(*t[:3], num, den, m, *t[3:])
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-5


def test_nearfield_autograd_function_passes_gradcheck_in_float64():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 4, 3)).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(nearfield_ops.NearField.apply, (q / 2, k, v), eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_nearfield_backward_dispatch_never_reaches_the_plain_version_off_the_cpu():
    meta = [torch.empty((2, 2, 8, 16), device="meta") for _ in range(5)]
    rows = [torch.empty((2, 2, 8), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        nearfield_ops.hattention_nearfield_bwd_op(*meta[:3], meta[3], rows[0], rows[1],
                                                  meta[4], rows[2], rows[3])
    cpu = [torch.zeros((2, 2, 8, 16)) for _ in range(5)] + [torch.zeros((2, 2, 8))] * 4
    with pytest.raises(ValueError, match="CUDA"):
        nearfield_kernel.hattention_nearfield_bwd_cuda(*cpu[:4], cpu[5], cpu[6], cpu[4],
                                                       cpu[7], cpu[8])


def _grads_both(q, k, v, w, c_leaf, rank):
    f = lambda q, k, v: jnp.sum(hat_jax.h_attention(q, k, v, c_leaf=c_leaf, rank=rank) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (hat.h_attention(*leaves, c_leaf=c_leaf, rank=rank) * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in leaves], [np.asarray(g) for g in want]


H_ATT_LIMITS = (1e-3, 1e-4, 1e-4)     # dq, dk, dv


@pytest.mark.parametrize("s,c_leaf,rank", [(256, 32, 4), (512, 64, 8)])
def test_h_attention_grad_matches_jax_grad(s, c_leaf, rank):
    rng = np.random.RandomState(s)
    q, k, v = _smooth_qkv(rng, 2, s, 4, 2, 16)
    w = rng.randn(2, s, 4, 16).astype(np.float32)
    got, want = _grads_both(q, k, v, w, c_leaf, rank)
    for a, b, limit in zip(got, want, H_ATT_LIMITS):
        assert rel_err(a, b) <= limit


def test_h_attention_grad_carries_the_cotangent_of_m(monkeypatch):
    """The far field's ACA factors exp(clip(s - m)), so the loss reaches m:
    the near field's backward gets a nonzero gm, and the gradients match
    jax.grad."""
    seen = []
    bwd = nearfield_ops.hattention_nearfield_bwd_op

    def record(*args):
        seen.append(float(args[-1].abs().max()))
        return bwd(*args)

    monkeypatch.setattr(nearfield_ops, "hattention_nearfield_bwd_op", record)
    rng = np.random.RandomState(7)
    q, k, v = _smooth_qkv(rng, 2, 256, 4, 2, 16)
    w = rng.randn(2, 256, 4, 16).astype(np.float32)
    got, want = _grads_both(q, k, v, w, 32, 4)
    assert len(seen) == 1 and seen[0] > 1e-3
    for a, b, limit in zip(got, want, H_ATT_LIMITS):
        assert rel_err(a, b) <= limit


def _aca_bilinear_in_place(q_rows, m_rows, k_cols, rank):
    """``aca_bilinear`` as it was before it was made differentiable: U and V
    written column by column in place."""
    lead = q_rows.shape[:-2]
    R, d = q_rows.shape[-2:]
    C = k_cols.shape[-2]
    q, m, kc = q_rows.reshape(-1, R, d), m_rows.reshape(-1, R), k_cols.reshape(-1, C, d)
    n = q.shape[0]
    nidx = torch.arange(n)
    U, V = torch.zeros((n, R, rank)), torch.zeros((n, C, rank))
    row_mask, col_mask = torch.ones((n, R)), torch.ones((n, C))
    j_r = torch.zeros(n, dtype=torch.int64)
    for r in range(rank):
        s = torch.einsum("nrd,nd->nr", q, kc[nidx, j_r])
        a_col = torch.exp(torch.clamp(s - m, -hat.CLAMP, hat.CLAMP))
        u_hat = a_col - torch.einsum("nrk,nk->nr", U, V[nidx, j_r])
        i_r = hat._masked_argmax(u_hat, row_mask)
        alpha = u_hat[nidx, i_r]
        safe = alpha.abs() > 1e-30
        inv = torch.where(safe, 1.0 / torch.where(safe, alpha, torch.ones_like(alpha)),
                          torch.zeros_like(alpha))
        u_r = u_hat * inv[:, None]
        s_row = torch.einsum("ncd,nd->nc", kc, q[nidx, i_r])
        a_row = torch.exp(torch.clamp(s_row - m[nidx, i_r][:, None], -hat.CLAMP, hat.CLAMP))
        v_r = a_row - torch.einsum("nck,nk->nc", V, U[nidx, i_r])
        v_r = torch.where(safe[:, None], v_r, torch.zeros_like(v_r))
        u_r = torch.where(safe[:, None], u_r, torch.zeros_like(u_r))
        row_mask[nidx, i_r] = 0.0
        col_mask[nidx, j_r] = 0.0
        j_r = hat._masked_argmax(v_r, col_mask)
        U[:, :, r] = u_r
        V[:, :, r] = v_r
    return U.reshape(*lead, R, rank), V.reshape(*lead, C, rank)


@pytest.mark.parametrize("shape,rank", [((3, 2, 64, 16), 8), ((2, 5, 40, 8), 16),
                                        ((1, 1, 128, 32), 4)])
def test_aca_bilinear_forward_keeps_its_bits(shape, rank):
    rng = np.random.RandomState(rank + shape[2])
    q = torch.from_numpy((rng.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32))
    k = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    m = torch.from_numpy(rng.randn(*shape[:-1]).astype(np.float32))
    u, v = hat.aca_bilinear(q, m, k, rank)
    u0, v0 = _aca_bilinear_in_place(q, m, k, rank)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    # under autograd (U and V built out of place): the same bits, and
    # differentiable through q, m and k
    leaves = [t.clone().requires_grad_() for t in (q, m, k)]
    u, v = hat.aca_bilinear(*leaves, rank)
    assert torch.equal(u.detach(), u0) and torch.equal(v.detach(), v0)
    (u.sum() + v.square().sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


def test_h_attention_forward_bits_do_not_depend_on_autograd():
    """The far field's sums go in place without a graph and out of place
    under autograd: the outputs are bit-identical."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(a) for a in _smooth_qkv(rng, 2, 256, 4, 2, 16))
    with torch.no_grad():
        plain = hat.h_attention(q, k, v, c_leaf=32, rank=4)
    recorded = hat.h_attention(q.clone().requires_grad_(), k, v, c_leaf=32, rank=4)
    assert recorded.requires_grad and torch.equal(recorded.detach(), plain)


@pytest.mark.parametrize("window,chunk,q_offset", [(0, 64, 0), (48, 64, 0), (0, 32, 64)])
def test_chunked_attention_grad_matches_jax_grad(window, chunk, q_offset):
    """The (window, chunk, q_offset) cases of test_torch_lm.py, through the
    custom VJP of both packages."""
    rng = np.random.RandomState(chunk + window + 1)
    sq = 256 - q_offset
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, 256, 2, 16).astype(np.float32)
    v = rng.randn(2, 256, 2, 16).astype(np.float32)
    w = rng.randn(2, sq, 4, 16).astype(np.float32)
    kw = dict(causal=True, window=window, chunk=chunk, q_offset=q_offset)
    f = lambda q, k, v: jnp.sum(chunked_jax(q, k, v, **kw) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (chunked_attention(*leaves, **kw) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        assert rel_err(t.grad.numpy(), np.asarray(g)) <= 1e-5
