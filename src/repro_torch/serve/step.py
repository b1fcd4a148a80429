"""Serving steps: LM prefill / decode and batched H-matrix query serving.

Port of ``repro.serve.step``.

  * ``prefill_step(params, tokens)``  tokens (B, S) -> logits (B, 1, V) of
    the last position, caches (one (k, v) per layer, each (B, S, Hkv, D));
  * ``decode_step(params, tokens, caches, cache_len)``  tokens (B, 1) +
    caches of capacity > cache_len -> logits (B, 1, V), the same caches with
    slot ``cache_len`` written in place.

Both run under ``torch.inference_mode``.

``HMatrixServer`` packs incoming query vectors into ``(N, R)`` panels and
serves each panel with ONE ``make_apply`` launch (the multi-RHS product);
``HMatrixSolveServer`` does the same for regression-fit traffic, one
``make_solver`` PCG per panel.  Each server owns one
:class:`repro_torch.serve.runtime.PanelRuntime` on the H-matrix's device
and offers both modes over the same launch:

  * ``serve(batch)``: the synchronous path, pack -> launch -> fetch per
    panel (``_serve_in_panels``);
  * ``submit(vec) -> PanelFuture`` / ``flush()`` / ``serve_async(batch)``:
    the runtime's scheduler packs and launches panels without fetching;
    results come to the host when a future is awaited.

Both modes pack the same width-bucketed panels as request rows, upload and
transpose them on the device and fetch the same way, so their results are
bit-identical.  With a ``mesh`` (``repro_torch.parallel.make_panel_mesh``)
each panel is sharded over it (``repro_torch.parallel.hshard``): the apply
server's by blocks (row shards take any width), the solve server's by
columns, its panel width rounded up to a multiple of the mesh's shard
count so that every shard is full.
"""
from __future__ import annotations

from collections import deque

import torch

from .._device import resolve_device
from ..core.hmatrix import HMatrix, make_apply
from ..models import lm
from ..parallel.hshard import mesh_panel
from ..solve import make_solver
from .runtime import (PanelRuntime, as_vector, fetch_rows, pack_rows, staging_buffer,
                      upload_rows, width_for)


def _require_decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder serving is not yet ported")


def make_prefill_step(cfg):
    _require_decoder_only(cfg)

    @torch.inference_mode()
    def prefill_step(params, tokens):
        return lm.forward(params, cfg, tokens, mode="prefill")

    return prefill_step


def make_decode_step(cfg):
    _require_decoder_only(cfg)

    @torch.inference_mode()
    def decode_step(params, tokens, caches, cache_len: int):
        return lm.forward(params, cfg, tokens, mode="decode", caches=caches,
                          cache_len=cache_len)

    return decode_step


def greedy_sample(logits, vocab_size: int):
    """Greedy over the REAL vocab (padded entries masked) -> int64 ids."""
    lf = logits.float()
    mask = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
    lf = torch.where(mask, lf, torch.full_like(lf, -torch.inf))
    return torch.argmax(lf, dim=-1)


class _PanelServerBase:
    """Shared serving front end: one launch callable, two serving modes.

    Subclasses set ``n``, ``max_batch`` and ``_launch`` (``(N, w) -> (N, w)``
    on the device) before calling ``_init_runtime``.
    """

    def _init_runtime(self, device, deadline_s, max_queue, chaos=None, resilience=None,
                      shed_above=None, n_dev=1):
        self.device = device
        self.n_dev = n_dev
        self.runtime = PanelRuntime(self.n, self.max_batch, self._launch, n_dev=n_dev,
                                    deadline_s=deadline_s, max_queue=max_queue, chaos=chaos,
                                    resilience=resilience, shed_above=shed_above,
                                    device=device)

    def tenant_spec(self, weight: float = 1.0, deadline_s: float | None = None,
                    max_queue: int | None = None, **spec_kw):
        """This server's launch as a multi-tenant registration.

        Returns a ``repro_torch.serve.tenancy.TenantSpec`` with the SAME launch
        callable, width bucketing and device as the server's own runtime, so a
        tenant registered from it packs bit-identical panels::

            mtr.add_tenant("apply-eu", srv.tenant_spec(weight=2.0))

        ``deadline_s`` / ``max_queue`` default to the server's own.  Extra
        keywords (``resilience``, ``shed_above``, ``store``, ...) pass through.
        """
        from .tenancy import TenantSpec
        if deadline_s is None:
            deadline_s = self.runtime.deadline_s
        if max_queue is None:
            max_queue = self.runtime.max_queue
        return TenantSpec(n=self.n, max_batch=self.max_batch, launch=self._launch,
                          n_dev=self.n_dev, weight=weight, deadline_s=deadline_s,
                          max_queue=max_queue, device=self.device, **spec_kw)

    @property
    def widths(self) -> tuple:
        """Panel width buckets (partial panels pad to these)."""
        return self.runtime.widths

    def serve(self, batch) -> list:
        """Synchronous path: pack -> launch -> fetch, panel by panel."""
        return _serve_in_panels(batch, self.n, self.max_batch, self._launch,
                                widths=self.runtime.widths, device=self.device)

    def submit(self, vec):
        """Enqueue one request; returns a ``PanelFuture`` at once."""
        return self.runtime.submit(vec)

    def flush(self):
        """Launch any partial panel now (e.g. at the end of a burst)."""
        self.runtime.flush()

    def serve_async(self, batch) -> list:
        """Submit a whole batch, flush, and return its futures in order."""
        futures = [self.submit(q) for q in batch]
        self.flush()
        return futures

    def precompile(self):
        """Launch every panel width bucket once on a zero panel (builds the
        kernels before real requests)."""
        self.runtime.precompile()

    def close(self):
        """Drain the queue and stop the runtime's scheduler thread."""
        self.runtime.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HMatrixServer(_PanelServerBase):
    """Micro-batching front end over the batched H-matrix apply.

    Queries are collected into panels of width ``max_batch`` (a partial
    panel pads to its width bucket), each served by one apply on
    ``hm.device``.

    Parameters
    ----------
    hm : HMatrix
        The H-matrix to serve.
    max_batch : int, optional
        Panel width.
    use_kernels : bool, optional
        Route the apply through the kernel wrappers (the CUDA kernels for
        CUDA tensors, their plain versions on the CPU).
    mesh : PanelMesh, optional
        Shard each panel's blocks over this mesh (``make_apply(mesh=)``, row
        shards: each shard evaluates a share of the blocks, and the partial
        results are summed in shard order).
    deadline_s, max_queue
        Async mode: flush a partial panel once its oldest request has waited
        this long; backpressure cap on queued requests.
    chaos, resilience, shed_above
        Resilience knobs of the runtime (``serve.faults``).
    """

    def __init__(self, hm: HMatrix, max_batch: int = 64, use_kernels: bool = True, mesh=None,
                 deadline_s: float | None = None, max_queue: int | None = None, chaos=None,
                 resilience=None, shed_above: int | None = None):
        self.n = hm.shape[0]
        self.max_batch = int(max_batch)
        self._launch = make_apply(hm, use_kernels=use_kernels, mesh=mesh)
        self._init_runtime(hm.device, deadline_s, max_queue, chaos=chaos,
                           resilience=resilience, shed_above=shed_above)

    def serve(self, queries) -> list:
        """``H @ q`` for a batch of queries (original point order), in panels.

        Returns a list of ``(N,)`` float32 host arrays in input order.  A load
        larger than ``max_batch`` is split into ``ceil(len / max_batch)``
        panels, each one launch; the ragged tail pads only to its width
        bucket.
        """
        return super().serve(queries)


def _serve_in_panels(vectors, n: int, max_batch: int, launch, widths=None,
                     device=None) -> list:
    """The synchronous micro-batching loop: pack -> launch -> fetch.

    A batch larger than ``max_batch`` is split into panels, so every query
    gets its result whatever the load.  One ``(max_batch, n)`` staging buffer
    (pinned for a CUDA ``device``) is packed row by row and reused across
    panels, its pad rows zeroed each time; with ``widths`` the ragged tail
    pads only to its width bucket.  The fetch of a panel completes its
    stream's work, the upload included, before the buffer is packed again.
    An empty request list returns ``[]`` without a launch.
    """
    if max_batch < 1:
        raise ValueError(f"panel width must be >= 1, got {max_batch}")
    qs = [as_vector(q) for q in vectors]
    for q in qs:
        if q.shape != (n,):
            raise ValueError(f"query shape {q.shape} != ({n},)")
    if not qs:
        return []                                   # no launch for no work
    dev = resolve_device(device)
    buf = staging_buffer(max_batch, n, dev)         # ONE reused staging buffer
    buf_np = buf.numpy()
    out: list = []
    for start in range(0, len(qs), max_batch):
        chunk = qs[start:start + max_batch]
        w = width_for(len(chunk), widths) if widths else max_batch
        pack_rows(buf_np, chunk, w)
        rows = fetch_rows(launch(upload_rows(buf[:w], dev)))    # one fetch
        out.extend(rows[j] for j in range(len(chunk)))
    return out


class HMatrixSolveServer(_PanelServerBase):
    """Micro-batching front end over the H-matrix PCG solver.

    The regression-fit twin of :class:`HMatrixServer`: target vectors ``f``
    (right-hand sides of ``(A + sigma^2 I) c = f``) are packed into panels,
    each solved by ONE ``make_solver`` call.  Each launched panel appends its
    LAZY :class:`repro_torch.solve.SolveInfo` to ``last_info`` (a deque of
    the ``LAST_INFO_MAX`` most recent panels); ``serve`` clears it first.

    The PCG reads ``active.any()`` on the host every iteration, so a solve
    launch holds the scheduler thread for the whole solve: async solve panels
    do not overlap yet.

    Parameters
    ----------
    hm : HMatrix
        The H-matrix defining ``A``.
    sigma2 : float
        Regularization shift.
    max_batch : int, optional
        Panel width; with a ``mesh`` rounded up to a multiple of its shard
        count (``self.max_batch`` is the width used).
    tol, max_iter, precondition, use_kernels
        Passed to :func:`repro_torch.solve.make_solver`.
    mesh : PanelMesh, optional
        Shard each panel's columns over this mesh; the shards' PCGs step in
        lockstep (``make_solver(mesh=)``).
    deadline_s, max_queue, chaos, resilience, shed_above
        As :class:`HMatrixServer`.  A panel that the NaN/Inf guard relaunches
        appends a second record to ``last_info``.
    """

    LAST_INFO_MAX = 256          # panels of convergence history kept

    def __init__(self, hm: HMatrix, sigma2: float, max_batch: int = 8, tol: float = 1e-5,
                 max_iter: int = 300, precondition: bool = True, use_kernels: bool = True,
                 mesh=None, deadline_s: float | None = None, max_queue: int | None = None,
                 chaos=None, resilience=None, shed_above: int | None = None):
        self.n = hm.shape[0]
        self.max_batch, n_dev = mesh_panel(max_batch, mesh)
        self.last_info = deque(maxlen=self.LAST_INFO_MAX)
        self._solve = make_solver(hm, sigma2, tol=tol, max_iter=max_iter,
                                  precondition=precondition, use_kernels=use_kernels, mesh=mesh)

        def launch(panel):
            c, info = self._solve(panel)
            self.last_info.append(info)
            return c

        self._launch = launch
        self._init_runtime(hm.device, deadline_s, max_queue, chaos=chaos,
                           resilience=resilience, shed_above=shed_above, n_dev=n_dev)

    def serve(self, targets) -> list:
        """Solve for a batch of targets (original point order), in panels.

        Returns a list of ``(N,)`` coefficient vectors in input order.
        Zero-padded columns start inactive, so a short panel costs no extra
        iterations.
        """
        # clear in place: the scheduler thread's launch appends to this deque
        self.last_info.clear()
        return super().serve(targets)

    def precompile(self):
        """Warm every width bucket; the warm-up panels' records are dropped."""
        super().precompile()
        self.last_info.clear()
