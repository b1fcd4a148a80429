"""Launch wrappers of the CUDA kernels ``csrc/aca.cu`` and ``csrc/lowrank_matmat.cu``.

Replace ``repro/kernels/batched_aca/kernel.py``: ``batched_aca_t`` (the
fixed-rank ACA of one level group, pivot search on the card; its route per
level group is picked by :func:`aca_route`) and ``batched_lowrank_matmat_t``
(``Y[b] = U[b] (V[b]^T X[b])``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ...core.geometry import matern_norm
from .. import require_cuda_f32, stream_handle
from ..phi import kernel_id

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LOWRANK_ARGTYPES = [_P] * 3 + [_LL, _I, _P, _LL, _I, _P] + [_I] * 5 + [_P]
_LOWRANK_LEVEL_ARGTYPES = [_P] * 3 + [_I, _P, _P, _I] + [_P] * 4 + [_I, _P] + [_I] * 4 + [_P]
_ACA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_K = 64
MAX_KR = 1024        # k * R per launch; wider panels go in column chunks
MAX_BATCH = 65535
MAX_POINT_DIM = 3

# The ACA's two routes (csrc/aca.cu): "resident" keeps a block's factors in
# the shared memory of one thread-block cluster of 1..8 CTAs for all k
# steps; "streamed" splits a block over CTAs, two launches per step.
ACA_ROUTES = ("resident", "streamed")
RESIDENT_CLUSTERS = (1, 2, 4, 8)        # 8: the portable cluster size
RESIDENT_STATIC_SMEM = 2048             # bytes kept beside the dynamic part (under 1 KB used)
RESIDENT_TARGET_SMEM = 76 * 1024        # a cluster this small leaves room for 3 CTAs per SM
RESIDENT_MAX_LOCAL = 64 * 256           # rows (columns) a resident CTA holds: 64 per thread


def resident_smem_bytes(m: int, n: int, k: int, d: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA of the resident route: U and V
    entries (k rounded up to a multiple of 4) and the points of its
    ceil(m / cluster) rows and ceil(n / cluster) columns
    (``repro_aca_resident_smem`` in ``csrc/aca.cu``)."""
    return 4 * (4 * -(-k // 4) + d) * (-(-m // cluster) + -(-n // cluster))


def resident_fits(m: int, n: int, k: int, d: int, cluster: int, smem_per_block: int) -> bool:
    """True if the resident route can hold an (m, n) block on ``cluster`` CTAs."""
    return (cluster in RESIDENT_CLUSTERS
            and max(-(-m // cluster), -(-n // cluster)) <= RESIDENT_MAX_LOCAL
            and resident_smem_bytes(m, n, k, d, cluster) + RESIDENT_STATIC_SMEM
            <= smem_per_block)


def aca_route(m: int, n: int, k: int, d: int, smem_per_block: int) -> tuple[str, int]:
    """The route of one level group: ``("resident", cluster)`` or
    ``("streamed", 0)``.

    A pure function of the block shape and the card's shared memory per
    block (``smem_per_block``, opt-in): the resident route on the smallest
    cluster whose CTAs hold at most ``RESIDENT_TARGET_SMEM`` (so that several
    CTAs share an SM), else on the smallest whose CTAs fit at all, else the
    streamed route.
    """
    fits = [cs for cs in RESIDENT_CLUSTERS if resident_fits(m, n, k, d, cs, smem_per_block)]
    small = [cs for cs in fits if resident_smem_bytes(m, n, k, d, cs) <= RESIDENT_TARGET_SMEM]
    if small or fits:
        return "resident", (small or fits)[0]
    return "streamed", 0


@functools.lru_cache(maxsize=None)
def smem_per_block(device: torch.device) -> int:
    """Shared memory a CTA may opt in to on a CUDA device (read once per device)."""
    fn = _build.c_function("aca", "repro_aca_smem_optin", [ctypes.c_int])
    optin = fn(device.index if device.index is not None else torch.cuda.current_device())
    if optin <= 0:
        raise RuntimeError(f"batched_aca: cannot read the shared memory per block of {device}")
    return optin


def _pick_route(m: int, n: int, k: int, d: int, device: torch.device,
                route: str | None, cluster: int | None) -> tuple[str, int]:
    """(route, cluster) of one launch: the picker's unless forced."""
    what = "batched_aca"
    if route not in (None, *ACA_ROUTES):
        raise ValueError(f"{what}: route must be one of {ACA_ROUTES} or None, got {route!r}")
    if route == "streamed":
        return "streamed", 0
    limit = smem_per_block(device)
    if cluster is None:
        picked = aca_route(m, n, k, d, limit)
        if route is None or picked[0] == "resident":
            return picked
        raise ValueError(f"{what}: a block of {m} x {n} at k={k} does not fit the resident "
                         f"route's shared memory ({limit} bytes per CTA, clusters up to 8)")
    if not resident_fits(m, n, k, d, cluster, limit):
        raise ValueError(f"{what}: the resident route takes clusters {RESIDENT_CLUSTERS} whose "
                         f"CTAs fit {limit} bytes; got cluster={cluster} for {m} x {n}, k={k}")
    return "resident", cluster


def _aca_launch(rpts: torch.Tensor, rids: torch.Tensor, cpts: torch.Tensor,
                cids: torch.Tensor, m: int, n: int, kernel_name: str, k: int,
                route: str | None = None, cluster: int | None = None):
    """Factor the B = len(rids) blocks ``phi(rpts cluster rids[b], cpts cluster
    cids[b])`` (clusters of m and n points) -> (U, V, pivot keys (2, k, B)).
    A block with an id outside its point array gets NaN factors.

    Key ``[0, r, b]`` holds step r's row pivot of block b and key ``[1, r,
    b]`` step r + 1's column pivot, as ``2^32 - 1 - index`` in the low 32
    bits (step 0's column is 0).  ``route`` ("resident", "streamed") and
    ``cluster`` (the resident route's CTAs per block) default to
    :func:`aca_route`'s choice; both routes give the same bits."""
    what = "batched_aca"
    dev = rpts.device
    b, d = rids.shape[0], rpts.shape[1]
    if not 1 <= d <= MAX_POINT_DIM:
        raise ValueError(f"{what}: the kernel takes point dimension 1..{MAX_POINT_DIM}, got {d}")
    if not 1 <= k <= MAX_K or b > MAX_BATCH:
        raise ValueError(f"{what}: the kernel takes 1 <= k <= {MAX_K} and at most "
                         f"{MAX_BATCH} blocks, got k={k}, B={b}")
    if not 1 <= m <= rpts.shape[0] or not 1 <= n <= cpts.shape[0] or max(m, n) >= 2 ** 31:
        raise ValueError(f"{what}: block of {m} x {n} is empty or larger than its points")
    route, cluster = _pick_route(m, n, k, d, dev, route, cluster)
    u = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    v = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    keys = torch.zeros((2, k, b), dtype=torch.int64, device=dev)
    if b == 0:
        return u, v, keys
    scratch = (torch.empty((b * k * (m + n + 1),), dtype=torch.float32, device=dev)
               if route == "streamed" else None)
    fn = _build.c_function("aca", "repro_batched_aca", _ACA_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rpts.data_ptr(), rids.data_ptr(), cpts.data_ptr(), cids.data_ptr(),
                 u.data_ptr(), v.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                 keys.data_ptr(), b, m, n, rpts.shape[0] // m, cpts.shape[0] // n, d, k,
                 kernel_id(kernel_name), matern_norm(d), cluster, stream_handle(dev))
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return u, v, keys


def batched_aca_level_cuda(points: torch.Tensor, row_ids: torch.Tensor, col_ids: torch.Tensor,
                           level: int, kernel_name: str, k: int, route: str | None = None,
                           cluster: int | None = None):
    """Factor one level group without gathering its points.

    points: (n_pad, d) float32 tree-ordered points; row_ids, col_ids: (B,)
    int64 cluster ids at ``level`` (cluster i is rows [i m, (i + 1) m) with
    m = n_pad >> level), all on one CUDA device -> U, V: (B, m, k).  The
    ids are not read back to the host (an apply needs no sync): a block
    with an id outside [0, 2^level) gets NaN factors, and an H-matrix's
    block groups are checked once, when ``hmatrix.block_groups`` builds them.
    ``route`` and ``cluster`` force a route (see :func:`_aca_launch`).
    """
    what = "batched_aca"
    require_cuda_f32(what, points)
    if points.ndim != 2 or row_ids.shape != col_ids.shape or row_ids.ndim != 1:
        raise ValueError(f"{what}: shapes points {tuple(points.shape)}, row_ids "
                         f"{tuple(row_ids.shape)}, col_ids {tuple(col_ids.shape)} do not "
                         "match (n_pad, d), (B,), (B,)")
    for ids in (row_ids, col_ids):
        if ids.device != points.device or ids.dtype != torch.int64 or not ids.is_contiguous():
            raise ValueError(f"{what}: cluster ids must be contiguous int64 on {points.device}")
    n_pad = points.shape[0]
    m = n_pad >> level
    if m < 1 or m << level != n_pad:
        raise ValueError(f"{what}: {n_pad} points do not split into 2^{level} clusters")
    u, v, _ = _aca_launch(points, row_ids, points, col_ids, m, m, kernel_name, k, route, cluster)
    return u, v


def lowrank_column_chunks(k: int, r: int) -> list[tuple[int, int]]:
    """(first column, width) of each launch of a k x R low-rank product:
    at most ``MAX_KR`` values of T (k x width) per launch."""
    width = max(1, MAX_KR // k)
    return [(c0, min(width, r - c0)) for c0 in range(0, r, width)]


def _lowrank_scratch(b: int, n: int, k: int, r: int, device) -> torch.Tensor:
    """T, the split partials and the split counters of one launch."""
    floats = _build.c_function("lowrank_matmat", "repro_lowrank_scratch_floats",
                               [ctypes.c_int] * 4, ctypes.c_longlong)(b, n, k, r)
    return torch.empty((floats,), dtype=torch.float32, device=device)


def _check_lowrank_k(what: str, k: int, b: int) -> None:
    if not 1 <= k <= MAX_K or b > MAX_BATCH:
        raise ValueError(f"{what}: the kernel takes 1 <= k <= {MAX_K} and at most "
                         f"{MAX_BATCH} blocks, got k={k}, B={b}")


def batched_lowrank_matmat_cuda(u: torch.Tensor, v: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """u: (B, m, k), v: (B, n, k), x: (B, n, R) float32 CUDA tensors -> (B, m, R).

    Panels with k * R > ``MAX_KR`` go in column chunks, each read and
    written in place through its row stride (no copies)."""
    what = "batched_lowrank_matmat"
    require_cuda_f32(what, u, v, x)
    if u.ndim != 3 or v.ndim != 3 or x.ndim != 3 or v.shape[0] != u.shape[0] \
            or v.shape[2] != u.shape[2] or x.shape[:2] != v.shape[:2]:
        raise ValueError(f"{what}: shapes u {tuple(u.shape)}, v {tuple(v.shape)}, "
                         f"x {tuple(x.shape)} do not match (B, m, k), (B, n, k), (B, n, R)")
    b, m, k = u.shape
    n, r = v.shape[1], x.shape[2]
    _check_lowrank_k(what, k, b)
    y = torch.empty((b, m, r), dtype=torch.float32, device=u.device)
    if b == 0 or m == 0 or r == 0:
        return y
    fn = _build.c_function("lowrank_matmat", "repro_lowrank_matmat", _LOWRANK_ARGTYPES)
    with torch.cuda.device(u.device):
        for c0, w in lowrank_column_chunks(k, r):
            scratch = _lowrank_scratch(b, n, k, w, u.device)
            err = fn(u.data_ptr(), v.data_ptr(), x.data_ptr() + 4 * c0, n * r, r,
                     y.data_ptr() + 4 * c0, m * r, r, scratch.data_ptr(), b, m, n, k, w,
                     stream_handle(u.device))
            _build.check(err, what)
            _build.LAUNCHES[what] += 1
    return y


def batched_lowrank_matmat_level_cuda(u: torch.Tensor, v: torch.Tensor, x_pad: torch.Tensor,
                                      cols: torch.Tensor, group,
                                      z_pad: torch.Tensor) -> torch.Tensor:
    """Apply one admissible level group in place: for every distinct row
    cluster of ``group`` (a ``core.hmatrix.BlockGroup``), ``z_pad[cluster] +=``
    the sum of its blocks' ``U[b] (V[b]^T x_pad[cluster cols[b]])``, the blocks
    taken in the order of ``group.table``.

    u, v: (B, m, k) factors; x_pad, z_pad: (n_pad, R) tree-ordered panels,
    float32 CUDA, contiguous; cols: (B,) int64 column clusters (cluster i is
    rows [i m, (i + 1) m)).  Each block's X slice is read in place and each
    output row is written once; the result equals the gathered entry
    followed by ``_scatter_rows`` bit for bit.  Returns ``z_pad``.  The ids
    are not read back (checked when ``hmatrix.block_groups`` built them).
    """
    what = "batched_lowrank_matmat"
    require_cuda_f32(what, u, v, x_pad, z_pad)
    if u.ndim != 3 or v.shape != u.shape or x_pad.ndim != 2 or z_pad.shape != x_pad.shape:
        raise ValueError(f"{what}: shapes u {tuple(u.shape)}, v {tuple(v.shape)}, x_pad "
                         f"{tuple(x_pad.shape)}, z_pad {tuple(z_pad.shape)} do not match "
                         "(B, m, k), (B, m, k), (n_pad, R), (n_pad, R)")
    b, m, k = u.shape
    n_pad, r = x_pad.shape
    if m < 1 or n_pad % m:
        raise ValueError(f"{what}: {n_pad} rows do not split into clusters of {m}")
    _check_lowrank_k(what, k, b)
    ids = (cols, group.out_rows, group.offsets, group.blocks, group.longest_first)
    for t in ids:
        if t.device != u.device or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{what}: cluster ids and the group's lists must be contiguous "
                             f"int64 on {u.device}")
    n_out = group.out_rows.shape[0]
    if cols.shape != (b,) or group.blocks.shape != (b,) or group.offsets.shape != (n_out + 1,) \
            or group.longest_first.shape != (n_out,):
        raise ValueError(f"{what}: the group's lists do not match its {b} blocks")
    if b == 0 or r == 0:
        return z_pad
    fn = _build.c_function("lowrank_matmat", "repro_lowrank_matmat_level",
                           _LOWRANK_LEVEL_ARGTYPES)
    with torch.cuda.device(u.device):
        for c0, w in lowrank_column_chunks(k, r):
            scratch = _lowrank_scratch(b, m, k, w, u.device)
            err = fn(u.data_ptr(), v.data_ptr(), x_pad.data_ptr() + 4 * c0, r, cols.data_ptr(),
                     z_pad.data_ptr() + 4 * c0, r, group.out_rows.data_ptr(),
                     group.offsets.data_ptr(), group.blocks.data_ptr(),
                     group.longest_first.data_ptr(), n_out, scratch.data_ptr(), b, m, k, w,
                     stream_handle(u.device))
            _build.check(err, what)
            _build.LAUNCHES[what] += 1
    return z_pad
