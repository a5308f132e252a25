"""Dense min-label pull: connected components of the exact radius graph.

Counterpart of the JAX package's ``cluster/dense_grow.py``. Distances come
in matmul form from [8, T] operands (:func:`_operands`); one pull gives each
row the min label over its in-radius same-id rows (:func:`min_pull_plain`,
the ``min_pull_xla`` math, is the spec). The TPU kernel evaluates all T^2
pairs; the port's kernel evaluates only the block pairs that
:func:`pull_tables` lists as able to hold a neighbour, built once per
:func:`dense_components` call, and gives the same result row for row. On a
CUDA tensor :func:`min_pull` launches ``csrc/dense_pull.cu``; on a CPU
tensor it runs :func:`min_pull_blocks_plain`, the same pairs in plain
PyTorch. The pointer jumping and the convergence loop of
:func:`dense_components` stay in PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _cuda
from ..utils import trace

KERNEL = _cuda.Kernel(
    "dense_pull",
    "pst_dense_pull_blocks",
    [_cuda.PTR] * 8 + [_cuda.INT, _cuda.FLOAT, _cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/dense_pull.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/cluster/dense_grow.py:77",
)

_TABLES_SRC = "panopticsegforlargescalepointcloud_tpu_torch/csrc/pull_tables.cu"
# the pair tables' kernels: parts of B's port (the TPU kernel needs no tables)
KEYS_KERNEL = _cuda.Kernel(
    "pull_keys", "pst_pull_keys", [_cuda.PTR] * 5 + [_cuda.INT, _cuda.FLOAT, _cuda.PTR],
    source=_TABLES_SRC, replaces=KERNEL.replaces)
BLOCKS_KERNEL = _cuda.Kernel(
    "pull_blocks", "pst_pull_blocks", [_cuda.PTR] * 4 + [_cuda.INT] + [_cuda.PTR] * 10,
    source=_TABLES_SRC, replaces=KERNEL.replaces)
CANDS_KERNEL = _cuda.Kernel(
    "pull_cands", "pst_pull_cands",
    [_cuda.PTR] * 5 + [_cuda.INT, _cuda.FLOAT, _cuda.FLOAT] + [_cuda.PTR] * 3,
    source=_TABLES_SRC, replaces=KERNEL.replaces)

_BQ = 256
_BS = 2048
BR = 128  # rows per block of the pair tables (csrc/dense_pull.cu: BR)
_PLAIN_ROWS = 1024  # query rows per step of min_pull_plain
_INF = float("inf")
_U = 2.0 ** -24  # f32 unit roundoff
_MARGIN_ULPS = 32.0  # see pull_tables
_CELL_BITS = 16  # Hilbert bits per axis of the row order
_ID_SHIFT = 3 * _CELL_BITS
_LAST_KEY = (1 << 63) - 1
_SEGS = 4  # id runs per block with a box of their own


class PullTables(NamedTuple):
    """The row order and candidate block pairs of one set of operands."""

    perm: torch.Tensor  # [T] int32: block position -> caller row
    q: torch.Tensor  # [T, 4] f32 (q0, q1, q2, qn) in block order
    p: torch.Tensor  # [T, 4] f32 (x, y, z, pn) in block order
    ids: torch.Tensor  # [T] int32 in block order
    cand: torch.Tensor  # [nb, nb] int32: each query block's candidates first, ascending
    ncand: torch.Tensor  # [nb] int32: how many of each row of ``cand`` are candidates
    r2: float  # the radius^2 the tables were built for


def supports_dense(t: int) -> bool:
    """The compacted row count must tile evenly (as in the JAX package)."""
    return t >= _BS and t % _BQ == 0 and t % _BS == 0


def _operands(pos: torch.Tensor, valid: torch.Tensor):
    """[8, T] operands: qmat rows (-2x, -2y, -2z, 1, qn, 0, 0, 0), smat rows
    (x, y, z, pn, 1, 0, 0, 0); invalid rows carry +inf norms."""
    x = pos.float()
    n2 = (x * x).sum(dim=1)
    n2 = torch.where(valid, n2, torch.full_like(n2, _INF))
    one = torch.ones_like(n2)
    zero = torch.zeros_like(n2)
    qmat = torch.stack([-2 * x[:, 0], -2 * x[:, 1], -2 * x[:, 2], one, n2, zero, zero, zero])
    smat = torch.stack([x[:, 0], x[:, 1], x[:, 2], n2, one, zero, zero, zero])
    return qmat.contiguous(), smat.contiguous()


def _neighbour_chunks(qmat, smat, ids, r2: float):
    """(r0, r1, ok [r1 - r0, T]) over chunks of query rows: ok marks the
    same-id pairs within the radius. d2 is summed term by term over the 8
    operand rows, with separate multiplies and adds: the kernel's 5-term sum
    rounds the same (see ``csrc/dense_pull.cu``)."""
    t = ids.shape[0]
    for r0 in range(0, t, _PLAIN_ROWS):
        r1 = min(t, r0 + _PLAIN_ROWS)
        q = qmat[:, r0:r1]
        d2 = q[0][:, None] * smat[0][None, :]
        for r in range(1, 8):
            d2 = d2 + q[r][:, None] * smat[r][None, :]
        yield r0, r1, (d2 <= r2) & (ids[r0:r1, None] == ids[None, :])


def min_pull_plain(qmat, smat, ids, labels, r2: float) -> torch.Tensor:
    """One pull over all pairs in plain PyTorch, a chunk of query rows at a
    time: the spec."""
    out = torch.empty(ids.shape[0], dtype=torch.float32, device=qmat.device)
    for r0, r1, ok in _neighbour_chunks(qmat, smat, ids, r2):
        out[r0:r1] = torch.where(ok, labels[None, :], _INF).amin(dim=1)
    return out


def qualifying_pairs(qmat, smat, ids, r2: float) -> int:
    """The (query, support) pairs a pull needs: same id and d2 <= r2, each
    row with itself included (a host sync: for reports only)."""
    return sum(int(ok.sum()) for _, _, ok in _neighbour_chunks(qmat, smat, ids, r2))


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Bits 0..15 of int64 ``v`` moved to bits 0, 3, 6, ..., 45."""
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    return (v | (v << 2)) & 0x1249249249249249


def _hilbert3(c: torch.Tensor) -> torch.Tensor:
    """Hilbert index of int64 cell coordinates c [T, 3] in [0, 2^16):
    Skilling's transform (AIP Conf. Proc. 707, 2004) to the transposed index,
    then interleaved with axis 0 the high bit of each level."""
    x = [c[:, 0].clone(), c[:, 1].clone(), c[:, 2].clone()]
    q = 1 << (_CELL_BITS - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            bit = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0 = torch.where(bit, x[0] ^ p, x[0] ^ t)
            if i > 0:
                x[i] = torch.where(bit, x[i], x[i] ^ t)
            x[0] = x0
        q >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    q = 1 << (_CELL_BITS - 1)
    while q > 1:
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return (_spread3(x[0] ^ t) << 2) | (_spread3(x[1] ^ t) << 1) | _spread3(x[2] ^ t)


def _valid_rows(qmat, smat) -> torch.Tensor:
    return torch.isfinite(smat[3]) & torch.isfinite(qmat[4])


def _keys_plain(qmat, smat, ids, lo, inv_cell: float) -> torch.Tensor:
    """The row order's sort keys (``csrc/pull_tables.cu:pull_keys_kernel``)."""
    c = torch.floor((smat[:3].T - lo) * inv_cell).clamp(0, (1 << _CELL_BITS) - 1).long()
    h = _hilbert3(c)
    idk = ids.long().clamp(0, (1 << (63 - _ID_SHIFT)) - 1)
    h = torch.where(idk % 2 == 1, ((1 << _ID_SHIFT) - 1) - h, h)
    return torch.where(_valid_rows(qmat, smat), (idk << _ID_SHIFT) | h,
                       torch.full_like(h, _LAST_KEY))


def _blocks_plain(qmat, smat, ids, perm):
    """Operands, ids and rows in block order and each id run's box, id range
    and largest norm (``csrc/pull_tables.cu:pull_blocks_kernel``): (q, p,
    sid, perm32, lo, hi, idlo, idhi, nmax); a run without valid rows has
    idlo > idhi."""
    t = ids.shape[0]
    nb = t // BR
    dev = smat.device
    q = torch.cat([qmat[0:3], qmat[4:5]])[:, perm].T.contiguous()
    p = smat[0:4, perm].T.contiguous()
    sid = ids[perm].to(torch.int32).contiguous()
    vb = _valid_rows(qmat, smat)[perm]
    idb = sid.reshape(nb, BR)
    first = torch.ones_like(idb, dtype=torch.bool)
    first[:, 1:] = idb[:, 1:] != idb[:, :-1]
    seg = (torch.cumsum(first.to(torch.int32), dim=1) - 1).clamp(max=_SEGS - 1)
    seg = (torch.arange(nb, device=dev)[:, None] * _SEGS + seg).reshape(-1)
    ns = nb * _SEGS
    seg3 = seg[:, None].expand(-1, 3)
    lo = torch.full((ns, 3), _INF, device=dev).scatter_reduce(
        0, seg3, torch.where(vb[:, None], p[:, :3], _INF), "amin")
    hi = torch.full((ns, 3), -_INF, device=dev).scatter_reduce(
        0, seg3, torch.where(vb[:, None], p[:, :3], -_INF), "amax")
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    idlo = torch.full((ns,), big, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(vb, sid, big), "amin")
    idhi = torch.full((ns,), small, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(vb, sid, small), "amax")
    nmax = torch.zeros(ns, device=dev).scatter_reduce(
        0, seg, torch.where(vb, p[:, 3], 0.0), "amax")
    return q, p, sid, perm.to(torch.int32), lo, hi, idlo, idhi, nmax


def _cands_plain(lo, hi, idlo, idhi, nmax, nb: int, r2: float):
    """Candidate support blocks of each query block, ascending, then the
    others (``csrc/pull_tables.cu:pull_cands_kernel`` writes only the
    candidates), and their count. Each operation rounds as the kernel's."""
    gap = torch.maximum(lo[:, None, :] - hi[None, :, :], lo[None, :, :] - hi[:, None, :])
    gap = gap.clamp(min=0.0)
    bd2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    margin = (_MARGIN_ULPS * _U) * ((nmax[:, None] + nmax[None, :]) + r2)
    live = idlo <= idhi  # a run without valid rows has an empty id range
    ok = (live[:, None] & live[None, :]
          & (idlo[:, None] <= idhi[None, :]) & (idlo[None, :] <= idhi[:, None])
          & (bd2 <= r2 + margin))
    ok = ok.reshape(nb, _SEGS, nb, _SEGS).any(dim=3).any(dim=1)
    cand = torch.argsort((~ok).to(torch.int8), dim=1, stable=True).to(torch.int32).contiguous()
    return cand, ok.sum(dim=1).to(torch.int32)


def pull_tables(qmat, smat, ids, r2: float) -> PullTables:
    """The row order and candidate block pairs for operands in the layout
    of :func:`_operands` (positions are smat rows 0-2; a row is valid where
    its norm is finite). On a CUDA tensor: three launches of
    ``csrc/pull_tables.cu`` around one sort, with no host sync; on a CPU
    tensor their plain versions (:func:`_keys_plain`, :func:`_blocks_plain`,
    :func:`_cands_plain`). Sizes depend on T alone.

    Order: by id, then by the Hilbert index of the row's radius-sized cell
    (reversed for odd ids, so that an id's last rows and the next id's
    first rows share a corner), invalid rows last; blocks of :data:`BR`
    consecutive rows are then small in all three axes. Ids outside
    [0, 2^15) take the key of the nearer end, which changes the order, not
    the result. Per run of one id in a block (up to four, the last taking
    the rest): the id range and the box of its valid rows and the largest
    valid norm (an empty id range where it has none). A support block is a
    candidate of a query block when a run of each has meeting id ranges and
    a squared box distance of at most ``r2 + margin``.

    The margin makes the skip safe against the rounding of the kernel's d2.
    With u = 2^-24 and S = |q|^2 + |p|^2: the norms qn, pn carry up to 3u of
    their value, the three products -2 q_k p_k (|sum| <= S) up to u S
    together, and the four adds, whose partial sums stay below 2 S, up to
    2u S each: |d2 - |q - p|^2| <= 14 u S to first order. The box distance,
    from exact coordinates, rounds by at most 6u of itself, which the margin
    also covers near r2. So a skipped pair, whose box distance exceeds
    r2 + 32 u (Nq + Np + r2), with Nq, Np the runs' largest norms (>= the
    rows' own), has a computed d2 > r2: it cannot qualify."""
    t = ids.shape[0]
    if qmat.shape != (8, t) or smat.shape != (8, t):
        raise ValueError("pull_tables: operands must be [8, T] and ids [T]")
    if t % BR:
        raise ValueError(f"pull_tables: T = {t} is not a multiple of {BR}")
    r2 = float(r2)
    inv_cell = 1.0 / r2 ** 0.5
    lo = torch.where(_valid_rows(qmat, smat)[:, None], smat[:3].T, _INF).amin(dim=0)
    perm = torch.argsort(row_keys(qmat, smat, ids, lo, inv_cell), stable=True)
    q, p, sid, perm32, *runs = block_runs(qmat, smat, ids, perm)
    cand, ncand = block_cands(*runs, t // BR, r2)
    return PullTables(perm32, q, p, sid, cand, ncand, r2)


def row_keys(qmat, smat, ids, lo, inv_cell: float) -> torch.Tensor:
    """[T] int64 sort keys: ``csrc/pull_tables.cu:pull_keys_kernel`` on a
    CUDA tensor, :func:`_keys_plain` on a CPU tensor."""
    t = ids.shape[0]
    if smat.device.type == "cpu":
        return _keys_plain(qmat, smat, ids, lo, inv_cell)
    if not (qmat.dtype == smat.dtype == lo.dtype == torch.float32) or ids.dtype != torch.int32:
        raise TypeError("pull tables take f32 operands and int32 ids")
    if not all(a.is_contiguous() for a in (qmat, smat, ids, lo)):
        raise ValueError("pull tables need contiguous operands")
    if not all(a.device == smat.device for a in (qmat, ids, lo)):
        raise ValueError("pull table operands must be on one device")
    key = torch.empty(t, dtype=torch.int64, device=smat.device)
    KEYS_KERNEL(qmat.data_ptr(), smat.data_ptr(), ids.data_ptr(), lo.data_ptr(),
                key.data_ptr(), t, inv_cell, _cuda.stream_ptr(smat.device))
    return key


def block_runs(qmat, smat, ids, perm):
    """Block order and id runs (q, p, sid, perm32, lo, hi, idlo, idhi, nmax):
    ``csrc/pull_tables.cu:pull_blocks_kernel`` on a CUDA tensor,
    :func:`_blocks_plain` on a CPU tensor."""
    t = ids.shape[0]
    dev = smat.device
    if dev.type == "cpu":
        return _blocks_plain(qmat, smat, ids, perm)
    if perm.dtype != torch.int64 or perm.shape != (t,) or perm.device != dev:
        raise ValueError("block_runs: perm must be [T] int64 on the operands' device")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ns = t // BR * _SEGS
    out = (torch.empty((t, 4), **f32), torch.empty((t, 4), **f32), torch.empty(t, **i32),
           torch.empty(t, **i32), torch.empty((ns, 3), **f32), torch.empty((ns, 3), **f32),
           torch.empty(ns, **i32), torch.empty(ns, **i32), torch.empty(ns, **f32))
    BLOCKS_KERNEL(qmat.data_ptr(), smat.data_ptr(), ids.data_ptr(), perm.data_ptr(), t,
                  *(a.data_ptr() for a in out), _cuda.stream_ptr(dev))
    return out


def block_cands(lo, hi, idlo, idhi, nmax, nb: int, r2: float):
    """(cand [nb, nb], ncand [nb]) int32: ``csrc/pull_tables.cu:
    pull_cands_kernel`` on a CUDA tensor (only each row's candidates are
    written), :func:`_cands_plain` on a CPU tensor."""
    dev = lo.device
    if dev.type == "cpu":
        return _cands_plain(lo, hi, idlo, idhi, nmax, nb, r2)
    cand = torch.empty((nb, nb), dtype=torch.int32, device=dev)
    ncand = torch.empty(nb, dtype=torch.int32, device=dev)
    CANDS_KERNEL(lo.data_ptr(), hi.data_ptr(), idlo.data_ptr(), idhi.data_ptr(),
                 nmax.data_ptr(), nb, float(r2), _MARGIN_ULPS * _U, cand.data_ptr(),
                 ncand.data_ptr(), _cuda.stream_ptr(dev))
    return cand, ncand


def pairs_evaluated(tables: PullTables) -> int:
    """Pairs one pull evaluates (a host sync: for reports only)."""
    return int(tables.ncand.sum()) * BR * BR


def min_pull_blocks_plain(tables: PullTables, labels: torch.Tensor) -> torch.Tensor:
    """The kernel's pull in plain PyTorch: exactly the pairs of the
    candidate block pairs of ``tables``, d2 as the kernel sums it. Equals
    :func:`min_pull_plain` when the tables drop no qualifying pair."""
    t = tables.ids.shape[0]
    dev = tables.q.device
    lab = labels[tables.perm.long()]
    ncand = tables.ncand.tolist()
    arange = torch.arange(BR, device=dev)
    out_sorted = torch.full((t,), _INF, dtype=torch.float32, device=dev)
    for qb, n in enumerate(ncand):
        if n == 0:
            continue
        rows = (tables.cand[qb, :n].long()[:, None] * BR + arange).reshape(-1)
        qv = tables.q[qb * BR:(qb + 1) * BR]
        pv = tables.p[rows]
        d2 = qv[:, 0:1] * pv[None, :, 0] + qv[:, 1:2] * pv[None, :, 1]
        d2 = d2 + qv[:, 2:3] * pv[None, :, 2]
        d2 = d2 + pv[None, :, 3]
        d2 = d2 + qv[:, 3:4]
        same_id = tables.ids[qb * BR:(qb + 1) * BR, None] == tables.ids[rows][None]
        ok = (d2 <= tables.r2) & same_id
        out_sorted[qb * BR:(qb + 1) * BR] = torch.where(ok, lab[rows][None, :], _INF).amin(dim=1)
    out = torch.empty_like(out_sorted)
    out[tables.perm.long()] = out_sorted
    return out


def min_pull(qmat, smat, ids, labels, r2: float, tables: PullTables | None = None
             ) -> torch.Tensor:
    """qmat, smat [8, T] f32 in the layout of :func:`_operands`, ids [T]
    int32, labels [T] f32 -> [T] f32 min neighbor label (+inf where none,
    including invalid rows). ``tables``: :func:`pull_tables` of these
    operands and ``r2``, built here when not given (a caller that pulls
    many times builds them once). The kernel reads q rows 0-2 and 4 and s
    rows 0-3, since the other products are x * 1 and 0 * 0, which round the
    8-term sum no differently."""
    t = ids.shape[0]
    if labels.shape != (t,):
        raise ValueError("min_pull: labels must be [T]")
    if tables is None:
        tables = pull_tables(qmat, smat, ids, r2)
    elif tables.r2 != float(r2) or tables.ids.shape != (t,):
        raise ValueError("min_pull: the tables were built for other operands or another r2")
    if labels.device.type == "cpu":
        return min_pull_blocks_plain(tables, labels)
    if labels.dtype != torch.float32 or not labels.is_contiguous():
        raise TypeError("min_pull takes contiguous f32 labels")
    if labels.device != tables.q.device:
        raise ValueError("min_pull: labels and tables must be on one device")
    out = torch.empty(t, dtype=torch.float32, device=labels.device)
    KERNEL(tables.q.data_ptr(), tables.p.data_ptr(), tables.ids.data_ptr(),
           tables.perm.data_ptr(), labels.data_ptr(), tables.cand.data_ptr(),
           tables.ncand.data_ptr(), out.data_ptr(), t, tables.r2,
           _cuda.stream_ptr(labels.device))
    return out


def dense_components(pos, ids, valid, radius: float, init_labels, max_iters: int = 64):
    """Connected components of the same-id radius graph by dense pulls and
    pointer jumping, from ``init_labels`` (cell_seed_labels contract).
    Returns int32 labels, each component carrying its min member row. The
    pull tables are built once; the loop checks convergence on the host
    once per iteration (a ``grow`` host read and a ``grow_rounds`` count,
    :mod:`..utils.trace`)."""
    t = pos.shape[0]
    qmat, smat = _operands(pos, valid)
    ids = ids.to(torch.int32).contiguous()
    r2 = float(radius) * float(radius)
    tables = pull_tables(qmat, smat, ids, r2)
    fill_t = torch.full((1,), t, dtype=torch.int32, device=pos.device)

    def pull(lab_i32):
        got = min_pull(qmat, smat, ids, lab_i32.float().contiguous(), r2, tables)
        got_i32 = torch.where(torch.isfinite(got), got, float(t)).to(torch.int32)
        new = torch.minimum(lab_i32, got_i32)
        new = torch.where(valid, new, fill_t)
        for _ in range(3):
            ext = torch.cat([new, fill_t])
            new = torch.minimum(new, ext[new.clamp(max=t).long()])
        return new

    labels = init_labels.to(torch.int32)
    for _ in range(max_iters):
        trace.count("grow_rounds")
        new = pull(pull(labels))
        with trace.host_read("grow"):
            changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels
