"""Cell hashing: clustering's helpers and the point backbones' radius
queries (counterpart of the JAX package's ``cluster/neighbors.py``:
``run_starts``, ``_shifted_cells``, ``cell_seed_labels``, ``radius_query``,
``radius_neighbors`` and ``radius_graph``, the edge list of region growing's
edge path).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.hashing import INVALID_KEY, BitLayout, pack_coords

_MAX_SAMPLES = 256


def run_starts(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """``searchsorted(sorted_keys, q, side="left")``: the first table index
    whose key is >= q (``len(sorted_keys)`` if none), int32 of the query's
    shape. The JAX package co-sorts queries and table (binary search is
    slow on the TPU); the card searches."""
    return torch.searchsorted(sorted_keys, query_keys.contiguous(), side="left").to(torch.int32)


def _shifted_cells(pos, batch, valid, radius, bits: BitLayout, num_ids: int = _MAX_SAMPLES):
    """Cell coords shifted so each id's valid minimum packs to 0."""
    cell = torch.floor(pos * (1.0 / radius)).to(torch.int32)
    big = 1 << 24
    cellw = torch.where(valid[:, None], cell, torch.full_like(cell, big))
    b = batch.clamp(0, num_ids - 1).long()
    cmin = torch.full((num_ids, 3), big, dtype=torch.int32, device=pos.device)
    cmin.scatter_reduce_(0, b[:, None].expand(-1, 3), cellw, reduce="amin", include_self=True)
    half = torch.tensor([1 << (bits.bx - 1), 1 << (bits.by - 1), 1 << (bits.bz - 1)],
                        dtype=torch.int32, device=pos.device)
    return cell - cmin[b] - half


def cell_seed_labels(pos, ids, valid, radius: float, bits: BitLayout,
                     num_ids: int = _MAX_SAMPLES) -> torch.Tensor:
    """Initial union-find labels: same-id points sharing a cube of side
    radius/2 are provably connected and get the row id of one member.
    Returns [N] int32 (``n`` for invalid rows)."""
    n = pos.shape[0]
    dev = pos.device
    cell = _shifted_cells(pos, ids, valid, radius * 0.5, bits, num_ids)
    keys = pack_coords(ids, cell, bits, extra_invalid=~valid)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    arange = torch.arange(n, dtype=torch.int64, device=dev)
    head_pos = torch.cummax(torch.where(first, arange, torch.full_like(arange, -1)), dim=0).values
    rep_sorted = order[head_pos.clamp(min=0)]
    lab_sorted = torch.where(skeys != INVALID_KEY, rep_sorted, order)
    labels = torch.empty_like(lab_sorted)
    labels[order] = lab_sorted
    labels = labels.to(torch.int32)
    return torch.where(valid, labels, torch.full_like(labels, n))


# Default cell-key layout of the radius queries: 9 bits per axis (512-cell
# extents) leave 5 bits, 31 distinct batch ids.
DEFAULT_CELL_BITS = BitLayout(9, 9, 9)

# the 27 adjacent cells, z fastest
_CELL_OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                         axis=-1).reshape(-1, 3).astype(np.int32)


def _cell_scan(q_pos, q_ids, q_valid, s_pos, s_ids, s_valid, radius: float,
               bits: BitLayout, num_ids: int, offsets: np.ndarray = _CELL_OFFSETS):
    """The support rows binned into cells of side ``radius``, sorted by
    key (stable), and every query's adjacent cell keys (one per row of
    ``offsets``) with the sorted position where each cell's run starts.
    Cells are shifted by the per-id minimum over query ∪ support, so one
    sample's two sets share a frame. Returns (q_keys [Q, O], support keys,
    sorted support keys, order, start [Q, O])."""
    nq = q_pos.shape[0]
    dev = q_pos.device
    inv = 1.0 / radius
    q_cell = torch.floor(q_pos * inv).to(torch.int32)
    s_cell = torch.floor(s_pos * inv).to(torch.int32)
    big = 1 << 24
    qi = q_ids.clamp(0, num_ids - 1).long()
    si = s_ids.clamp(0, num_ids - 1).long()
    cmin = torch.full((num_ids, 3), big, dtype=torch.int32, device=dev)
    for ids, cell, valid in ((qi, q_cell, q_valid), (si, s_cell, s_valid)):
        cmin.scatter_reduce_(0, ids[:, None].expand(-1, 3),
                             torch.where(valid[:, None], cell, torch.full_like(cell, big)),
                             reduce="amin", include_self=True)
    half = torch.tensor([1 << (bits.bx - 1), 1 << (bits.by - 1), 1 << (bits.bz - 1)],
                        dtype=torch.int32, device=dev)
    q_cell = q_cell - cmin[qi] - half
    s_cell = s_cell - cmin[si] - half
    s_keys = pack_coords(s_ids, s_cell, bits, extra_invalid=~s_valid)
    order = torch.argsort(s_keys, stable=True)
    skeys = s_keys[order]
    no = offsets.shape[0]
    offs = torch.from_numpy(offsets).to(dev)
    qc = q_cell[:, None, :] + offs[None, :, :]  # [Q, O, 3]
    q_keys = pack_coords(q_ids[:, None].expand(nq, no).reshape(-1), qc.reshape(-1, 3), bits,
                         extra_invalid=(~q_valid)[:, None].expand(nq, no).reshape(-1))
    q_keys = q_keys.reshape(nq, no)
    return q_keys, s_keys, skeys, order, run_starts(skeys, q_keys).long()


def _k_nearest(q_pos, pos_s, q_keys, skeys, order, start, radius: float, k: int,
               cell_cap: int):
    """The ``k`` nearest of the candidates: up to ``cell_cap`` sorted
    support rows from each run ``start`` [Q, O] whose key is the cell's
    ``q_keys`` and which lie within ``radius``. Among equal distances the
    candidate scanned first comes first, as ``lax.top_k`` orders them: the
    selection sorts the distance's bits and the candidate's slot as one
    key (non-negative floats order as their bit patterns, and the key is
    unique, so the k smallest are one set in one order on any device).
    Returns (idx [Q, min(k, O·cell_cap)] int32 into the support rows, -1
    padding; dist2 f32, +inf padding), nearest first."""
    nq = q_pos.shape[0]
    ns = pos_s.shape[0]
    dev = q_pos.device
    slot = torch.arange(cell_cap, dtype=torch.int64, device=dev)
    cand = torch.clamp(start[:, :, None] + slot, max=ns - 1)  # [Q, O, cap]
    in_cell = skeys[cand] == q_keys[:, :, None]
    dist2 = None
    for c in range(3):  # the squares summed in coordinate order
        d = q_pos[:, c, None, None] - pos_s[:, c][cand]
        dist2 = d * d if dist2 is None else dist2 + d * d
    ok = in_cell & (dist2 <= radius * radius) & (q_keys[:, :, None] != INVALID_KEY)
    m = cand.shape[1] * cell_cap
    dist2 = torch.where(ok, dist2, torch.full_like(dist2, float("inf"))).reshape(nq, m)
    cand = torch.where(ok, cand, torch.zeros_like(cand)).reshape(nq, m)
    key = (dist2.view(torch.int32).long() << 32) | torch.arange(m, device=dev)
    sel = torch.topk(key, min(k, m), dim=1, largest=False, sorted=True).indices
    dist2 = dist2.gather(1, sel)
    idx = order[cand.gather(1, sel)].to(torch.int32)
    return torch.where(torch.isfinite(dist2), idx, torch.full_like(idx, -1)), dist2


def _pad_columns(t: torch.Tensor, k: int, fill) -> torch.Tensor:
    """[R, kk] -> [R, k] with ``fill`` in the columns past kk."""
    if t.shape[1] >= k:
        return t
    return torch.cat([t, t.new_full((t.shape[0], k - t.shape[1]), fill)], dim=1)


def radius_query(q_pos: torch.Tensor, q_ids: torch.Tensor, q_valid: torch.Tensor,
                 s_pos: torch.Tensor, s_ids: torch.Tensor, s_valid: torch.Tensor,
                 radius: float, k: int = 16, cell_cap: int = 16,
                 bits: BitLayout = DEFAULT_CELL_BITS, num_ids: int = _MAX_SAMPLES
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-set fixed-K radius search: for each query row, up to ``k``
    nearest *support* rows within ``radius`` with the same id. Every query
    scans its 27 adjacent cells (side ``radius``), at most ``cell_cap``
    support rows a cell in sorted order: rows past the cap are invisible
    as candidates. Ties: :func:`_k_nearest`.

    Returns (idx [Q, k] int32 into the support rows, -1 padding; dist2 [Q, k]
    f32, +inf padding), nearest first."""
    q_keys, _, skeys, order, start = _cell_scan(q_pos, q_ids, q_valid, s_pos, s_ids,
                                                s_valid, radius, bits, num_ids)
    idx, dist2 = _k_nearest(q_pos, s_pos[order], q_keys, skeys, order, start, radius, k,
                            cell_cap)
    return _pad_columns(idx, k, -1), _pad_columns(dist2, k, float("inf"))


def radius_neighbors(pos: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                     radius: float, k: int = 32, cell_cap: int = 16,
                     bits: BitLayout = DEFAULT_CELL_BITS, include_self: bool = True,
                     num_ids: int = _MAX_SAMPLES) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest neighbours within ``radius`` on one set, same sample
    only: :func:`radius_query` with the set as both query and support.
    Without ``include_self`` a row's own hit becomes padding (-1, +inf) in
    place, the other columns unmoved, as in the JAX package.

    Returns (idx [N, k] int32, -1 padding; dist2 [N, k] f32), nearest first."""
    idx, dist2 = radius_query(pos, batch, valid, pos, batch, valid, radius, k, cell_cap,
                              bits, num_ids)
    if not include_self:
        own = idx == torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)[:, None]
        idx = torch.where(own, torch.full_like(idx, -1), idx)
        dist2 = torch.where(own, torch.full_like(dist2, float("inf")), dist2)
    return idx, dist2


# the 13 offsets lexicographically greater than (0, 0, 0): each pair of
# adjacent cells is visited from one side only
_HALF_OFFSETS = np.array([o for o in _CELL_OFFSETS.tolist() if tuple(o) > (0, 0, 0)],
                         np.int32)


def radius_graph(pos: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, radius: float,
                 k: int = 32, cell_cap: int = 16, bits: BitLayout = DEFAULT_CELL_BITS,
                 num_ids: int = _MAX_SAMPLES
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetrized same-id radius graph for connectivity (region growing's
    edge path), as the JAX package builds it:

    * the half stencil: each row scans 13 of its 27 adjacent cells and, in
      its own cell, the rows after it in sort order, so each pair within
      the radius is found once (up to ``cell_cap`` rows a cell), and keeps
      the ``k`` nearest (:func:`_k_nearest`): ``fwd``;
    * the reverse edges: the forward destinations sorted stably, each
      row's in-edges one contiguous run of which the first ``k`` are kept,
      the source of sorted slot p being ``order[p] // k``: ``rev``;
    * ``trunc``: rows whose in-edges overflow the ``k`` reverse slots
      (pull-only propagation may leave such a hub's component split), plus
      valid rows whose shifted cell overflowed ``bits`` (no neighbours).

    Returns (fwd [N, k], rev [N, k], trunc []) int32 (-1 padding)."""
    n = pos.shape[0]
    dev = pos.device
    arange = torch.arange(n, dtype=torch.int64, device=dev)
    q_keys, keys, skeys, order, start = _cell_scan(pos, ids, valid, pos, ids, valid, radius,
                                                   bits, num_ids, _HALF_OFFSETS)
    sorted_pos_of = torch.empty_like(order)
    sorted_pos_of[order] = arange
    # own cell: only the rows strictly after this one in sort order
    start = torch.cat([start, (sorted_pos_of + 1)[:, None]], dim=1)
    q_keys = torch.cat([q_keys, keys[:, None]], dim=1)  # [N, 14]
    fwd, _ = _k_nearest(pos, pos[order], q_keys, skeys, order, start, radius, k, cell_cap)
    key_overflow = (valid & (keys == INVALID_KEY)).sum()

    kk = fwd.shape[1]
    nkk = n * kk
    dst = torch.where(fwd >= 0, fwd, n).reshape(-1).long()
    dst_sorted, sorder = torch.sort(dst, stable=True)
    src_sorted = (sorder // kk).to(torch.int32)
    # each row's first in-edge (the JAX package's scatter-min of positions)
    starts = torch.searchsorted(dst_sorted, arange)
    rslot = torch.arange(k, dtype=torch.int64, device=dev)
    rcand = torch.clamp(starts[:, None] + rslot, max=nkk - 1)
    rok = dst_sorted[rcand] == arange[:, None]
    rev = torch.where(rok, src_sorted[rcand], torch.full_like(rcand, -1, dtype=torch.int32))
    over = dst_sorted[torch.clamp(starts + k, max=nkk - 1)] == arange
    return _pad_columns(fwd, k, -1), rev, (over.sum() + key_overflow).to(torch.int32)


def cell_cap_truncated(q_pos, q_ids, q_valid, s_pos, s_ids, s_valid, radius: float,
                       cell_cap: int, bits: BitLayout = DEFAULT_CELL_BITS,
                       num_ids: int = _MAX_SAMPLES) -> torch.Tensor:
    """[] int64: the valid query rows of :func:`radius_query` for which
    ``cell_cap`` hid a candidate, i.e. some of the 27 cells they scan holds
    more than ``cell_cap`` support rows (a diagnostic: does the cap bind)."""
    ns = s_pos.shape[0]
    q_keys, _, skeys, _, start = _cell_scan(q_pos, q_ids, q_valid, s_pos, s_ids, s_valid,
                                            radius, bits, num_ids)
    past = start + cell_cap
    over = (past < ns) & (skeys[past.clamp(max=ns - 1)] == q_keys) & (q_keys != INVALID_KEY)
    return (over.any(dim=1) & q_valid).sum()
