"""Cell hashing helpers for clustering (counterpart of the JAX package's
``cluster/neighbors.py``: ``run_starts``, ``_shifted_cells`` and
``cell_seed_labels``; the edge-list radius graph is not part of this slice).
"""

from __future__ import annotations

import torch

from ..ops.hashing import INVALID_KEY, BitLayout, pack_coords

_MAX_SAMPLES = 256


def run_starts(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """``searchsorted(sorted_keys, q, side="left")`` via one stable co-sort
    (queries first among equal keys, then a suffix min over table rows)."""
    n = sorted_keys.shape[0]
    shape = query_keys.shape
    q = query_keys.reshape(-1)
    m = q.shape[0]
    dev = q.device
    all_keys = torch.cat([q, sorted_keys])
    tag = torch.cat([torch.full((m,), -1, dtype=torch.int64, device=dev),
                     torch.arange(n, dtype=torch.int64, device=dev)])
    order = torch.argsort(all_keys, stable=True)
    stags = tag[order]
    table_pos = torch.where(stags >= 0, stags, torch.full_like(stags, n))
    nxt = torch.flip(torch.cummin(torch.flip(table_pos, [0]), dim=0).values, [0])
    res = torch.empty_like(nxt)
    res[order] = nxt
    return res[:m].to(torch.int32).reshape(shape)


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
