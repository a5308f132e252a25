"""Region growing as connected components on the compacted thing rows.

Counterpart of the JAX package's ``cluster/region_grow.py:region_grow_folded``
on its compacted dense-pull branch: eligible rows are compacted (stably) to a
static budget of T rows, the class is folded into the id (``batch * C +
class``), components of the exact same-id radius graph come from
:func:`.dense_grow.dense_components`, then small components are dropped and
roots get dense proposal ids. The JAX package's edge-list path is its
off-TPU fallback and is not part of this port: a budget that does not tile
for the dense pull raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.hashing import BitLayout
from ..ops.scatter import scatter_drop, segment_sum
from .dense_grow import dense_components, supports_dense
from .neighbors import cell_seed_labels


class RegionGrowResult(NamedTuple):
    point_prop: torch.Tensor  # [N] int32 proposal id, -1 = none
    prop_valid: torch.Tensor  # [P] bool
    prop_batch: torch.Tensor  # [P] int32 (-1 pad)
    num_props: torch.Tensor  # [] int32 (count before the capacity clip)
    overflow: torch.Tensor  # [] int32 eligible rows past the point cap


def _fold_bits(num_ids: int) -> BitLayout:
    """Cell-key layout with enough id bits for ``num_ids`` folded values."""
    bb = 1
    while (1 << bb) - 1 <= num_ids:
        bb += 1
    rem = 32 - bb
    bz = rem // 3
    by = (rem - bz) // 2
    bx = rem - bz - by
    return BitLayout(bx, by, bz)


def region_grow_folded(
    pos: torch.Tensor,
    sem_class: torch.Tensor,
    batch: torch.Tensor,
    grow_mask: torch.Tensor,
    radius: float,
    max_proposals: int,
    num_classes: int,
    num_samples: int,
    point_cap: int,
    min_cluster_size: int = 10,
    max_iters: int = 64,
) -> RegionGrowResult:
    n = pos.shape[0]
    dev = pos.device
    t = point_cap
    if not (0 < t < n) or not supports_dense(t):
        raise ValueError(
            f"region growing needs a compaction budget 0 < T < {n} that tiles "
            f"the dense pull (multiple of 2048), got T={t}"
        )
    num_ids = num_samples * num_classes
    bits = _fold_bits(num_ids)
    # stable compaction: thing rows keep their key-sorted order
    cnt = torch.cumsum(grow_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(grow_mask & (cnt < t), cnt, torch.full_like(cnt, t))
    rows = scatter_drop(t, n, tgt, torch.arange(n, dtype=torch.int32, device=dev))
    rvalid = rows < n
    rows_safe = rows.clamp(max=n - 1).long()
    total = grow_mask.sum().to(torch.int32)
    overflow = (total - t).clamp(min=0)
    cpos = pos[rows_safe]
    cbatch = batch[rows_safe]
    cids = cbatch * num_classes + sem_class[rows_safe]
    init = cell_seed_labels(cpos, cids, rvalid, radius, bits, num_ids=num_ids)
    labels = dense_components(cpos, cids, rvalid, radius, init, max_iters)
    r = _finalize_components(labels, cbatch, rvalid, max_proposals, min_cluster_size)
    point_prop = scatter_drop(n, -1, torch.where(rvalid, rows_safe, n), r.point_prop)
    return RegionGrowResult(point_prop, r.prop_valid, r.prop_batch, r.num_props, overflow)


def _finalize_components(labels, batch, grow_mask, max_proposals: int, min_cluster_size: int):
    """Converged min-member-row labels -> size filter + dense proposal ids."""
    n = labels.shape[0]
    dev = labels.device
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    sizes = segment_sum(grow_mask.to(torch.int32),
                        torch.where(grow_mask, labels, torch.full_like(labels, -1)), n)
    big = sizes[labels.clamp(max=n - 1).long()] >= min_cluster_size
    keep = grow_mask & big
    is_root = keep & (labels == arange)
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    root_prop = torch.where(is_root & (rank < max_proposals), rank, torch.full_like(rank, -1))
    root_ext = torch.cat([root_prop, root_prop.new_full((1,), -1)])
    point_prop = torch.where(keep, root_ext[labels.clamp(max=n).long()],
                             torch.full_like(labels, -1))
    num = is_root.sum().to(torch.int32)
    prop_ids = torch.arange(max_proposals, dtype=torch.int32, device=dev)
    prop_valid = prop_ids < torch.clamp(num, max=max_proposals)
    root_rows = scatter_drop(max_proposals, -1,
                             torch.where(root_prop >= 0, root_prop, max_proposals), arange)
    prop_batch = torch.where(prop_valid, batch[root_rows.clamp(min=0).long()],
                             torch.full_like(prop_ids, -1))
    return RegionGrowResult(point_prop, prop_valid, prop_batch, num,
                            torch.zeros((), dtype=torch.int32, device=dev))
