"""Region growing as connected components of the same-class radius graph.

Counterpart of the JAX package's ``cluster/region_grow.py``.
:func:`region_grow_folded`, which models run, folds the class into the id
(``batch * C + class``), so only same-sample same-class rows connect. Two
algorithms, chosen from the configuration and the static shape exactly as
the JAX package chooses them:

* the dense pull (``dense_pull`` with a compaction budget that tiles):
  eligible rows are compacted (stably) to T rows and
  :func:`.dense_grow.dense_components` propagates over the exact radius
  graph (kernel B on the card);
* the edge path (no budget, ``dense_pull`` off, or a budget that does not
  tile): :func:`.neighbors.radius_graph` builds the k-nearest edge lists on
  the compacted or on all rows, and :func:`_grow_on_edges` propagates the
  minimum label over them (PyTorch gathers, as the JAX package computes
  them outside any Pallas kernel).

Both start from :func:`.neighbors.cell_seed_labels`; small components are
dropped and roots get dense proposal ids. :func:`region_grow`, for callers
without a static class count, builds the graph per sample and drops the
cross-class edges after it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.hashing import BitLayout
from ..ops.scatter import scatter_drop, segment_sum
from ..utils import trace
from .dense_grow import dense_components, supports_dense
from .neighbors import DEFAULT_CELL_BITS, cell_seed_labels, radius_graph


class RegionGrowResult(NamedTuple):
    point_prop: torch.Tensor  # [N] int32 proposal id, -1 = none
    prop_valid: torch.Tensor  # [P] bool
    prop_batch: torch.Tensor  # [P] int32 (-1 pad)
    num_props: torch.Tensor  # [] int32 (count before the capacity clip)
    overflow: torch.Tensor  # [] int32 eligible rows past the point cap
    # [] int32 rows whose edges the radius graph truncated (0 on the dense pull)
    graph_trunc: torch.Tensor


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


def region_grow(
    pos: torch.Tensor,
    sem_class: torch.Tensor,
    batch: torch.Tensor,
    grow_mask: torch.Tensor,
    radius: float,
    max_proposals: int,
    min_cluster_size: int = 10,
    k_neighbors: int = 32,
    cell_cap: int = 16,
    max_iters: int = 64,
) -> RegionGrowResult:
    """Same-class radius components of the ``grow_mask`` rows, without a
    static class count: the k-nearest radius graph of each sample, its
    cross-class edges dropped in both directions, then the edge path's
    propagation from every row's own label (no cell seeding: the seeds
    would have to separate the classes). Where the budgets do not bind
    (``graph_trunc`` 0) it groups as :func:`region_grow_folded`; the
    candidates of other classes count against ``k_neighbors`` and
    ``cell_cap`` here."""
    fwd, rev, trunc = radius_graph(pos, batch, grow_mask, radius, k=k_neighbors,
                                   cell_cap=cell_cap, bits=DEFAULT_CELL_BITS)

    def same_class(e):
        ok = (e >= 0) & (sem_class[e.clamp(min=0).long()] == sem_class[:, None])
        return torch.where(ok, e, torch.full_like(e, -1))

    r = _grow_on_edges(same_class(fwd), same_class(rev), batch, grow_mask, max_proposals,
                       min_cluster_size, max_iters)
    return r._replace(graph_trunc=trunc)


def region_grow_folded(
    pos: torch.Tensor,
    sem_class: torch.Tensor,
    batch: torch.Tensor,
    grow_mask: torch.Tensor,
    radius: float,
    max_proposals: int,
    num_classes: int,
    num_samples: int,
    point_cap: int = 0,
    min_cluster_size: int = 10,
    k_neighbors: int = 32,
    cell_cap: int = 16,
    max_iters: int = 64,
    dense_pull: bool = True,
) -> RegionGrowResult:
    """Same-class radius components of the ``grow_mask`` rows.
    ``point_cap`` 0 < T < N compacts the eligible rows to T before either
    algorithm runs (rows past T are left out and counted in ``overflow``);
    ``dense_pull`` runs the dense pull where T tiles
    (:func:`.dense_grow.supports_dense`), the edge path otherwise;
    ``k_neighbors`` and ``cell_cap`` budget the edge path's graph."""
    n = pos.shape[0]
    dev = pos.device
    num_ids = num_samples * num_classes
    bits = _fold_bits(num_ids)
    if not (point_cap and point_cap < n):
        ids = batch * num_classes + sem_class
        fwd, rev, trunc = radius_graph(pos, ids, grow_mask, radius, k=k_neighbors,
                                       cell_cap=cell_cap, bits=bits, num_ids=num_ids)
        init = cell_seed_labels(pos, ids, grow_mask, radius, bits, num_ids=num_ids)
        r = _grow_on_edges(fwd, rev, batch, grow_mask, max_proposals, min_cluster_size,
                           max_iters, init)
        return r._replace(graph_trunc=trunc)
    t = point_cap
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
    # the rows past the budget carry ids of clamped gathers: rvalid excludes them
    cids = cbatch * num_classes + sem_class[rows_safe]
    init = cell_seed_labels(cpos, cids, rvalid, radius, bits, num_ids=num_ids)
    if dense_pull and supports_dense(t):
        labels = dense_components(cpos, cids, rvalid, radius, init, max_iters)
        r = _finalize_components(labels, cbatch, rvalid, max_proposals, min_cluster_size)
        trunc = torch.zeros((), dtype=torch.int32, device=dev)  # the exact graph
    else:
        fwd, rev, trunc = radius_graph(cpos, cids, rvalid, radius, k=k_neighbors,
                                       cell_cap=cell_cap, bits=bits, num_ids=num_ids)
        r = _grow_on_edges(fwd, rev, cbatch, rvalid, max_proposals, min_cluster_size,
                           max_iters, init)
    point_prop = scatter_drop(n, -1, torch.where(rvalid, rows_safe, n), r.point_prop)
    return RegionGrowResult(point_prop, r.prop_valid, r.prop_batch, r.num_props, overflow,
                            trunc)


def _grow_on_edges(fwd, rev, batch, grow_mask, max_proposals: int, min_cluster_size: int,
                   max_iters: int, init_labels=None) -> RegionGrowResult:
    """Components by pull-only min-label propagation over ``fwd ∪ rev``,
    in the JAX package's schedule: each iteration pulls twice, each pull
    followed by three pointer jumps, until nothing changes or after
    ``max_iters`` iterations (where that binds, the labels depend on it).
    The convergence test reads one flag on the host per iteration (a
    ``grow`` host read and a ``grow_rounds`` count, :mod:`..utils.trace`)."""
    n = fwd.shape[0]
    dev = fwd.device
    adj = torch.cat([fwd, rev], dim=1)
    has = adj >= 0
    safe = adj.clamp(min=0).long()
    fill = torch.full((1,), n, dtype=torch.int32, device=dev)
    if init_labels is None:
        init_labels = torch.where(grow_mask, torch.arange(n, dtype=torch.int32, device=dev),
                                  fill)

    def pull(labels):
        nbr = torch.where(has, labels[safe], fill)
        new = torch.minimum(labels, nbr.min(dim=1).values)
        for _ in range(3):
            new = torch.minimum(new, torch.cat([new, fill])[new.clamp(max=n).long()])
        return torch.where(grow_mask, new, fill)

    labels = init_labels.to(torch.int32)
    it, changed = 0, True
    while changed and it < max_iters:
        trace.count("grow_rounds")
        new = pull(pull(labels))
        with trace.host_read("grow"):
            changed = bool((new != labels).any())
        labels = new
        it += 1
    return _finalize_components(labels, batch, grow_mask, max_proposals, min_cluster_size)


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
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return RegionGrowResult(point_prop, prop_valid, prop_batch, num, zero, zero)
