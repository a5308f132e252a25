"""Neighbour-count diagnostics (counterpart of the JAX package's
``utils/debugging.py``; upstream's ``FIND_NEIGHBOUR_DIST`` mode).

How many neighbours each point finds inside the clustering radius, counted
as the JAX package's fixed-K grid-hash search finds them (same sample only,
the point itself included; cells of side ``radius``, 27 cells scanned, at
most ``cell_cap`` candidates per cell, at most ``k`` kept). Besides the
count statistics it reports the *saturation fraction*: how many points hit
the K budget.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..cluster.neighbors import _shifted_cells, run_starts
from ..ops.hashing import INVALID_KEY, BitLayout, pack_coords

# the JAX package's region-growing neighbour budget (``rg_k_neighbors``)
# and its radius search's defaults
NEIGHBOUR_K = 16
CELL_CAP = 16
CELL_BITS = BitLayout(9, 9, 9)


def radius_neighbor_counts(pos: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                           radius: float, k: int = NEIGHBOUR_K,
                           cell_cap: int = CELL_CAP) -> torch.Tensor:
    """[N] int64: the number of neighbours the JAX package's
    ``radius_neighbors(pos, batch, valid, radius, k, cell_cap)`` returns for
    each row (min(candidates within the radius, k); 0 for invalid rows)."""
    n = pos.shape[0]
    offs = torch.stack(torch.meshgrid(*([torch.arange(-1, 2)] * 3), indexing="ij"),
                       -1).reshape(-1, 3).to(torch.int32).to(pos.device)
    cell = _shifted_cells(pos, batch, valid, radius, CELL_BITS)
    keys = pack_coords(batch, cell, CELL_BITS, extra_invalid=~valid)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    pos_s = pos[order]
    q_cells = (cell[:, None, :] + offs[None]).reshape(-1, 3)
    q_batch = batch[:, None].expand(n, 27).reshape(-1)
    q_inv = (~valid)[:, None].expand(n, 27).reshape(-1)
    q_keys = pack_coords(q_batch, q_cells, CELL_BITS, extra_invalid=q_inv).reshape(n, 27)
    start = run_starts(skeys, q_keys).long()
    slot = torch.arange(cell_cap, device=pos.device)
    cand = (start[:, :, None] + slot).clamp(max=n - 1)  # [N, 27, cap]
    in_cell = skeys[cand] == q_keys[:, :, None]
    d = pos[:, None, None, :] - pos_s[cand]
    ok = in_cell & ((d * d).sum(-1) <= radius * radius) & (q_keys[:, :, None] != INVALID_KEY)
    return ok.reshape(n, -1).sum(-1).clamp(max=k)


def neighbour_count_stats(pos, batch, valid, radius: float, k: int = NEIGHBOUR_K,
                          device=None) -> Dict[str, float]:
    """Run the clustering neighbour search once and summarize the counts of
    the valid rows: mean and median neighbour count and the fraction of
    points saturating the K budget. Inputs are numpy arrays or tensors;
    the search runs on ``device`` (that of ``pos`` when None)."""
    pos, batch, valid = (torch.as_tensor(np.asarray(a) if isinstance(a, np.ndarray) else a,
                                         device=device)
                         for a in (pos, batch, valid))
    counts = radius_neighbor_counts(pos.float(), batch.int(), valid.bool(), radius, k)
    counts = counts[valid.bool()].cpu().numpy()
    if len(counts) == 0:
        return {"nbr_mean": 0.0, "nbr_median": 0.0, "nbr_saturated": 0.0}
    return {
        "nbr_mean": float(counts.mean()),
        "nbr_median": float(np.median(counts)),
        "nbr_saturated": float((counts >= k).mean()),
    }
