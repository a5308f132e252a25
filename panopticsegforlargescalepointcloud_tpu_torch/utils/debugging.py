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

from ..cluster.neighbors import radius_neighbors


def radius_neighbor_counts(pos: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                           radius: float, k: int, cell_cap: int = 16) -> torch.Tensor:
    """[N] int64: the number of neighbours ``radius_neighbors(pos, batch,
    valid, radius, k, cell_cap)`` returns for each row (min(candidates
    within the radius, k); 0 for invalid rows)."""
    idx, _ = radius_neighbors(pos, batch, valid, radius, k=k, cell_cap=cell_cap)
    return (idx >= 0).sum(-1)


def neighbour_count_stats(pos, batch, valid, radius: float, k: int,
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
