"""Neighbour-count diagnostics (counterpart of the JAX package's
``utils/debugging.py``; upstream's ``FIND_NEIGHBOUR_DIST`` mode).

How many neighbours each point finds inside the clustering radius, counted
as the JAX package's fixed-K grid-hash search finds them (same sample only,
the point itself included; cells of side ``radius``, 27 cells scanned, at
most ``cell_cap`` candidates per cell, at most ``k`` kept). Besides the
count statistics it reports the *saturation fraction*: how many points hit
the K budget; a :class:`DistributionNeighbour` accumulates the counts'
histogram over calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..cluster.neighbors import radius_neighbors

DEBUGGING_VARS = {"FIND_NEIGHBOUR_DIST": False}


class DistributionNeighbour:
    """Histogram of per-point neighbour counts at one radius; counts past
    the last bin land in it."""

    def __init__(self, radius: float, bins: int = 1000):
        self._radius = radius
        self._bins = bins
        self._histogram = np.zeros(bins)

    def reset(self):
        self._histogram = np.zeros(self._bins)

    @property
    def radius(self):
        return self._radius

    @property
    def histogram(self):
        return self._histogram

    @property
    def histogram_non_zero(self):
        """The histogram up to its last non-zero bin."""
        nz = np.nonzero(self._histogram)[0]
        return self._histogram[: nz[-1] + 1] if len(nz) else self._histogram[:0]

    def add_valid_neighbours(self, counts):
        self._histogram += np.bincount(
            np.clip(np.asarray(counts, np.int64), 0, self._bins - 1), minlength=self._bins)


def radius_neighbor_counts(pos: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                           radius: float, k: int, cell_cap: int = 16) -> torch.Tensor:
    """[N] int64: the number of neighbours ``radius_neighbors(pos, batch,
    valid, radius, k, cell_cap)`` returns for each row (min(candidates
    within the radius, k); 0 for invalid rows)."""
    idx, _ = radius_neighbors(pos, batch, valid, radius, k=k, cell_cap=cell_cap)
    return (idx >= 0).sum(-1)


def neighbour_count_stats(pos, batch, valid, radius: float, k: int,
                          meter: DistributionNeighbour | None = None,
                          device=None) -> Dict[str, float]:
    """Run the clustering neighbour search once and summarize the counts of
    the valid rows: mean and median neighbour count and the fraction of
    points saturating the K budget; ``meter`` also accumulates them. Inputs
    are numpy arrays or tensors; the search runs on ``device`` (that of
    ``pos`` when None)."""
    pos, batch, valid = (torch.as_tensor(np.asarray(a) if isinstance(a, np.ndarray) else a,
                                         device=device)
                         for a in (pos, batch, valid))
    counts = radius_neighbor_counts(pos.float(), batch.int(), valid.bool(), radius, k)
    counts = counts[valid.bool()].cpu().numpy()
    if meter is not None:
        meter.add_valid_neighbours(counts)
    if len(counts) == 0:
        return {"nbr_mean": 0.0, "nbr_median": 0.0, "nbr_saturated": 0.0}
    return {
        "nbr_mean": float(counts.mean()),
        "nbr_median": float(np.median(counts)),
        "nbr_saturated": float((counts >= k).mean()),
    }
