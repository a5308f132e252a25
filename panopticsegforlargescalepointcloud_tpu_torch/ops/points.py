"""Point-sampling and neighbour ops: pairwise distances, kNN, ball query,
farthest-point sampling and kNN interpolation (counterpart of the JAX
package's ``ops/points.py``).

Fixed shapes throughout: kNN and the ball query are brute-force masked
[Q, R] distance matrices, FPS the iterative max-min scan. No entry point of
the port calls them; the point backbones use the grid-hash
:func:`..cluster.neighbors.radius_query`. The K smallest are selected with
ties broken by the lower reference row, as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_dist2(query: torch.Tensor, ref: torch.Tensor,
                   qvalid: Optional[torch.Tensor] = None,
                   rvalid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked squared distances [Q, R]; invalid pairs become +inf."""
    q2 = (query * query).sum(dim=1)[:, None]
    r2 = (ref * ref).sum(dim=1)[None, :]
    d2 = torch.clamp(q2 + r2 - 2.0 * (query @ ref.T), min=0.0)
    inf = torch.full_like(d2, float("inf"))
    if rvalid is not None:
        d2 = torch.where(rvalid[None, :], d2, inf)
    if qvalid is not None:
        d2 = torch.where(qvalid[:, None], d2, inf)
    return d2


def _smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest non-negative entries per row, ascending, the lower
    column first among equal values: (values, columns)."""
    cols = torch.arange(d2.shape[1], device=d2.device)
    key = (d2.contiguous().view(torch.int32).long() << 32) | cols
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return d2.gather(1, sel), sel


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        qvalid: Optional[torch.Tensor] = None, rvalid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest reference rows per query (brute force). Returns (idx [Q, k]
    int32, -1 where fewer than k valid refs; dist2 [Q, k] f32, +inf
    padding), nearest first."""
    d2 = pairwise_dist2(query, ref, qvalid, rvalid)
    dist2, idx = _smallest(d2, min(k, ref.shape[0]))
    idx = torch.where(torch.isfinite(dist2), idx, torch.full_like(idx, -1)).to(torch.int32)
    pad = k - idx.shape[1]
    if pad > 0:
        idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], dim=1)
        dist2 = torch.cat([dist2, dist2.new_full((dist2.shape[0], pad), float("inf"))], dim=1)
    return idx, dist2


def ball_query(query: torch.Tensor, ref: torch.Tensor, radius: float, k: int,
               qvalid: Optional[torch.Tensor] = None, rvalid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` reference rows within ``radius`` per query, nearest
    first; -1 / +inf padding."""
    idx, dist2 = knn(query, ref, k, qvalid, rvalid)
    ok = dist2 <= radius * radius
    return (torch.where(ok, idx, torch.full_like(idx, -1)),
            torch.where(ok, dist2, torch.full_like(dist2, float("inf"))))


def farthest_point_sample(pos: torch.Tensor, num_samples: int,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative farthest-point sampling from the first valid row: each
    step adds the row farthest from the selected set (the first such row on
    ties). Returns [num_samples] int32 row indices; indices repeat when
    fewer valid rows exist."""
    n = pos.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=pos.device)
    start = torch.argmax(valid.to(torch.int32))
    neg = torch.full((n,), float("-inf"), dtype=pos.dtype, device=pos.device)
    mind2 = torch.where(valid, ((pos - pos[start]) ** 2).sum(dim=1), neg)
    sel = torch.full((num_samples,), 0, dtype=torch.int64, device=pos.device)
    sel[0] = start
    for i in range(1, num_samples):
        nxt = torch.argmax(mind2)
        sel[i] = nxt
        d2 = ((pos - pos[nxt]) ** 2).sum(dim=1)
        mind2 = torch.where(valid, torch.minimum(mind2, d2), neg)
    return sel.to(torch.int32)


def knn_interpolate(feats: torch.Tensor, src_pos: torch.Tensor, dst_pos: torch.Tensor,
                    k: int = 3, src_valid: Optional[torch.Tensor] = None,
                    dst_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-squared-distance weighted mean of the k nearest source
    features per destination (torch_geometric ``knn_interpolate``)."""
    idx, d2 = knn(dst_pos, src_pos, k, dst_valid, src_valid)
    w = torch.where(idx >= 0, 1.0 / torch.clamp(d2, min=1e-16), torch.zeros_like(d2))
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-16)
    g = feats[idx.clamp(min=0).long()]  # [D, k, C]
    out = (g * w[:, :, None].to(feats.dtype)).sum(dim=1)
    if dst_valid is not None:
        out = torch.where(dst_valid[:, None], out, torch.zeros_like(out))
    return out
