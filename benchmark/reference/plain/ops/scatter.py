"""Segment reductions and drop-mode scatters on padded tensors.

Counterparts of the JAX package's ``ops/scatter.py`` (``jax.ops.segment_*``
semantics: negative or out-of-range segment ids are dropped) and of JAX's
``x.at[idx].set(v, mode="drop")``. Dropped rows are routed to one extra slot
of an ``n + 1`` buffer that is sliced away, so real targets never collide.
"""

from __future__ import annotations

import torch


def scatter_drop(
    n: int, fill, tgt: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``full((n,) + values.shape[1:], fill).at[tgt].set(values, mode="drop")``.

    Targets outside [0, n) go to a scratch slot. Callers guarantee that the
    real targets are unique (the JAX code relies on the same)."""
    t = torch.where((tgt >= 0) & (tgt < n), tgt.long(),
                    torch.full_like(tgt, n, dtype=torch.long))
    out = torch.full((n + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    out[t] = values
    return out[:n]


def _seg_index(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(ok, segment_ids.long(),
                       torch.full_like(segment_ids, num_segments, dtype=torch.long))


def _expand(idx: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    idx = _seg_index(segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    out.index_add_(0, idx, data)
    return out[:num_segments]


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, eps: float = 1e-8
) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype, device=data.device),
                        segment_ids, num_segments)
    return total / (count.reshape((-1,) + (1,) * (data.dim() - 1)) + eps)


def _segment_extreme(data, segment_ids, num_segments, fill, reduce):
    idx = _seg_index(segment_ids, num_segments)
    if data.dtype.is_floating_point:
        init = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        init = info.min if reduce == "amax" else info.max
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), init, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, _expand(idx, data), data, reduce=reduce, include_self=True)
    out = out[:num_segments]
    if fill is not None:
        count = segment_sum(torch.ones(data.shape[:1], dtype=torch.int32, device=data.device),
                            segment_ids, num_segments)
        empty = (count == 0).reshape((-1,) + (1,) * (data.dim() - 1))
        out = torch.where(empty, torch.full_like(out, fill), out)
    return out


def segment_max(data, segment_ids, num_segments: int, fill=None) -> torch.Tensor:
    """Segment max; empty segments get ``fill`` (default: the dtype's lowest)."""
    return _segment_extreme(data, segment_ids, num_segments, fill, "amax")


def segment_min(data, segment_ids, num_segments: int, fill=None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, fill, "amin")
