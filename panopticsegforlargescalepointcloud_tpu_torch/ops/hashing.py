"""Voxel-coordinate hashing: packed keys + sort-join lookup.

Counterpart of the JAX package's ``ops/hashing.py``. Keys pack (batch, x, y,
z) into 32 bits; they are held in ``int64`` tensors here (torch's ``uint32``
supports too few ops), which keeps the values and their order. Padding rows
carry ``INVALID_KEY = 0xFFFFFFFF``, which sorts after every valid key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BitLayout(NamedTuple):
    """Static bit allocation for key packing: x, y, z bits (batch gets the rest)."""

    bx: int = 10
    by: int = 10
    bz: int = 8

    @property
    def bb(self) -> int:
        return 32 - self.bx - self.by - self.bz

    @property
    def max_batch(self) -> int:
        # the all-ones batch field is reserved so INVALID_KEY never collides
        return (1 << self.bb) - 1


DEFAULT_BITS = BitLayout(10, 10, 8)
INVALID_KEY = 0xFFFFFFFF


def pack_coords(
    batch: torch.Tensor,
    coords: torch.Tensor,
    bits: BitLayout = DEFAULT_BITS,
    extra_invalid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pack (batch [N], coords [N, 3]) int32 into int64 keys in [0, 2^32).

    Out-of-range coordinates, out-of-range batch ids and rows flagged by
    ``extra_invalid`` map to INVALID_KEY."""
    bx, by, bz = bits.bx, bits.by, bits.bz
    x = coords[:, 0].long() + (1 << (bx - 1))
    y = coords[:, 1].long() + (1 << (by - 1))
    z = coords[:, 2].long() + (1 << (bz - 1))
    b = batch.long()
    valid = (
        (x >= 0) & (x < (1 << bx))
        & (y >= 0) & (y < (1 << by))
        & (z >= 0) & (z < (1 << bz))
        & (b >= 0) & (b < bits.max_batch)
    )
    if extra_invalid is not None:
        valid = valid & ~extra_invalid
    key = (b << (bx + by + bz)) | (x << (by + bz)) | (y << bz) | z
    return torch.where(valid, key, torch.full_like(key, INVALID_KEY))


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Row index of each query key in an ascending key table, -1 if absent.

    The sort method of the JAX package: co-sort table and queries (table
    rows first among equal keys, so the sort must be stable), then carry the
    last seen table row forward with a running max."""
    shape = query_keys.shape
    q = query_keys.reshape(-1)
    n, m = sorted_keys.shape[0], q.shape[0]
    dev = q.device
    all_keys = torch.cat([sorted_keys, q])
    tag = torch.cat([
        torch.arange(n, dtype=torch.int64, device=dev),
        torch.full((m,), -1, dtype=torch.int64, device=dev),
    ])
    order = torch.argsort(all_keys, stable=True)
    skeys = all_keys[order]
    last_row = torch.cummax(tag[order], dim=0).values
    cand = last_row.clamp(min=0)
    hit = (sorted_keys[cand] == skeys) & (last_row >= 0)
    res_sorted = torch.where(hit, cand, torch.full_like(cand, -1))
    res = torch.empty_like(res_sorted)
    res[order] = res_sorted  # order is a permutation: no duplicate targets
    out = torch.where(q != INVALID_KEY, res[n:], torch.full_like(q, -1))
    return out.to(torch.int32).reshape(shape)
